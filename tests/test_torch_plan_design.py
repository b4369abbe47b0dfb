"""The arithmetic of the port's ``proxy_plan`` kernel
(``csrc/proxy_plan.cu``), modelled on the CPU and held to
``check_plan`` (float64 arithmetic; flips only within 8 f32 ulps of the
threshold) and to the plain version (``proxy_plan_ref``).

The model computes what the kernel computes, in its order:

  * the head: kGroup = 4 lanes per proxy cell; lane j sums the channel
    quads q = j, j + 4, ... (channels 4q .. 4q + 3 in turn, one fma
    each, from 0), then a butterfly over the 4 lanes (xor 2, 1), so
    lane 0 holds (v0 + v2) + (v1 + v3); each fma is the exact product
    added in float64 and rounded to f32 (a double rounding, where the
    card rounds once: the two differ in about one case in 2^29);
  * the sigmoid 1 / (1 + exp(-x)) in f32 (PyTorch's CPU exp, within an
    ulp or two of the card's expf) and the strict s > threshold;
  * the mapping through bitmasks: each proxy row's positives a word over
    the proxy columns, each span row a word of its nonzero entries; a
    detector row's word is the OR of the proxy rows under its span, and
    cell (y, x) is mapped iff that word AND span_x row x's word is
    nonzero;
  * the stats over the mapped grid.

Planted mistakes, each of which must fail: ``>=`` for ``>`` (caught
where a sigmoid equals the threshold exactly: zero features and bias
give 0.5 in every implementation, and the plain version's plan at
threshold 0.5 is empty; ``check_plan`` cannot see it, since such a cell
lies in the band), a span end off by one (every span word one bit
longer), and stats taken before the mapping (on the proxy grid).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.proxy_plan import check as plan_check  # noqa: E402
from repro_torch.kernels.proxy_plan.ops import (  # noqa: E402
    check_plan, plan_stats, proxy_plan_ref, span_matrix)

GROUP = 4           # kGroup: lanes a proxy cell
# (B, hp, wp, C, hc, wc): the card cases' shapes and
# tests/test_torch_kernels.py's PLAN_SHAPES
SHAPES = sorted({c[1] for c in plan_check.CASES}
                | {(16, 8, 13, 64, 34, 60), (4, 3, 4, 16, 5, 8)})


def fma32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def kernel_logits(feat: np.ndarray, w: np.ndarray, b) -> np.ndarray:
    """(B, hp, wp) f32 logits, summed as the kernel sums them."""
    C = feat.shape[-1]
    lanes = []
    for j in range(GROUP):
        acc = np.zeros(feat.shape[:-1], np.float32)
        for q in range(j, (C + 3) // 4, GROUP):
            for c in range(4 * q, min(4 * q + 4, C)):
                acc = fma32(feat[..., c], np.float32(w[c]), acc)
        lanes.append(acc)
    off = GROUP // 2
    while off:
        lanes = [lanes[j] + lanes[j ^ off] for j in range(GROUP)]
        off //= 2
    return lanes[0] + np.float32(b)


def words(span: np.ndarray, end_slack: int = 0) -> np.ndarray:
    """Each span row as one uint64 word of its nonzero entries (at most
    64 sources); ``end_slack`` 1 plants a span end off by one."""
    n = span.shape[1]
    out = np.zeros(span.shape[0], np.uint64)
    for i, row in enumerate(span):
        nz = list(np.flatnonzero(row))
        if end_slack and nz[-1] + 1 < n:
            nz.append(nz[-1] + 1)
        for k in nz:
            out[i] |= np.uint64(1) << np.uint64(k)
    return out


def model_plan(feat, w, b, thr, hc, wc, strict=True, end_slack=0,
               stats_first=False):
    """The kernel's plan (grid (B, hc, wc) int8, stats (B, 8) int32) by
    the arithmetic above, with the planted mistakes as options."""
    B, hp, wp, _ = feat.shape
    assert hp <= 64 and wp <= 64
    x = kernel_logits(feat, w, b)
    s = np.float32(1) / (np.float32(1) + torch.exp(
        torch.from_numpy(-x)).numpy())
    pos = s >= np.float32(thr) if not strict else s > np.float32(thr)
    bits = (np.uint64(1) << np.arange(wp, dtype=np.uint64))
    rowbits = (pos * bits).sum(axis=2, dtype=np.uint64)          # (B, hp)
    ymask = words(span_matrix(hc, hp), end_slack)                # (hc,)
    xmask = words(span_matrix(wc, wp), end_slack)                # (wc,)
    rmask = np.zeros((B, hc), np.uint64)
    for y in range(hc):
        for h in range(hp):
            if ymask[y] >> np.uint64(h) & np.uint64(1):
                rmask[:, y] |= rowbits[:, h]
    grid = (rmask[:, :, None] & xmask[None, None, :]) != 0
    stats = plan_stats(torch.from_numpy(pos if stats_first else grid))
    return torch.from_numpy(grid.astype(np.int8)), stats


def _case(shape, kind):
    return plan_check.case_operands(("", shape, kind), seed=shape[4])


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# every shape at a threshold between cells and on a cell; the empty
# frame where the batch holds it
PARAMS = [(s, k) for s in SHAPES for k in ("quantile", "on_a_cell",
                                           "empty_frame")
          if k != "empty_frame" or s[0] > plan_check.EMPTY_FRAME]


@pytest.mark.parametrize("shape,kind", PARAMS,
                         ids=[f"{s}-{k}" for s, k in PARAMS])
def test_model_holds_to_check_plan(shape, kind):
    feat, w, b, thr = _case(shape, kind)
    hc, wc = shape[4:]
    grid, stats = model_plan(feat, w, b, thr, hc, wc)
    reach = check_plan(feat, w, b, thr, grid, stats)
    # outside the band the model's plan is the plain version's, bit
    # for bit, stats included
    sy = torch.from_numpy(span_matrix(hc, shape[1]))
    sx = torch.from_numpy(span_matrix(wc, shape[2]))
    gp, sp = proxy_plan_ref(torch.from_numpy(feat), torch.from_numpy(w),
                            torch.tensor([b]), thr, sy, sx)
    same = ~(grid != gp).any(dim=(1, 2))
    assert torch.equal(stats[same], sp[same])
    assert reach > 0 or bool(same.all())


def test_model_matches_the_strict_threshold_at_a_tie():
    # zero features and bias: every sigmoid is exactly 0.5
    feat = np.zeros((2, 8, 13, 64), np.float32)
    w = np.ones(64, np.float32)
    grid, stats = model_plan(feat, w, 0.0, 0.5, 34, 60)
    sy = torch.from_numpy(span_matrix(34, 8))
    sx = torch.from_numpy(span_matrix(60, 13))
    gp, sp = proxy_plan_ref(torch.from_numpy(feat), torch.from_numpy(w),
                            torch.zeros(1), 0.5, sy, sx)
    assert int(gp.sum()) == 0
    assert torch.equal(grid, gp) and torch.equal(stats, sp)


def test_planted_non_strict_threshold_fails():
    feat = np.zeros((2, 8, 13, 64), np.float32)
    w = np.ones(64, np.float32)
    grid, _ = model_plan(feat, w, 0.0, 0.5, 34, 60, strict=False)
    sy = torch.from_numpy(span_matrix(34, 8))
    sx = torch.from_numpy(span_matrix(60, 13))
    gp, _ = proxy_plan_ref(torch.from_numpy(feat), torch.from_numpy(w),
                           torch.zeros(1), 0.5, sy, sx)
    assert not torch.equal(grid, gp)


@pytest.mark.parametrize("mistake", [dict(end_slack=1),
                                     dict(stats_first=True)],
                         ids=["span end off by one",
                              "stats before the mapping"])
@pytest.mark.parametrize("shape", [plan_check.MAIN, (4, 3, 4, 16, 5, 8)],
                         ids=["main path", "reduced"])
def test_planted_mistake_fails_check_plan(shape, mistake):
    feat, w, b, thr = _case(shape, "quantile")
    grid, stats = model_plan(feat, w, b, thr, *shape[4:], **mistake)
    with pytest.raises(AssertionError):
        check_plan(feat, w, b, thr, grid, stats)
