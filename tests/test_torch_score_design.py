"""The per-frame engine's two kernels, ``proxy_score`` and the
single-frame ``window_gather``, around their card design, on the CPU.

``proxy_score``'s arithmetic is modelled as the card kernel
(``csrc/proxy_score.cu``) computes it: one warp a cell row; where C is
even, lane l takes the channel pairs (2p, 2p + 1) for p = l, l + 32,
..., one fma each from 0 (so at C 64 each lane holds two products);
where C is odd, lane l takes channels l, l + 32, ...; then the xor
shuffle tree (16, 8, 4, 2, 1) in f32, the bias, and 1 / (1 + exp(-x)) in
f32.  Each fma is the exact product added in float64 and rounded to f32
(a double rounding, where the card rounds once: the two differ in about
one case in 2^29).  The model is held within 1e-6 of the plain version
and to ``check_scores`` (float64 arithmetic, flips only within 8 f32
ulps of the threshold) at every card case of
``kernels/proxy_score/check.py``.

The wrappers' card outputs are checked through their CPU-visible parts:
``proxy_score``'s one output buffer (``out_buffer``: the scores, then
the positives) and ``views_to_host``'s one copy, and each wrapper's
launch with a fake launcher (which symbol, which pointers), so that the
per-frame engine's host tables of at most 16 rows go to the launch
itself, never through a copy.  The single-frame gather's plain version
is held to the JAX package's Pallas kernel in interpret mode with host
tables of 8 and 20 rows, and ``ProxyModel.scores`` / ``scores_batch`` to
the plain version of the head on the encoder's features.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

from repro.kernels.proxy_score.ref import (  # noqa: E402
    proxy_score_ref as jx_score)
from repro.kernels.window_gather.kernel import (  # noqa: E402
    window_gather_pallas)
from repro.kernels.window_gather.ref import (  # noqa: E402
    window_gather_ref as jx_gather1)
from repro_torch.core.proxy import ProxyModel  # noqa: E402
from repro_torch.kernels import views_to_host  # noqa: E402
from repro_torch.kernels.proxy_score import check as score_check  # noqa: E402
from repro_torch.kernels.proxy_score import ops as score_ops  # noqa: E402
from repro_torch.kernels.proxy_score.ops import (  # noqa: E402
    check_scores, out_buffer, proxy_score, proxy_score_ref)
from repro_torch.kernels.window_gather import check as gather_check  # noqa: E402
from repro_torch.kernels.window_gather import ops as gather_ops  # noqa: E402
from repro_torch.kernels.window_gather.ops import (  # noqa: E402
    MAX_PARAM_ROWS, window_gather)

LANES = 32


def _fma(a, b, c):
    """f32 fma as the exact product added in float64, rounded to f32."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def kernel_model(feat, w, b, threshold):
    """(scores, pos) as the card kernel computes them (module docstring).
    feat: (B, Hc, Wc, C) f32; w: (C,) f32; b: f32."""
    shape = feat.shape[:-1]
    C = feat.shape[-1]
    f = feat.reshape(-1, C).astype(np.float32)
    w = np.asarray(w, np.float32)
    acc = np.zeros((f.shape[0], LANES), np.float32)
    if C % 2 == 0:
        for p0 in range(0, C // 2, LANES):
            for lane in range(min(LANES, C // 2 - p0)):
                p = p0 + lane
                acc[:, lane] = _fma(f[:, 2 * p], w[2 * p], acc[:, lane])
                acc[:, lane] = _fma(f[:, 2 * p + 1], w[2 * p + 1],
                                    acc[:, lane])
    else:
        for c0 in range(0, C, LANES):
            for lane in range(min(LANES, C - c0)):
                acc[:, lane] = _fma(f[:, c0 + lane], w[c0 + lane],
                                    acc[:, lane])
    idx = np.arange(LANES)
    for off in (16, 8, 4, 2, 1):
        acc = (acc + acc[:, idx ^ off]).astype(np.float32)
    x = (acc[:, 0] + np.float32(b)).astype(np.float32)
    s = (np.float32(1) / (np.float32(1) + np.exp(-x))).astype(np.float32)
    return s.reshape(shape), (s > np.float32(threshold)).astype(np.int8) \
        .reshape(shape)


@pytest.mark.parametrize("case", score_check.CASES,
                         ids=[c[0] for c in score_check.CASES])
def test_kernel_model_holds_every_card_case(case):
    feat, w, b, thr = score_check.case_operands(case)
    s_m, p_m = kernel_model(feat, w, b, thr)
    s_p, _ = proxy_score_ref(torch.from_numpy(feat), torch.from_numpy(w),
                             torch.tensor([b]), thr)
    assert np.abs(s_m - s_p.numpy()).max() <= score_check.SCORE_ATOL
    band = check_scores(feat, w, b, thr, s_m, p_m)
    if case[2] == "on_a_cell":
        assert band > 0


@pytest.mark.parametrize("C", [64, 13])
@pytest.mark.parametrize("seed", [1, 2])
def test_kernel_model_on_seeded_features(C, seed):
    """The summation order on other seeded features, at C 64 (two
    products a lane) and at an odd C (the scalar loop)."""
    case = ("seeded", (8, 8, 13, C), "quantile")
    feat, w, b, thr = score_check.case_operands(case, seed=seed)
    s_m, p_m = kernel_model(feat, w, b, thr)
    s_j, _ = jx_score(feat, w, b, thr)
    assert np.abs(s_m - np.asarray(s_j)).max() <= score_check.SCORE_ATOL
    check_scores(feat, w, b, thr, s_m, p_m)


def test_proxy_score_one_buffer_outputs():
    """The card's outputs: scores then positives in one buffer, two views
    with today's shapes and dtypes, brought back by one copy; filled
    with the plain version's outputs they read back equal to it and
    within 1e-6 of the JAX reference."""
    case = score_check.CASES[1]
    feat, w, b, thr = score_check.case_operands(case)
    B, hc, wc, _ = feat.shape
    scores, pos = out_buffer(B, hc, wc, "cpu")
    assert scores.shape == pos.shape == (B, hc, wc)
    assert scores.dtype == torch.float32 and pos.dtype == torch.int8
    store = scores.untyped_storage()
    assert pos.untyped_storage().data_ptr() == store.data_ptr()
    assert B * hc * wc * 5 <= store.nbytes() < B * hc * wc * 5 + 4
    assert scores.is_contiguous() and pos.is_contiguous()
    assert pos.storage_offset() == B * hc * wc * 4
    s_p, p_p = proxy_score_ref(torch.from_numpy(feat), torch.from_numpy(w),
                               torch.tensor([b]), thr)
    scores.copy_(s_p)
    pos.copy_(p_p)
    s_h, p_h = views_to_host(scores, pos)
    assert s_h.dtype == np.float32 and p_h.dtype == np.int8
    np.testing.assert_array_equal(s_h, s_p.numpy())
    np.testing.assert_array_equal(p_h, p_p.numpy())
    s_j, p_j = (np.asarray(a) for a in jx_score(feat, w, b, thr))
    np.testing.assert_allclose(s_h, s_j, rtol=0, atol=1e-6)
    assert int((p_h != p_j).sum()) <= check_scores(feat, w, b, thr, s_j,
                                                   p_j)
    # slices along the batch keep their offsets into the one buffer
    s1, p1 = views_to_host(scores[2:5], pos[2:5])
    np.testing.assert_array_equal(s1, s_p.numpy()[2:5])
    np.testing.assert_array_equal(p1, p_p.numpy()[2:5])


@pytest.mark.parametrize("inference", [False, True])
def test_views_to_host_copies_one_span(inference, monkeypatch):
    """Views of one buffer (``proxy_plan``'s int8 grid and int32 stats,
    sliced along the batch as ``plan_batch`` slices them) come back from
    one ``Tensor.cpu()`` of the bytes spanning them, equal to a copy of
    each; tensors of two storages take a copy each."""
    B, hc, wc, width = 4, 3, 5, 8
    ctx = torch.inference_mode() if inference else contextlib.nullcontext()
    with ctx:
        buf = torch.arange(B * hc * wc + B * width * 4,
                           dtype=torch.int64).to(torch.uint8)
        grid = buf[:B * hc * wc].view(torch.int8).view(B, hc, wc)
        stats = buf[B * hc * wc:].view(torch.int32).view(B, width)
        copies = []
        real = torch.Tensor.cpu
        monkeypatch.setattr(torch.Tensor, "cpu",
                            lambda t: copies.append(t.shape) or real(t))
        g, st = views_to_host(grid[:3], stats[:3])
        assert copies == [(B * hc * wc + 3 * width * 4,)]
        np.testing.assert_array_equal(g, real(grid[:3]).numpy())
        np.testing.assert_array_equal(st, real(stats[:3]).numpy())
        assert g.dtype == np.int8 and st.dtype == np.int32
        copies.clear()
        a, c = views_to_host(grid, stats.clone())
        assert len(copies) == 2
        np.testing.assert_array_equal(c, real(stats).numpy())


class _FakeLaunch:
    """Stands in for a C launcher: records its symbol and arguments."""

    def __init__(self):
        self.calls = []

    def launcher(self, *key):
        def fn(*args):
            self.calls.append((key[0] if key else "proxy_score_launch",
                               args))
            return 0
        return None, fn


@contextlib.contextmanager
def _as_if_on_card(ops, fake):
    saved = {k: getattr(ops, k) for k in ("on_cuda", "_launcher",
                                          "device_guard", "stream_of")}
    ops.on_cuda = lambda t: True
    ops._launcher = fake.launcher
    ops.device_guard = lambda t: contextlib.nullcontext()
    ops.stream_of = lambda t: 0
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(ops, k, v)


@pytest.mark.parametrize("n,symbol", [
    (8, "window_gather_rows_launch"), (MAX_PARAM_ROWS,
                                       "window_gather_rows_launch"),
    (20, "window_gather_launch")])
def test_window_gather_routes_a_host_table_by_its_rows(n, symbol):
    """A host table of at most MAX_PARAM_ROWS rows goes to the rows
    launcher as the caller's own memory (no copy is made); a longer one
    to the device-table launcher."""
    frame = torch.zeros((64, 96, 3))
    tbl = np.zeros((n, 2), np.int32)
    fake = _FakeLaunch()
    before = window_gather.launches
    with _as_if_on_card(gather_ops, fake):
        out = window_gather(frame, tbl, win_h=32, win_w=48, cell=16)
    assert window_gather.launches == before + 1
    assert out.shape == (n, 32, 48, 3)
    (sym, args), = fake.calls
    assert sym == symbol
    assert args[3] == n and args[10] == 1      # n, vec4
    if symbol == "window_gather_rows_launch":
        assert args[1] == tbl.ctypes.data


def test_proxy_score_launch_writes_one_buffer():
    """The launch's positives follow its scores in one buffer, and the
    wrapper hands back views of it."""
    feat = torch.zeros((1, 8, 13, 64))
    w, b = torch.zeros(64), torch.zeros(1)
    fake = _FakeLaunch()
    with _as_if_on_card(score_ops, fake):
        s, p = proxy_score(feat, w, b, 0.5)
    (_, args), = fake.calls
    rows = 8 * 13
    assert args[4] == s.data_ptr() and args[5] == p.data_ptr()
    assert args[5] == args[4] + rows * 4 and args[6:8] == (rows, 64)
    assert s.untyped_storage().data_ptr() == p.untyped_storage().data_ptr()


@pytest.mark.parametrize("n_rows", [8, 20])
def test_single_gather_plain_version_matches_pallas(n_rows):
    """The plain version on a host table of 8 or 20 rows (seeded, the
    far edge, a zero row) against the Pallas kernel in interpret mode
    and its oracle, exact."""
    H, W, cell = 80, 128, 16
    rng = np.random.default_rng(n_rows)
    frame = rng.standard_normal((H, W, 3)).astype(np.float32)
    for wc, hc in ((3, 2), (5, 3)):
        case = ("t", (H, W, 3), (wc, hc),
                "long" if n_rows == 20 else "padded", "host")
        tbl = gather_check.single_case_table(case, rng)
        assert len(tbl) == n_rows and not tbl[-1].any()
        win_h, win_w = hc * cell, wc * cell
        got = window_gather(torch.from_numpy(frame), tbl, win_h=win_h,
                            win_w=win_w, cell=cell).numpy()
        np.testing.assert_array_equal(got, np.asarray(jx_gather1(
            frame, tbl * cell, win_h=win_h, win_w=win_w)))
        np.testing.assert_array_equal(got, np.asarray(window_gather_pallas(
            frame, tbl, win_h=win_h, win_w=win_w, cell=cell,
            interpret=True)))
        np.testing.assert_array_equal(got[-1], frame[:win_h, :win_w])


def test_touched_bytes_counts_overlap_once():
    tbl = np.array([[0, 0], [0, 0], [1, 1], [9, 9]], np.int32)
    # (2, 2)-cell windows of 32 px in a 64 x 64 frame: rows 0-1 cover
    # [0, 32)^2, row 2 [16, 48)^2, row 3 clamps to [32, 64)^2
    got = gather_check.touched_bytes((64, 64, 3), tbl, 32, 32)
    covered = np.zeros((64, 64), bool)
    for y, x in ((0, 0), (16, 16), (32, 32)):
        covered[y:y + 32, x:x + 32] = True
    assert got == covered.sum() * 3 * 4


def _proxy(seed=5):
    return ProxyModel(8, 4, (32, 24), seed=seed, device="cpu")


def test_proxy_model_scores_as_before():
    """``ProxyModel.scores`` / ``scores_batch``: the plain head on the
    encoder's features, on the host, with their shapes and dtypes
    (``scores_batch`` drops its bucket's padding rows)."""
    proxy = _proxy()
    rng = np.random.default_rng(0)
    frames = rng.random((3, 24, 32, 3), np.float32)
    enc = proxy.encoder
    feat = proxy.features(frames)
    with torch.inference_mode():
        s_p, p_p = proxy_score_ref(feat, enc.head_w, enc.head_b, 0.5)
    s, p = proxy.scores(frames[1], 0.5)
    assert isinstance(s, np.ndarray) and s.dtype == np.float32
    assert p.dtype == np.int8 and s.shape == p.shape == (3, 4)
    feat1 = proxy.features(frames[1][None])   # as ``scores`` batches it
    with torch.inference_mode():
        s1, p1 = proxy_score_ref(feat1, enc.head_w, enc.head_b, 0.5)
    np.testing.assert_array_equal(s, s1.numpy()[0])
    np.testing.assert_array_equal(p, p1.numpy()[0])
    sb, pb = proxy.scores_batch(frames, 0.5)
    assert sb.shape == pb.shape == (3, 3, 4)
    np.testing.assert_array_equal(sb, s_p.numpy()[:3])
    np.testing.assert_array_equal(pb, p_p.numpy()[:3])
    s0, p0 = proxy.scores_batch(frames[:0], 0.5)
    assert s0.shape == p0.shape == (0, 3, 4)
    assert s0.dtype == np.float32 and p0.dtype == np.int8
