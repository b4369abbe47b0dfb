"""The port's kernels against the JAX package's, on the CPU.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs its Pallas kernels in interpret mode (as tests/test_kernels.py
does) and its jnp oracles.  Inputs come from seeded numpy.

proxy_plan: every implementation's plan is held against float64
arithmetic with ``check_plan`` — cells whose sigmoid lies within
``FLIP_ULPS`` f32 ulps of the threshold may flip, nothing else may —
and outside that band the port's grids and stats equal the JAX ones.
proxy_score: scores within 1e-6 of the JAX kernel's, and every
implementation's positives held to float64 with ``check_scores`` (the
same 8-ulp band); outside it the positives equal the JAX ones.
window_gather_batch and window_gather: pure copies, so exact.
assign and track_step: the port's plain versions, the JAX package's
Pallas kernels in interpret mode and its numpy oracles agree bit for bit
(columns, and f32 outputs compared as bits).
flash_attention and decode_attention: the port's plain versions against
the JAX package's CPU paths (``_chunked_jnp``, the padding wrapper,
``_jnp_fallback``), its Pallas kernels in interpret mode and its naive
oracle, within the tolerances of tests/test_kernels.py (2e-5 in f32,
2e-2 in bf16, absolute and relative).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.proxy_plan.kernel import proxy_plan_pallas  # noqa: E402
from repro.kernels.proxy_plan.ops import span_matrix as jx_span  # noqa: E402
from repro.kernels.proxy_plan.ref import proxy_plan_ref as jx_plan  # noqa: E402
from repro.kernels.proxy_score.kernel import proxy_score_pallas  # noqa: E402
from repro.kernels.proxy_score.ref import (  # noqa: E402
    proxy_score_ref as jx_score)
from repro.kernels.window_gather.kernel import (  # noqa: E402
    window_gather_batch_pallas, window_gather_pallas)
from repro.kernels.window_gather.ref import (  # noqa: E402
    window_gather_batch_ref as jx_gather, window_gather_ref as jx_gather1)
from repro.kernels.assign.kernel import assign_pallas, solve_one  # noqa: E402
from repro.kernels.assign.ops import _solve_vmapped  # noqa: E402
from repro.core.hungarian import (  # noqa: E402
    BIG, hungarian_batch as jx_hungarian_batch, solve_device_np)
from repro.kernels.track_step import (  # noqa: E402
    pack_params as jx_pack, track_step_ref as jx_step_ref)
from repro.kernels.track_step.kernel import track_step_pallas  # noqa: E402
from repro.kernels.track_step.ops import (  # noqa: E402
    LOG1P_TABLE_2D as JX_TABLE)
from repro_torch.core.hungarian import hungarian_batch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.assign import assign_batch  # noqa: E402
from repro_torch.kernels.track_step import (  # noqa: E402
    LOG1P_TABLE_2D, pack_params, track_step)
from repro_torch.kernels.proxy_plan import (  # noqa: E402
    proxy_plan, span_matrix)
from repro_torch.kernels.proxy_plan.ops import check_plan  # noqa: E402
from repro_torch.kernels.proxy_score import (  # noqa: E402
    check_scores, proxy_score)
from repro_torch.kernels.window_gather import (  # noqa: E402
    window_gather, window_gather_batch)
from repro.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_pallas)
from repro.kernels.flash_attention.ops import (  # noqa: E402
    _chunked_jnp as jx_chunked, flash_attention as jx_flash)
from repro.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref as jx_flash_oracle)
from repro.kernels.decode_attention.kernel import (  # noqa: E402
    decode_attention_pallas)
from repro.kernels.decode_attention.ops import (  # noqa: E402
    _jnp_fallback as jx_decode_fallback)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_ref)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_ref)

# (B, hp, wp, C, hc, wc): the full-width main path (proxy 416x256 at
# cell 32 -> 13x8 cells of 64 features, detector grid 60x34) and a
# reduced one (proxy 32x24 at cell 8, detector 128x80)
PLAN_SHAPES = [(16, 8, 13, 64, 34, 60), (4, 3, 4, 16, 5, 8)]


def _plan_inputs(shape, seed):
    B, hp, wp, C, _, _ = shape
    rng = np.random.default_rng(seed)
    feat = np.maximum(rng.standard_normal((B, hp, wp, C)), 0) \
        .astype(np.float32)                  # relu features
    w = (rng.standard_normal(C) / np.sqrt(C)).astype(np.float32)
    b = np.float32(0.1)
    s64 = 1.0 / (1.0 + np.exp(-(np.einsum(
        "bhwc,c->bhw", feat.astype(np.float64), w.astype(np.float64))
        + b)))
    return feat, w, b, s64


@pytest.mark.parametrize("shape", PLAN_SHAPES)
@pytest.mark.parametrize("thr_kind", ["quantile", "on_a_cell"])
def test_proxy_plan_matches_jax(shape, thr_kind):
    B, hp, wp, C, hc, wc = shape
    feat, w, b, s64 = _plan_inputs(shape, seed=hc)
    if thr_kind == "quantile":
        thr = float(np.quantile(s64, 0.85))
    else:       # a threshold ON one cell's score: that cell may flip
        thr = float(np.float32(s64[B // 2, hp // 2, wp // 2]))
    sy, sx = jnp.asarray(jx_span(hc, hp)), jnp.asarray(jx_span(wc, wp))
    np.testing.assert_array_equal(span_matrix(hc, hp), jx_span(hc, hp))
    got = proxy_plan(torch.from_numpy(feat), torch.from_numpy(w),
                     torch.tensor([b]), thr, grid_hw=(hc, wc))
    got = [t.numpy() for t in got]
    assert got[0].dtype == np.int8 and got[0].shape == (B, hc, wc)
    assert got[1].dtype == np.int32 and got[1].shape == (B, 8)
    reach = check_plan(feat, w, b, thr, *got)
    if thr_kind == "on_a_cell":
        assert reach > 0
    for name, ref in (
            ("interpret", proxy_plan_pallas(feat, w, b, thr, sy, sx,
                                            interpret=True)),
            ("jnp ref", jx_plan(feat, w, b, thr, sy, sx))):
        grid, stats = (np.asarray(a) for a in ref)
        assert check_plan(feat, w, b, thr, grid, stats) == reach, name
        flipped = (grid != got[0]).any(axis=(1, 2))
        # every flip lies in the band (checked above); frames no flip
        # touched agree exactly, stats rows included
        np.testing.assert_array_equal(grid[~flipped], got[0][~flipped])
        np.testing.assert_array_equal(stats[~flipped], got[1][~flipped])
        assert flipped.sum() <= (reach > 0) * B


def test_proxy_plan_empty_frame_sentinels():
    feat = np.zeros((2, 3, 4, 8), np.float32)
    grid, stats = proxy_plan(torch.from_numpy(feat), torch.zeros(8),
                             torch.tensor([-5.0]), 0.5, grid_hw=(5, 7))
    assert int(grid.sum()) == 0
    np.testing.assert_array_equal(stats.numpy(),
                                  [[0, 5, -1, 7, -1, 0, 0, 0]] * 2)


# (B, Hc, Wc, C): the per-frame path (one proxy frame of 13x8 cells of
# 64 features), a chunk with fused_plan=False, the reduced config
# (proxy 32x24 at cell 8, 4 base channels -> 16 features), and a shape
# whose rows (231) are not a multiple of the Pallas kernel's 256-row block
SCORE_SHAPES = [(1, 8, 13, 64), (16, 8, 13, 64), (4, 3, 4, 16),
                (3, 7, 11, 24)]


@pytest.mark.parametrize("shape", SCORE_SHAPES)
@pytest.mark.parametrize("thr_kind", ["mid", "on_a_cell", "inf", "-inf"])
def test_proxy_score_matches_jax(shape, thr_kind):
    B, hc, wc, C = shape
    feat, w, b, s64 = _plan_inputs((B, hc, wc, C, 1, 1), seed=C + hc)
    thr = {"mid": float(np.median(s64)),
           # ON one cell's score: that cell may go either way
           "on_a_cell": float(np.float32(s64[B // 2, hc // 2, wc // 2])),
           "inf": float("inf"), "-inf": float("-inf")}[thr_kind]
    s_t, p_t = proxy_score(torch.from_numpy(feat), torch.from_numpy(w),
                           torch.tensor([b]), thr)
    s_t, p_t = s_t.numpy(), p_t.numpy()
    assert s_t.dtype == np.float32 and s_t.shape == (B, hc, wc)
    assert p_t.dtype == np.int8 and p_t.shape == (B, hc, wc)
    band = check_scores(feat, w, b, thr, s_t, p_t)
    if thr_kind == "on_a_cell":
        assert band > 0
    if thr_kind == "inf":
        assert band == 0 and not p_t.any()
    if thr_kind == "-inf":
        assert band == 0 and p_t.all()
    for name, ref in (
            ("interpret", proxy_score_pallas(feat, w, b, thr,
                                             interpret=True)),
            ("jnp ref", jx_score(feat, w, b, thr))):
        s_j, p_j = (np.asarray(a) for a in ref)
        np.testing.assert_allclose(s_t, s_j, rtol=0, atol=1e-6,
                                   err_msg=name)
        assert check_scores(feat, w, b, thr, s_j, p_j) == band, name
        # every disagreement lies in the band (checked above)
        assert int((p_j != p_t).sum()) <= band, name


def test_proxy_score_threshold_is_strict():
    """A score exactly at the threshold is not positive, as in the
    reference's ``score > threshold``."""
    s, p = proxy_score(torch.zeros((1, 1, 2, 8)), torch.zeros(8),
                       torch.zeros(1), 0.5)
    assert float(s[0, 0, 0]) == 0.5 and not p.any()
    s_j, p_j = jx_score(np.zeros((1, 1, 2, 8), np.float32),
                        np.zeros(8, np.float32), 0.0, 0.5)
    assert float(s_j[0, 0, 0]) == 0.5 and not np.asarray(p_j).any()


def test_check_scores_rejects_a_flip_outside_the_band():
    feat, w, b, s64 = _plan_inputs((1, 8, 13, 64, 1, 1), seed=3)
    thr = float(np.median(s64))
    s, p = proxy_score(torch.from_numpy(feat), torch.from_numpy(w),
                       torch.tensor([b]), thr)
    far = np.unravel_index(np.argmax(np.abs(s64 - thr)), s64.shape)
    bad_p = p.clone()
    bad_p[far] = 1 - bad_p[far]
    bad_s = s.clone()
    bad_s[far] = 1.0 if int(bad_p[far]) else 0.0
    with pytest.raises(AssertionError, match="exact arithmetic"):
        check_scores(feat, w, b, thr, bad_s, bad_p)
    with pytest.raises(AssertionError, match="scores' own"):
        check_scores(feat, w, b, thr, s, bad_p)


def _gather_case(B, H, W, cell, sizes, seed):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    cases = []
    for (wc, hc) in sizes:
        n = 5
        tbl = np.zeros((8, 3), np.int32)     # bucket-padded with zeros
        tbl[:n, 0] = rng.integers(0, B, n)
        tbl[:n, 1] = rng.integers(0, H // cell - hc + 1, n)
        tbl[:n, 2] = rng.integers(0, W // cell - wc + 1, n)
        cases.append((hc * cell, wc * cell, tbl))
    return frames, cases


@pytest.mark.parametrize("B,H,W,sizes", [
    (16, 544, 960, [(15, 9), (30, 17)]),     # full-width main path
    (3, 80, 128, [(3, 2), (5, 3)]),          # reduced
])
def test_window_gather_batch_matches_jax(B, H, W, sizes):
    cell = 16
    frames, cases = _gather_case(B, H, W, cell, sizes, seed=H)
    ft = torch.from_numpy(frames)
    for win_h, win_w, tbl in cases:
        got = window_gather_batch(ft, tbl, win_h=win_h, win_w=win_w,
                                  cell=cell).numpy()
        ref = np.asarray(jx_gather(
            frames, tbl * np.array([1, cell, cell], np.int32),
            win_h=win_h, win_w=win_w))
        np.testing.assert_array_equal(got, ref)
        for k, (b, cy, cx) in enumerate(tbl):   # padding rows: frame 0
            np.testing.assert_array_equal(
                got[k], frames[b, cy * cell:cy * cell + win_h,
                               cx * cell:cx * cell + win_w])
        # interpret mode walks every 16x16 tile: at full width it takes
        # one real window and one padding row
        rows = slice(None) if H < 200 else [0, len(tbl) - 1]
        pal = window_gather_batch_pallas(frames, tbl[rows], win_h=win_h,
                                         win_w=win_w, cell=cell,
                                         interpret=True)
        np.testing.assert_array_equal(got[rows], np.asarray(pal))


@pytest.mark.parametrize("H,W,sizes", [
    (544, 960, [(15, 9), (30, 17), (60, 34)]),    # full-width per-frame path
    (80, 128, [(3, 2), (5, 3)]),                  # reduced
])
def test_window_gather_matches_jax(H, W, sizes):
    """The single-frame gather against the JAX Pallas kernel in
    interpret mode and its dynamic_slice oracle: a table bucket-padded
    with zero rows, a window at the far edge, exact."""
    cell = 16
    rng = np.random.default_rng(H + W)
    frame = rng.standard_normal((H, W, 3)).astype(np.float32)
    ft = torch.from_numpy(frame)
    for (wc, hc) in sizes:
        win_h, win_w = hc * cell, wc * cell
        tbl = np.zeros((8, 2), np.int32)
        tbl[:3, 0] = rng.integers(0, H // cell - hc + 1, 3)
        tbl[:3, 1] = rng.integers(0, W // cell - wc + 1, 3)
        tbl[3] = (H // cell - hc, W // cell - wc)       # far edge
        got = window_gather(ft, tbl, win_h=win_h, win_w=win_w,
                            cell=cell).numpy()
        assert got.shape == (8, win_h, win_w, 3)
        np.testing.assert_array_equal(got, np.asarray(jx_gather1(
            frame, tbl * cell, win_h=win_h, win_w=win_w)))
        for k, (cy, cx) in enumerate(tbl):     # padding rows: cell (0, 0)
            np.testing.assert_array_equal(
                got[k], frame[cy * cell:cy * cell + win_h,
                              cx * cell:cx * cell + win_w])
        # interpret mode walks every 16x16 tile: at full width it takes
        # the far-edge window and one padding row
        rows = slice(None) if H < 200 else [3, 7]
        pal = window_gather_pallas(frame, tbl[rows], win_h=win_h,
                                   win_w=win_w, cell=cell, interpret=True)
        np.testing.assert_array_equal(got[rows], np.asarray(pal))


def test_window_gather_clamps_like_dynamic_slice():
    """Origins past the frame clamp into it, as ``dynamic_slice`` does."""
    frame = np.arange(64 * 96 * 3, dtype=np.float32).reshape(64, 96, 3)
    tbl = np.array([[9, 9], [-1, 2], [0, 5]], np.int32)
    got = window_gather(torch.from_numpy(frame), tbl, win_h=32, win_w=48,
                        cell=16).numpy()
    np.testing.assert_array_equal(got, np.asarray(jx_gather1(
        frame, tbl * 16, win_h=32, win_w=48)))
    np.testing.assert_array_equal(got[0], frame[32:, 48:])
    with pytest.raises(ValueError, match="must be \\(n, 2\\)"):
        window_gather(torch.from_numpy(frame), np.zeros((2, 3), np.int32),
                      win_h=32, win_w=48, cell=16)


def _counts():
    return (proxy_plan.launches, window_gather_batch.launches,
            assign_batch.launches, track_step.launches,
            proxy_score.launches, window_gather.launches)


def test_wrappers_run_plain_version_on_cpu_tensors():
    """A CPU tensor takes the plain version: no launch is counted."""
    before = _counts()
    proxy_plan(torch.ones(1, 2, 2, 4), torch.ones(4), torch.zeros(1), 0.5,
               grid_hw=(2, 2))
    window_gather_batch(torch.ones(1, 32, 32, 3),
                        np.zeros((1, 3), np.int32), win_h=16, win_w=16,
                        cell=16)
    s, p = proxy_score(torch.ones(1, 2, 2, 4), torch.ones(4),
                       torch.zeros(1), 0.5)
    assert s.device.type == p.device.type == "cpu"
    assert window_gather(torch.ones(32, 32, 3), np.zeros((1, 2), np.int32),
                         win_h=16, win_w=16, cell=16).shape == (1, 16, 16, 3)
    assert assign_batch(torch.ones(2, 3, 3)).shape == (2, 3)
    rng = np.random.default_rng(0)
    arrs, thr, np_params = _track_step_operands(rng, 1, 8, 4, 4, 4)
    out = track_step(*(torch.from_numpy(a) for a in arrs),
                     torch.from_numpy(thr), pack_params(np_params, "cpu"),
                     torch.from_numpy(LOG1P_TABLE_2D))
    assert [o.device.type for o in out] == ["cpu"] * 3
    assert _counts() == before


def test_wrappers_reject_other_devices():
    """Neither a kernel nor a plain version exists off CPU and CUDA."""
    meta = torch.empty((1, 2, 2, 4), device="meta")
    with pytest.raises(ValueError):
        proxy_plan(meta, meta[0, 0, 0], meta[0, 0, 0, :1], 0.5,
                   grid_hw=(2, 2))
    with pytest.raises(ValueError):
        window_gather_batch(torch.empty((1, 32, 32, 3), device="meta"),
                            np.zeros((1, 3), np.int32), win_h=16,
                            win_w=16, cell=16)
    with pytest.raises(ValueError):
        proxy_score(meta, meta[0, 0, 0], meta[0, 0, 0, :1], 0.5)
    with pytest.raises(ValueError):
        window_gather(torch.empty((32, 32, 3), device="meta"),
                      np.zeros((1, 2), np.int32), win_h=16, win_w=16,
                      cell=16)
    with pytest.raises(ValueError):
        assign_batch(torch.empty((1, 4, 4), device="meta"))
    with pytest.raises(ValueError):
        track_step(*([torch.empty((1, 8, 4), device="meta")] + [None] * 10))


LAUNCHERS = [
    ("proxy_plan.cu", "proxy_plan_launch",
     "repro_torch.kernels.proxy_plan.ops", "LAUNCH_ARGTYPES"),
    ("window_gather.cu", "window_gather_batch_launch",
     "repro_torch.kernels.window_gather.ops", "LAUNCH_ARGTYPES"),
    ("window_gather.cu", "window_gather_batch_rows_launch",
     "repro_torch.kernels.window_gather.ops", "LAUNCH_ARGTYPES"),
    ("window_gather.cu", "window_gather_launch",
     "repro_torch.kernels.window_gather.ops", "LAUNCH_ARGTYPES_SINGLE"),
    ("window_gather.cu", "window_gather_rows_launch",
     "repro_torch.kernels.window_gather.ops", "LAUNCH_ARGTYPES_SINGLE"),
    ("proxy_score.cu", "proxy_score_launch",
     "repro_torch.kernels.proxy_score.ops", "LAUNCH_ARGTYPES"),
    ("assign.cu", "assign_launch", "repro_torch.kernels.assign.ops",
     "LAUNCH_ARGTYPES"),
    ("track_step.cu", "track_step_launch",
     "repro_torch.kernels.track_step.ops", "LAUNCH_ARGTYPES"),
    ("flash_attention.cu", "flash_attention_launch",
     "repro_torch.kernels.flash_attention.ops", "LAUNCH_ARGTYPES"),
    ("flash_attention_bwd.cu", "flash_attention_bwd_launch",
     "repro_torch.kernels.flash_attention.ops", "BWD_LAUNCH_ARGTYPES"),
    ("decode_attention.cu", "decode_attention_launch",
     "repro_torch.kernels.decode_attention.ops", "LAUNCH_ARGTYPES"),
    ("ssd_scan.cu", "ssd_scan_launch", "repro_torch.kernels.ssd_scan.ops",
     "LAUNCH_ARGTYPES"),
]


# ids name the source, launcher and module (each launcher has one)
@pytest.mark.parametrize("src,fn,ops,attr", LAUNCHERS,
                         ids=["-".join(row[:3]) for row in LAUNCHERS])
def test_ctypes_signature_matches_c_source(src, fn, ops, attr):
    """The ctypes argtypes each wrapper declares (module attribute
    ``attr``) match the C launcher's parameter list (a mismatch only
    shows on the card otherwise)."""
    import ctypes
    import importlib
    import re
    from repro_torch.kernels._build import SRC_DIR
    text = (SRC_DIR / src).read_text()
    m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
    assert m, fn
    want = []
    for param in m.group(1).split(","):
        param = " ".join(param.split())
        if "*" in param:
            want.append(ctypes.c_void_p)
        elif param.startswith("float "):
            want.append(ctypes.c_float)
        else:
            assert param.startswith("int "), param
            want.append(ctypes.c_int)
    assert list(getattr(importlib.import_module(ops), attr)) == want


def test_bit_matched_kernels_build_without_fma_contraction(tmp_path,
                                                           monkeypatch):
    """track_step.cu and assign.cu are compiled with -fmad=false (and no
    source with --use_fast_math), so nvcc cannot fuse a multiply and an
    add that fastmath.cuh left separate; the other kernels keep the
    common flags."""
    cmds = {}

    class FakeNvcc:
        def __init__(self, cmd, **_):
            out = cmd[cmd.index("-o") + 1]
            cmds[cmd[-1].rsplit("/", 1)[-1]] = cmd
            open(out, "w").close()
            self.returncode = 0

        def communicate(self):
            return "", None

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", FakeNvcc)
    _build.build()
    assert set(cmds) == {f"{n}.cu" for n in _build.sources()}
    assert {"assign.cu", "track_step.cu"} <= set(cmds)
    for src, cmd in cmds.items():
        assert "--use_fast_math" not in cmd and "-use_fast_math" not in cmd
        assert ("-fmad=false" in cmd) == (src in ("assign.cu",
                                                  "track_step.cu")), src
        assert "arch=compute_90a,code=sm_90a" in cmd


# ---------------------------------------------------------------------------
# assign: the JV solve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,N", [(1, 1), (3, 4), (2, 9), (4, 16)])
def test_assign_matches_jax(K, N):
    """Costs quantised to 1/64, so f32 potentials are exact and equal-cost
    ties are frequent: the first-index tie-break must agree too."""
    rng = np.random.default_rng(10 * K + N)
    costs = rng.integers(0, 256, (K, N, N)).astype(np.float32) / 64.0
    got = assign_batch(torch.from_numpy(costs)).numpy()
    assert got.dtype == np.int32 and got.shape == (K, N)
    np.testing.assert_array_equal(
        got, np.asarray(_solve_vmapped(jnp.asarray(costs))))
    np.testing.assert_array_equal(
        got, np.asarray(assign_pallas(jnp.asarray(costs), interpret=True)))
    for k in range(K):
        assert sorted(got[k]) == list(range(N))


@pytest.mark.parametrize("levels", [4, 256])
def test_assign_eff_n_restriction(levels):
    """eff_n < N solves exactly the leading square (rows past it report
    column 0), whatever the padding holds; few cost levels give ties."""
    rng = np.random.default_rng(levels)
    N, eff = 16, 6
    costs = rng.integers(0, levels, (3, N, N)).astype(np.float32) / 64.0
    got = assign_batch(torch.from_numpy(costs), eff_n=eff).numpy()
    ref = np.asarray(jax.vmap(lambda c: solve_one(c, eff_n=eff))(
        jnp.asarray(costs)))
    np.testing.assert_array_equal(got, ref)
    for k in range(3):
        np.testing.assert_array_equal(got[k, :eff],
                                      solve_device_np(costs[k, :eff, :eff]))
        np.testing.assert_array_equal(got[k, eff:], 0)


def test_assign_raises_instead_of_looping():
    """Non-finite costs never let the search end: the step cap raises
    rather than return a partial answer or loop for ever."""
    with pytest.raises(RuntimeError, match="did not converge"):
        assign_batch(torch.full((1, 4, 4), float("nan")))


def test_hungarian_batch_matches_jax():
    """Rectangular problems with forbidden (BIG) pairs, padded to one
    square: the same pairs as the JAX package's hungarian_batch."""
    rng = np.random.default_rng(5)
    mats = []
    for n, m in ((3, 5), (6, 2), (0, 4), (7, 7), (1, 1)):
        c = (rng.integers(0, 64, (n, m)) / 64.0).astype(np.float32)
        c[rng.random((n, m)) < 0.3] = BIG
        mats.append(c)
    got = hungarian_batch(mats, device="cpu")
    assert got == jx_hungarian_batch(mats)
    assert any(got)


# ---------------------------------------------------------------------------
# track_step: the fused tracker step
# ---------------------------------------------------------------------------

def _track_step_operands(rng, K, Q, H, e, M):
    """tests/test_kernels.py's operands: live tracks and valid detections
    as PREFIXES, integer te gaps, boxes in roughly world units."""
    def g(*s):
        return rng.standard_normal(s).astype(np.float32)

    params = {
        "det_proj/w": g(e + 6, e) * 0.5, "det_proj/b": g(e) * 0.1,
        "gru/wz": g(e + H, H) * 0.5, "gru/wr": g(e + H, H) * 0.5,
        "gru/wh": g(e + H, H) * 0.5,
        "gru/bz": g(H) * 0.1, "gru/br": g(H) * 0.1, "gru/bh": g(H) * 0.1,
        "match/w0": g(H + e + 6, M) * 0.5, "match/b0": g(M) * 0.1,
        "match/w1": g(M, 1) * 0.5, "match/b1": g(1) * 0.1,
    }
    h_r = np.zeros((K, Q, H), np.float32)
    tbox_r = np.zeros((K, Q, 4), np.float32)
    alive_r = np.zeros((K, Q), np.float32)
    te_gap_r = np.zeros((K, Q), np.float32)
    te_match = np.zeros((K, Q), np.float32)
    x = np.zeros((K, Q, e), np.float32)
    dbox = np.zeros((K, Q, 4), np.float32)
    dvalid = np.zeros((K, Q), np.float32)
    for k in range(K):
        T = int(rng.integers(0, Q + 1))
        n = int(rng.integers(0, Q + 1))
        h_r[k, :T] = g(T, H) * 0.5
        tbox_r[k, :T] = rng.random((T, 4), np.float32)
        alive_r[k, :T] = 1.0
        te_gap_r[k, :T] = rng.integers(1, 9, T)
        te_match[k] = float(rng.integers(0, 9))
        x[k, :n] = g(n, e) * 0.5
        dbox[k, :n] = rng.random((n, 4), np.float32)
        dvalid[k, :n] = 1.0
    thr = np.full((1, 1), 0.35, np.float32)
    return (h_r, tbox_r, alive_r, te_gap_r, te_match, x, dbox,
            dvalid), thr, params


def _port_step(arrs, thr, np_params):
    out = track_step(*(torch.from_numpy(a) for a in arrs),
                     torch.from_numpy(thr), pack_params(np_params, "cpu"),
                     torch.from_numpy(LOG1P_TABLE_2D))
    return [o.numpy() for o in out]


def _assert_bits(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("K,Q,H,e,M", [(1, 8, 16, 8, 16),
                                       (2, 16, 24, 16, 24),
                                       (3, 8, 20, 12, 20)])
def test_track_step_matches_jax(K, Q, H, e, M):
    """The reference test's shapes: the port's plain version against the
    Pallas kernel in interpret mode and the numpy oracle, bit for bit."""
    rng = np.random.default_rng(1000 * K + Q + H + e)
    arrs, thr, np_params = _track_step_operands(rng, K, Q, H, e, M)
    got = _port_step(arrs, thr, np_params)
    packed = jx_pack(np_params)
    _assert_bits(got, jx_step_ref(*arrs, thr, packed, JX_TABLE))
    _assert_bits(got, track_step_pallas(
        *[jnp.asarray(a) for a in arrs], jnp.asarray(thr), packed,
        JX_TABLE, interpret=True))
    matched, alive, dvalid = got[0], arrs[2], arrs[7]
    for k in range(K):
        cols = matched[k][matched[k] >= 0]
        assert len(set(cols.tolist())) == len(cols)
        assert np.all(dvalid[k][cols] > 0)
        assert np.all(matched[k][alive[k] <= 0] == -1)


@pytest.mark.parametrize("Q", [8, 16])
def test_track_step_full_width_heads(Q):
    """The full-width tracker heads (H 64, e 32, M 64: pairs 102 wide)
    against the numpy oracle."""
    rng = np.random.default_rng(Q)
    arrs, thr, np_params = _track_step_operands(rng, 2, Q, 64, 32, 64)
    _assert_bits(_port_step(arrs, thr, np_params),
                 jx_step_ref(*arrs, thr, jx_pack(np_params), JX_TABLE))


def test_track_step_slot_padding_invariance():
    """The same stream in Q and in 2Q slots: the solve runs on the
    assoc_side square of the live counts, so the first Q rows agree."""
    rng = np.random.default_rng(3)
    Q = 16
    arrs, thr, np_params = _track_step_operands(rng, 1, Q, 16, 8, 16)
    wide = [np.concatenate([a, np.zeros_like(a)], axis=1) for a in arrs]
    wide[4][:] = arrs[4][0, 0]                 # te_match is a broadcast
    small = _port_step(arrs, thr, np_params)
    big = _port_step(wide, thr, np_params)
    _assert_bits([b[:, :Q] for b in big], small)
    assert (small[0] >= 0).any()


# ---------------------------------------------------------------------------
# flash_attention and decode_attention
# ---------------------------------------------------------------------------

ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _attn_close(got, want, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(jnp.asarray(got, jnp.float32))
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got, want, atol=ATTN_TOL[dtype],
                               rtol=ATTN_TOL[dtype])


def _qkv(seed, q_shape, kv_shape, dtype):
    """The same seeded inputs for both packages, rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in (q_shape, kv_shape, kv_shape)]
    jx = [jnp.asarray(a).astype(dtype) for a in arrs]
    pt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, pt


FLASH_CASES = [                  # B, Sq, Skv, Hq, Hkv, D, causal
    (2, 128, 128, 4, 4, 32, True),      # group 1
    (1, 64, 256, 4, 2, 32, True),       # Sq < Skv: queries at the end
    (2, 128, 128, 14, 2, 16, False),    # group 7, non-causal
    (1, 128, 128, 14, 2, 64, True),     # group 7 at qwen2's head dim
    (1, 128, 128, 4, 4, 128, True),     # deepseek-moe-16b's head dim
    (1, 128, 128, 7, 1, 128, True),     # deepseek-coder-33b's group 7
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal", FLASH_CASES)
def test_flash_attention_matches_jax(dtype, B, Sq, Skv, Hq, Hkv, D, causal):
    (jq, jk, jv), (q, k, v) = _qkv(10, (B, Sq, Hq, D), (B, Skv, Hkv, D),
                                   dtype)
    got = flash_attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    _attn_close(got, jx_chunked(jq, jk, jv, causal=causal,
                                sm_scale=1.0 / D ** 0.5, block_k=64), dtype)
    _attn_close(got, flash_attention_pallas(jq, jk, jv, causal=causal,
                                            block_q=64, block_k=64,
                                            interpret=True), dtype)
    _attn_close(got, jx_flash_oracle(jq, jk, jv, causal=causal), dtype)


@pytest.mark.parametrize("Sq,Skv,causal", [(100, 100, True),
                                           (100, 75, False)])
def test_flash_attention_ragged_edge_matches_padding_wrapper(Sq, Skv,
                                                             causal):
    """Lengths that are no block multiple: the reference's wrapper pads
    to 128 and masks with kv_valid; the port masks the edge itself."""
    (jq, jk, jv), (q, k, v) = _qkv(11, (2, Sq, 4, 32), (2, Skv, 2, 32),
                                   "float32")
    got = flash_attention(q, k, v, causal=causal)
    _attn_close(got, jx_flash(jq, jk, jv, causal=causal), "float32")
    _attn_close(got, jx_flash_oracle(jq, jk, jv, causal=causal), "float32")


def test_flash_attention_kv_valid_matches_pallas():
    (jq, jk, jv), (q, k, v) = _qkv(12, (1, 64, 4, 32), (1, 64, 2, 32),
                                   "float32")
    got = flash_attention(q, k, v, causal=False, kv_valid=40)
    _attn_close(got, flash_attention_pallas(jq, jk, jv, causal=False,
                                            block_q=64, block_k=32,
                                            interpret=True, kv_valid=40),
                "float32")
    _attn_close(got, jx_chunked(jq, jk, jv, causal=False, sm_scale=32 ** -.5,
                                block_k=32, kv_valid=40), "float32")


def test_flash_attention_row_with_no_visible_key_is_zero():
    """Causal with Sq > Skv: the first Sq - Skv queries see no key.  The
    port gives 0 there, as the Pallas kernel does on a tile it skips
    (its finalize maps l == 0 to 0); the reference's ``_chunked_jnp``
    averages V over the masked keys instead.  Every other row agrees
    with all three."""
    (jq, jk, jv), (q, k, v) = _qkv(13, (1, 128, 4, 32), (1, 64, 2, 32),
                                   "float32")
    got = flash_attention(q, k, v, causal=True)
    assert not got[:, :64].any()
    _attn_close(got, flash_attention_pallas(jq, jk, jv, causal=True,
                                            block_q=64, block_k=64,
                                            interpret=True), "float32")
    chunked = jx_chunked(jq, jk, jv, causal=True, sm_scale=32 ** -.5,
                         block_k=64)
    _attn_close(got[:, 64:], chunked[:, 64:], "float32")
    mean_v = np.asarray(jv, np.float32).mean(axis=1)          # (1, 2, 32)
    np.testing.assert_allclose(np.asarray(chunked)[0, 0, ::2], mean_v[0],
                               atol=1e-5)


def test_flash_attention_refuses_causal_ragged_unequal_lengths():
    """As the reference's wrapper: causal with Sq != Skv where either is
    no multiple of its block (128, or the length itself below it)."""
    q = torch.zeros((1, 200, 2, 16))
    k = torch.zeros((1, 300, 2, 16))
    with pytest.raises(NotImplementedError):
        flash_attention(q, k, k, causal=True)
    with pytest.raises(NotImplementedError):
        jx_flash(jnp.zeros((1, 200, 2, 16)), jnp.zeros((1, 300, 2, 16)),
                 jnp.zeros((1, 300, 2, 16)), causal=True)
    assert flash_attention(q, k, k, causal=False).shape == q.shape
    short = torch.zeros((1, 100, 2, 16))       # one block of 100
    assert flash_attention(short, k[:, :120], k[:, :120]).shape == \
        short.shape


DECODE_CASES = [                 # B, S, Hq, Hkv, D, block_k (Pallas)
    (3, 128, 4, 4, 32, 64),      # group 1
    (2, 256, 4, 2, 64, 128),     # group 2
    (4, 96, 14, 2, 16, 32),      # group 7
    (2, 128, 4, 4, 128, 64),     # deepseek-moe-16b's head dim
    (2, 128, 6, 1, 128, 64),     # grok-1-314b's group 6 at head dim 128
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,bk", DECODE_CASES)
def test_decode_attention_matches_jax(dtype, B, S, Hq, Hkv, D, bk):
    """kv_len takes 1 and S (and seeded lengths between)."""
    (jq, jk, jv), (q, k, v) = _qkv(14, (B, Hq, D), (B, S, Hkv, D), dtype)
    lens = np.random.default_rng(15).integers(1, S + 1, B).astype(np.int32)
    lens[:2] = (1, S)
    got = decode_attention(q, k, v, torch.from_numpy(lens))
    assert got.dtype == q.dtype and got.shape == q.shape
    jl = jnp.asarray(lens)
    _attn_close(got, jx_decode_fallback(jq, jk, jv, jl,
                                        sm_scale=1.0 / D ** 0.5), dtype)
    _attn_close(got, decode_attention_pallas(jq, jk, jv, jl, block_k=bk,
                                             interpret=True), dtype)


def test_decode_attention_empty_row_is_zero_as_pallas():
    """kv_len 0: the Pallas kernel skips every block and writes 0, and so
    does the port (``_jnp_fallback`` would average V over the cache)."""
    (jq, jk, jv), (q, k, v) = _qkv(16, (2, 4, 16), (2, 64, 2, 16),
                                   "float32")
    lens = np.array([0, 17], np.int32)
    got = decode_attention(q, k, v, torch.from_numpy(lens))
    assert not got[0].any()
    _attn_close(got, decode_attention_pallas(jq, jk, jv, jnp.asarray(lens),
                                             block_k=32, interpret=True),
                "float32")


def test_attention_wrappers_run_plain_versions_on_cpu_tensors():
    before = (flash_attention.launches, decode_attention.launches)
    q, k = torch.ones((1, 8, 2, 16)), torch.ones((1, 8, 1, 16))
    assert torch.equal(flash_attention(q, k, k),
                       flash_attention_ref(q, k, k))
    lens = torch.tensor([5], dtype=torch.int32)
    assert torch.equal(decode_attention(q[:, 0], k, k, lens),
                       decode_attention_ref(q[:, 0], k, k, lens))
    assert (flash_attention.launches, decode_attention.launches) == before
    meta = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError):
        flash_attention(meta, meta[:, :, :1], meta[:, :, :1])
    with pytest.raises(ValueError):
        decode_attention(meta[:, 0], meta[:, :, :1], meta[:, :, :1],
                         torch.empty((1,), device="meta"))
