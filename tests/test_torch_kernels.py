"""The port's kernels against the JAX package's, on the CPU.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs its Pallas kernels in interpret mode (as tests/test_kernels.py
does) and its jnp oracles.  Inputs come from seeded numpy.

proxy_plan: every implementation's plan is held against float64
arithmetic with ``check_plan`` — cells whose sigmoid lies within
``FLIP_ULPS`` f32 ulps of the threshold may flip, nothing else may —
and outside that band the port's grids and stats equal the JAX ones.
window_gather_batch: a pure copy, so exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.proxy_plan.kernel import proxy_plan_pallas  # noqa: E402
from repro.kernels.proxy_plan.ops import span_matrix as jx_span  # noqa: E402
from repro.kernels.proxy_plan.ref import proxy_plan_ref as jx_plan  # noqa: E402
from repro.kernels.window_gather.kernel import (  # noqa: E402
    window_gather_batch_pallas)
from repro.kernels.window_gather.ref import (  # noqa: E402
    window_gather_batch_ref as jx_gather)
from repro_torch.kernels.proxy_plan import (  # noqa: E402
    proxy_plan, span_matrix)
from repro_torch.kernels.proxy_plan.ops import check_plan  # noqa: E402
from repro_torch.kernels.window_gather import (  # noqa: E402
    window_gather_batch)

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


def test_wrappers_run_plain_version_on_cpu_tensors():
    """A CPU tensor takes the plain version: no launch is counted."""
    before = (proxy_plan.launches, window_gather_batch.launches)
    proxy_plan(torch.ones(1, 2, 2, 4), torch.ones(4), torch.zeros(1), 0.5,
               grid_hw=(2, 2))
    window_gather_batch(torch.ones(1, 32, 32, 3),
                        np.zeros((1, 3), np.int32), win_h=16, win_w=16,
                        cell=16)
    assert (proxy_plan.launches, window_gather_batch.launches) == before


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


@pytest.mark.parametrize("src,fn,ops", [
    ("proxy_plan.cu", "proxy_plan_launch",
     "repro_torch.kernels.proxy_plan.ops"),
    ("window_gather.cu", "window_gather_batch_launch",
     "repro_torch.kernels.window_gather.ops"),
])
def test_ctypes_signature_matches_c_source(src, fn, ops):
    """The ctypes argtypes each wrapper declares match the C launcher's
    parameter list (a mismatch only shows on the card otherwise)."""
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
    assert list(importlib.import_module(ops).LAUNCH_ARGTYPES) == want
