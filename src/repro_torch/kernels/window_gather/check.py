"""The ``window_gather_batch`` kernel against its plain version on the
card: the cases, the operands and the rule, one copy for
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.

Rule: bit for bit (a gather is a pure copy), and every zero padding row
of a table crops frame 0 at cell (0, 0).

The cases (``(name, (B, H, W, C), (wc, hc) window in cells, kind)``,
cells of 16 px) at the main path's chunk (16 frames of 960 x 544, C 3):
the first chunk's plan (``chip_smoke.py`` passes its table; here four
seeded windows of (15, 9), the main path's smallest call), on the host
as the executor passes it (so the launch carries its rows); a seeded
table of 5 windows padded with zero rows to a bucket of 8, one row out
of range (both versions clamp it into the chunk), for each sub-frame
size; 8 windows of (30, 17), the main path's largest call (12.5 MB
out); and rows that are not 16-byte aligned (frames 4 bytes past an
aligned address), which take the kernel's scalar branch.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.window_gather.ops import (window_gather_batch,
                                                   window_gather_batch_ref)

SEED = 0
CELL = 16
CHUNK = (16, 544, 960, 3)           # (B, H, W, C)
CASES = (("first chunk's plan", CHUNK, (15, 9), "plan"),
         ("seeded padded table (15, 9)", CHUNK, (15, 9), "padded"),
         ("seeded padded table (30, 17)", CHUNK, (30, 17), "padded"),
         ("8 x (30, 17)", CHUNK, (30, 17), "full"),
         ("scalar branch", (2, 64, 48, 3), (1, 2), "unaligned"))
# the kernel's instances (profiler names contain this; the single-frame
# launcher's kernel is window_gather_kernel)
KERNEL_NAMES = ("window_gather_batch_kernel",)
SCALAR_KERNEL = "window_gather_batch_kernel_scalar"


def case_table(case, rng) -> np.ndarray:
    """The (n, 3) int32 (frame, cy, cx) table of one of ``CASES``."""
    _, (B, H, W, _), (wc, hc), kind = case
    n = {"plan": 4, "padded": 5, "full": 8, "unaligned": 2}[kind]
    tbl = np.zeros((8 if kind == "padded" else n, 3), np.int32)
    tbl[:n] = np.stack([rng.integers(0, B, n),
                        rng.integers(0, H // CELL - hc + 1, n),
                        rng.integers(0, W // CELL - wc + 1, n)], 1)
    if kind == "padded":
        tbl[4] = (B + 3, 99, 99)
    return tbl


def case_operands(case, device, seed: int = SEED,
                  frames: Optional[torch.Tensor] = None,
                  table: Optional[np.ndarray] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """(frames, table, win_h, win_w) of one of ``CASES``: N(0, 1) frames
    on ``device`` drawn from ``seed`` (or ``frames``, of the case's
    shape), the seeded table (or ``table``), on the host for the plan's
    case and on ``device`` for the others.  The scalar case's frames
    start one float past an allocation, so no row is 16-byte aligned."""
    _, shape, (wc, hc), kind = case
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if frames is None:
        n = int(np.prod(shape))
        if kind == "unaligned":
            frames = torch.randn(n + 1, generator=gen,
                                 device=device)[1:].view(shape)
        else:
            frames = torch.randn(shape, generator=gen, device=device)
    if tuple(frames.shape) != shape:
        raise ValueError(f"window_gather {case[0]}: frames "
                         f"{tuple(frames.shape)}, want {shape}")
    if table is None:
        table = case_table(case, np.random.default_rng(seed))
    table = torch.from_numpy(np.ascontiguousarray(table, np.int32))
    return (frames, table if kind == "plan" else table.to(device),
            hc * CELL, wc * CELL)


def check_case(case, device, seed: int = SEED,
               frames: Optional[torch.Tensor] = None,
               table: Optional[np.ndarray] = None) -> dict:
    """One launch of the kernel on one of ``CASES`` against the plain
    version on the same tensors, bit for bit; raises AssertionError
    otherwise.  -> the record: name, n, window, output bytes,
    max_abs_err, and the operands on the card."""
    name = case[0]
    ops = case_operands(case, device, seed, frames, table)
    frames, tbl, win_h, win_w = ops
    before = window_gather_batch.launches
    got = window_gather_batch(frames, tbl, win_h=win_h, win_w=win_w,
                              cell=CELL)
    want = window_gather_batch_ref(frames, tbl, win_h=win_h, win_w=win_w,
                                   cell=CELL)
    torch.cuda.synchronize()
    if window_gather_batch.launches != before + 1:
        raise AssertionError(f"window_gather_batch {name}: "
                             f"{window_gather_batch.launches - before} "
                             "launches")
    if got.shape != want.shape or not torch.equal(got, want):
        bad = (got != want).any(dim=(1, 2, 3)).nonzero().flatten()
        raise AssertionError(f"window_gather_batch {name}: kernel != plain "
                             f"version in windows {bad.tolist()}")
    for k in (tbl.cpu() == 0).all(dim=1).nonzero().flatten().tolist():
        if not torch.equal(got[k], frames[0, :win_h, :win_w]):
            raise AssertionError(f"window_gather_batch {name}: padding row "
                                 f"{k} is not frame 0 at cell (0, 0)")
    return dict(case=name, n=int(tbl.shape[0]), win=(win_h, win_w),
                out_bytes=got.numel() * got.element_size(),
                max_abs_err=float((got - want).abs().max()), operands=ops)


def kernels_launched(ops: tuple, seconds: float = 0.05) -> set:
    """The names of the kernel instances that the profiler's trace of
    ``seconds`` of calls on ``ops`` (``case_operands``) holds (a trace
    late in a long process can miss the launches of its first
    milliseconds)."""
    from torch.profiler import ProfilerActivity, profile
    frames, tbl, win_h, win_w = ops
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            window_gather_batch(frames, tbl, win_h=win_h, win_w=win_w,
                                cell=CELL)
        torch.cuda.synchronize()
    return {ev.key for ev in prof.key_averages()
            if any(n in ev.key for n in KERNEL_NAMES)}
