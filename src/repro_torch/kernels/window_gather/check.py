"""The window gathers against their plain versions on the card: the
cases, the operands and the rule, one copy for ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.  ``CASES`` / ``check_case`` hold
``window_gather_batch``, ``SINGLE_CASES`` / ``check_single_case`` the
single-frame ``window_gather``.

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

The single-frame cases (``(name, (H, W, C), (wc, hc), kind, where)``)
at the per-frame engine's frame (960 x 544, C 3): for each sub-frame
size, a table of 8 rows (6 seeded windows, one at the far edge, one
zero padding row), once on the host, as the engine passes it (at most
``MAX_PARAM_ROWS`` rows: the launch carries them), and once on the
card; a host table of 20 rows (18 seeded, the far edge, one zero row),
which goes to the card as a device table; and rows that are not
16-byte aligned (the frame one float past an aligned address), with
either table, which take the scalar kernel.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.window_gather.ops import (MAX_PARAM_ROWS,
                                                   window_gather,
                                                   window_gather_batch,
                                                   window_gather_batch_ref,
                                                   window_gather_ref)

SEED = 0
CELL = 16
CHUNK = (16, 544, 960, 3)           # (B, H, W, C)
CASES = (("first chunk's plan", CHUNK, (15, 9), "plan"),
         ("seeded padded table (15, 9)", CHUNK, (15, 9), "padded"),
         ("seeded padded table (30, 17)", CHUNK, (30, 17), "padded"),
         ("8 x (30, 17)", CHUNK, (30, 17), "full"),
         ("scalar branch", (2, 64, 48, 3), (1, 2), "unaligned"))
# the kernel's instances (profiler names contain this; float4 or scalar,
# each over a table type)
KERNEL_NAMES = ("window_gather_batch_kernel",)
SCALAR_KERNEL = "window_gather_batch_kernel_scalar"

FRAME = (544, 960, 3)               # (H, W, C): the per-frame engine's
SINGLE_CASES = (
    ("(15, 9), host table", FRAME, (15, 9), "padded", "host"),
    ("(15, 9), device table", FRAME, (15, 9), "padded", "device"),
    ("(30, 17), host table", FRAME, (30, 17), "padded", "host"),
    ("(30, 17), device table", FRAME, (30, 17), "padded", "device"),
    ("20-row host table", FRAME, (15, 9), "long", "host"),
    ("scalar branch, host table", (64, 48, 3), (1, 2), "unaligned", "host"),
    ("scalar branch, device table", (64, 48, 3), (1, 2), "unaligned",
     "device"))
# the single-frame op runs the batch kernel's body over a (cy, cx)
# table: the table's type names the instance, rows carried by the launch
# (FrameRows) or read from device memory (FrameTable)
SINGLE_KERNEL_NAMES = KERNEL_NAMES
ROWS_TABLE = "FrameRows"
DEVICE_TABLE = "FrameTable"


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


def single_rows(case) -> int:
    """The table rows of one of ``SINGLE_CASES``."""
    return 20 if case[3] == "long" else 8


def single_case_table(case, rng) -> np.ndarray:
    """The (n, 2) int32 (cy, cx) table of one of ``SINGLE_CASES``:
    seeded windows, then one at the far edge, then one zero row."""
    _, (H, W, _), (wc, hc), kind, _ = case
    n = single_rows(case)
    tbl = np.zeros((n, 2), np.int32)
    tbl[:n - 2] = np.stack([rng.integers(0, H // CELL - hc + 1, n - 2),
                            rng.integers(0, W // CELL - wc + 1, n - 2)], 1)
    tbl[n - 2] = (H // CELL - hc, W // CELL - wc)
    return tbl


def single_operands(case, device, seed: int = SEED,
                    frame: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, object, int, int]:
    """(frame, table, win_h, win_w) of one of ``SINGLE_CASES``: an N(0, 1)
    frame on ``device`` drawn from ``seed`` (or ``frame``, of the case's
    shape; the scalar cases' frame starts one float past an allocation),
    the seeded table as a host numpy array (as the per-frame engine
    passes it) or an int32 tensor on ``device``."""
    _, shape, (wc, hc), kind, where = case
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if frame is None:
        n = int(np.prod(shape))
        if kind == "unaligned":
            frame = torch.randn(n + 1, generator=gen,
                                device=device)[1:].view(shape)
        else:
            frame = torch.randn(shape, generator=gen, device=device)
    if tuple(frame.shape) != shape:
        raise ValueError(f"window_gather {case[0]}: frame "
                         f"{tuple(frame.shape)}, want {shape}")
    table = single_case_table(case, np.random.default_rng(seed))
    if where == "device":
        table = torch.from_numpy(table).to(device)
    return frame, table, hc * CELL, wc * CELL


def single_branch(case) -> Tuple[bool, bool]:
    """(scalar kernel, table rows carried by the launch) that one of
    ``SINGLE_CASES`` must take."""
    _, _, _, kind, where = case
    return kind == "unaligned", where == "host" \
        and single_rows(case) <= MAX_PARAM_ROWS


def touched_bytes(shape, table, win_h: int, win_w: int,
                  cell: int = CELL) -> int:
    """Bytes of the distinct f32 pixels of an (H, W, C) frame that the
    (n, 2) (cy, cx) table's windows cover, each counted once however
    many windows overlap it (clamped as the gather clamps)."""
    H, W, C = shape
    covered = np.zeros((H, W), bool)
    for cy, cx in np.asarray(table, np.int64).reshape(-1, 2):
        y = min(max(int(cy) * cell, 0), H - win_h)
        x = min(max(int(cx) * cell, 0), W - win_w)
        covered[y:y + win_h, x:x + win_w] = True
    return int(covered.sum()) * C * 4


def check_single_case(case, device, seed: int = SEED,
                      frame: Optional[torch.Tensor] = None) -> dict:
    """One launch of the single-frame kernel on one of ``SINGLE_CASES``
    against the plain version on the same frame and table, bit for bit;
    every zero row must crop cell (0, 0).  Raises AssertionError
    otherwise.  -> the record: name, n, window, output bytes, the bytes
    the bound counts (distinct pixels read, output written, a device
    table read), max_abs_err, and the operands."""
    name = case[0]
    ops = single_operands(case, device, seed, frame)
    frame, tbl, win_h, win_w = ops
    host_tbl = tbl.cpu().numpy() if isinstance(tbl, torch.Tensor) else tbl
    before = window_gather.launches
    got = window_gather(frame, tbl, win_h=win_h, win_w=win_w, cell=CELL)
    want = window_gather_ref(frame, torch.as_tensor(tbl), win_h=win_h,
                             win_w=win_w, cell=CELL)
    torch.cuda.synchronize()
    if window_gather.launches != before + 1:
        raise AssertionError(f"window_gather {name}: "
                             f"{window_gather.launches - before} launches")
    if got.shape != want.shape or not torch.equal(got, want):
        bad = (got != want).any(dim=(1, 2, 3)).nonzero().flatten()
        raise AssertionError(f"window_gather {name}: kernel != plain "
                             f"version in windows {bad.tolist()}")
    for k in np.flatnonzero((host_tbl == 0).all(axis=1)).tolist():
        if not torch.equal(got[k], frame[:win_h, :win_w]):
            raise AssertionError(f"window_gather {name}: padding row {k} "
                                 "is not cell (0, 0)")
    out_bytes = got.numel() * got.element_size()
    on_card = isinstance(tbl, torch.Tensor) or len(host_tbl) > MAX_PARAM_ROWS
    return dict(case=name, n=len(host_tbl), win=(win_h, win_w),
                out_bytes=out_bytes,
                bound_bytes=touched_bytes(tuple(frame.shape), host_tbl,
                                          win_h, win_w) + out_bytes
                + (host_tbl.nbytes if on_card else 0),
                max_abs_err=float((got - want).abs().max()), operands=ops)


def single_kernels_launched(ops: tuple, seconds: float = 0.05) -> set:
    """The names of the gather kernels and of the host-to-device copies
    that the profiler's trace of ``seconds`` of single-frame calls on
    ``ops`` (``single_operands``) holds."""
    from torch.profiler import ProfilerActivity, profile
    frame, tbl, win_h, win_w = ops
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            window_gather(frame, tbl, win_h=win_h, win_w=win_w, cell=CELL)
        torch.cuda.synchronize()
    return {ev.key for ev in prof.key_averages()
            if "window_gather" in ev.key or "Memcpy HtoD" in ev.key}
