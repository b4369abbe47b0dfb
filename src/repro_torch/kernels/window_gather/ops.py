"""Window gathers, cross-frame and single-frame.

``window_gather_batch(frames, table, win_h=, win_w=, cell=)`` crops n
windows of (win_h, win_w) px from a chunk of frames (B, H, W, C) by an
(n, 3) int32 table of (frame, cy, cx) rows in cell units, and returns
(n, win_h, win_w, C).  Rows are clamped into the chunk exactly as the
JAX package's oracle clamps them, so the executor's zero padding rows
crop frame 0 at cell (0, 0).

``window_gather(frame, cell_origins, win_h=, win_w=, cell=)`` is the
per-frame path's op: n windows from ONE frame (H, W, C) by an (n, 2)
int32 table of (cy, cx) rows, clamped the same way (``dynamic_slice``
semantics), so ``detect_with_windows``' zero padding rows crop cell
(0, 0).

On a CUDA tensor each launches the one kernel body of
``csrc/window_gather.cu`` (``window_gather_batch_launch`` and
``window_gather_launch`` for a table on the card;
``window_gather_batch_rows_launch`` and ``window_gather_rows_launch``
for a table of at most ``MAX_PARAM_ROWS`` rows on the host, whose rows
the launch carries as a kernel parameter, so no copy of the table goes
to the card); on a CPU tensor it runs its plain PyTorch version
(``window_gather_batch_ref``, ``window_gather_ref``: indexing).  All
are pure copies, so they agree exactly.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Union

import numpy as np
import torch

from repro_torch.kernels import (check_launch, device_guard, on_cuda, ptr,
                                  refuse_grad, stream_of)
from repro_torch.kernels._build import library

_MAX_WINDOWS = 65535        # the launch's grid.y limit
MAX_PARAM_ROWS = 16         # kMaxRows: a host table the launch carries
# window_gather_batch_launch and window_gather_batch_rows_launch(frames,
#     table, out, n, B, H, W, C, win_h, win_w, cell, vec4, stream)
LAUNCH_ARGTYPES = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 9
                   + (ctypes.c_void_p,))
# window_gather_launch and window_gather_rows_launch(frame, origins, out,
#     n, H, W, C, win_h, win_w, cell, vec4, stream)
LAUNCH_ARGTYPES_SINGLE = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 8
                          + (ctypes.c_void_p,))


def window_gather_batch_ref(frames: torch.Tensor, table: torch.Tensor, *,
                            win_h: int, win_w: int, cell: int
                            ) -> torch.Tensor:
    """Plain version.  frames: (B, H, W, C); table: (n, 3) int rows
    (frame, cy, cx) in cell units -> (n, win_h, win_w, C)."""
    B, H, W, _ = frames.shape
    t = table.to(device=frames.device, dtype=torch.int64)
    b = t[:, 0].clamp(0, B - 1)
    y = (t[:, 1] * cell).clamp(0, H - win_h)
    x = (t[:, 2] * cell).clamp(0, W - win_w)
    ys = y[:, None] + torch.arange(win_h, device=frames.device)
    xs = x[:, None] + torch.arange(win_w, device=frames.device)
    return frames[b[:, None, None], ys[:, :, None], xs[:, None, :]]


def window_gather_ref(frame: torch.Tensor, cell_origins: torch.Tensor, *,
                      win_h: int, win_w: int, cell: int) -> torch.Tensor:
    """Plain version.  frame: (H, W, C); cell_origins: (n, 2) int rows
    (cy, cx) in cell units -> (n, win_h, win_w, C)."""
    H, W, _ = frame.shape
    t = cell_origins.to(device=frame.device, dtype=torch.int64)
    y = (t[:, 0] * cell).clamp(0, H - win_h)
    x = (t[:, 1] * cell).clamp(0, W - win_w)
    ys = y[:, None] + torch.arange(win_h, device=frame.device)
    xs = x[:, None] + torch.arange(win_w, device=frame.device)
    return frame[ys[:, :, None], xs[:, None, :]]


@functools.lru_cache(maxsize=None)
def _launcher(symbol: str, argtypes: tuple):
    lib = library("window_gather")
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return lib, fn


def _check_window(op: str, H: int, W: int, win_h: int, win_w: int,
                  cell: int) -> None:
    if H % cell or W % cell or win_h % cell or win_w % cell \
            or not (0 < win_h <= H and 0 < win_w <= W):
        raise ValueError(f"{op}: window ({win_h}, {win_w}) and frame "
                         f"({H}, {W}) must be multiples of cell {cell}, "
                         "the window inside the frame")


def _vec4(src: torch.Tensor, out: torch.Tensor, W: int, C: int,
          win_w: int, cell: int) -> int:
    """1 when every window row starts and ends on 16 bytes, so the
    kernel copies float4s."""
    return int((W * C) % 4 == 0 and (win_w * C) % 4 == 0
               and (cell * C) % 4 == 0 and src.data_ptr() % 16 == 0
               and out.data_ptr() % 16 == 0)


def window_gather_batch(frames: torch.Tensor,
                        table: Union[np.ndarray, torch.Tensor], *,
                        win_h: int, win_w: int, cell: int) -> torch.Tensor:
    """frames: (B, H, W, C) f32 with H, W multiples of ``cell``; table:
    (n, 3) int32 (frame, cy, cx) rows in cell units, host or device (a
    host table of at most ``MAX_PARAM_ROWS`` rows goes to the card
    inside the launch).  Returns (n, win_h, win_w, C) on frames'
    device."""
    B, H, W, C = frames.shape
    _check_window("window_gather_batch", H, W, win_h, win_w, cell)
    table = torch.as_tensor(table, dtype=torch.int32)
    if table.ndim != 2 or table.shape[1] != 3:
        raise ValueError(f"window_gather_batch: table must be (n, 3), got "
                         f"{tuple(table.shape)}")
    if not on_cuda(frames):
        return window_gather_batch_ref(frames, table, win_h=win_h,
                                       win_w=win_w, cell=cell)
    refuse_grad("window_gather_batch", frames)
    n = int(table.shape[0])
    if frames.dtype != torch.float32 or not frames.is_contiguous():
        raise ValueError("window_gather_batch: frames must be a contiguous "
                         f"f32 tensor, got {frames.dtype}")
    if n > _MAX_WINDOWS:
        raise ValueError(f"window_gather_batch: {n} windows > "
                         f"{_MAX_WINDOWS} per call")
    if table.is_cuda or n > MAX_PARAM_ROWS:
        table = table.to(frames.device).contiguous()
        symbol = "window_gather_batch_launch"
    else:
        table = table.contiguous()
        symbol = "window_gather_batch_rows_launch"
    out = torch.empty((n, win_h, win_w, C), dtype=frames.dtype,
                      device=frames.device)
    if n == 0:
        return out
    vec4 = _vec4(frames, out, W, C, win_w, cell)
    lib, fn = _launcher(symbol, LAUNCH_ARGTYPES)
    with device_guard(frames):
        err = fn(ptr(frames), ptr(table), ptr(out), n, B, H, W, C, win_h,
                 win_w, cell, vec4, stream_of(frames))
    check_launch(err, lib, "window_gather_batch")
    window_gather_batch.launches += 1
    return out


window_gather_batch.launches = 0


def window_gather(frame: torch.Tensor,
                  cell_origins: Union[np.ndarray, torch.Tensor], *,
                  win_h: int, win_w: int, cell: int) -> torch.Tensor:
    """frame: (H, W, C) f32 with H, W multiples of ``cell``;
    cell_origins: (n, 2) int32 (cy, cx) rows in cell units, host or
    device (a host table of at most ``MAX_PARAM_ROWS`` rows goes to the
    card inside the launch).  Returns (n, win_h, win_w, C) on frame's
    device."""
    H, W, C = frame.shape
    _check_window("window_gather", H, W, win_h, win_w, cell)
    origins = torch.as_tensor(cell_origins, dtype=torch.int32)
    if origins.ndim != 2 or origins.shape[1] != 2:
        raise ValueError(f"window_gather: cell_origins must be (n, 2), "
                         f"got {tuple(origins.shape)}")
    if not on_cuda(frame):
        return window_gather_ref(frame, origins, win_h=win_h, win_w=win_w,
                                 cell=cell)
    refuse_grad("window_gather", frame)
    n = int(origins.shape[0])
    if frame.dtype != torch.float32 or not frame.is_contiguous():
        raise ValueError("window_gather: frame must be a contiguous f32 "
                         f"tensor, got {frame.dtype}")
    if n > _MAX_WINDOWS:
        raise ValueError(f"window_gather: {n} windows > {_MAX_WINDOWS} "
                         "per call")
    if origins.is_cuda or n > MAX_PARAM_ROWS:
        origins = origins.to(frame.device).contiguous()
        symbol = "window_gather_launch"
    else:
        origins = origins.contiguous()
        symbol = "window_gather_rows_launch"
    out = torch.empty((n, win_h, win_w, C), dtype=frame.dtype,
                      device=frame.device)
    if n == 0:
        return out
    vec4 = _vec4(frame, out, W, C, win_w, cell)
    lib, fn = _launcher(symbol, LAUNCH_ARGTYPES_SINGLE)
    with device_guard(frame):
        err = fn(ptr(frame), ptr(origins), ptr(out), n, H, W, C, win_h,
                 win_w, cell, vec4, stream_of(frame))
    check_launch(err, lib, "window_gather")
    window_gather.launches += 1
    return out


window_gather.launches = 0
