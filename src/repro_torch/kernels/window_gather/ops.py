"""Cross-frame window gather.

``window_gather_batch(frames, table, win_h=, win_w=, cell=)`` crops n
windows of (win_h, win_w) px from a chunk of frames (B, H, W, C) by an
(n, 3) int32 table of (frame, cy, cx) rows in cell units, and returns
(n, win_h, win_w, C).  Rows are clamped into the chunk exactly as the
JAX package's oracle clamps them, so the executor's zero padding rows
crop frame 0 at cell (0, 0).

On a CUDA tensor it launches ``csrc/window_gather.cu``; on a CPU tensor
it runs ``window_gather_batch_ref``, the plain PyTorch version (indexing).
Both are pure copies, so they agree exactly.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Union

import numpy as np
import torch

from repro_torch.kernels import check_launch, on_cuda, ptr, stream_of
from repro_torch.kernels._build import library

_MAX_WINDOWS = 65535        # the launch's grid.y limit
# window_gather_batch_launch(frames, table, out, n, B, H, W, C, win_h,
#                            win_w, cell, vec4, stream)
LAUNCH_ARGTYPES = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 9
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


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = library("window_gather")
    fn = lib.window_gather_batch_launch
    fn.argtypes = list(LAUNCH_ARGTYPES)
    fn.restype = ctypes.c_int
    return lib, fn


def window_gather_batch(frames: torch.Tensor,
                        table: Union[np.ndarray, torch.Tensor], *,
                        win_h: int, win_w: int, cell: int) -> torch.Tensor:
    """frames: (B, H, W, C) f32 with H, W multiples of ``cell``; table:
    (n, 3) int32 (frame, cy, cx) rows in cell units, host or device.
    Returns (n, win_h, win_w, C) on frames' device."""
    B, H, W, C = frames.shape
    if H % cell or W % cell or win_h % cell or win_w % cell \
            or not (0 < win_h <= H and 0 < win_w <= W):
        raise ValueError(f"window_gather_batch: window ({win_h}, {win_w}) "
                         f"and frame ({H}, {W}) must be multiples of cell "
                         f"{cell}, the window inside the frame")
    table = torch.as_tensor(table, dtype=torch.int32)
    if table.ndim != 2 or table.shape[1] != 3:
        raise ValueError(f"window_gather_batch: table must be (n, 3), got "
                         f"{tuple(table.shape)}")
    if not on_cuda(frames):
        return window_gather_batch_ref(frames, table, win_h=win_h,
                                       win_w=win_w, cell=cell)
    n = int(table.shape[0])
    if frames.dtype != torch.float32 or not frames.is_contiguous():
        raise ValueError("window_gather_batch: frames must be a contiguous "
                         f"f32 tensor, got {frames.dtype}")
    if n > _MAX_WINDOWS:
        raise ValueError(f"window_gather_batch: {n} windows > "
                         f"{_MAX_WINDOWS} per call")
    table = table.to(frames.device).contiguous()
    out = torch.empty((n, win_h, win_w, C), dtype=frames.dtype,
                      device=frames.device)
    if n == 0:
        return out
    vec4 = int((W * C) % 4 == 0 and (win_w * C) % 4 == 0
               and (cell * C) % 4 == 0 and frames.data_ptr() % 16 == 0
               and out.data_ptr() % 16 == 0)
    lib, fn = _launcher()
    with torch.cuda.device(frames.device):
        err = fn(ptr(frames), ptr(table), ptr(out), n, B, H, W, C, win_h,
                 win_w, cell, vec4, stream_of(frames))
    check_launch(err, lib, "window_gather_batch")
    window_gather_batch.launches += 1
    return out


window_gather_batch.launches = 0
