"""Fused proxy plan: head + threshold + detector-grid mapping + stats.

``proxy_plan(feat, w, b, threshold, grid_hw=(hc, wc))`` fuses the proxy
head (1x1 conv + sigmoid + threshold), the proxy -> detector grid mapping
(a detector cell is positive iff any proxy cell in its source span is)
and the per-frame plan-stat reduction, so only the (B, hc, wc) int8 grid
and a (B, 8) int32 stats row [count, ymin, ymax, xmin, xmax, 0, 0, 0]
leave the op.  An empty frame's row is [0, hc, -1, wc, -1, 0, 0, 0].

On a CUDA tensor it launches ``csrc/proxy_plan.cu``, and the grid and
stats it returns are views of one device buffer, which
``kernels.views_to_host`` brings to the host in one copy; on a CPU tensor it
runs ``proxy_plan_ref``, the plain PyTorch version (a copy of the JAX
package's ``kernels/proxy_plan/ref.py``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import (check_launch, device_guard, on_cuda, ptr,
                                  refuse_grad, stream_of)
from repro_torch.kernels._build import library

STATS_W = 8     # [count, ymin, ymax, xmin, xmax, 0, 0, 0]
_MASK_LIMIT = 7 * 1024      # the kernel's bitmask words (kMaxMasks)
# proxy_plan_launch(feat, w, b, threshold, span_y, span_x, grid, stats,
#                   B, hp, wp, C, hc, wc, stream)
LAUNCH_ARGTYPES = ((ctypes.c_void_p,) * 3 + (ctypes.c_float,)
                   + (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 6
                   + (ctypes.c_void_p,))


@functools.lru_cache(maxsize=None)
def span_matrix(n_dst: int, n_src: int) -> np.ndarray:
    """(n_dst, n_src) 0/1 f32: row i covers destination cell i's source
    span [ys_i, ye_i) (max-pool semantics, possibly overlapping)."""
    idx = np.arange(n_dst)
    ys = np.minimum((idx * n_src) // n_dst, n_src - 1)
    ye = np.minimum(((idx + 1) * n_src + n_src - 1) // n_dst, n_src)
    ye = np.maximum(ye, ys + 1)
    src = np.arange(n_src)
    return ((src[None, :] >= ys[:, None])
            & (src[None, :] < ye[:, None])).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _spans_on(device: torch.device, hc: int, hp: int, wc: int, wp: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.from_numpy(span_matrix(hc, hp)).to(device),
            torch.from_numpy(span_matrix(wc, wp)).to(device))


def _map(pos: torch.Tensor, span_y: torch.Tensor, span_x: torch.Tensor
         ) -> torch.Tensor:
    """(B, hp, wp) 0/1 f32 -> (B, hc, wc) bool: any positive in span."""
    cnt = torch.einsum("yh,bhw->byw", span_y, pos)
    cnt = torch.einsum("byw,xw->byx", cnt, span_x)
    return cnt > 0.5


def proxy_plan_ref(feat: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   threshold: float, span_y: torch.Tensor,
                   span_x: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version.  feat: (B, hp, wp, C); w: (C,); b: (1,);
    span_y: (hc, hp) f32 0/1; span_x: (wc, wp) f32 0/1.

    Returns (mapped (B, hc, wc) int8, stats (B, STATS_W) int32)."""
    logits = torch.einsum("bhwc,c->bhw", feat.float(), w.float()) + b
    pos = (torch.sigmoid(logits) > threshold).float()
    mapped = _map(pos, span_y, span_x)
    return mapped.to(torch.int8), plan_stats(mapped)


def plan_stats(mapped: torch.Tensor) -> torch.Tensor:
    """(B, hc, wc) grid -> (B, STATS_W) int32 rows [count, ymin, ymax,
    xmin, xmax, 0, 0, 0]; an empty frame gives [0, hc, -1, wc, -1, ...]."""
    mapped = mapped != 0
    hc, wc = mapped.shape[1], mapped.shape[2]
    dev = mapped.device
    yi = torch.arange(hc, dtype=torch.int32, device=dev)
    xi = torch.arange(wc, dtype=torch.int32, device=dev)
    rows_any = mapped.any(dim=2)
    cols_any = mapped.any(dim=1)
    count = mapped.sum(dim=(1, 2)).to(torch.int32)
    ymin = torch.where(rows_any, yi, hc).min(dim=1).values
    ymax = torch.where(rows_any, yi, -1).max(dim=1).values
    xmin = torch.where(cols_any, xi, wc).min(dim=1).values
    xmax = torch.where(cols_any, xi, -1).max(dim=1).values
    zero = torch.zeros_like(count)
    return torch.stack([count, ymin, ymax, xmin, xmax, zero, zero, zero],
                       dim=1).to(torch.int32)


FLIP_ULPS = 8   # band around the threshold where a cell may flip


def check_plan(feat, w, b, threshold: float, grid, stats,
               ulps: int = FLIP_ULPS) -> int:
    """Hold a plan (grid, stats) from any implementation of this op —
    the kernel, the plain version, the JAX package's — against exact
    arithmetic on the same inputs.  Each proxy cell's sigmoid is taken
    in float64; a cell within ``ulps`` f32 ulps of the threshold may
    come out either way (its logit is a 64-term f32 dot summed in
    another order, and sigmoids differ by an ulp or two); every other
    cell must come out as the exact arithmetic says.  So the grid must
    lie between the maps of (exact positives minus the band) and (exact
    positives plus the band), and the stats must be the grid's own.

    Inputs are tensors or arrays on any device.  Returns the number of
    detector-grid cells inside the band's reach (where implementations
    may legitimately differ); raises AssertionError otherwise."""
    def host(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu()
        return torch.from_numpy(np.array(x))

    f = host(feat).double()
    wv = host(w).double().reshape(-1)
    bv = host(b).double().reshape(-1)[0]
    grid, stats = host(grid), host(stats)
    B, hp, wp, _ = f.shape
    hc, wc = grid.shape[1], grid.shape[2]
    s = torch.sigmoid(torch.einsum("bhwc,c->bhw", f, wv) + bv)
    thr = np.float32(threshold)
    band = ulps * float(np.spacing(thr))
    near = (s - float(thr)).abs() <= band
    pos = s > float(thr)
    sy = torch.from_numpy(span_matrix(hc, hp)).double()
    sx = torch.from_numpy(span_matrix(wc, wp)).double()
    lo = _map((pos & ~near).double(), sy, sx)
    hi = _map((pos | near).double(), sy, sx)
    g = grid != 0
    outside = (g & ~hi) | (~g & lo)
    if outside.any():
        b_, y, x = (int(v) for v in outside.nonzero()[0])
        raise AssertionError(
            f"plan cell (frame {b_}, y {y}, x {x}) disagrees with exact "
            f"arithmetic beyond {ulps} ulp of threshold {thr}: "
            f"{int(outside.sum())} such cells")
    if not torch.equal(stats.to(torch.int32), plan_stats(g)):
        bad = (stats.to(torch.int32) != plan_stats(g)).any(1).nonzero()
        raise AssertionError(f"plan stats disagree with the grid in "
                             f"frames {bad.flatten().tolist()}")
    return int((lo != hi).sum())


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = library("proxy_plan")
    fn = lib.proxy_plan_launch
    fn.argtypes = list(LAUNCH_ARGTYPES)
    fn.restype = ctypes.c_int
    return lib, fn


@functools.lru_cache(maxsize=None)
def _layout(B: int, hp: int, wp: int, hc: int, wc: int) -> int:
    """Byte offset of the stats in the output buffer (the grid's bytes
    rounded up to 16); raises for a grid whose bitmasks (words of 32
    bits: ``mask_bytes`` in ``csrc/proxy_plan.cu``) exceed the kernel's
    shared memory."""
    nwx, nwy = -(-wp // 32), -(-hp // 32)
    if (hp * nwx + hc * nwy + wc * nwx + hc * nwx) * 4 > _MASK_LIMIT:
        raise ValueError(f"proxy_plan: grid ({hp}, {wp}) -> ({hc}, {wc}) "
                         "needs more shared memory than one block has")
    return -(-B * hc * wc // 16) * 16


def proxy_plan(feat: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               threshold: float, *, grid_hw: Tuple[int, int]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """feat: (B, hp, wp, C) f32 proxy features; w: (C,); b: (1,) head
    weights on the same device; grid_hw: (hc, wc) detector grid.

    Returns (mapped (B, hc, wc) int8, stats (B, 8) int32) on feat's
    device."""
    hc, wc = (int(v) for v in grid_hw)
    B, hp, wp, C = feat.shape
    if not on_cuda(feat):
        sy, sx = _spans_on(feat.device, hc, hp, wc, wp)
        return proxy_plan_ref(feat, w, b, threshold, sy, sx)
    refuse_grad("proxy_plan", feat, w, b)
    dev = feat.get_device()
    for name, t, shape in (("feat", feat, (B, hp, wp, C)),
                           ("w", w, (C,)), ("b", b, (1,))):
        if t.get_device() != dev or t.dtype != torch.float32 \
                or t.shape != shape or not t.is_contiguous():
            raise ValueError(f"proxy_plan: {name} must be a contiguous "
                             f"f32 tensor of shape {shape} on "
                             f"{feat.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    off = _layout(B, hp, wp, hc, wc)
    buf = feat.new_empty(off + B * STATS_W * 4, dtype=torch.int8)
    grid = buf[:B * hc * wc].view(B, hc, wc)
    stats = buf[off:].view(torch.int32).view(B, STATS_W)
    if B == 0:
        return grid, stats
    lib, fn = _launcher()
    sy, sx = _spans_on(feat.device, hc, hp, wc, wp)
    with device_guard(feat):
        err = fn(ptr(feat), ptr(w), ptr(b), float(threshold), ptr(sy),
                 ptr(sx), ptr(grid), ptr(stats), B, hp, wp, C, hc, wc,
                 stream_of(feat))
    check_launch(err, lib, "proxy_plan")
    proxy_plan.launches += 1
    return grid, stats


proxy_plan.launches = 0
