"""Proxy head over a score map: 1x1 conv + sigmoid + threshold.

``proxy_score(feat, w, b, threshold)`` takes proxy features (B, Hc, Wc,
C) and the head's weights w (C,), b (1,), and returns (scores (B, Hc,
Wc) f32, pos (B, Hc, Wc) int8), where pos is ``score > threshold``,
strictly, with the threshold taken as an f32.  The unfused proxy path
(``ProxyModel.scores`` / ``scores_batch``) brings both back to the host.

On a CUDA tensor it launches ``csrc/proxy_score.cu`` into one buffer
(``out_buffer``: the f32 scores, then the int8 positives) and returns
two views of it, which ``views_to_host`` brings to the host in one
copy; on a CPU tensor it runs ``proxy_score_ref``, the plain PyTorch
version (a copy of the JAX package's ``kernels/proxy_score/ref.py``).
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

FLIP_ULPS = 8   # band around the threshold where a cell may flip
# proxy_score_launch(feat, w, b, threshold, scores, pos, rows, C, stream)
LAUNCH_ARGTYPES = ((ctypes.c_void_p,) * 3 + (ctypes.c_float,)
                   + (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 2
                   + (ctypes.c_void_p,))


def proxy_score_ref(feat: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    threshold: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version.  feat: (B, Hc, Wc, C); w: (C,); b: (1,).

    Returns (scores (B, Hc, Wc) f32 sigmoid, pos (B, Hc, Wc) int8)."""
    logits = torch.einsum("bhwc,c->bhw", feat.float(), w.float()) \
        + b.float().reshape(())
    scores = torch.sigmoid(logits)
    pos = scores > float(np.float32(threshold))
    return scores, pos.to(torch.int8)


def check_scores(feat, w, b, threshold: float, scores, pos,
                 ulps: int = FLIP_ULPS) -> int:
    """Hold (scores, pos) from any implementation of this op — the
    kernel, the plain version, the JAX package's — against exact
    arithmetic on the same inputs.  Each cell's sigmoid is taken in
    float64; a cell within ``ulps`` f32 ulps of the threshold may come
    out either way (its logit is a C-term f32 dot summed in another
    order, and sigmoids differ by an ulp or two); every other cell must
    be positive exactly where the exact sigmoid exceeds the threshold.
    The positives must also be the implementation's own ``scores >
    threshold``.

    Inputs are tensors or arrays on any device.  Returns the number of
    cells inside the band (where implementations may legitimately
    differ); raises AssertionError otherwise."""
    def host(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu()
        return torch.from_numpy(np.array(x))

    f = host(feat).double()
    wv = host(w).double().reshape(-1)
    bv = host(b).double().reshape(-1)[0]
    scores, pos = host(scores), host(pos) != 0
    if scores.shape != pos.shape or scores.shape != f.shape[:-1]:
        raise AssertionError(f"scores {tuple(scores.shape)} / pos "
                             f"{tuple(pos.shape)} do not match features "
                             f"{tuple(f.shape)}")
    thr = np.float32(threshold)
    if not torch.equal(pos, scores.float() > float(thr)):
        raise AssertionError("positives are not the scores' own "
                             f"score > {thr}")
    s = torch.sigmoid(torch.einsum("bhwc,c->bhw", f, wv) + bv)
    band = ulps * float(np.spacing(thr)) if np.isfinite(thr) else 0.0
    near = (s - float(thr)).abs() <= band
    wrong = (pos != (s > float(thr))) & ~near
    if wrong.any():
        b_, y, x = (int(v) for v in wrong.nonzero()[0])
        raise AssertionError(
            f"proxy cell (frame {b_}, y {y}, x {x}) disagrees with exact "
            f"arithmetic beyond {ulps} ulp of threshold {thr}: "
            f"{int(wrong.sum())} such cells")
    return int(near.sum())


def out_buffer(B: int, Hc: int, Wc: int, device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores (B, Hc, Wc) f32, pos (B, Hc, Wc) int8) as views of one
    buffer on ``device``: rows * 4 bytes of scores, then rows bytes of
    positives (the buffer is f32, rounded up to whole words).  Four
    tensor ops, since each costs host time on every per-frame call."""
    rows = B * Hc * Wc
    buf = torch.empty(rows + (rows + 3) // 4, dtype=torch.float32,
                      device=device)
    strides = (Hc * Wc, Wc, 1)
    return (buf.as_strided((B, Hc, Wc), strides),
            buf.view(torch.int8).as_strided((B, Hc, Wc), strides, rows * 4))


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = library("proxy_score")
    fn = lib.proxy_score_launch
    fn.argtypes = list(LAUNCH_ARGTYPES)
    fn.restype = ctypes.c_int
    return lib, fn


def proxy_score(feat: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """feat: (B, Hc, Wc, C) f32 proxy features; w: (C,); b: (1,) head
    weights on the same device; threshold: a host float.

    Returns (scores (B, Hc, Wc) f32, pos (B, Hc, Wc) int8) on feat's
    device; on the card both are views of one buffer (``out_buffer``)."""
    B, Hc, Wc, C = feat.shape
    if not on_cuda(feat):
        return proxy_score_ref(feat, w, b, threshold)
    refuse_grad("proxy_score", feat, w, b)
    for name, t, shape in (("feat", feat, (B, Hc, Wc, C)),
                           ("w", w, (C,)), ("b", b, (1,))):
        if t.device != feat.device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"proxy_score: {name} must be a contiguous "
                             f"f32 tensor of shape {shape} on "
                             f"{feat.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    scores, pos = out_buffer(B, Hc, Wc, feat.device)
    rows = B * Hc * Wc
    if rows == 0:
        return scores, pos
    lib, fn = _launcher()
    with device_guard(feat):
        err = fn(ptr(feat), ptr(w), ptr(b), float(threshold), ptr(scores),
                 ptr(pos), rows, C, stream_of(feat))
    check_launch(err, lib, "proxy_score")
    proxy_score.launches += 1
    return scores, pos


proxy_score.launches = 0
