"""Decode attention: one query token per batch row against its KV cache.

``decode_attention(q, k, v, kv_len, sm_scale=)`` takes q (B, Hq, D), the
cache k, v (B, S, Hkv, D) in f32 or bf16 and kv_len (B,) int32 valid
lengths, and returns (B, Hq, D) in q's dtype, softmax in f32, masking
keys at or past kv_len[b].  The G = Hq / Hkv query heads of a KV head
share its keys (q head h reads KV head h // G).  Every decode step of
the model (``models.attention``) calls it once a layer.

On a CUDA tensor it launches ``csrc/decode_attention.cu``, one launch a
call: a cluster of 16 blocks per (KV head, batch row) splits the keys
and merges its partial softmaxes in distributed shared memory (kv_len
stays on the card, read by the kernel; the grid depends on B and Hkv
only: no synchronisation, and a CUDA graph can capture it).  On a CPU
tensor it runs ``decode_attention_ref``, the plain PyTorch version of
the JAX package's ``_jnp_fallback`` (``kernels/decode_attention/ops.py``):
one masked softmax over the cache.  As in ``flash_attention``, masked
keys weigh exactly 0, so a row with kv_len 0 gives 0 (the Pallas
kernel's answer; ``_jnp_fallback`` averages V over the whole cache
there).  Under autograd (grad mode on and an input that requires grad) a
CUDA call raises NotImplementedError: the kernel has no backward, and
training never decodes.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import (check_launch, device_guard, on_cuda, ptr,
                                  refuse_grad, stream_of)
from repro_torch.kernels._build import library
from repro_torch.kernels.flash_attention.ops import _check_operands

NEG_INF = float(np.finfo(np.float32).min)
MAX_GROUP = 16                   # q heads per KV head the kernel holds
# decode_attention_launch(q, k, v, kv_len, o, B, S, Hq, Hkv, D, sm_scale,
#                         bf16, stream)
LAUNCH_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 5
                   + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p))


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, kv_len: torch.Tensor,
                         sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: scores over the whole cache, masked, softmax in
    f32 (normalised before the product with V, as the reference)."""
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Hkv, G, D) * sm_scale
    s = torch.einsum("bhgd,bshd->bhgs", qf, k.float())
    mask = (torch.arange(S, device=q.device)[None, :]
            < kv_len.to(q.device)[:, None])[:, None, None, :]  # (B,1,1,S)
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l == 0.0, 1.0, l)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return out.reshape(B, Hq, D).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = library("decode_attention")
    fn = lib.decode_attention_launch
    fn.argtypes = list(LAUNCH_ARGTYPES)
    fn.restype = ctypes.c_int
    return lib, fn


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor,
                     sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, D); k, v: (B, S, Hkv, D); kv_len: (B,) int32 on q's
    device -> (B, Hq, D) in q's dtype."""
    B, Hq, D = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != D or Hq % k.shape[2] \
            or tuple(kv_len.shape) != (B,):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, kv_len "
                         f"{tuple(kv_len.shape)}")
    S, Hkv = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if not on_cuda(q):
        return decode_attention_ref(q, k, v, kv_len, sm_scale)
    refuse_grad("decode_attention", q, k, v,
                why="the decode kernel has no backward (decoding serves; "
                "training runs flash_attention)")
    _check_operands("decode_attention", q, k, v)
    if kv_len.device != q.device or kv_len.dtype != torch.int32 \
            or not kv_len.is_contiguous():
        raise ValueError("decode_attention: kv_len must be a contiguous "
                         f"int32 tensor on {q.device}")
    if Hq // Hkv > MAX_GROUP:
        raise NotImplementedError(f"decode_attention: {Hq // Hkv} q heads "
                                  f"per KV head (the kernel holds "
                                  f"{MAX_GROUP})")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib, fn = _launcher()
    with device_guard(q):
        err = fn(ptr(q), ptr(k), ptr(v), ptr(kv_len), ptr(out), B, S, Hq,
                 Hkv, D, float(sm_scale), int(q.dtype == torch.bfloat16),
                 stream_of(q))
    check_launch(err, lib, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
