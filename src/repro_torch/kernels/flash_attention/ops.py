"""Flash attention: causal or full GQA attention with an online softmax.

``flash_attention(q, k, v, causal=, sm_scale=, kv_valid=)`` takes q (B,
Sq, Hq, D) and k, v (B, Skv, Hkv, D) in f32 or bf16 and returns (B, Sq,
Hq, D) in q's dtype, with the softmax in f32 and ``sm_scale`` 1/sqrt(D)
by default.  Queries sit at the end of the key axis when Sq < Skv;
``kv_valid`` > 0 masks keys at or past it; a query that sees no key gives
0.  The model's prefill (``models.attention``) calls it once a layer.

On a CUDA tensor it launches ``csrc/flash_attention.cu``, which masks
the ragged edge itself (no padded copy): both dtypes on tensor cores
(wgmma fed by TMA), f32 as 3xTF32 (each operand split into a tf32 hi
and lo term, three products); each dtype has its own kernel, and a call
the kernel refuses raises.  On a CPU tensor it runs
``flash_attention_ref``, the plain PyTorch version: the JAX package's
memory-bounded ``_chunked_jnp`` (``kernels/flash_attention/ops.py``), a
loop over key blocks of 128 with the same online softmax.  One
difference from ``_chunked_jnp``, on purpose: a masked key contributes
exactly 0 there too, so a query with no visible key gives 0, as the
Pallas kernel's finalize (``l == 0 -> 0``) intends, where
``_chunked_jnp`` (and the Pallas kernel on a tile it does not skip)
averages V over the masked keys.  Rows that see a key are unaffected.

Training: when grad mode is on and q, k or v requires grad, a CUDA call
goes through ``FlashAttentionFn``, whose forward launches the same
forward kernel and whose backward launches ``flash_attention_bwd``
(``csrc/flash_attention_bwd.cu``: dQ, dK and dV, each sum in f32; bf16
on tensor cores, f32 on CUDA cores); every
other call (serving) launches the forward kernel as before.  On a CPU
tensor ``flash_attention_ref`` runs under autograd, and its own graph is
the gradient: the reference differentiates ``_chunked_jnp`` off the TPU,
with the one difference above (a query that sees no key gives 0 and
zero gradients).  ``flash_attention_bwd_ref``, the plain backward, is
``torch.autograd.grad`` of ``flash_attention_ref``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import (check_launch, device_guard, on_cuda, ptr,
                                  stream_of)
from repro_torch.kernels._build import library

NEG_INF = float(np.finfo(np.float32).min)
BLOCK = 128                      # the reference wrapper's block_q/block_k
# head dims the kernels are built for: qwen2-0.5b's and stablelm-1.6b's
# 64, zamba2-7b's 112, deepseek-moe-16b's (and grok-1-314b's,
# deepseek-67b's and deepseek-coder-33b's) 128
HEAD_DIMS = (64, 112, 128)
DTYPES = (torch.float32, torch.bfloat16)
# flash_attention_launch(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, kv_valid,
#                        causal, sm_scale, bf16, stream)
LAUNCH_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 8
                   + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p))
# flash_attention_bwd_launch(q, k, v, o, dout, dq, dk, dv, lse, di,
#                            dk_part, dv_part, B, Sq, Skv, Hq, Hkv, D,
#                            kv_valid, causal, sm_scale, bf16, stream)
BWD_LAUNCH_ARGTYPES = ((ctypes.c_void_p,) * 12 + (ctypes.c_int,) * 8
                       + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p))
# the backward's row statistics (lse, Di) are kept Sq rounded up to this
# apart, so the bf16 kernels copy a tile's 64 rows whole
BWD_ROWS = 64


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        sm_scale: Optional[float] = None,
                        kv_valid: int = 0,
                        block_k: int = BLOCK) -> torch.Tensor:
    """Plain version: online softmax over key blocks of ``block_k``
    (the last one ragged), f32 throughout, out in q's dtype."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    n_valid = kv_valid if 0 < kv_valid < Skv else Skv
    qf = (q.float() * sm_scale).reshape(B, Sq, Hkv, G, D)
    qpos = torch.arange(Sq, device=q.device) + (Skv - Sq)
    m = torch.full((B, Sq, Hkv, G, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, Sq, Hkv, G, 1), device=q.device)
    acc = torch.zeros((B, Sq, Hkv, G, D), device=q.device)
    # blocks past n_valid hold only masked keys: they change nothing
    for k0 in range(0, n_valid, block_k):
        kb = k[:, k0:k0 + block_k].float()
        vb = v[:, k0:k0 + block_k].float()
        kpos = torch.arange(k0, k0 + kb.shape[1], device=q.device)
        vis = (kpos < n_valid)[None, :].expand(Sq, -1)
        if causal:
            vis = vis & (kpos[None, :] <= qpos[:, None])      # (Sq, bk)
        vis = vis[None, :, None, None, :]
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kb)
        s = torch.where(vis, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(vis, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bqhgk,bkhd->bqhgd", p, vb)
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    return (acc / l).reshape(B, Sq, Hq, D).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = library("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = list(LAUNCH_ARGTYPES)
    fn.restype = ctypes.c_int
    return lib, fn


def _check_operands(name, q, k, v):
    """The CUDA kernels' contract: q, k, v contiguous, of one dtype (f32
    or bf16), on q's device, 16-byte aligned, with a supported head
    dim."""
    idx, dtype = q.get_device(), q.dtype
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if t.get_device() != idx or t.dtype != dtype \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be a contiguous, 16-byte "
                             f"aligned {q.dtype} tensor on {q.device}, got "
                             f"{t.dtype} on {t.device}")
    if q.dtype not in DTYPES:
        raise ValueError(f"{name}: dtype {q.dtype} not in {DTYPES}")
    if q.shape[-1] not in HEAD_DIMS:
        raise NotImplementedError(f"{name}: head dim {q.shape[-1]} has no "
                                  f"kernel build (built for {HEAD_DIMS})")


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            dout: torch.Tensor, causal: bool = True,
                            sm_scale: Optional[float] = None,
                            kv_valid: int = 0):
    """Plain backward: ``torch.autograd.grad`` of ``flash_attention_ref``
    at (q, k, v) against ``dout`` -> (dq, dk, dv) in the inputs' dtypes.
    ``o`` (the forward's output, which the kernel reads) is not read: the
    plain version recomputes its own."""
    del o
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_ref(*leaves, causal=causal, sm_scale=sm_scale,
                                  kv_valid=kv_valid)
        return torch.autograd.grad(out, leaves, dout)


@functools.lru_cache(maxsize=None)
def _bwd_launcher():
    lib = library("flash_attention_bwd")
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = list(BWD_LAUNCH_ARGTYPES)
    fn.restype = ctypes.c_int
    return lib, fn


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, dout: torch.Tensor,
                        causal: bool = True,
                        sm_scale: Optional[float] = None,
                        kv_valid: int = 0):
    """The gradient of ``flash_attention(q, k, v, causal, sm_scale,
    kv_valid)``, whose output was ``o``, against ``dout`` (both (B, Sq,
    Hq, D)) -> (dq, dk, dv) in q's dtype.  On a CUDA tensor it launches
    ``csrc/flash_attention_bwd.cu`` (two or three kernels a call, one
    launch counted; bf16 with Hq > Hkv writes per-head f32 partials of dk
    and dv into scratch allocated here, which a third kernel sums); on a
    CPU tensor it runs ``flash_attention_bwd_ref``."""
    B, Sq, Hq, D = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != D or Hq % k.shape[2] \
            or o.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, o "
                         f"{tuple(o.shape)}, dout {tuple(dout.shape)}")
    Skv, Hkv = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    if not on_cuda(q):
        return flash_attention_bwd_ref(q, k, v, o, dout, causal, sm_scale,
                                       kv_valid)
    _check_operands("flash_attention_bwd", q, k, v)
    _check_operands("flash_attention_bwd", q, o, dout)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if not B or not Hq or not D:
        return dq, dk, dv
    rows = -(-Sq // BWD_ROWS) * BWD_ROWS
    lse = torch.empty((B, Hq, rows), dtype=torch.float32, device=q.device)
    di = torch.empty_like(lse)
    bf16 = q.dtype == torch.bfloat16
    parts = [None, None]
    if bf16 and Hq > Hkv:
        parts = [torch.empty((B, Skv, Hq, D), dtype=torch.float32,
                             device=q.device) for _ in range(2)]
    lib, fn = _bwd_launcher()
    with device_guard(q):
        err = fn(ptr(q), ptr(k), ptr(v), ptr(o), ptr(dout), ptr(dq),
                 ptr(dk), ptr(dv), ptr(lse), ptr(di),
                 *(None if t is None else ptr(t) for t in parts), B, Sq,
                 Skv, Hq, Hkv, D, int(kv_valid), int(bool(causal)),
                 float(sm_scale), int(bf16), stream_of(q))
    check_launch(err, lib, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def _forward_kernel(q, k, v, causal, sm_scale, kv_valid) -> torch.Tensor:
    """One launch of the forward kernel on CUDA tensors."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    _check_operands("flash_attention", q, k, v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib, fn = _launcher()
    with device_guard(q):
        err = fn(ptr(q), ptr(k), ptr(v), ptr(out), B, Sq, Skv, Hq, Hkv, D,
                 int(kv_valid), int(bool(causal)), float(sm_scale),
                 int(q.dtype == torch.bfloat16), stream_of(q))
    check_launch(err, lib, "flash_attention")
    flash_attention.launches += 1
    return out


class FlashAttentionFn(torch.autograd.Function):
    """The forward kernel with ``flash_attention_bwd`` as its gradient
    (CUDA tensors under grad)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, kv_valid):
        out = _forward_kernel(q, k, v, causal, sm_scale, kv_valid)
        ctx.save_for_backward(q, k, v, out)
        ctx.args = (causal, sm_scale, kv_valid)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out,
                                         dout.contiguous().to(q.dtype),
                                         *ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    kv_valid: int = 0) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D) in
    q's dtype; differentiable on both devices."""
    B, Sq, Hq, D = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != D or Hq % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    Skv, Hkv = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    # the reference pads both sequences to blocks of 128, which shifts the
    # causal diagonal when Sq != Skv; it refuses that case, and so do we
    ragged = Sq % min(BLOCK, max(Sq, 1)) or Skv % min(BLOCK, max(Skv, 1))
    if causal and ragged and Sq != Skv:
        raise NotImplementedError(
            "causal attention with ragged Sq != Skv padding")
    if not on_cuda(q):
        return flash_attention_ref(q, k, v, causal, sm_scale, kv_valid)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, sm_scale, kv_valid)
    return _forward_kernel(q, k, v, causal, sm_scale, kv_valid)


flash_attention.launches = 0
