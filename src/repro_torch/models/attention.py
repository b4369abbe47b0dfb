"""GQA attention (the port's counterpart of the JAX package's
``models/attention.py``): the full-sequence forward over the
``flash_attention`` kernel (prefill) and the single-token decode step
over the ``decode_attention`` kernel.

Cache layout as the reference's: K and V of one layer are (B, S_max,
Hkv, D) in the activation dtype.  The decode step writes the new token's
K/V row at ``pos`` IN PLACE (the reference's functional ``.at[].set``
returns a new cache; the port updates the tensors it is given and
returns them).  Cross-attention (``cross_kv``, ``kv_override``) belongs
to the encoder-decoder family, which is not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.models.common import param_dtype
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import Linear, apply_rope, rope_tables

Rope = Tuple[torch.Tensor, torch.Tensor]        # cos, sin


class Attention(nn.Module):
    """wq, wk, wv (d_in -> q_dim / kv_dim, bias when ``cfg.qkv_bias``)
    and wo (q_dim -> d_model), as ``def_attention``; ``d_in`` defaults to
    d_model (Zamba2's shared block reads 2 d_model)."""

    def __init__(self, cfg: ModelConfig, device=None,
                 d_in: Optional[int] = None):
        super().__init__()
        d = d_in or cfg.d_model
        dt = param_dtype(cfg)
        self.cfg = cfg
        self.wq = Linear(d, cfg.q_dim, cfg.qkv_bias, device, dt)
        self.wk = Linear(d, cfg.kv_dim, cfg.qkv_bias, device, dt)
        self.wv = Linear(d, cfg.kv_dim, cfg.qkv_bias, device, dt)
        self.wo = Linear(cfg.q_dim, cfg.d_model, False, device, dt)

    def project(self, x: torch.Tensor):
        """``_project_qkv``: x (B, S, d_in) -> q (B, S, Hq, D), k, v (B,
        S, Hkv, D)."""
        cfg = self.cfg
        B, S = x.shape[:2]
        q = self.wq(x).reshape(B, S, cfg.n_heads, cfg.head_dim)
        k = self.wk(x).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
        v = self.wv(x).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
        return q, k, v

    def rope(self, positions: torch.Tensor) -> Rope:
        return rope_tables(positions, self.cfg.head_dim, self.cfg.rope_theta)

    def forward(self, x: torch.Tensor, rope: Optional[Rope] = None):
        """``attention_full``, causal, with rope at positions 0..S-1
        (``rope``: the tables, when the caller shares them across
        layers).  x: (B, S, d_in) -> (out (B, S, d_model), (k, v)), k
        and v after rope: the prefill's cache rows."""
        B, S = x.shape[:2]
        q, k, v = self.project(x)
        cos, sin = rope or self.rope(torch.arange(S, device=x.device))
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        out = flash_attention(q, k, v, causal=True)
        return self.wo(out.reshape(B, S, self.cfg.q_dim)), (k, v)

    def decode(self, x: torch.Tensor, cache_k: torch.Tensor,
               cache_v: torch.Tensor, pos: torch.Tensor,
               rope: Optional[Rope] = None) -> torch.Tensor:
        """``attention_decode``.  x: (B, 1, d_in); cache_k / cache_v: (B,
        S, Hkv, D), written in place at (row, pos[row]); pos: (B,) int32,
        the number of valid cached tokens; ``rope``: the tables at
        ``pos[:, None]``, when shared across layers.  -> (B, 1,
        d_model)."""
        B = x.shape[0]
        q, k, v = self.project(x)                      # (B, 1, H, D)
        cos, sin = rope or self.rope(pos[:, None])
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        rows = torch.arange(B, device=x.device)
        cache_k[rows, pos] = k[:, 0].to(cache_k.dtype)
        cache_v[rows, pos] = v[:, 0].to(cache_v.dtype)
        out = decode_attention(q[:, 0], cache_k, cache_v, pos + 1)
        return self.wo(out.reshape(B, 1, self.cfg.q_dim))


def kv_cache_shape(cfg: ModelConfig, n_layers: int, batch: int,
                   max_len: int) -> Tuple[int, ...]:
    return (n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
