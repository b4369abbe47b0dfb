"""GQA attention (the port's counterpart of the JAX package's
``models/attention.py``): the full-sequence forward over the
``flash_attention`` kernel (prefill) and the single-token decode step
over the ``decode_attention`` kernel.

Cache layout as the reference's: K and V of one layer are (B, S_max,
Hkv, D) in the activation dtype.  The decode step writes the new token's
K/V row at ``pos`` IN PLACE (the reference's functional ``.at[].set``
returns a new cache; the port updates the tensors it is given and
returns them).

The encoder-decoder family (Whisper) uses three more paths: attention
without rope (``use_rope=False`` at construction: every path of the
module skips it), non-causal full attention (its encoder), and
cross-attention: ``cross_kv`` projects the encoder output once, the
full forward's ``kv`` takes those K/V in place of its own (the
reference's ``kv_override``: Sq = the prompt length against Skv = the
encoder's frames, non-causal), and ``decode_cross`` runs one query
token over them with every row's ``kv_len`` the frame count and no
cache write (the reference's ``update_cache=False``, which still
projects the new token's K and V and throws them away; the port does
not compute them).
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
    d_model (Zamba2's shared block reads 2 d_model); ``use_rope=False``
    for a module that never rotates (Whisper's)."""

    def __init__(self, cfg: ModelConfig, device=None,
                 d_in: Optional[int] = None, use_rope: bool = True):
        super().__init__()
        d = d_in or cfg.d_model
        dt = param_dtype(cfg)
        self.cfg = cfg
        self.use_rope = use_rope
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

    def cross_kv(self, enc_out: torch.Tensor):
        """``cross_kv``: the encoder output (B, F, d_in) projected once ->
        k, v (B, F, Hkv, D), no rope."""
        cfg = self.cfg
        B, F = enc_out.shape[:2]
        k = self.wk(enc_out).reshape(B, F, cfg.n_kv_heads, cfg.head_dim)
        v = self.wv(enc_out).reshape(B, F, cfg.n_kv_heads, cfg.head_dim)
        return k, v

    def forward(self, x: torch.Tensor, rope: Optional[Rope] = None,
                causal: bool = True, kv: Optional[Tuple] = None):
        """``attention_full``, with rope at positions 0..S-1 unless the
        module has none (``rope``: the tables, when the caller shares
        them across layers).  ``kv``: cross-attention's (k, v) from
        ``cross_kv``, used as they are in place of x's own (no rope).
        x: (B, S, d_in) -> (out (B, S, d_model), (k, v)), k and v after
        rope: the prefill's cache rows."""
        cfg = self.cfg
        B, S = x.shape[:2]
        if kv is None:
            q, k, v = self.project(x)
            if self.use_rope:
                cos, sin = rope or self.rope(torch.arange(S,
                                                          device=x.device))
                q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        else:
            q = self.wq(x).reshape(B, S, cfg.n_heads, cfg.head_dim)
            k, v = kv
        out = flash_attention(q, k, v, causal=causal)
        return self.wo(out.reshape(B, S, cfg.q_dim)), (k, v)

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
        if self.use_rope:
            cos, sin = rope or self.rope(pos[:, None])
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        rows = torch.arange(B, device=x.device)
        cache_k[rows, pos] = k[:, 0].to(cache_k.dtype)
        cache_v[rows, pos] = v[:, 0].to(cache_v.dtype)
        out = decode_attention(q[:, 0], cache_k, cache_v, pos + 1)
        return self.wo(out.reshape(B, 1, self.cfg.q_dim))

    def decode_cross(self, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, kv_len: torch.Tensor
                     ) -> torch.Tensor:
        """``attention_decode(..., update_cache=False)`` for
        cross-attention: x (B, 1, d_in) over the encoder's K/V (B, F,
        Hkv, D), read and not written, masked by ``kv_len`` (B,) int32
        (F on every row), no rope.  -> (B, 1, d_model)."""
        cfg = self.cfg
        B = x.shape[0]
        q = self.wq(x).reshape(B, cfg.n_heads, cfg.head_dim)
        out = decode_attention(q, cache_k, cache_v, kv_len)
        return self.wo(out.reshape(B, 1, cfg.q_dim))


def kv_cache_shape(cfg: ModelConfig, n_layers: int, batch: int,
                   max_len: int) -> Tuple[int, ...]:
    return (n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
