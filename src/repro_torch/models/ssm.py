"""Mamba2 (SSD) block (the port's counterpart of the JAX package's
``models/ssm.py``): in_proj -> (z, x, B, C, dt), causal depthwise conv,
the SSD scan (the ``ssd_scan`` kernel on the card), gated RMSNorm,
out_proj.

Decode carries two states per layer: the SSM state (B, H, P, N) f32 and
a conv tail (B, d_conv-1, conv_dim) in the activation dtype holding the
last inputs of the depthwise convolution (pre-conv).  ``SSMBlock.decode``
updates both IN PLACE (the reference returns new ones).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_step
from repro_torch.models.common import param_dtype
from repro_torch.models.layers import (CastWeights, Linear, empty_param,
                                      rmsnorm)

State = Dict[str, torch.Tensor]


def dims(cfg: ModelConfig) -> Tuple[object, int, int, int]:
    """(ssm config, d_inner, SSM heads, conv width)."""
    s = cfg.ssm
    d_inner = s.d_inner(cfg.d_model)
    n_heads = s.n_heads(cfg.d_model)
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return s, d_inner, n_heads, conv_dim


def proj_dim(cfg: ModelConfig) -> int:
    """Width of the fused input projection [z, x, B, C, dt]."""
    s, d_inner, n_heads, _ = dims(cfg)
    return 2 * d_inner + 2 * s.n_groups * s.d_state + n_heads


def init_ssm_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device) -> State:
    """Zero decode state of one layer; the conv tail in ``dtype``."""
    s, _, n_heads, conv_dim = dims(cfg)
    return {"ssm": torch.zeros((batch, n_heads, s.head_dim, s.d_state),
                               dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, s.d_conv - 1, conv_dim),
                                dtype=dtype, device=device)}


class SSMBlock(CastWeights):
    """``def_ssm_block``'s parameters; ``forward`` is ``ssm_block_full``
    and ``decode`` ``ssm_block_decode``.  ``conv_w`` and ``conv_b`` keep
    a copy in the activation dtype (the reference casts them at use)."""

    CAST = ("conv_w", "conv_b")

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        s, d_inner, n_heads, conv_dim = dims(cfg)
        d = cfg.d_model
        dt = param_dtype(cfg)
        self.cfg = cfg
        self.in_proj = Linear(d, proj_dim(cfg), False, device, dt)
        self.conv_w = empty_param((s.d_conv, conv_dim), device, dt)
        self.conv_b = empty_param((conv_dim,), device, dt)
        self.A_log = empty_param((n_heads,), device, dt)
        self.dt_bias = empty_param((n_heads,), device, dt)
        self.D = empty_param((n_heads,), device, dt)
        self.norm_scale = empty_param((d_inner,), device, dt)
        self.out_proj = Linear(d_inner, d, False, device, dt)

    def keep_cast(self, name: str, dtype: torch.dtype) -> None:
        if name in self.CAST:
            super().keep_cast(name, dtype)

    def _split(self, proj: torch.Tensor):
        """``_split_proj``: z, xbc (pre-conv), dt."""
        s, d_inner, n_heads, conv_dim = dims(self.cfg)
        return (proj[..., :d_inner], proj[..., d_inner:d_inner + conv_dim],
                proj[..., -n_heads:])

    def _ssm_inputs(self, conv: torch.Tensor, dt: torch.Tensor):
        """silu(conv + conv_b) split into x, B, C; softplus(dt + dt_bias)
        in f32; A = -exp(A_log) (dt_bias and A_log upcast)."""
        s, d_inner, _, _ = dims(self.cfg)
        gN = s.n_groups * s.d_state
        conv = F.silu(conv + self.weight("conv_b", conv.dtype))
        dt_act = F.softplus(dt.float() + self.dt_bias.float())
        return (conv[..., :d_inner], conv[..., d_inner:d_inner + gN],
                conv[..., d_inner + gN:], dt_act,
                -torch.exp(self.A_log.float()))

    def _out(self, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """``_gated_norm`` (RMSNorm(y * silu(z)), in f32, back in y's
        dtype), then out_proj."""
        return self.out_proj(rmsnorm(y * F.silu(z), self.norm_scale,
                                     self.cfg.norm_eps))

    def forward(self, x: torch.Tensor, return_state: bool = False):
        """x: (B, S, d_model) -> out (B, S, d_model) [, the decode state
        after the S tokens: the final SSM state and the last d_conv - 1
        rows of the pre-conv xbc].  A state needs S >= d_conv - 1 (the
        reference's tail would be shorter than its cache)."""
        s, d_inner, n_heads, _ = dims(self.cfg)
        B_, S_ = x.shape[:2]
        if return_state and S_ < s.d_conv - 1:
            raise ValueError(f"the decode state's conv tail needs at least "
                             f"d_conv - 1 = {s.d_conv - 1} tokens, got {S_}")
        z, xbc, dt = self._split(self.in_proj(x))
        # causal depthwise conv over time, summed in the activation
        # dtype in the reference's order
        w = self.weight("conv_w", x.dtype)
        pad = F.pad(xbc, (0, 0, s.d_conv - 1, 0))
        conv = pad[:, :S_] * w[0]
        for i in range(1, s.d_conv):
            conv = conv + pad[:, i:i + S_] * w[i]
        xs, Bm, Cm, dt_act, A = self._ssm_inputs(conv, dt)
        y, final = ssd_scan(xs.reshape(B_, S_, n_heads, s.head_dim), dt_act,
                            A, Bm, Cm, self.D.float(), chunk=s.chunk_size)
        out = self._out(y.reshape(B_, S_, d_inner), z)
        if return_state:
            return out, {"ssm": final, "conv": xbc[:, S_ - (s.d_conv - 1):]}
        return out

    def decode(self, x: torch.Tensor, state: State) -> torch.Tensor:
        """x: (B, 1, d_model); state: ``init_ssm_state``'s tensors (or
        views of a stacked cache), updated in place.  -> (B, 1,
        d_model)."""
        s, d_inner, n_heads, _ = dims(self.cfg)
        B_ = x.shape[0]
        z, xbc, dt = self._split(self.in_proj(x[:, 0]))
        tail = state["conv"]
        hist = torch.cat([tail, xbc[:, None].to(tail.dtype)], dim=1)
        conv = torch.einsum("btc,tc->bc", hist.to(x.dtype),
                            self.weight("conv_w", x.dtype))
        xt, Bt, Ct, dt_act, A = self._ssm_inputs(conv, dt)
        y, new = ssd_step(state["ssm"], xt.reshape(B_, n_heads, s.head_dim),
                          dt_act, A, Bt, Ct, self.D.float())
        state["ssm"].copy_(new)
        tail.copy_(hist[:, 1:])
        return self._out(y.reshape(B_, d_inner), z)[:, None]
