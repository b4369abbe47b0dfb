"""Building blocks of the language models (the port's counterpart of the
JAX package's ``models/layers.py``).

Dtype rules, as the reference's: parameters are held in the config's
``param_dtype`` (f32 master weights by default; bf16 where a model does
not fit the card otherwise), each module built with ``dtype=``; compute
follows the activations (bf16 at the configs' default), with each weight
cast to the activation dtype at use; norms run in f32 (their scales
upcast) and logits come out in f32 (the tied table or the head upcast).
``Linear``, ``SwiGLU`` and ``GeluMLP`` keep each weight's copy in the
activation dtype beside it when the two dtypes differ, made once when
the weight is written (``LMWeights.load_``, and again by
``LMWeights.refresh_casts`` after a train step's update): the bits of a
cast at every use.  The kept copies serve inference only: with grad
mode on, each weight is cast at use, in the graph, so its gradient
reaches the master weight.

``Linear`` keeps the reference's weight layout, ``w`` of shape
(d_in, d_out), so ``params.lm_from_params`` copies it as it is.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def empty_param(shape, device, dtype=None) -> nn.Parameter:
    """A parameter in ``dtype`` (default f32) to be filled by an init or
    the bridge.  It asks for no gradient until a trainer turns that on
    (``requires_grad_``, as ``train.TrainStep`` does)."""
    return nn.Parameter(torch.empty(tuple(shape),
                                    dtype=dtype or torch.float32,
                                    device=device), requires_grad=False)


class CastWeights(nn.Module):
    """A module whose weights are used in the activation dtype.
    ``keep_cast(name, dtype)`` stores ``<name>`` cast to ``dtype`` as a
    non-persistent buffer ``<name>_cast`` (so ``.to()`` moves it and
    ``state_dict`` leaves it out) when the weight is held in another
    dtype, and no second copy when it is held in ``dtype`` already;
    whoever writes the weight calls it again (an existing copy is
    overwritten in place).  Without a kept copy of that dtype a use
    casts (a no-op for a weight held in it).  Kept copies serve only
    with grad mode off (inference): with it on, ``weight`` casts in the
    graph, so the gradient reaches the master."""

    @torch.no_grad()
    def keep_cast(self, name: str, dtype: torch.dtype) -> None:
        weight = getattr(self, name)
        if dtype == weight.dtype:
            return
        kept = self._buffers.get(f"{name}_cast")
        if kept is not None and kept.dtype == dtype \
                and kept.shape == weight.shape:
            kept.copy_(weight)
        else:
            self.register_buffer(f"{name}_cast", weight.detach().to(dtype),
                                 persistent=False)

    def weight(self, name: str, dtype: torch.dtype) -> torch.Tensor:
        if not torch.is_grad_enabled():
            kept = self._buffers.get(f"{name}_cast")
            if kept is not None and kept.dtype == dtype:
                return kept
        return getattr(self, name).to(dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float
            ) -> torch.Tensor:
    """``rmsnorm``: computed in f32 (the scale upcast), returned in the
    input's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


class RMSNorm(nn.Module):
    """``rmsnorm`` with its scale as a parameter."""

    def __init__(self, dim: int, eps: float, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.scale = empty_param((dim,), device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.scale, self.eps)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float) -> torch.Tensor:
    """``layernorm``: computed in f32 (scale and bias upcast), returned in
    the input's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


class LayerNorm(nn.Module):
    """``layernorm`` with its scale and bias as parameters (the
    encoder-decoder family's norm)."""

    def __init__(self, dim: int, eps: float, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.scale = empty_param((dim,), device, dtype)
        self.bias = empty_param((dim,), device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.scale, self.bias, self.eps)


class Linear(CastWeights):
    """``linear``: y = x @ w (+ b), weight (d_in, d_out), both cast to
    x's dtype."""

    def __init__(self, d_in: int, d_out: int, bias: bool, device=None,
                 dtype=None):
        super().__init__()
        self.w = empty_param((d_in, d_out), device, dtype)
        self.b = empty_param((d_out,), device, dtype) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x, self.weight("w", x.dtype))
        if self.b is not None:
            y = y + self.weight("b", x.dtype)
        return y


class Embedding(nn.Module):
    """The token table (vocab, d); ``embed`` and the tied ``unembed``."""

    def __init__(self, vocab: int, dim: int, device=None, dtype=None):
        super().__init__()
        self.table = empty_param((vocab, dim), device, dtype)

    def embed(self, tokens: torch.Tensor, dtype: torch.dtype
              ) -> torch.Tensor:
        # gathering then casting gives the bits of the reference's
        # cast-then-gather
        return self.table[tokens].to(dtype)

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        """Logits in f32 (loss numerics): both sides upcast."""
        return torch.matmul(x.float(), self.table.float().t())


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (...,) int -> cos, sin of shape (..., head_dim // 2),
    f32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def sinusoidal_positions(n: int, dim: int, device=None) -> torch.Tensor:
    """Whisper's fixed sinusoidal position embeddings (n, dim), f32: the
    sines of dim // 2 frequencies, then their cosines (not interleaved),
    the frequencies exp(-i log(10000) / (dim // 2 - 1))."""
    half = dim // 2
    step = torch.tensor(math.log(10_000.0), dtype=torch.float32,
                        device=device) / max(half - 1, 1)
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=device) * step)
    ang = torch.arange(n, dtype=torch.float32, device=device)[:, None] \
        * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, D//2) or (S, D//2).  Half-split
    rotation in x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    c = cos[..., None, :].to(x.dtype)       # (B, S, 1, D/2)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


class SwiGLU(CastWeights):
    """``mlp_swiglu``: (silu(x @ w_gate) * (x @ w_up)) @ w_down, from
    ``d_in`` (default ``d_model``: Zamba2's shared block reads 2 d_model)
    back to ``d_model``, as ``def_mlp_swiglu``."""

    def __init__(self, d_model: int, d_ff: int, device=None,
                 d_in: Optional[int] = None, dtype=None):
        super().__init__()
        d_in = d_in or d_model
        self.w_gate = empty_param((d_in, d_ff), device, dtype)
        self.w_up = empty_param((d_in, d_ff), device, dtype)
        self.w_down = empty_param((d_ff, d_model), device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = torch.matmul(x, self.weight("w_gate", x.dtype))
        u = torch.matmul(x, self.weight("w_up", x.dtype))
        return torch.matmul(F.silu(g) * u, self.weight("w_down", x.dtype))


class GeluMLP(CastWeights):
    """``mlp_gelu``: gelu(x @ w_in + b_in) @ w_out + b_out, as
    ``def_mlp_gelu``.  ``jax.nn.gelu`` is the tanh approximation by
    default, so this is ``approximate="tanh"``, not torch's default
    erf."""

    def __init__(self, d_model: int, d_ff: int, device=None, dtype=None):
        super().__init__()
        self.w_in = empty_param((d_model, d_ff), device, dtype)
        self.b_in = empty_param((d_ff,), device, dtype)
        self.w_out = empty_param((d_ff, d_model), device, dtype)
        self.b_out = empty_param((d_model,), device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.matmul(x, self.weight("w_in", x.dtype)) \
            + self.weight("b_in", x.dtype)
        h = F.gelu(h, approximate="tanh")
        return torch.matmul(h, self.weight("w_out", x.dtype)) \
            + self.weight("b_out", x.dtype)
