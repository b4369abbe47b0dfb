"""Decoder-only LM assembly, dense and ssm families (the port's
counterpart of the JAX package's ``models/transformer.py``): parameter
specs, the full-sequence forward with cache capture (prefill), caches,
and the single-token decode.

The reference stacks each layer's parameters on a leading ``(n_layers,)``
axis and runs ``lax.scan`` over them; the port keeps one module per
layer in an ``nn.ModuleList`` and loops.  The specs keep the stacked
paths and shapes, so a stacked tensor (the reference's, or the port's
own init) is split over the layers when it is loaded.  The caches are
the reference's trees: for the dense family one (L, B, S, Hkv, D) K/V
tensor pair; for the ssm family (Mamba2) ``{"ssm": (L, B, H, P, N) f32,
"conv": (L, B, d_conv - 1, conv_dim)}``, which has no sequence axis.

The other families raise NotImplementedError naming the ``ROADMAP.md``
item that ports them.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import Attention, Rope, kv_cache_shape
from repro_torch.models.common import ParamSpec
from repro_torch.models.layers import (CastWeights, Embedding, Linear,
                                      RMSNorm, SwiGLU)
from repro_torch.models.ssm import (SSMBlock, dims as ssm_dims,
                                   init_ssm_state, proj_dim)

Cache = Dict[str, Any]
PORTED = ("dense", "ssm")

# families still to port, and the ROADMAP.md queue 1 item that will
NOT_PORTED = {
    "hybrid": "queue 1 item 12c (Zamba2 hybrid: head-dim-112 attention "
              "instances, the shared block)",
    "moe": "queue 1 item 12d (mixture of experts)",
    "vlm": "queue 1 item 12e (vision frontend)",
    "encdec": "queue 1 item 12f (encoder-decoder, cross-attention)",
}


def check_family(cfg: ModelConfig) -> None:
    if cfg.family in PORTED:
        return
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP.md {NOT_PORTED[cfg.family]})")
    raise ValueError(f"{cfg.name}: family {cfg.family!r} has no LM")


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _ssm_layer_specs(cfg: ModelConfig) -> List[ParamSpec]:
    """``def_rmsnorm("ln")`` + ``def_ssm_block("ssm")``, stacked."""
    L, d = cfg.n_layers, cfg.d_model
    s, d_inner, H, conv_dim = ssm_dims(cfg)
    return [ParamSpec("layers/ln/scale", (L, d), "ones"),
            ParamSpec("layers/ssm/in_proj/w", (L, d, proj_dim(cfg))),
            ParamSpec("layers/ssm/conv_w", (L, s.d_conv, conv_dim)),
            ParamSpec("layers/ssm/conv_b", (L, conv_dim), "zeros"),
            ParamSpec("layers/ssm/A_log", (L, H), "ssm_a"),
            ParamSpec("layers/ssm/dt_bias", (L, H), "ssm_dt"),
            ParamSpec("layers/ssm/D", (L, H), "ones"),
            ParamSpec("layers/ssm/norm_scale", (L, d_inner), "ones"),
            ParamSpec("layers/ssm/out_proj/w", (L, d_inner, d))]


def param_specs(cfg: ModelConfig) -> List[ParamSpec]:
    """``def_lm_params`` for the dense and ssm families: paths and shapes
    of the reference's parameter tree, layers stacked."""
    check_family(cfg)
    L, d, q, kv, ff = (cfg.n_layers, cfg.d_model, cfg.q_dim, cfg.kv_dim,
                       cfg.d_ff)
    specs = [ParamSpec("embed/table", (cfg.vocab_size, d), scale=1.0)]
    if cfg.family == "ssm":
        specs += _ssm_layer_specs(cfg)
    else:
        specs.append(ParamSpec("layers/ln_attn/scale", (L, d), "ones"))
        for name, d_out in (("wq", q), ("wk", kv), ("wv", kv)):
            specs.append(ParamSpec(f"layers/attn/{name}/w", (L, d, d_out)))
            if cfg.qkv_bias:
                specs.append(ParamSpec(f"layers/attn/{name}/b", (L, d_out),
                                       "zeros"))
        specs += [ParamSpec("layers/attn/wo/w", (L, q, d)),
                  ParamSpec("layers/ln_mlp/scale", (L, d), "ones"),
                  ParamSpec("layers/mlp/w_gate", (L, d, ff)),
                  ParamSpec("layers/mlp/w_up", (L, d, ff)),
                  ParamSpec("layers/mlp/w_down", (L, ff, d))]
    specs.append(ParamSpec("ln_final/scale", (d,), "ones"))
    if not cfg.tie_embeddings:
        specs.append(ParamSpec("lm_head/w", (d, cfg.vocab_size)))
    return specs


class Block(nn.Module):
    """One attention layer: ``_attn_layer_fwd`` (swiglu)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln_attn = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.attn = Attention(cfg, device=device)
        self.ln_mlp = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, device)

    def forward(self, h: torch.Tensor, rope: Optional[Rope] = None):
        a, kv = self.attn(self.ln_attn(h), rope=rope)
        h = h + a
        return h + self.mlp(self.ln_mlp(h)), kv

    def decode(self, h, cache_k, cache_v, pos, rope: Optional[Rope] = None):
        h = h + self.attn.decode(self.ln_attn(h), cache_k, cache_v, pos,
                                 rope)
        return h + self.mlp(self.ln_mlp(h))


class SSMLayer(nn.Module):
    """One Mamba2 layer: ``_ssm_layer_fwd``, h + ssm(rmsnorm(h))."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.ssm = SSMBlock(cfg, device)

    def forward(self, h: torch.Tensor, return_state: bool = False):
        if return_state:
            out, state = self.ssm(self.ln(h), return_state=True)
            return h + out, state
        return h + self.ssm(self.ln(h)), None

    def decode(self, h: torch.Tensor, state) -> torch.Tensor:
        return h + self.ssm.decode(self.ln(h), state)


class TransformerLM(nn.Module):
    """The LM's weights (f32 masters), one module per layer (``Block``s
    for the dense family, ``SSMLayer``s for ssm).  Built empty;
    ``Model.init_params`` or ``params.lm_from_params`` fill it through
    ``load_``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, device)
        layer = SSMLayer if cfg.family == "ssm" else Block
        self.layers = nn.ModuleList(layer(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.ln_final = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.lm_head = None if cfg.tie_embeddings else Linear(
            cfg.d_model, cfg.vocab_size, False, device)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    @torch.no_grad()
    def load_(self, path: str, value: torch.Tensor) -> None:
        """Copy the parameter at reference path ``path`` ("layers/..."
        stacked over the layers) from ``value``; a layer weight's copy in
        the activation dtype is made here, once."""
        head, _, rest = path.partition("/")
        if head == "layers":
            if value.shape[0] != len(self.layers):
                raise ValueError(f"{path}: {value.shape[0]} layers, model "
                                 f"has {len(self.layers)}")
            owner, _, name = rest.replace("/", ".").rpartition(".")
            for layer, v in zip(self.layers, value):
                module = layer.get_submodule(owner)
                getattr(module, name).copy_(v)
                if isinstance(module, CastWeights):
                    module.keep_cast(name, dtype_of(self.cfg))
        else:
            self.get_parameter(path.replace("/", ".")).copy_(value)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """Final norm and the head, logits in f32."""
        h = self.ln_final(h)
        if self.lm_head is None:
            return self.embed.unembed(h)
        return torch.matmul(h.float(), self.lm_head.w)


def _ssm_cache(cfg: ModelConfig, batch: int, device) -> Cache:
    """The ssm family's zero cache: every layer's ``init_ssm_state``
    stacked, as the reference's ``make_cache``."""
    st = init_ssm_state(cfg, batch, dtype_of(cfg), device)
    return {"layers": {k: torch.zeros((cfg.n_layers,) + tuple(v.shape),
                                      dtype=v.dtype, device=device)
                       for k, v in st.items()}}


def lm_forward(model: TransformerLM, tokens: torch.Tensor, *,
               return_cache: bool = False, cache_len: Optional[int] = None,
               logits_at: Optional[torch.Tensor] = None):
    """tokens: (B, S) -> (logits f32, aux_loss, cache | None).

    Logits are (B, S, V), or (B, V) at one position per row when
    ``logits_at`` (B,) is given (the same numbers up to the head
    matmul's summation order, for S times less work).  With
    ``return_cache`` the cache holds every layer's K/V of the S
    positions; ``cache_len`` (>= S) allocates it that long at once,
    zeros past S, which is ``pad_cache`` without the copy.  For the ssm
    family the cache is every layer's decode state after the S tokens
    (it has no length: ``cache_len`` is not read)."""
    cfg = model.cfg
    dtype = dtype_of(cfg)
    B, S = tokens.shape
    h = model.embed.embed(tokens, dtype)
    cache: Optional[Cache] = None
    if cfg.family == "ssm":
        if return_cache:
            cache = _ssm_cache(cfg, B, h.device)
        for i, layer in enumerate(model.layers):
            h, st = layer(h, return_state=return_cache)
            if cache is not None:
                for k, v in st.items():
                    cache["layers"][k][i] = v
    else:
        if return_cache:
            n = S if cache_len is None else cache_len
            if n < S:
                raise ValueError(f"cache_len {n} < sequence length {S}")
            shape = kv_cache_shape(cfg, cfg.n_layers, B, n)
            ck = torch.zeros(shape, dtype=dtype, device=h.device)
            cv = torch.zeros(shape, dtype=dtype, device=h.device)
            cache = {"layers": (ck, cv)}
        # the rope tables are the same for every layer: computed once
        rope = model.layers[0].attn.rope(torch.arange(S, device=h.device))
        for i, layer in enumerate(model.layers):
            h, (k, v) = layer(h, rope)
            if cache is not None:
                ck[i, :, :S] = k
                cv[i, :, :S] = v
    if logits_at is not None:
        h = h[torch.arange(B, device=h.device), logits_at]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return model.logits(h), aux, cache


def cache_has_length(cfg: ModelConfig) -> bool:
    """Whether the decode cache holds ``max_len`` positions (a KV cache,
    which a generate past ``max_len`` overflows) rather than a state
    with no length (ssm)."""
    check_family(cfg)
    return cfg.family != "ssm"


def make_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> Cache:
    """Zero caches of ``max_len`` positions (the reference's mode
    'init'); the ssm family's states have no length."""
    if not cache_has_length(cfg):
        return _ssm_cache(cfg, batch, device)
    shape = kv_cache_shape(cfg, cfg.n_layers, batch, max_len)
    dtype = dtype_of(cfg)
    return {"layers": (torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device))}


def pad_cache(cfg: ModelConfig, cache: Cache, max_len: int) -> Cache:
    """Grow the seq axis of the KV cache (captured at prefill length) to
    ``max_len`` with zeros, so decode can append.  SSM states are
    length-free: left alone."""
    if not cache_has_length(cfg):
        return dict(cache)
    k, v = cache["layers"]
    extra = max_len - k.shape[2]
    if extra <= 0:
        return dict(cache)
    pad = (0, 0, 0, 0, 0, extra)          # last three axes: D, Hkv, S
    return {**cache, "layers": (torch.nn.functional.pad(k, pad),
                                torch.nn.functional.pad(v, pad))}


def lm_decode(model: TransformerLM, token: torch.Tensor, pos: torch.Tensor,
              cache: Cache):
    """token: (B, 1); pos: (B,) int32, the valid cache length per row
    (the new token goes at index pos; the ssm family does not read it).
    -> (logits (B, 1, V) f32, cache), the cache updated in place."""
    h = model.embed.embed(token, dtype_of(model.cfg))
    if model.cfg.family == "ssm":
        states = cache["layers"]
        for i, layer in enumerate(model.layers):
            h = layer.decode(h, {k: v[i] for k, v in states.items()})
        return model.logits(h), cache
    ck, cv = cache["layers"]
    rope = model.layers[0].attn.rope(pos[:, None])
    for i, layer in enumerate(model.layers):
        h = layer.decode(h, ck[i], cv[i], pos, rope)
    return model.logits(h), cache
