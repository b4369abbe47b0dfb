"""Decoder-only LM assembly, dense, vlm, moe, ssm and hybrid families (the
port's counterpart of the JAX package's ``models/transformer.py``):
parameter specs, the full-sequence forward with cache capture (prefill),
caches, and the single-token decode.

The reference stacks each layer's parameters on leading axes and runs
``lax.scan`` over them; the port keeps one module per layer in an
``nn.ModuleList`` and loops.  The specs keep the stacked paths and
shapes, so a stacked tensor (the reference's, or the port's own init) is
split over the layers when it is loaded.  The caches are the reference's
trees: for the dense and vlm families one (L, B, S, Hkv, D) K/V tensor
pair; for
the moe family one pair a stack, ``dense_layers`` (the first
``dense_first_n`` layers, whose MLP is a SwiGLU of ``dense_d_ff``) and
``layers`` (the rest, whose MLP is a ``moe.MoEBlock``); for the ssm
family (Mamba2) ``{"ssm": (L, B, H, P, N) f32, "conv": (L, B,
d_conv - 1, conv_dim)}``, which has no sequence axis.

The hybrid family (Zamba2) runs ``n_groups`` groups of ``ssm_per_group``
Mamba2 layers, each group followed by one of ``n_shared_blocks`` SHARED
attention + MLP blocks (group gi uses block gi % n_shared_blocks), whose
projections read ``concat([h, h_embed])`` (width 2 d_model; h_embed is
the embedding output, the same at every site), then ``tail_ssm`` more
Mamba2 layers.  Its parameters are ``groups/ssm_layers/...`` stacked on
two axes (n_groups, ssm_per_group), ``shared/...`` (n_shared_blocks)
and ``tail/...`` (tail_ssm); its cache holds ``groups`` (the SSM states,
(n_groups, ssm_per_group, B, ...)), ``shared_kv`` (one K/V pair a site,
(n_groups, B, S, Hkv, D)) and ``tail``.

The vlm family (Pixtral) is the dense stack whose first ``n_embeds``
positions take precomputed patch embeddings in place of the token
embeddings (the vision frontend is a stub, as in the reference).  The
encoder-decoder family (Whisper) is ``models/encdec.py``; it shares
``LMWeights`` (the loading of stacked parameters) and ``pad_cache``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import Attention, Rope, kv_cache_shape
from repro_torch.models.common import ParamSpec, param_dtype
from repro_torch.models.layers import (CastWeights, Embedding, Linear,
                                      RMSNorm, SwiGLU)
from repro_torch.models.moe import MoEBlock
from repro_torch.models.ssm import (SSMBlock, dims as ssm_dims,
                                   init_ssm_state, proj_dim)

Cache = Dict[str, Any]
PORTED = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED:
        raise ValueError(f"{cfg.name}: family {cfg.family!r} has no LM")


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _ssm_layer_specs(cfg: ModelConfig, prefix: str,
                     lead: Tuple[int, ...]) -> List[ParamSpec]:
    """``def_rmsnorm("ln")`` + ``def_ssm_block("ssm")`` under ``prefix``,
    stacked on the ``lead`` axes."""
    d = cfg.d_model
    s, d_inner, H, conv_dim = ssm_dims(cfg)
    return [ParamSpec(f"{prefix}/ln/scale", lead + (d,), "ones"),
            ParamSpec(f"{prefix}/ssm/in_proj/w", lead + (d, proj_dim(cfg))),
            ParamSpec(f"{prefix}/ssm/conv_w", lead + (s.d_conv, conv_dim)),
            ParamSpec(f"{prefix}/ssm/conv_b", lead + (conv_dim,), "zeros"),
            ParamSpec(f"{prefix}/ssm/A_log", lead + (H,), "ssm_a"),
            ParamSpec(f"{prefix}/ssm/dt_bias", lead + (H,), "ssm_dt"),
            ParamSpec(f"{prefix}/ssm/D", lead + (H,), "ones"),
            ParamSpec(f"{prefix}/ssm/norm_scale", lead + (d_inner,), "ones"),
            ParamSpec(f"{prefix}/ssm/out_proj/w", lead + (d_inner, d))]


def _swiglu_specs(prefix: str, lead: Tuple[int, ...], d_in: int, ff: int,
                  d: int) -> List[ParamSpec]:
    """``def_mlp_swiglu`` under ``prefix``, stacked on the ``lead``
    axes."""
    return [ParamSpec(f"{prefix}/w_gate", lead + (d_in, ff)),
            ParamSpec(f"{prefix}/w_up", lead + (d_in, ff)),
            ParamSpec(f"{prefix}/w_down", lead + (ff, d))]


def _moe_specs(cfg: ModelConfig, prefix: str, n: int) -> List[ParamSpec]:
    """``def_moe_block`` under ``prefix``, stacked on ``(n,)``: the router
    (always f32), the routed experts stacked on E, the shared experts."""
    m, d = cfg.moe, cfg.d_model
    E, f = m.n_experts, m.expert_d_ff
    specs = [ParamSpec(f"{prefix}/router", (n, d, E), dtype="float32"),
             ParamSpec(f"{prefix}/experts/w_gate", (n, E, d, f)),
             ParamSpec(f"{prefix}/experts/w_up", (n, E, d, f)),
             ParamSpec(f"{prefix}/experts/w_down", (n, E, f, d))]
    for i in range(m.n_shared):
        specs += _swiglu_specs(f"{prefix}/shared{i}", (n,), d, f, d)
    return specs


def _attn_block_specs(cfg: ModelConfig, prefix: str, n: int, d_in: int,
                      d_ff: Optional[int] = None,
                      moe: bool = False) -> List[ParamSpec]:
    """An attention block (``_def_attn_layer``, or the hybrid's shared
    block reading ``d_in`` = 2 d_model) under ``prefix``, stacked on
    ``(n,)``: its MLP a SwiGLU of ``d_ff`` (default ``cfg.d_ff``), or
    with ``moe`` an MoE block."""
    d, q, kv = cfg.d_model, cfg.q_dim, cfg.kv_dim
    specs = [ParamSpec(f"{prefix}/ln_attn/scale", (n, d_in), "ones")]
    for name, d_out in (("wq", q), ("wk", kv), ("wv", kv)):
        specs.append(ParamSpec(f"{prefix}/attn/{name}/w", (n, d_in, d_out)))
        if cfg.qkv_bias:
            specs.append(ParamSpec(f"{prefix}/attn/{name}/b", (n, d_out),
                                   "zeros"))
    specs += [ParamSpec(f"{prefix}/attn/wo/w", (n, q, d)),
              ParamSpec(f"{prefix}/ln_mlp/scale", (n, d_in), "ones")]
    if moe:
        return specs + _moe_specs(cfg, f"{prefix}/moe", n)
    return specs + _swiglu_specs(f"{prefix}/mlp", (n,), d_in,
                                 d_ff or cfg.d_ff, d)


def attn_stack_sizes(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """The attention-layer stacks of the dense and moe families in order,
    (parameter and cache key, layers): dense ``layers``; moe
    ``dense_layers`` (when ``dense_first_n``) then ``layers``."""
    if cfg.family != "moe":
        return [("layers", cfg.n_layers)]
    n_dense = cfg.moe.dense_first_n
    return ([("dense_layers", n_dense)] if n_dense else []) \
        + [("layers", cfg.n_layers - n_dense)]


def param_specs(cfg: ModelConfig) -> List[ParamSpec]:
    """``def_lm_params`` for the dense, vlm, moe, ssm and hybrid
    families: paths, shapes and dtype overrides of the reference's
    parameter tree, layers stacked."""
    check_family(cfg)
    if cfg.family == "encdec":
        raise ValueError(f"{cfg.name}: the encdec family's specs are "
                         "models.encdec.param_specs")
    L, d = cfg.n_layers, cfg.d_model
    specs = [ParamSpec("embed/table", (cfg.vocab_size, d), scale=1.0)]
    if cfg.family == "ssm":
        specs += _ssm_layer_specs(cfg, "layers", (L,))
    elif cfg.family == "hybrid":
        h = cfg.hybrid
        specs += _ssm_layer_specs(cfg, "groups/ssm_layers",
                                  (h.n_groups, h.ssm_per_group))
        specs += _attn_block_specs(cfg, "shared", h.n_shared_blocks, 2 * d)
        specs += _ssm_layer_specs(cfg, "tail", (h.tail_ssm,))
    elif cfg.family == "moe":
        for key, n in attn_stack_sizes(cfg):
            specs += _attn_block_specs(
                cfg, key, n, d, d_ff=cfg.moe.dense_d_ff,
                moe=key == "layers")
    else:
        specs += _attn_block_specs(cfg, "layers", L, d)
    specs.append(ParamSpec("ln_final/scale", (d,), "ones"))
    if not cfg.tie_embeddings:
        specs.append(ParamSpec("lm_head/w", (d, cfg.vocab_size)))
    return specs


class Block(nn.Module):
    """One attention layer: ``_attn_layer_fwd``, its MLP ``mlp``, a SwiGLU
    of ``d_ff`` (default ``cfg.d_ff``), or with ``moe`` an ``MoEBlock``
    named ``moe``."""

    def __init__(self, cfg: ModelConfig, device=None,
                 d_ff: Optional[int] = None, moe: bool = False):
        super().__init__()
        dt = param_dtype(cfg)
        self.ln_attn = RMSNorm(cfg.d_model, cfg.norm_eps, device, dt)
        self.attn = Attention(cfg, device=device)
        self.ln_mlp = RMSNorm(cfg.d_model, cfg.norm_eps, device, dt)
        if moe:
            self.moe = MoEBlock(cfg, device)
        else:
            self.mlp = SwiGLU(cfg.d_model, d_ff or cfg.d_ff, device,
                              dtype=dt)

    def _ffn(self, h: torch.Tensor):
        """h + the MLP of rmsnorm(h) -> (h, the MoE aux loss or None)."""
        x = self.ln_mlp(h)
        if "moe" in self._modules:
            out, aux = self.moe(x)
            return h + out, aux
        return h + self.mlp(x), None

    def forward(self, h: torch.Tensor, rope: Optional[Rope] = None):
        """-> (h, (k, v) after rope, the MoE aux loss or None)."""
        a, kv = self.attn(self.ln_attn(h), rope=rope)
        h, aux = self._ffn(h + a)
        return h, kv, aux

    def decode(self, h, cache_k, cache_v, pos, rope: Optional[Rope] = None):
        h = h + self.attn.decode(self.ln_attn(h), cache_k, cache_v, pos,
                                 rope)
        return self._ffn(h)[0]


class SharedBlock(nn.Module):
    """Zamba2's shared attention + MLP block (``_shared_block_fwd``): both
    halves normalise ``concat([h, h_embed])`` (width 2 d_model) and add
    their output to h."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d2, dt = 2 * cfg.d_model, param_dtype(cfg)
        self.ln_attn = RMSNorm(d2, cfg.norm_eps, device, dt)
        self.attn = Attention(cfg, device=device, d_in=d2)
        self.ln_mlp = RMSNorm(d2, cfg.norm_eps, device, dt)
        self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, device, d_in=d2, dtype=dt)

    def _mlp(self, h: torch.Tensor, h_embed: torch.Tensor) -> torch.Tensor:
        return h + self.mlp(self.ln_mlp(torch.cat([h, h_embed], dim=-1)))

    def forward(self, h: torch.Tensor, h_embed: torch.Tensor,
                rope: Optional[Rope] = None):
        """Causal attention (rope at positions 0..S-1), then the MLP.  ->
        (h, (k, v)), k and v after rope: the site's cache rows."""
        a, kv = self.attn(self.ln_attn(torch.cat([h, h_embed], dim=-1)),
                          rope=rope)
        return self._mlp(h + a, h_embed), kv

    def decode(self, h, h_embed, cache_k, cache_v, pos,
               rope: Optional[Rope] = None):
        x2 = torch.cat([h, h_embed], dim=-1)
        h = h + self.attn.decode(self.ln_attn(x2), cache_k, cache_v, pos,
                                 rope)
        return self._mlp(h, h_embed)


class SSMLayer(nn.Module):
    """One Mamba2 layer: ``_ssm_layer_fwd``, h + ssm(rmsnorm(h))."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, cfg.norm_eps, device,
                          param_dtype(cfg))
        self.ssm = SSMBlock(cfg, device)

    def forward(self, h: torch.Tensor, return_state: bool = False):
        if return_state:
            out, state = self.ssm(self.ln(h), return_state=True)
            return h + out, state
        return h + self.ssm(self.ln(h)), None

    def decode(self, h: torch.Tensor, state) -> torch.Tensor:
        return h + self.ssm.decode(self.ln(h), state)


class LMWeights(nn.Module):
    """An LM's weights, one module per layer, loaded from the reference's
    stacked parameter paths (``load_``).  Subclasses give ``_stacks``
    and hold the token table as ``embed``."""

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def _stacks(self) -> Dict[str, tuple]:
        """Each stacked path prefix -> (the stacked axes, the modules in
        the order of the stack, flattened)."""
        raise NotImplementedError

    def sites(self, path: str) -> Tuple[Tuple[int, ...], list]:
        """Where the reference's parameter ``path`` lives in the port: (its
        stacked axes, () for an unstacked one; a list of (module,
        attribute name), one per stacked layer in the stack's order)."""
        for prefix, (lead, modules) in self._stacks().items():
            if path.startswith(prefix + "/"):
                owner, _, name = path[len(prefix) + 1:].replace(
                    "/", ".").rpartition(".")
                return lead, [(layer.get_submodule(owner), name)
                              for layer in modules]
        owner, _, name = path.replace("/", ".").rpartition(".")
        return (), [(self.get_submodule(owner), name)]

    @torch.no_grad()
    def load_(self, path: str, value: torch.Tensor) -> None:
        """Copy the parameter at reference path ``path`` (a stacked path,
        "layers/...", for the moe family also "dense_layers/...", for the
        hybrid family "groups/ssm_layers/...", "shared/..." and
        "tail/...", for the encdec family "encoder/..." and
        "decoder/...") from ``value``, cast to the parameter's dtype; a
        layer weight's copy in the activation dtype, where that differs,
        is made here, once."""
        lead, sites = self.sites(path)
        if tuple(value.shape[:len(lead)]) != lead:
            raise ValueError(f"{path}: stacked {tuple(value.shape)}, "
                             f"model has {lead} layers")
        flat = value.reshape((-1,) + tuple(value.shape[len(lead):]))
        for (module, name), v in zip(sites, flat):
            getattr(module, name).copy_(v)
            if lead and isinstance(module, CastWeights):
                module.keep_cast(name, dtype_of(self.cfg))

    @torch.no_grad()
    def refresh_casts(self) -> None:
        """Make every kept activation-dtype copy again from its weight, in
        place (``load_`` makes them; a train step's update changes the
        weights under them)."""
        dtype = dtype_of(self.cfg)
        for module in self.modules():
            if not isinstance(module, CastWeights):
                continue
            for key in list(module._buffers):
                if key.endswith("_cast"):
                    module.keep_cast(key[:-len("_cast")], dtype)


class TransformerLM(LMWeights):
    """The LM's weights (in ``cfg.param_dtype``: f32 masters by default;
    the MoE router always f32), one module per layer: ``Block``s (dense,
    vlm) or ``SSMLayer``s (ssm) in ``layers``; for the moe family ``Block``s
    with a SwiGLU of ``dense_d_ff`` in ``dense_layers`` and with an
    ``MoEBlock`` in ``layers``; for the hybrid family ``groups``
    (n_groups lists of ``SSMLayer``s), ``shared`` (``SharedBlock``s) and
    ``tail`` (``SSMLayer``s).  Built empty; ``Model.init_params`` or
    ``params.lm_from_params`` fill it through ``load_``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_family(cfg)
        if cfg.family == "encdec":
            raise ValueError(f"{cfg.name}: the encdec family's weights are "
                             "models.encdec.EncDecLM")
        self.cfg = cfg
        dt = param_dtype(cfg)
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, device, dt)

        def ssm_layers(n):
            return nn.ModuleList(SSMLayer(cfg, device) for _ in range(n))
        if cfg.family == "hybrid":
            h = cfg.hybrid
            self.groups = nn.ModuleList(ssm_layers(h.ssm_per_group)
                                        for _ in range(h.n_groups))
            self.shared = nn.ModuleList(SharedBlock(cfg, device)
                                        for _ in range(h.n_shared_blocks))
            self.tail = ssm_layers(h.tail_ssm)
        elif cfg.family == "ssm":
            self.layers = ssm_layers(cfg.n_layers)
        else:
            moe = cfg.family == "moe"
            for key, n in attn_stack_sizes(cfg):
                setattr(self, key, nn.ModuleList(
                    Block(cfg, device,
                          d_ff=cfg.moe.dense_d_ff if moe else None,
                          moe=moe and key == "layers")
                    for _ in range(n)))
        self.ln_final = RMSNorm(cfg.d_model, cfg.norm_eps, device, dt)
        self.lm_head = None if cfg.tie_embeddings else Linear(
            cfg.d_model, cfg.vocab_size, False, device, dt)

    def attn_stacks(self) -> List[Tuple[str, nn.ModuleList]]:
        """The dense and moe families' stacks of ``Block``s in order, by
        parameter and cache key (``attn_stack_sizes``)."""
        return [(key, getattr(self, key))
                for key, _ in attn_stack_sizes(self.cfg)]

    def _stacks(self) -> Dict[str, tuple]:
        if self.cfg.family == "ssm":
            return {"layers": ((len(self.layers),), list(self.layers))}
        if self.cfg.family != "hybrid":
            return {key: ((len(mods),), list(mods))
                    for key, mods in self.attn_stacks()}
        return {"groups/ssm_layers": (
                    (len(self.groups), len(self.groups[0])),
                    [layer for group in self.groups for layer in group]),
                "shared": ((len(self.shared),), list(self.shared)),
                "tail": ((len(self.tail),), list(self.tail))}

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """Final norm and the head, logits in f32 (both sides upcast)."""
        h = self.ln_final(h)
        if self.lm_head is None:
            return self.embed.unembed(h)
        return torch.matmul(h.float(), self.lm_head.w.float())


def _states(cfg: ModelConfig, lead: Tuple[int, ...], batch: int,
            device) -> Dict[str, torch.Tensor]:
    """``init_ssm_state`` stacked on the ``lead`` axes, zeros."""
    st = init_ssm_state(cfg, batch, dtype_of(cfg), device)
    return {k: torch.zeros(lead + tuple(v.shape), dtype=v.dtype,
                           device=device) for k, v in st.items()}


def _ssm_cache(cfg: ModelConfig, batch: int, device) -> Cache:
    """The ssm family's zero cache: every layer's ``init_ssm_state``
    stacked, as the reference's ``make_cache``."""
    return {"layers": _states(cfg, (cfg.n_layers,), batch, device)}


def _hybrid_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device) -> Cache:
    """The hybrid family's zero cache, as the reference's
    ``make_cache``: the groups' and the tail's SSM states and one K/V
    pair of ``max_len`` positions a shared-block site."""
    h = cfg.hybrid
    shape = kv_cache_shape(cfg, h.n_groups, batch, max_len)
    dtype = dtype_of(cfg)
    return {"groups": _states(cfg, (h.n_groups, h.ssm_per_group), batch,
                              device),
            "shared_kv": (torch.zeros(shape, dtype=dtype, device=device),
                          torch.zeros(shape, dtype=dtype, device=device)),
            "tail": _states(cfg, (h.tail_ssm,), batch, device)}


def _kv_cache(cfg: ModelConfig, batch: int, max_len: int,
              device) -> Cache:
    """The dense and moe families' zero cache: one K/V pair of
    ``max_len`` positions a stack of ``attn_stack_sizes``."""
    dtype = dtype_of(cfg)
    cache = {}
    for key, n in attn_stack_sizes(cfg):
        shape = kv_cache_shape(cfg, n, batch, max_len)
        cache[key] = (torch.zeros(shape, dtype=dtype, device=device),
                      torch.zeros(shape, dtype=dtype, device=device))
    return cache


def _put_state(stack: Dict[str, torch.Tensor], idx, state) -> None:
    for k, v in state.items():
        stack[k][idx] = v


def merge_patches(h: torch.Tensor, patch_embeds: torch.Tensor
                  ) -> torch.Tensor:
    """The vlm family's frontend merge: the (B, P, d) patch embeddings,
    cast to h's dtype, take the first P of h's S positions (the
    reference's ``concat([patch_embeds, h[:, P:]])``).  The reference's
    concat gives P positions, not S, when S < P; the port raises
    ValueError unless S > P."""
    B, S, d = h.shape
    if patch_embeds.ndim != 3 or patch_embeds.shape[0] != B \
            or patch_embeds.shape[2] != d:
        raise ValueError(f"patch_embeds {tuple(patch_embeds.shape)} for "
                         f"tokens of batch {B} at d_model {d}")
    P = patch_embeds.shape[1]
    if S <= P:
        raise ValueError(f"vlm: the longest prompt ({S} tokens) must be "
                         f"longer than the {P} patch embeddings it starts "
                         "with")
    return torch.cat([patch_embeds.to(h.dtype), h[:, P:]], dim=1)


def lm_forward(model: TransformerLM, tokens: torch.Tensor, *,
               patch_embeds: Optional[torch.Tensor] = None,
               return_cache: bool = False, cache_len: Optional[int] = None,
               logits_at: Optional[torch.Tensor] = None):
    """tokens: (B, S) -> (logits f32, aux_loss f32, cache | None);
    ``patch_embeds`` (B, P, d), the vlm family's, take the first P
    positions (``merge_patches``).

    Logits are (B, S, V), or (B, V) at one position per row when
    ``logits_at`` (B,) is given (the same numbers up to the head
    matmul's summation order, for S times less work).  With
    ``return_cache`` the cache holds every layer's K/V of the S
    positions; ``cache_len`` (>= S) allocates it that long at once,
    zeros past S, which is ``pad_cache`` without the copy.  For the ssm
    family the cache is every layer's decode state after the S tokens
    (it has no length: ``cache_len`` is not read); for the hybrid family
    the groups' and the tail's states and each shared-block site's K/V.
    The aux loss is the MoE blocks' load-balance losses summed in layer
    order (0 for the other families)."""
    cfg = model.cfg
    dtype = dtype_of(cfg)
    B, S = tokens.shape
    h = model.embed.embed(tokens, dtype)
    if patch_embeds is not None:
        h = merge_patches(h, patch_embeds)
    cache: Optional[Cache] = None
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if return_cache and cfg.family != "ssm":
        n = S if cache_len is None else cache_len
        if n < S:
            raise ValueError(f"cache_len {n} < sequence length {S}")
    if cfg.family == "ssm":
        if return_cache:
            cache = _ssm_cache(cfg, B, h.device)
        for i, layer in enumerate(model.layers):
            h, st = layer(h, return_state=return_cache)
            if cache is not None:
                _put_state(cache["layers"], i, st)
    elif cfg.family == "hybrid":
        if return_cache:
            cache = _hybrid_cache(cfg, B, n, h.device)
            ck, cv = cache["shared_kv"]
        h_embed = h
        shared = model.shared
        rope = shared[0].attn.rope(torch.arange(S, device=h.device))
        for gi, group in enumerate(model.groups):
            for li, layer in enumerate(group):
                h, st = layer(h, return_state=return_cache)
                if cache is not None:
                    _put_state(cache["groups"], (gi, li), st)
            h, (k, v) = shared[gi % len(shared)](h, h_embed, rope)
            if cache is not None:
                ck[gi, :, :S] = k
                cv[gi, :, :S] = v
        for i, layer in enumerate(model.tail):
            h, st = layer(h, return_state=return_cache)
            if cache is not None:
                _put_state(cache["tail"], i, st)
    else:
        if return_cache:
            cache = _kv_cache(cfg, B, n, h.device)
        stacks = model.attn_stacks()
        # the rope tables are the same for every layer: computed once
        rope = stacks[0][1][0].attn.rope(torch.arange(S, device=h.device))
        for key, layers in stacks:
            for i, layer in enumerate(layers):
                h, (k, v), a = layer(h, rope)
                if a is not None:
                    aux = aux + a
                if cache is not None:
                    cache[key][0][i, :, :S] = k
                    cache[key][1][i, :, :S] = v
    if logits_at is not None:
        h = h[torch.arange(B, device=h.device), logits_at]
    return model.logits(h), aux, cache


def cache_has_length(cfg: ModelConfig) -> bool:
    """Whether the decode cache holds ``max_len`` positions (a KV cache,
    which a generate past ``max_len`` overflows; for the encdec family
    its self-attention cache) rather than a state with no length
    (ssm)."""
    check_family(cfg)
    return cfg.family != "ssm"


def make_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> Cache:
    """Zero caches of ``max_len`` positions (the reference's mode
    'init'); the ssm family's states have no length.  The encdec
    family's is ``encdec.make_encdec_cache``."""
    if not cache_has_length(cfg):
        return _ssm_cache(cfg, batch, device)
    if cfg.family == "hybrid":
        return _hybrid_cache(cfg, batch, max_len, device)
    return _kv_cache(cfg, batch, max_len, device)


def pad_cache(cfg: ModelConfig, cache: Cache, max_len: int) -> Cache:
    """Grow the seq axis of every KV cache pair (captured at prefill
    length) to ``max_len`` with zeros, so decode can append.  SSM states
    are length-free: left alone; the encdec family's cross cache keeps
    its frames (the reference pads ``cache["self"]`` only)."""
    out = dict(cache)
    if not cache_has_length(cfg):
        return out
    keys = (("shared_kv",) if cfg.family == "hybrid" else
            ("self",) if cfg.family == "encdec" else
            [key for key, _ in attn_stack_sizes(cfg)])
    for key in keys:
        k, v = cache[key]
        extra = max_len - k.shape[2]
        if extra > 0:
            pad = (0, 0, 0, 0, 0, extra)      # last three axes: D, Hkv, S
            out[key] = (torch.nn.functional.pad(k, pad),
                        torch.nn.functional.pad(v, pad))
    return out


def lm_decode(model: TransformerLM, token: torch.Tensor, pos: torch.Tensor,
              cache: Cache):
    """token: (B, 1); pos: (B,) int32, the valid cache length per row
    (the new token goes at index pos; the ssm family does not read it;
    the hybrid family's shared blocks do, at every site).
    -> (logits (B, 1, V) f32, cache), the cache updated in place."""
    h = model.embed.embed(token, dtype_of(model.cfg))
    if model.cfg.family == "ssm":
        states = cache["layers"]
        for i, layer in enumerate(model.layers):
            h = layer.decode(h, {k: v[i] for k, v in states.items()})
        return model.logits(h), cache
    if model.cfg.family == "hybrid":
        h_embed = h
        shared = model.shared
        ck, cv = cache["shared_kv"]
        rope = shared[0].attn.rope(pos[:, None])
        for gi, group in enumerate(model.groups):
            for li, layer in enumerate(group):
                h = layer.decode(h, {k: v[gi, li]
                                     for k, v in cache["groups"].items()})
            h = shared[gi % len(shared)].decode(h, h_embed, ck[gi], cv[gi],
                                                pos, rope)
        for i, layer in enumerate(model.tail):
            h = layer.decode(h, {k: v[i] for k, v in cache["tail"].items()})
        return model.logits(h), cache
    stacks = model.attn_stacks()
    rope = stacks[0][1][0].attn.rope(pos[:, None])
    for key, layers in stacks:
        ck, cv = cache[key]
        for i, layer in enumerate(layers):
            h = layer.decode(h, ck[i], cv[i], pos, rope)
    return model.logits(h), cache
