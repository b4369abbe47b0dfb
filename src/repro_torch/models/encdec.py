"""Encoder-decoder transformer, Whisper's backbone (the port's counterpart
of the JAX package's ``models/encdec.py``).

The audio conv frontend is a stub, as in the reference: the batch key
``audio_embeds`` supplies precomputed frame embeddings (B, F, d_model).
The encoder adds sinusoidal positions and runs bidirectional attention;
the decoder adds a learned position table (``dec_pos``, ``MAX_DEC_POS``
rows), runs causal self-attention and cross-attention to the encoder
output.  Norms are LayerNorms (pre-norm), MLPs tanh-GELU, no attention
uses rope, and the unembedding is the tied token table, in f32.

Parameters keep the reference's tree paths: ``embed/table``,
``dec_pos``, ``encoder/...`` (stacked on ``n_encoder_layers``),
``decoder/...`` (stacked on ``n_layers``), ``ln_enc_final`` and
``ln_final``.  The cache is the reference's: ``{"self": (k, v),
"cross": (k, v)}``, each (L, B, S, Hkv, D) in the activation dtype; the
self cache holds ``cache_len`` positions (the prefill writes it at
``max_len`` at once), the cross cache the F encoder frames, projected
once at the prefill and only read by decode (every row's ``kv_len`` is
F).  The reference's prefill with cache capture and its forward without
run the decoder's self-attention by two routes that give the same
numbers; the port has one.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import Attention, kv_cache_shape
from repro_torch.models.common import ParamSpec, param_dtype
from repro_torch.models.layers import (Embedding, GeluMLP, LayerNorm,
                                      empty_param, sinusoidal_positions)
from repro_torch.models.transformer import Cache, LMWeights, dtype_of

MAX_DEC_POS = 32_768   # rows of the learned decoder position table


def _ln_specs(path: str, lead: Tuple[int, ...], d: int) -> List[ParamSpec]:
    return [ParamSpec(f"{path}/scale", lead + (d,), "ones"),
            ParamSpec(f"{path}/bias", lead + (d,), "zeros")]


def _attn_specs(cfg: ModelConfig, path: str, n: int) -> List[ParamSpec]:
    """``def_attention`` under ``path``, stacked on ``(n,)``."""
    d, q, kv = cfg.d_model, cfg.q_dim, cfg.kv_dim
    specs = []
    for name, d_out in (("wq", q), ("wk", kv), ("wv", kv)):
        specs.append(ParamSpec(f"{path}/{name}/w", (n, d, d_out)))
        if cfg.qkv_bias:
            specs.append(ParamSpec(f"{path}/{name}/b", (n, d_out),
                                   "zeros"))
    return specs + [ParamSpec(f"{path}/wo/w", (n, q, d))]


def _mlp_specs(cfg: ModelConfig, path: str, n: int) -> List[ParamSpec]:
    """``def_mlp_gelu`` under ``path``, stacked on ``(n,)``."""
    d, f = cfg.d_model, cfg.d_ff
    return [ParamSpec(f"{path}/w_in", (n, d, f)),
            ParamSpec(f"{path}/b_in", (n, f), "zeros"),
            ParamSpec(f"{path}/w_out", (n, f, d)),
            ParamSpec(f"{path}/b_out", (n, d), "zeros")]


def param_specs(cfg: ModelConfig) -> List[ParamSpec]:
    """``def_encdec_params``: paths and shapes of the reference's tree,
    layers stacked."""
    d, n_enc, n_dec = cfg.d_model, cfg.n_encoder_layers, cfg.n_layers
    specs = [ParamSpec("embed/table", (cfg.vocab_size, d), scale=1.0),
             ParamSpec("dec_pos", (MAX_DEC_POS, d), scale=0.01)]
    specs += _ln_specs("encoder/ln_attn", (n_enc,), d)
    specs += _attn_specs(cfg, "encoder/attn", n_enc)
    specs += _ln_specs("encoder/ln_mlp", (n_enc,), d)
    specs += _mlp_specs(cfg, "encoder/mlp", n_enc)
    for ln, attn in (("ln_self", "self_attn"), ("ln_cross", "cross_attn")):
        specs += _ln_specs(f"decoder/{ln}", (n_dec,), d)
        specs += _attn_specs(cfg, f"decoder/{attn}", n_dec)
    specs += _ln_specs("decoder/ln_mlp", (n_dec,), d)
    specs += _mlp_specs(cfg, "decoder/mlp", n_dec)
    return specs + _ln_specs("ln_enc_final", (), d) \
        + _ln_specs("ln_final", (), d)


class EncoderLayer(nn.Module):
    """``encode``'s scan body: bidirectional attention, then the GELU
    MLP, each on a LayerNorm of h and added to it."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = param_dtype(cfg)
        self.ln_attn = LayerNorm(cfg.d_model, cfg.norm_eps, device, dt)
        self.attn = Attention(cfg, device=device, use_rope=False)
        self.ln_mlp = LayerNorm(cfg.d_model, cfg.norm_eps, device, dt)
        self.mlp = GeluMLP(cfg.d_model, cfg.d_ff, device, dt)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = h + self.attn(self.ln_attn(h), causal=False)[0]
        return h + self.mlp(self.ln_mlp(h))


class DecoderLayer(nn.Module):
    """``_dec_layer_full``: causal self-attention, cross-attention to the
    encoder output, the GELU MLP, each on a LayerNorm of h."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = param_dtype(cfg)
        d, eps = cfg.d_model, cfg.norm_eps
        self.ln_self = LayerNorm(d, eps, device, dt)
        self.self_attn = Attention(cfg, device=device, use_rope=False)
        self.ln_cross = LayerNorm(d, eps, device, dt)
        self.cross_attn = Attention(cfg, device=device, use_rope=False)
        self.ln_mlp = LayerNorm(d, eps, device, dt)
        self.mlp = GeluMLP(d, cfg.d_ff, device, dt)

    def forward(self, h: torch.Tensor, cross_kv: Tuple):
        """h (B, S, d); ``cross_kv``: this layer's (k, v) of the encoder
        output.  -> (h, (k, v) of the self-attention: the prefill's
        cache rows)."""
        a, kv = self.self_attn(self.ln_self(h), causal=True)
        h = h + a
        h = h + self.cross_attn(self.ln_cross(h), causal=False,
                                kv=cross_kv)[0]
        return h + self.mlp(self.ln_mlp(h)), kv

    def decode(self, h, self_k, self_v, pos, cross_k, cross_v, n_frames):
        """One token: self-attention writes its K/V at ``pos`` and reads
        ``pos + 1`` keys; cross-attention reads ``n_frames`` (B,) keys."""
        h = h + self.self_attn.decode(self.ln_self(h), self_k, self_v, pos)
        h = h + self.cross_attn.decode_cross(self.ln_cross(h), cross_k,
                                             cross_v, n_frames)
        return h + self.mlp(self.ln_mlp(h))


class EncDecLM(LMWeights):
    """The encoder-decoder's weights (in ``cfg.param_dtype``), one module
    per layer: ``encoder`` (``EncoderLayer``s) and ``decoder``
    (``DecoderLayer``s).  Built empty; ``Model.init_params`` or
    ``params.lm_from_params`` fill it through ``load_``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.name}: family {cfg.family!r} is not "
                             "encdec")
        self.cfg = cfg
        dt = param_dtype(cfg)
        d = cfg.d_model
        self.embed = Embedding(cfg.vocab_size, d, device, dt)
        self.dec_pos = empty_param((MAX_DEC_POS, d), device, dt)
        self.encoder = nn.ModuleList(EncoderLayer(cfg, device)
                                     for _ in range(cfg.n_encoder_layers))
        self.decoder = nn.ModuleList(DecoderLayer(cfg, device)
                                     for _ in range(cfg.n_layers))
        self.ln_enc_final = LayerNorm(d, cfg.norm_eps, device, dt)
        self.ln_final = LayerNorm(d, cfg.norm_eps, device, dt)

    def _stacks(self) -> Dict[str, tuple]:
        return {"encoder": ((len(self.encoder),), list(self.encoder)),
                "decoder": ((len(self.decoder),), list(self.decoder))}

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """Final LayerNorm and the tied unembedding, logits in f32."""
        return self.embed.unembed(self.ln_final(h))


def encode(model: EncDecLM, audio_embeds: torch.Tensor) -> torch.Tensor:
    """``encode``: audio_embeds (B, F, d) -> the encoder output (B, F, d)
    in the activation dtype."""
    cfg = model.cfg
    dtype = dtype_of(cfg)
    if audio_embeds.ndim != 3 or audio_embeds.shape[2] != cfg.d_model:
        raise ValueError(f"audio_embeds {tuple(audio_embeds.shape)}: "
                         f"expected (B, frames, {cfg.d_model})")
    F = audio_embeds.shape[1]
    h = audio_embeds.to(dtype)
    h = h + sinusoidal_positions(F, cfg.d_model, h.device).to(dtype)[None]
    for layer in model.encoder:
        h = layer(h)
    return model.ln_enc_final(h)


def make_encdec_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device: torch.device) -> Cache:
    """Zero caches, as the reference's mode 'init': the self cache of
    ``max_len`` positions, the cross cache of the config's F frames."""
    dtype = dtype_of(cfg)

    def pair(n):
        shape = kv_cache_shape(cfg, cfg.n_layers, batch, n)
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))
    return {"self": pair(max_len), "cross": pair(cfg.frontend.n_embeds)}


def encdec_forward(model: EncDecLM, audio_embeds: torch.Tensor,
                   tokens: torch.Tensor, *, return_cache: bool = False,
                   cache_len: Optional[int] = None,
                   logits_at: Optional[torch.Tensor] = None):
    """audio_embeds (B, F, d), tokens (B, S) -> (logits f32, aux 0,
    cache | None).  Logits are (B, S, V), or (B, V) at ``logits_at``
    (B,).  With ``return_cache``: the self cache holds every decoder
    layer's K/V of the S positions, allocated ``cache_len`` (>= S) long,
    zeros past S; the cross cache every layer's K/V of the F frames."""
    cfg = model.cfg
    dtype = dtype_of(cfg)
    B, S = tokens.shape
    if S > MAX_DEC_POS:
        raise ValueError(f"{S} tokens: the decoder's position table has "
                         f"{MAX_DEC_POS} rows")
    if audio_embeds.shape[0] != B:
        raise ValueError(f"audio_embeds of batch {audio_embeds.shape[0]} "
                         f"for tokens of batch {B}")
    enc = encode(model, audio_embeds)
    h = model.embed.embed(tokens, dtype) + model.dec_pos[:S].to(dtype)[None]
    cache: Optional[Cache] = None
    if return_cache:
        n = S if cache_len is None else cache_len
        if n < S:
            raise ValueError(f"cache_len {n} < sequence length {S}")
        sk = torch.zeros(kv_cache_shape(cfg, cfg.n_layers, B, n),
                         dtype=dtype, device=h.device)
        ck = torch.empty(kv_cache_shape(cfg, cfg.n_layers, B, enc.shape[1]),
                         dtype=dtype, device=h.device)
        sv, cv = torch.zeros_like(sk), torch.empty_like(ck)
        cache = {"self": (sk, sv), "cross": (ck, cv)}
    for i, layer in enumerate(model.decoder):
        kv = layer.cross_attn.cross_kv(enc)
        if cache is not None:
            ck[i], cv[i] = kv
        h, (k, v) = layer(h, kv)
        if cache is not None:
            sk[i, :, :S] = k
            sv[i, :, :S] = v
    if logits_at is not None:
        h = h[torch.arange(B, device=h.device), logits_at]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return model.logits(h), aux, cache


def encdec_decode(model: EncDecLM, token: torch.Tensor, pos: torch.Tensor,
                  cache: Cache):
    """``encdec_decode``: token (B, 1); pos (B,) int32, the valid self
    cache length per row (the new token's K/V go at index pos, and it
    takes ``dec_pos[pos]``).  -> (logits (B, 1, V) f32, cache), the self
    cache updated in place, the cross cache read only."""
    dtype = dtype_of(model.cfg)
    B = token.shape[0]
    h = model.embed.embed(token, dtype) + model.dec_pos[pos][:, None].to(dtype)
    sk, sv = cache["self"]
    ck, cv = cache["cross"]
    n_frames = torch.full((B,), ck.shape[2], dtype=torch.int32,
                          device=h.device)
    for i, layer in enumerate(model.decoder):
        h = layer.decode(h, sk[i], sv[i], pos, ck[i], cv[i], n_frames)
    return model.logits(h), cache
