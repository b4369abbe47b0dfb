"""The Model API (the port's counterpart of the JAX package's
``models/model.py``), dense, moe, ssm and hybrid families.

``build_model(cfg)`` returns a ``Model`` exposing:

  init_params(seed, device=)  -> TransformerLM (weights in the config's
                                 param_dtype: f32 masters by default)
  param_specs() / param_count()
  forward(params, batch, return_cache=)  -> (logits, aux, cache | None)
  prefill(params, batch, max_len=)       -> (logits_last (B, V), cache)
  decode_step(params, token, pos, cache) -> (logits (B, V), cache)
  make_cache(batch, max_len, device=)    -> cache

Where the reference passes a parameter pytree, the port passes the
``TransformerLM`` module that holds the weights.  ``loss`` (training)
is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import Device, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf_mod
from repro_torch.models.common import init_tensor
from repro_torch.models.transformer import TransformerLM


def _tokens(batch: Dict[str, Any], device: torch.device) -> torch.Tensor:
    toks = batch["tokens"]
    if isinstance(toks, torch.Tensor):
        return toks.to(device)
    return torch.as_tensor(np.asarray(toks, np.int64), device=device)


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def param_specs(self):
        return tf_mod.param_specs(self.cfg)

    def param_count(self) -> int:
        return sum(s.numel for s in self.param_specs())

    @property
    def cache_has_length(self) -> bool:
        """True for a KV cache of ``max_len`` positions; False for a
        state with no length, which decodes past ``max_len``."""
        return tf_mod.cache_has_length(self.cfg)

    def init_params(self, seed: int = 0, device: Device = "cuda"
                    ) -> TransformerLM:
        """Weights drawn by name from ``seed`` (``models.common``), on
        ``device``: the port's own init, not the reference's numbers.
        Each is drawn in f32 and held in its spec's dtype or the config's
        ``param_dtype``; one parameter's f32 draw lives at a time."""
        dev = resolve_device(device)
        model = TransformerLM(self.cfg, dev)
        for spec in self.param_specs():
            model.load_(spec.path, init_tensor(spec, seed, dev,
                                               self.cfg.param_dtype))
        return model.eval()

    def forward(self, params: TransformerLM, batch: Dict[str, Any],
                return_cache: bool = False, cache_len: Optional[int] = None,
                logits_at=None):
        if set(batch) - {"tokens"}:
            raise NotImplementedError(
                f"batch keys {sorted(set(batch) - {'tokens'})}: frontend "
                "embeddings belong to families not ported yet")
        toks = _tokens(batch, params.device)
        if logits_at is not None:
            logits_at = torch.as_tensor(logits_at, device=params.device)
        with torch.inference_mode():
            return tf_mod.lm_forward(params, toks, return_cache=return_cache,
                                     cache_len=cache_len,
                                     logits_at=logits_at)

    def prefill(self, params: TransformerLM, batch: Dict[str, Any],
                max_len: Optional[int] = None):
        """Logits at the last (padded) position and the cache, grown to
        ``max_len`` when given (a KV cache; SSM states have no length)."""
        S = _tokens(batch, params.device).shape[1]
        last = torch.full((len(batch["tokens"]),), S - 1)
        logits, _, cache = self.forward(
            params, batch, return_cache=True,
            cache_len=max(S, max_len or 0), logits_at=last)
        return logits, cache

    def decode_step(self, params: TransformerLM, token, pos, cache):
        """token: (B, 1); pos: (B,) int32 on the params' device (not
        read by the ssm family; the hybrid family's attention sites read
        it).  The cache is updated in place and returned."""
        with torch.inference_mode():
            logits, cache = tf_mod.lm_decode(params, token, pos, cache)
        return logits[:, 0], cache

    def make_cache(self, batch: int, max_len: int, device: Device = "cuda"):
        return tf_mod.make_cache(self.cfg, batch, max_len,
                                 resolve_device(device))


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "pipeline":
        raise ValueError(
            "multiscope pipeline is built via repro_torch.core.pipeline, "
            "not build_model")
    tf_mod.check_family(cfg)
    return Model(cfg)
