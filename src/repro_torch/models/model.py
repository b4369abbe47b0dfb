"""The Model API (the port's counterpart of the JAX package's
``models/model.py``), every LM family: dense, vlm, moe, ssm, hybrid
and encdec.

``build_model(cfg)`` returns a ``Model`` exposing:

  init_params(seed, device=)  -> the weights module (in the config's
                                 param_dtype: f32 masters by default)
  param_specs() / param_count()
  forward(params, batch, return_cache=)  -> (logits, aux, cache | None)
  loss(params, batch)                    -> (scalar f32, metrics dict)
  prefill(params, batch, max_len=)       -> (logits_last (B, V), cache)
  decode_step(params, token, pos, cache) -> (logits (B, V), cache)
  make_cache(batch, max_len, device=)    -> cache

Where the reference passes a parameter pytree, the port passes the
module that holds the weights (``TransformerLM``; for the encdec
family ``encdec.EncDecLM``).  Batches are dicts: every family reads
``tokens``, the vlm family also ``patch_embeds`` (optional, as the
reference's ``batch.get``) and the encdec family ``audio_embeds``
(required); each as a numpy array or a tensor, moved to the weights'
device; ``loss`` also reads ``loss_mask``.  A key the family does not
read raises ValueError.

``forward``, ``prefill`` and ``decode_step`` run under
``torch.inference_mode`` (serving); ``loss`` runs the same forward with
grad mode as the caller has it, so ``loss.backward()`` (or
``train.TrainStep``) reaches every weight that asks for a gradient.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import Device, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.common import init_tensor
from repro_torch.models.transformer import LMWeights

# the frontend embeddings each family reads beside ``tokens``
FRONTEND_KEYS = {"vlm": "patch_embeds", "encdec": "audio_embeds"}


def _tokens(batch: Dict[str, Any], device: torch.device) -> torch.Tensor:
    toks = batch["tokens"]
    if isinstance(toks, torch.Tensor):
        return toks.to(device)
    return torch.as_tensor(np.asarray(toks, np.int64), device=device)


def _embeds(x, device: torch.device) -> torch.Tensor:
    """Frontend embeddings as a tensor on ``device`` (numpy arrays as
    f32; the model casts them to its activation dtype)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.asarray(x, np.float32)).to(device)


def lm_param_specs(cfg: ModelConfig):
    """The parameter specs of any LM family."""
    tf_mod.check_family(cfg)
    if cfg.family == "encdec":
        return encdec_mod.param_specs(cfg)
    return tf_mod.param_specs(cfg)


def new_lm(cfg: ModelConfig, device: torch.device) -> LMWeights:
    """The empty weights module of any LM family on ``device``."""
    tf_mod.check_family(cfg)
    if cfg.family == "encdec":
        return encdec_mod.EncDecLM(cfg, device)
    return tf_mod.TransformerLM(cfg, device)


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def param_specs(self):
        return lm_param_specs(self.cfg)

    def param_count(self) -> int:
        return sum(s.numel for s in self.param_specs())

    @property
    def cache_has_length(self) -> bool:
        """True for a KV cache of ``max_len`` positions; False for a
        state with no length, which decodes past ``max_len``."""
        return tf_mod.cache_has_length(self.cfg)

    def init_params(self, seed: int = 0, device: Device = "cuda"
                    ) -> LMWeights:
        """Weights drawn by name from ``seed`` (``models.common``), on
        ``device``: the port's own init, not the reference's numbers.
        Each is drawn in f32 and held in its spec's dtype or the config's
        ``param_dtype``; one parameter's f32 draw lives at a time."""
        dev = resolve_device(device)
        model = new_lm(self.cfg, dev)
        for spec in self.param_specs():
            model.load_(spec.path, init_tensor(spec, seed, dev,
                                               self.cfg.param_dtype))
        return model.eval()

    def _check_keys(self, batch: Dict[str, Any], extra=()) -> None:
        frontend = FRONTEND_KEYS.get(self.cfg.family)
        unread = set(batch) - {"tokens", frontend, *extra}
        if unread:
            raise ValueError(f"batch keys {sorted(unread)}: the "
                             f"{self.cfg.family} family reads tokens"
                             + (f" and {frontend}" if frontend else "")
                             + (", and loss reads loss_mask" if extra
                                else ""))

    def _run(self, params: LMWeights, batch: Dict[str, Any],
             return_cache: bool = False, cache_len: Optional[int] = None,
             logits_at=None):
        """The forward of any family, in the caller's grad mode."""
        cfg = self.cfg
        frontend = FRONTEND_KEYS.get(cfg.family)
        dev = params.device
        toks = _tokens(batch, dev)
        if logits_at is not None:
            logits_at = torch.as_tensor(logits_at, device=dev)
        embeds = batch.get(frontend) if frontend else None
        if embeds is not None:
            embeds = _embeds(embeds, dev)
        if cfg.family == "encdec":
            if embeds is None:
                raise ValueError("the encdec family needs audio_embeds")
            return encdec_mod.encdec_forward(
                params, embeds, toks, return_cache=return_cache,
                cache_len=cache_len, logits_at=logits_at)
        return tf_mod.lm_forward(params, toks, patch_embeds=embeds,
                                 return_cache=return_cache,
                                 cache_len=cache_len, logits_at=logits_at)

    def forward(self, params: LMWeights, batch: Dict[str, Any],
                return_cache: bool = False, cache_len: Optional[int] = None,
                logits_at=None):
        self._check_keys(batch)
        with torch.inference_mode():
            return self._run(params, batch, return_cache=return_cache,
                             cache_len=cache_len, logits_at=logits_at)

    def loss(self, params: LMWeights, batch: Dict[str, Any]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``Model.loss``: next-token cross-entropy over an f32
        ``log_softmax`` of ``logits[:, :-1]``, weighed by ``loss_mask``
        shifted by one (default all ones) over max(sum of the mask, 1);
        the moe family adds ``aux_loss_coef`` times the load-balance
        loss.  -> (total, {"ce", "aux", "tokens"}), all f32 scalars, in
        the caller's grad mode."""
        self._check_keys(batch, ("loss_mask",))
        logits, aux, _ = self._run(params, batch)
        tokens = _tokens(batch, params.device)
        targets = tokens[:, 1:]
        lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        nll = -lp.gather(-1, targets[..., None])[..., 0]
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones(targets.shape, dtype=torch.float32,
                              device=nll.device)
        else:
            mask = torch.as_tensor(mask, device=nll.device)[:, 1:].float()
        denom = torch.clamp(mask.sum(), min=1.0)
        ce = (nll * mask).sum() / denom
        total = ce + self.cfg.moe.aux_loss_coef * aux \
            if self.cfg.moe.enabled else ce
        return total, {"ce": ce, "aux": aux, "tokens": mask.sum()}

    def prefill(self, params: LMWeights, batch: Dict[str, Any],
                max_len: Optional[int] = None):
        """Logits at the last (padded) position and the cache, grown to
        ``max_len`` when given (a KV cache; SSM states have no length)."""
        S = _tokens(batch, params.device).shape[1]
        last = torch.full((len(batch["tokens"]),), S - 1)
        logits, _, cache = self.forward(
            params, batch, return_cache=True,
            cache_len=max(S, max_len or 0), logits_at=last)
        return logits, cache

    def decode_step(self, params: LMWeights, token, pos, cache):
        """token: (B, 1); pos: (B,) int32 on the params' device (not
        read by the ssm family; the hybrid family's attention sites read
        it; the encdec family's self-attention).  The cache is updated in
        place and returned."""
        with torch.inference_mode():
            if self.cfg.family == "encdec":
                logits, cache = encdec_mod.encdec_decode(params, token, pos,
                                                         cache)
            else:
                logits, cache = tf_mod.lm_decode(params, token, pos, cache)
        return logits[:, 0], cache

    def make_cache(self, batch: int, max_len: int, device: Device = "cuda"):
        dev = resolve_device(device)
        if self.cfg.family == "encdec":
            return encdec_mod.make_encdec_cache(self.cfg, batch, max_len,
                                                dev)
        return tf_mod.make_cache(self.cfg, batch, max_len, dev)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "pipeline":
        raise ValueError(
            "multiscope pipeline is built via repro_torch.core.pipeline, "
            "not build_model")
    tf_mod.check_family(cfg)
    return Model(cfg)
