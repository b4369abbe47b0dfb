"""Parameter specs and name-seeded init (the port's counterpart of the
JAX package's ``models/common.py`` ``ParamBuilder`` / ``build``).

A model declares its parameters as ``ParamSpec``s: a '/'-joined path as
in the reference's parameter tree ("layers/attn/wq/w"), the shape with
the leading ``(n_layers,)`` axis of stacked layer parameters, and the
init, and the dtype the parameter is held in when it is not the
config's ``param_dtype`` (the MoE router is always f32).  ``init_tensor``
draws one parameter from a ``torch.Generator``
seeded by ``name_seed(path, seed)`` (sha256 of "seed:path", as the
reference's ``_name_seed``), so the init is order-independent and
restart-stable, with the reference's scales: normal times
1/sqrt(fan_in) (fan_in = shape[-2]), or an explicit scale (1.0 for the
embedding), ones, zeros, and the two inits of the SSM block: ``ssm_a``
(``A_log`` = log U[1, 16]) and ``ssm_dt`` (``dt_bias``, the inverse
softplus of U[1e-3, 1e-1]), in f32, then casts it to its dtype, as the
reference's ``ParamBuilder.param`` does.  torch's generator is not
JAX's: the same seed gives other numbers than the reference's
``init_params``, so the tests carry the reference's weights over with
``params.lm_from_params``.

The reference's sharding hooks (``shard``, ``sharding_ctx``) are no-ops
without a mesh and have no counterpart here.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class ParamSpec:
    path: str
    shape: Tuple[int, ...]
    init: str = "normal"            # normal | zeros | ones | ssm_a | ssm_dt
    scale: Optional[float] = None   # normal only; default 1/sqrt(fan_in)
    dtype: Optional[str] = None     # None: the config's param_dtype

    @property
    def numel(self) -> int:
        return math.prod(self.shape)

    def torch_dtype(self, param_dtype: str) -> torch.dtype:
        """The dtype the parameter is held in: its own, else
        ``param_dtype`` (a config's, e.g. "bfloat16")."""
        return getattr(torch, self.dtype or param_dtype)


def param_dtype(cfg) -> torch.dtype:
    """The dtype a model's parameters are held in: ``cfg.param_dtype``."""
    return getattr(torch, cfg.param_dtype)


def name_seed(name: str, base_seed: int) -> int:
    h = hashlib.sha256(f"{base_seed}:{name}".encode()).digest()
    return int.from_bytes(h[:8], "little") % (2**63 - 1)


def init_tensor(spec: ParamSpec, seed: int, device: torch.device,
                param_dtype: str = "float32") -> torch.Tensor:
    """One parameter drawn as ``spec`` says, on ``device``: drawn in f32,
    then cast to ``spec.torch_dtype(param_dtype)`` (the f32 draw is not
    kept)."""
    return _draw_f32(spec, seed, device).to(spec.torch_dtype(param_dtype))


def _draw_f32(spec: ParamSpec, seed: int, device: torch.device
              ) -> torch.Tensor:
    shape = spec.shape
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=torch.float32, device=device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=torch.float32, device=device)
    if spec.init not in ("normal", "ssm_a", "ssm_dt"):
        raise ValueError(f"unknown init {spec.init!r}")
    gen = torch.Generator(device=device)
    gen.manual_seed(name_seed(spec.path, seed))
    if spec.init != "normal":
        u = torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=device)
        if spec.init == "ssm_a":             # log(U[1, 16])
            return torch.log(u.mul_(15.0).add_(1.0))
        u = u.mul_(1e-1 - 1e-3).add_(1e-3)  # U[1e-3, 1e-1]
        return u + torch.log(-torch.expm1(-u))
    fan_in = shape[-2] if len(shape) >= 2 else max(shape[-1], 1)
    s = spec.scale if spec.scale is not None else 1.0 / math.sqrt(fan_in)
    out = torch.randn(shape, generator=gen, dtype=torch.float32,
                      device=device)
    return out.mul_(s)
