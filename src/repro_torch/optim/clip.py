"""Global-norm gradient clipping over a nested dict / list / tuple of
tensors (the port of the JAX package's ``repro.optim.clip``)."""
from __future__ import annotations

from typing import Any, Callable, List

import torch


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _map(fn: Callable[[torch.Tensor], Any], tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for x in _leaves(tree)]
    return torch.sqrt(sum(leaves))


def clip_by_global_norm(tree, max_norm: float):
    """-> (tree scaled so its global norm is at most ``max_norm``, the
    norm before scaling)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return _map(lambda x: (x * scale).to(x.dtype), tree), norm
