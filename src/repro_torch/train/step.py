"""Train-step builder (the port's counterpart of the JAX package's
``train/step.py``): loss -> grads -> clip -> (optional transform) ->
AdamW, with microbatch gradient accumulation.

``TrainStep(params, batch)`` runs one step on the weights module
``params`` (``models.model.Model.init_params`` or
``params.lm_from_params``) with the port's ``optim.AdamW`` built over
its parameters, and returns the reference's metrics.

Accumulation: the batch is split into ``accum`` microbatches along the
batch axis and run one after another; their gradients are summed in f32
(from zero, in microbatch order) and scaled by 1 / accum, as are their
losses.  Activation memory scales with batch / accum, while the
gradients are one f32 set (two while accumulating).

One difference from the reference, on purpose: the update happens IN
PLACE on the weights module (and the optimizer's own state), where the
reference returns new parameters and a new optimizer state.  After the
update every kept activation-dtype copy of a weight is made again
(``LMWeights.refresh_casts``), so serving after a step reads the new
weights.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.models.model import Model, lm_param_specs
from repro_torch.models.transformer import LMWeights
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.clip import clip_by_global_norm


class _Loss(nn.Module):
    """``Model.loss`` as a module call over the weights, so
    ``torch.func.functional_call`` can stand cast tensors in for the
    masters (parameter names are the weights' own under ``w.``)."""

    def __init__(self, model: Model, weights: LMWeights):
        super().__init__()
        self.model = model
        self.w = weights

    def forward(self, batch):
        return self.model.loss(self.w, batch)


@dataclasses.dataclass(frozen=True)
class TrainStep:
    model: Model
    optimizer: AdamW
    accum: int = 1
    max_grad_norm: float = 1.0
    grad_transform: Optional[Callable[[Dict], Dict]] = None
    # cast f32 master weights to bf16 ONCE at step entry (per microbatch),
    # in the graph: gradients flow back through the cast and reach the
    # masters in f32.  Which leaves are cast follows the reference's tree,
    # whose layer parameters are stacked: a leaf of two or more axes
    # there (a layer's norm scale is one, stacked (L, d)).
    cast_bf16: bool = False

    def _params(self) -> List[nn.Parameter]:
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def _sites(self, weights: LMWeights):
        """(reference spec, [(module, name)] per stacked layer) for every
        leaf of the reference's tree."""
        return [(spec, weights.sites(spec.path)[1])
                for spec in lm_param_specs(weights.cfg)]

    def _casts(self, weights: LMWeights) -> Dict[str, torch.Tensor]:
        """The ``functional_call`` stand-ins of ``cast_bf16``: each f32
        master whose reference leaf has two or more axes, cast to bf16
        (a graph node over the master)."""
        if not self.cast_bf16:
            return {}
        ndim = {}
        for spec, sites in self._sites(weights):
            for module, name in sites:
                ndim[id(getattr(module, name))] = len(spec.shape)
        return {f"w.{name}": p.to(torch.bfloat16)
                for name, p in weights.named_parameters()
                if p.dtype == torch.float32 and ndim.get(id(p), 0) >= 2}

    def _microbatch(self, batch: Dict[str, Any]) -> List[Dict[str, Any]]:
        n = self.accum

        def split(x, i):
            b = x.shape[0]
            assert b % n == 0, (b, n)
            return x[i * (b // n):(i + 1) * (b // n)]
        return [{k: split(v, i) for k, v in batch.items()} for i in range(n)]

    def grads(self, params: LMWeights, batch: Dict[str, Any]
              ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
        """-> (the gradients, one f32 tensor a parameter in the
        optimizer's order, the metrics); the reference's ``grads``."""
        ps = self._params()
        for p in ps:
            p.requires_grad_(True)
        loss_call = _Loss(self.model, params)

        def loss_and_grad(b):
            with torch.enable_grad():
                loss, metrics = torch.func.functional_call(
                    loss_call, self._casts(params), (b,))
                g = torch.autograd.grad(loss, ps, allow_unused=True)
            g = [torch.zeros_like(p, dtype=torch.float32) if x is None
                 else x.float() for x, p in zip(g, ps)]
            metrics = {k: v.detach() for k, v in metrics.items()}
            return loss.detach(), metrics, g
        if self.accum <= 1:
            loss, metrics, g = loss_and_grad(batch)
            return g, {"loss": loss, **metrics}
        g_acc = loss_acc = None
        for mb in self._microbatch(batch):
            loss, _, g = loss_and_grad(mb)
            if g_acc is None:
                g_acc, loss_acc = g, loss
            else:
                for a, x in zip(g_acc, g):
                    a.add_(x)
                loss_acc = loss_acc + loss
            del g
        scale = 1.0 / self.accum
        return [x * scale for x in g_acc], {"loss": loss_acc * scale}

    def _transform(self, params: LMWeights, g: List[torch.Tensor]
                   ) -> List[torch.Tensor]:
        """``grad_transform`` over the gradients in the reference's
        layout (nested dicts, layers stacked), split back per parameter."""
        index = {id(p): i for i, p in enumerate(self._params())}
        tree: Dict = {}
        for spec, sites in self._sites(params):
            node = tree
            *heads, last = spec.path.split("/")
            for part in heads:
                node = node.setdefault(part, {})
            node[last] = torch.stack(
                [g[index[id(getattr(m, n))]] for m, n in sites]
            ).reshape(spec.shape)
        tree = self.grad_transform(tree)
        out = list(g)
        for spec, sites in self._sites(params):
            node = tree
            for part in spec.path.split("/"):
                node = node[part]
            flat = node.reshape((len(sites),) + tuple(
                getattr(*sites[0]).shape))
            for (m, n), x in zip(sites, flat):
                out[index[id(getattr(m, n))]] = x
        return out

    def __call__(self, params: LMWeights, batch: Dict[str, Any]
                 ) -> Dict[str, torch.Tensor]:
        """One step, in place on ``params`` -> metrics: ``loss`` (and
        ``ce``, ``aux``, ``tokens`` when ``accum`` is 1) and
        ``grad_norm``, the global norm before clipping."""
        g, metrics = self.grads(params, batch)
        g, gnorm = clip_by_global_norm(g, self.max_grad_norm)
        if self.grad_transform is not None:
            g = self._transform(params, g)
        self.optimizer.step(grads=g)
        del g
        params.refresh_casts()
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        return metrics


def build_train_step(model: Model, optimizer: AdamW, *, accum: int = 1,
                     max_grad_norm: float = 1.0, grad_transform=None,
                     cast_bf16: bool = False) -> TrainStep:
    return TrainStep(model, optimizer, accum, max_grad_norm,
                     grad_transform, cast_bf16)
