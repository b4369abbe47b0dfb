"""AdamW with fp32 master weights and an optional 8-bit second moment.

The port of the JAX package's ``repro.optim.adamw`` as a
``torch.optim.Optimizer``: the same update, step for step.

  * bias corrections ``1 - b1**step`` and ``1 - b2**step`` in float32 at
    the 1-based step;
  * ``eps`` outside the square root: ``mhat / (sqrt(vhat) + eps)``;
  * decoupled decay added to the step before the learning rate scales
    it: ``p - lr * (mhat / (sqrt(vhat) + eps) + weight_decay * p)``;
  * ``lr`` a float or a callable of the step (``optim.schedules``).

Its defaults are the reference's (b2 0.95, weight decay 0.1), not
``torch.optim.AdamW``'s.  A parameter whose ``grad`` is None is updated
as with a zero gradient, as the reference updates every leaf.
``step(grads=...)`` takes the gradients as a list, one a parameter in
``param_groups`` order, in place of each ``.grad`` (the train step's f32
gradients: a ``.grad`` is held in its parameter's dtype).

With ``quantize_v`` the second moment is held as int8 with a float32
absmax scale per row of the last axis, dequantized for each update.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Union

import torch


def _quantize_v(v: torch.Tensor):
    """fp32 -> (int8, fp32 row scale).  v >= 0 (second moment)."""
    if v.ndim == 0:
        scale = torch.clamp(v, min=1e-30)
        return (v / scale * 127).to(torch.int8), scale
    amax = torch.amax(v, dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-30)
    q = torch.round(v / scale * 127).to(torch.int8)
    return q, scale


def _dequantize_v(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale / 127.0


class AdamWState(NamedTuple):
    step: int
    m: List[torch.Tensor]
    v: List            # fp32 tensors, or (int8, scale) pairs when quantized


class AdamW(torch.optim.Optimizer):
    def __init__(self, params, lr: Union[Callable, float] = 1e-3,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, quantize_v: bool = False):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay,
                                      quantize_v=quantize_v))
        self.n_steps = 0

    @staticmethod
    def _lr(lr, step: int) -> torch.Tensor:
        if callable(lr):
            return torch.as_tensor(lr(torch.tensor(step, dtype=torch.int32)),
                                   dtype=torch.float32)
        return torch.tensor(lr, dtype=torch.float32)

    @torch.no_grad()
    def step(self, closure=None, grads: Optional[Sequence] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self.n_steps += 1
        step = self.n_steps
        step_f = torch.tensor(float(step), dtype=torch.float32)
        given = iter(grads) if grads is not None else None
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            lr = self._lr(group["lr"], step)
            bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** step_f
            bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** step_f
            for p in group["params"]:
                g = next(given) if given is not None else p.grad
                self._update(p, g, group, lr, bc1, bc2)
        return loss

    def _update(self, p, grad, group, lr, bc1, bc2) -> None:
        b1, b2, eps = group["b1"], group["b2"], group["eps"]
        st = self.state[p]
        if not st:
            st["m"] = torch.zeros_like(p, dtype=torch.float32)
            v0 = torch.zeros_like(p, dtype=torch.float32)
            st["v"] = _quantize_v(v0) if group["quantize_v"] else v0
        g = (grad if grad is not None else torch.zeros_like(p)
             ).to(torch.float32)
        lr, bc1, bc2 = (t.to(p.device) for t in (lr, bc1, bc2))
        m = b1 * st["m"] + (1 - b1) * g
        vf = _dequantize_v(*st["v"]) if group["quantize_v"] else st["v"]
        vf = b2 * vf + (1 - b2) * g * g
        mhat = m / bc1
        vhat = vf / bc2
        delta = mhat / (torch.sqrt(vhat) + eps)
        pf = p.to(torch.float32)
        if group["weight_decay"]:
            delta = delta + group["weight_decay"] * pf
        p.copy_((pf - lr * delta).to(p.dtype))
        st["m"] = m
        st["v"] = _quantize_v(vf) if group["quantize_v"] else vf

    def adam_state(self) -> AdamWState:
        """The step count and the moments, in parameter order."""
        ps = [p for g in self.param_groups for p in g["params"]]
        return AdamWState(self.n_steps,
                          [self.state[p]["m"] for p in ps if self.state[p]],
                          [self.state[p]["v"] for p in ps if self.state[p]])


def adamw(params, lr=1e-3, **kw) -> AdamW:
    return AdamW(params, lr=lr, **kw)
