"""Mixture-of-experts FFN (the port's counterpart of the JAX package's
``models/moe.py``): token-choice top-k routing and capacity-bounded,
sort-based dispatch, grouped by sequence row.

Each batch row routes its S tokens on its own into an (E, C) slot
buffer, C = ``moe_capacity`` = ceil(cf * S * top_k / E), within [1, S].
Routing is f32 (the router weight is always f32): a softmax over the E
experts, the top k of it, whose raw probabilities weigh the experts (not
renormalised over the k, as the reference), and the load-balance loss E
* sum_e f_e * P_e a row, then the mean over rows.  Dispatch sorts a
row's (token, expert) pairs stably by expert id; a pair's place in its
expert's segment is its position, and a pair at position C or later is
dropped (it contributes 0).  The experts run as three batched matmuls
over E on the (B, E, C, d) buffer (plain products: the reference leaves
them to XLA outside any Pallas kernel).  The combine weighs each kept
slot by its gate in the activation dtype and sums a token's k
contributions in increasing expert id, from zero, which is the order of
the reference's ``y.at[t_sort].add`` over the expert-sorted updates;
then the shared experts are added in order.

No scatter-add anywhere, so two runs on the card give the same bits:
the buffer is filled by a gather (slot c of expert e reads the pair
sorted to place ``start[e] + c``), and the combine reads each token's
slots through the inverse of the sort.  Two differences from the
reference's arrays, neither visible in the output: segment starts come
from ``searchsorted`` over the sorted expert ids (the reference counts
with a scatter-add), and the buffer is built by that gather (the
reference scatters into it in 'drop' mode).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.common import param_dtype
from repro_torch.models.layers import CastWeights, SwiGLU, empty_param


def moe_capacity(m: MoEConfig, seq: int) -> int:
    """Slots per expert and row: the reference's Python float arithmetic,
    ceil(capacity_factor * seq * top_k / n_experts), within [1, seq]."""
    c = int(-(-m.capacity_factor * seq * m.top_k // m.n_experts))
    return max(1, min(c, seq))


@dataclass
class Routing:
    """One row-grouped routing of (B, S) tokens over E experts of C slots.

    gate_vals, gate_idx (B, S, k), the top k of the router's f32 softmax,
    largest first; aux, the load-balance loss (f32 scalar); order
    (B, S * k), the stable sort of a row's pairs (token-major) by expert
    id, and over the pairs so sorted: t_sort (the token), w_sort (its
    gate), keep (position < C) and slot (e * C + position, E * C where
    dropped), as the reference's arrays; src and filled (B, E, C): the
    sorted pair each slot holds and whether it holds one; places (B, S,
    k): each token's pairs' sorted places in increasing expert id."""
    gate_vals: torch.Tensor
    gate_idx: torch.Tensor
    aux: torch.Tensor
    order: torch.Tensor
    t_sort: torch.Tensor
    w_sort: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    src: torch.Tensor
    filled: torch.Tensor
    places: torch.Tensor

    @property
    def dropped(self) -> torch.Tensor:
        """(B,) pairs dropped in each row (on the device: no sync)."""
        return (~self.keep).sum(dim=-1)

    def kept_experts(self) -> torch.Tensor:
        """(B, S, k): each token's experts in increasing id, a dropped
        pair's as -1."""
        B, S, k = self.gate_idx.shape
        keep = self.keep.gather(1, self.places.reshape(B, S * k))
        return torch.where(keep.reshape(B, S, k),
                           self.gate_idx.sort(dim=-1).values, -1)

    def differs(self, other: "Routing") -> torch.Tensor:
        """(B, S): tokens whose top-k experts or kept pairs differ from
        ``other``'s (another run over the same tokens)."""
        def experts(r):
            return r.gate_idx.sort(dim=-1).values
        dev = self.gate_idx.device
        return ((experts(self) != experts(other).to(dev))
                | (self.kept_experts() != other.kept_experts().to(dev))
                ).any(dim=-1)


def route(x: torch.Tensor, router: torch.Tensor, m: MoEConfig) -> Routing:
    """``moe_block``'s routing and dispatch arithmetic for x (B, S, d)
    and the f32 router (d, E)."""
    B, S, _ = x.shape
    E, k = m.n_experts, m.top_k
    C = moe_capacity(m, S)
    dev = x.device
    probs = torch.softmax(torch.matmul(x.float(), router.float()), dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)

    # load balance: E * sum_e f_e * P_e a row, f_e the share of the row's
    # S * k picks that went to e (counts of ones: exact in any order)
    picks = F.one_hot(gate_idx.reshape(B, S * k), E).sum(dim=1)
    aux = E * ((picks.float() / (S * k)) * probs.mean(dim=1)).sum(-1).mean()

    e_flat = gate_idx.reshape(B, S * k)
    t_flat = torch.arange(S, device=dev).repeat_interleave(k)
    perm = torch.argsort(e_flat, dim=-1, stable=True)
    e_sort = e_flat.gather(1, perm)
    experts = torch.arange(E, device=dev).expand(B, E).contiguous()
    starts = torch.searchsorted(e_sort, experts)
    counts = torch.searchsorted(e_sort, experts, right=True) - starts
    pos = torch.arange(S * k, device=dev) - starts.gather(1, e_sort)
    keep = pos < C
    slot = torch.where(keep, e_sort * C + pos, E * C)

    c = torch.arange(C, device=dev)
    src = (starts[:, :, None] + c).clamp(max=S * k - 1)
    filled = c < counts[:, :, None]
    # a token's pairs have distinct experts: its sorted places, ascending,
    # run in increasing expert id
    places = torch.argsort(perm, dim=-1).reshape(B, S, k)
    return Routing(gate_vals, gate_idx, aux, perm, t_flat[perm],
                   gate_vals.reshape(B, S * k).gather(1, perm), keep, slot,
                   src, filled, places.sort(dim=-1).values)


class Experts(CastWeights):
    """The routed experts' SwiGLU weights, stacked on E: ``w_gate`` and
    ``w_up`` (E, d, f), ``w_down`` (E, f, d)."""

    def __init__(self, n: int, d: int, f: int, device=None, dtype=None):
        super().__init__()
        self.w_gate = empty_param((n, d, f), device, dtype)
        self.w_up = empty_param((n, d, f), device, dtype)
        self.w_down = empty_param((n, f, d), device, dtype)

    def forward(self, buf: torch.Tensor) -> torch.Tensor:
        """buf (E, N, d) -> (E, N, d): every expert's SwiGLU on its N rows,
        three batched matmuls over E."""
        dt = buf.dtype
        g = torch.bmm(buf, self.weight("w_gate", dt))
        u = torch.bmm(buf, self.weight("w_up", dt))
        return torch.bmm(F.silu(g) * u, self.weight("w_down", dt))


class MoEBlock(nn.Module):
    """``def_moe_block``'s parameters, ``router`` (d, E, always f32),
    ``experts`` and the shared SwiGLUs ``shared0`` ...; ``forward`` is
    ``moe_block``.  After each call ``routing`` holds that call's
    ``Routing`` (its gate_idx and its dropped pairs a row, read by the
    serving checks)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        m, d, dt = cfg.moe, cfg.d_model, param_dtype(cfg)
        self.cfg = cfg
        self.router = empty_param((d, m.n_experts), device, torch.float32)
        self.experts = Experts(m.n_experts, d, m.expert_d_ff, device, dt)
        self.n_shared = m.n_shared
        for i in range(m.n_shared):
            self.add_module(f"shared{i}",
                            SwiGLU(d, m.expert_d_ff, device, dtype=dt))
        self.routing = None

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, S, d) -> (out (B, S, d) in x's dtype, aux loss f32)."""
        m = self.cfg.moe
        B, S, d = x.shape
        E, k = m.n_experts, m.top_k
        r = route(x, self.router, m)
        self.routing = r
        C = r.src.shape[-1]

        # each slot takes the token of the pair sorted into it, or zeros
        tok = r.t_sort.gather(1, r.src.reshape(B, E * C))
        buf = torch.where(r.filled.reshape(B, E * C, 1),
                          x.gather(1, tok[..., None].expand(B, E * C, d)), 0)
        out = self.experts(buf.reshape(B, E, C, d).transpose(0, 1)
                           .reshape(E, B * C, d))
        out = out.reshape(E, B, C, d).transpose(0, 1).reshape(B, E * C, d)

        # combine: each token's k slots in increasing expert id, weighted
        # by their gates (dropped pairs give 0), summed from zero
        at = r.places.reshape(B, S * k)
        slot = r.slot.gather(1, at)
        got = out.gather(1, slot.clamp(max=E * C - 1)[..., None]
                         .expand(B, S * k, d))
        keep = r.keep.gather(1, at)[..., None]
        gates = r.w_sort.gather(1, at).to(x.dtype)[..., None]
        contrib = (torch.where(keep, got, 0) * gates).reshape(B, S, k, d)
        y = torch.zeros((B, S, d), dtype=x.dtype, device=x.device)
        for j in range(k):
            y = y + contrib[:, :, j]
        for i in range(self.n_shared):
            y = y + getattr(self, f"shared{i}")(x)
        return y, r.aux
