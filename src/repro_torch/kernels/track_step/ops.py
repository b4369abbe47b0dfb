"""Fused tracker step for K streams of Q slots.

``track_step(h_r, tbox_r, alive_r, te_gap_r, te_match, x, dbox, dvalid,
thr, params, table, err=None)`` computes one recurrent-tracker step per
stream, with the shapes and operand order of the JAX package's
``kernels/track_step/ops.py::track_step``:

  h_r (K, Q, H), tbox_r (K, Q, 4), alive_r / te_gap_r / te_match / dvalid
  (K, Q), x (K, Q, e), dbox (K, Q, 4) f32; thr (1, 1) f32; params the
  ``pack_params`` tuple; table (T, 1) f32 (``LOG1P_TABLE_2D``).

Rows are slots in rank order (live tracks a prefix), columns the frame's
detections (valid ones a prefix).  It returns ``matched`` (K, Q) int32,
the detection column per row or -1, ``h_upd`` (K, Q, H), the GRU state of
each row had it matched its solved column, and ``h_new`` (K, Q, H), the
GRU start of each column as a new track.  Pairs with a dead row, a
padding column or a match probability below ``thr`` cost
``FORBIDDEN_DEVICE``; the JV solve runs on the canonical ``assoc_side``
square of the live and valid counts, so the result does not depend on Q
and equals the host tracker's (``RecurrentTracker`` with ``assign="host"``)
bit for bit.

On a CUDA tensor it launches ``csrc/track_step.cu``; on a CPU tensor it
runs ``track_step_ref``, the plain PyTorch version, written from
``core/fastmath.py``'s ``t_*`` flavour and ``assign``'s ``solve_one_ref``.
The kernel writes the cost matrices into a scratch buffer that the
wrapper allocates with room after them for its workspace, K * Q * (e + M)
floats: the detection features and h prefixes its first launch computes
once per column and row.  A JV solve that hits its step cap raises;
given ``err``, a (1,) int32 tensor on h_r's device, it sets ``err[0]``
to 1 instead, and the call does not read it (no sync), so a caller
checks one flag for many steps.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import Device, resolve_device
from repro_torch.core import fastmath as fm
from repro_torch.core.hungarian import FORBIDDEN_DEVICE, assoc_side
from repro_torch.kernels import (check_launch, device_guard, on_cuda, ptr,
                                  refuse_grad, stream_of)
from repro_torch.kernels._build import library
from repro_torch.kernels.assign.ops import check_err, solve_one_ref

# flat operand order of the tracker heads, as ``tracker._host_params``
# names them; biases are reshaped to (1, n)
PARAM_ORDER: Tuple[str, ...] = (
    "det_proj/w", "det_proj/b",
    "gru/wz", "gru/wr", "gru/wh", "gru/bz", "gru/br", "gru/bh",
    "match/w0", "match/b0", "match/w1", "match/b1")

# the log1p-of-integer-gap table as a kernel operand, (T, 1) f32
LOG1P_TABLE_2D = fm.LOG1P_TABLE[:, None]

_FORBID = float(FORBIDDEN_DEVICE)
_HALF_FORBID = float(FORBIDDEN_DEVICE / 2)
NOT_CONVERGED = "track_step: the JV solve did not converge"
# track_step_launch(8 stream operands, thr, 12 heads, table, cost, cols,
#                   matched, h_upd, h_new, err, K, Q, H, e, M, n_table,
#                   stream)
LAUNCH_ARGTYPES = ((ctypes.c_void_p,) * 28 + (ctypes.c_int,) * 6
                   + (ctypes.c_void_p,))


def pack_params(np_params: Dict[str, np.ndarray], device: Device = "cuda"
                ) -> Tuple[torch.Tensor, ...]:
    """The tracker heads (``_host_params`` output) as the kernel's operand
    tuple of f32 tensors on ``device``, biases as (1, n) rows."""
    dev = resolve_device(device)
    out = []
    for key in PARAM_ORDER:
        v = np.asarray(np_params[key], np.float32)
        if v.ndim == 1:
            v = v[None, :]
        out.append(torch.from_numpy(np.ascontiguousarray(v)).to(dev))
    return tuple(out)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _det_feats(x, boxes, te, dp_w, dp_b, table):
    extra = torch.stack([boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3],
                         te * 0.125, fm.t_log1p_int(te, table)], dim=1)
    d = torch.cat([x, extra], dim=1)
    return fm.t_tanh(fm.t_matmul(d, dp_w) + dp_b)


def _gru(h, feat, wz, wr, wh, bz, br, bh):
    hf = torch.cat([feat, h], dim=-1)
    z = fm.t_sigmoid(fm.t_matmul(hf, wz) + bz)
    r = fm.t_sigmoid(fm.t_matmul(hf, wr) + br)
    hf2 = torch.cat([feat, r * h], dim=-1)
    cand = fm.t_tanh(fm.t_matmul(hf2, wh) + bh)
    return fm.t_fmadd(z, cand - h, h)       # single-multiply blend


def _cost_ref_one(h_r, tbox_r, alive_r, te_match, x, dbox, dvalid, thr,
                  params, table) -> Tuple[torch.Tensor, int]:
    """One stream's (Q, Q) cost matrix and the side of the square the JV
    solves."""
    dp_w, dp_b, _, _, _, _, _, _, m_w0, m_b0, m_w1, m_b1 = params
    Q, H = h_r.shape
    feats_m = _det_feats(x, dbox, te_match, dp_w, dp_b, table)

    # match logits of the live pairs only: every other pair costs the
    # sentinel whatever its logit, and pairs are independent rows
    cost = torch.full((Q, Q), _FORBID, device=h_r.device)
    rows = torch.nonzero(alive_r > 0)[:, 0]
    cols = torch.nonzero(dvalid > 0)[:, 0]
    if len(rows) and len(cols):
        T, N = len(rows), len(cols)
        d = dbox[cols][None, :, :] - tbox_r[rows][:, None, :]
        tesafe = te_match[cols].clamp(min=1.0)[None, :, None]
        rel = torch.cat([d[..., :2], d[..., :2] / tesafe, d[..., 2:]],
                        dim=-1)
        pair = torch.cat([h_r[rows][:, None].expand(T, N, H),
                          feats_m[cols][None].expand(T, N, -1), rel], dim=-1)
        hid = fm.t_tanh(fm.t_matmul(pair.reshape(T * N, -1), m_w0) + m_b0)
        logits = (fm.t_matmul(hid, m_w1) + m_b1).reshape(T, N)
        probs = fm.t_sigmoid(logits)
        live = torch.where(probs >= thr, 1.0 - probs,
                           torch.full_like(probs, _FORBID))
        cost[rows[:, None], cols[None, :]] = live

    # the canonical assoc_side square of the live/valid counts
    return cost, min(assoc_side(len(rows), len(cols)), Q)


def _step_ref_one(h_r, tbox_r, alive_r, te_gap_r, te_match, x, dbox,
                  dvalid, thr, params, table):
    dp_w, dp_b, wz, wr, wh, bz, br, bh = params[:8]
    cost, side = _cost_ref_one(h_r, tbox_r, alive_r, te_match, x, dbox,
                               dvalid, thr, params, table)
    sol = solve_one_ref(cost, eff_n=side)
    got = cost.gather(1, sol[:, None].long())[:, 0]
    matched = torch.where(got < _HALF_FORBID, sol, -1).to(torch.int32)

    idx = sol.long()
    feats_g = _det_feats(x[idx], dbox[idx], te_gap_r, dp_w, dp_b, table)
    h_upd = _gru(h_r, feats_g, wz, wr, wh, bz, br, bh)
    feats_0 = _det_feats(x, dbox, torch.zeros_like(te_match), dp_w, dp_b,
                         table)
    h_new = _gru(torch.zeros_like(h_r), feats_0, wz, wr, wh, bz, br, bh)
    return matched, h_upd, h_new


def track_costs_ref(h_r, tbox_r, alive_r, te_match, x, dbox, dvalid, thr,
                    params: Sequence[torch.Tensor], table
                    ) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """The cost matrices the step solves, (K, Q, Q), and each stream's
    square side: the JV's input, for counting its steps."""
    thr = torch.as_tensor(thr, dtype=torch.float32).reshape(-1)[0].item()
    table = table.reshape(-1)
    outs = [_cost_ref_one(*(a[k] for a in (h_r, tbox_r, alive_r, te_match,
                                           x, dbox, dvalid)),
                          thr, params, table)
            for k in range(h_r.shape[0])]
    return torch.stack([o[0] for o in outs]), tuple(o[1] for o in outs)


def track_step_ref(h_r, tbox_r, alive_r, te_gap_r, te_match, x, dbox,
                   dvalid, thr, params: Sequence[torch.Tensor], table,
                   err: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``track_step``: the same shapes, one stream at a
    time, on the inputs' device.  Its costs are finite by construction,
    so its solve never fails and ``err`` is left as it is."""
    thr = torch.as_tensor(thr, dtype=torch.float32).reshape(-1)[0].item()
    table = table.reshape(-1)
    outs = [_step_ref_one(*(a[k] for a in (h_r, tbox_r, alive_r, te_gap_r,
                                           te_match, x, dbox, dvalid)),
                          thr, params, table)
            for k in range(h_r.shape[0])]
    return tuple(torch.stack([o[i] for o in outs]) for i in range(3))


# ---------------------------------------------------------------------------
# Kernel
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _launcher():
    lib = library("track_step")
    fn = lib.track_step_launch
    fn.argtypes = list(LAUNCH_ARGTYPES)
    fn.restype = ctypes.c_int
    return lib, fn


def _check_shapes(h_r, ops, params, table) -> Tuple[int, ...]:
    K, Q, H = h_r.shape
    e = ops[5].shape[2]
    M = params[8].shape[1]
    want = [(K, Q, H), (K, Q, 4), (K, Q), (K, Q), (K, Q), (K, Q, e),
            (K, Q, 4), (K, Q), (1, 1),
            (e + 6, e), (1, e), (e + H, H), (e + H, H), (e + H, H),
            (1, H), (1, H), (1, H), (H + e + 6, M), (1, M), (M, 1), (1, 1)]
    got = [tuple(t.shape) for t in ops + params]
    if got != want:
        raise ValueError(f"track_step: operand shapes {got}, expected {want}")
    if table.ndim != 2 or table.shape[1] != 1:
        raise ValueError(f"track_step: table must be (T, 1), got "
                         f"{tuple(table.shape)}")
    return K, Q, H, e, M


def track_step(h_r, tbox_r, alive_r, te_gap_r, te_match, x, dbox, dvalid,
               thr: Union[torch.Tensor, float],
               params: Sequence[torch.Tensor], table: torch.Tensor,
               err: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One tracker step for K streams (module docstring); outputs on
    h_r's device.  ``err`` (optional, (1,) int32 on h_r's device): a
    capped JV solve sets it, and the call neither reads it nor raises."""
    check_err(err, h_r, "track_step")
    if not on_cuda(h_r):
        return track_step_ref(h_r, tbox_r, alive_r, te_gap_r, te_match, x,
                              dbox, dvalid, thr, params, table, err)
    refuse_grad("track_step", h_r, tbox_r, x, dbox, thr, *params)
    dev = h_r.device
    thr = torch.as_tensor(thr, dtype=torch.float32, device=dev).reshape(1, 1)
    ops = [h_r, tbox_r, alive_r, te_gap_r, te_match, x, dbox, dvalid, thr]
    params = list(params)
    K, Q, H, e, M = _check_shapes(h_r, ops, params, table)
    operands = ops + params + [table]
    for t in operands:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"track_step: every operand must be f32 on "
                             f"{dev}, got {t.dtype} on {t.device}")
    operands = [t.contiguous() for t in operands]
    # the cost matrices, then the kernel's workspace (module note)
    cost = torch.empty(K * Q * (Q + e + M), dtype=torch.float32, device=dev)
    cols = torch.empty((K, Q), dtype=torch.int32, device=dev)
    matched = torch.empty((K, Q), dtype=torch.int32, device=dev)
    h_upd = torch.empty((K, Q, H), dtype=torch.float32, device=dev)
    h_new = torch.empty((K, Q, H), dtype=torch.float32, device=dev)
    if K == 0 or Q == 0:
        return matched, h_upd, h_new
    flag = torch.zeros(1, dtype=torch.int32, device=dev) if err is None \
        else err
    lib, fn = _launcher()
    with device_guard(h_r):
        rc = fn(*(ptr(t) for t in operands), ptr(cost), ptr(cols),
                ptr(matched), ptr(h_upd), ptr(h_new), ptr(flag), K, Q, H, e,
                M, int(table.shape[0]), stream_of(h_r))
    check_launch(rc, lib, "track_step")
    track_step.launches += 1
    if err is None and int(flag.item()):
        raise RuntimeError(NOT_CONVERGED)
    return matched, h_upd, h_new


track_step.launches = 0
