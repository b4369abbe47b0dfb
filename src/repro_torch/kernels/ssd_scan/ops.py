"""Mamba2's SSD (state-space duality) scan over a full sequence, and the
single-token decode update.

``ssd_scan(x, dt, A, B, C, D, chunk=)`` takes x (b, S, H, P) in the
activation dtype, dt (b, S, H) post-softplus, A and D (H,) with A < 0,
and B, C (b, S, N) (one group), and returns y (b, S, H, P) in x's dtype
and the final state (b, H, P, N) in f32, starting from a zero state.
Per head, the recurrence is

    S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T,   y_t = S_t C_t + D x_t

computed by chunks of Q = min(chunk, S) tokens: with L the cumulative
sum of dt A inside the chunk,

    y     = [(C B^T) * decay] (dt x) + exp(L) * (C S^T) + D x
    S_new = exp(L_Q) S + (x w)^T B,   w = exp(L_Q - L) dt,

where decay[t, j] = exp(L_t - L_j) for j <= t and 0 above the diagonal
(exp is never evaluated there: L_t - L_j can be thousands for j > t).
S is padded up to a multiple of Q with dt = 0 steps, which leave y and
the state exact: the plain version pads; both kernels do the same
inside (rows past S load as zeros), so the wrapper copies nothing.  The
model's prefill and its loss (``models.ssm``) call it once a layer.

Under autograd (grad mode on and an input that requires grad) a CUDA
call goes through ``SSDScanFn``: the forward kernel, then
``ssd_scan_bwd`` (``csrc/ssd_scan_bwd.cu``) as its gradient.  A CPU call
runs ``ssd_scan_ref`` under autograd: the reference's gradient, except
that it is finite where the reference's is NaN (the decay's exp is taken
after the mask; see ``ssd_scan_ref``).  ``ssd_scan_bwd_ref`` is the plain
version of the backward kernel: the chunk formulas written out.

On a CUDA tensor it launches ``csrc/ssd_scan.cu`` (bf16 on tensor cores,
f32 on tensor cores as 3xTF32, in steps of 64 rows); on a CPU tensor it
runs ``ssd_scan_ref``, the plain PyTorch version of the JAX package's
``_chunked_jnp`` (``kernels/ssd_scan/ops.py``): the same chunked math
vectorised over (b, H), a loop over chunks.  ``ssd_scan_seq_ref`` is the
per-timestep recurrence (the reference's ``ref.py`` oracle), and
``ssd_step`` the decode update, plain PyTorch on both devices (the
reference has no kernel for it: O(P N) a head).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import (check_launch, device_guard, on_cuda, ptr,
                                  stream_of)
from repro_torch.kernels._build import library

MAX_CHUNK = 128                  # the largest Q (the bf16 kernel's tile)
# (P, N) the kernel is built for: mamba2-370m's (64, 128) and zamba2-7b's
# (64, 64), the ones the card runs
SHAPES = ((64, 128), (64, 64))
DTYPES = (torch.float32, torch.bfloat16)
# ssd_scan_launch(x, dt, A, B, C, D, y, final, b, S, H, P, N, Q, bf16,
#                 stream)
LAUNCH_ARGTYPES = ((ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 7
                   + (ctypes.c_void_p,))
# ssd_scan_bwd_launch(x, dt, A, B, C, D, dy, d_final, dx, ddt, dA, dB, dC,
#                     dD, states, dBh, dCh, dAp, dDp, b, S, H, P, N, bf16,
#                     plant, stream)
BWD_LAUNCH_ARGTYPES = ((ctypes.c_void_p,) * 19 + (ctypes.c_int,) * 7
                       + (ctypes.c_void_p,))
BWD_ROWS = 64                    # the backward kernel's rows a step
# faults the card's check plants in the backward kernel (``_launch_bwd``'s
# ``plant``; ``ssd_scan_bwd`` passes 0)
BWD_PLANTS = {"the carried dS dropped": 1,
              "dB summed over head 0 only": 2}


def _padded(x, dt, B, C, Q: int):
    """x, dt, B, C with S padded up to a multiple of Q by dt = 0 steps
    (exact: they neither decay nor update the state)."""
    pad = (-x.shape[1]) % Q
    if not pad:
        return x, dt, B, C
    return (F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)),
            F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad)))


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                 chunk: int = MAX_CHUNK
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the reference wrapper's padding, then
    ``_chunked_jnp``, f32 throughout, y in x's dtype; the decay's exp is
    taken after the mask, so its gradient stays finite where the
    reference's is NaN (the same forward bits)."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, S)
    x, dt, B, C = _padded(x, dt, B, C, Q)
    dev = x.device
    A, D = A.float(), D.float()
    tri = torch.ones((Q, Q), dtype=torch.bool, device=dev).tril()
    state = torch.zeros((b, H, P, N), dtype=torch.float32, device=dev)
    ys = []
    for c0 in range(0, x.shape[1], Q):
        xc = x[:, c0:c0 + Q].float()                   # (b,Q,H,P)
        dtc = dt[:, c0:c0 + Q].float()                 # (b,Q,H)
        Bc = B[:, c0:c0 + Q].float()                   # (b,Q,N)
        Cc = C[:, c0:c0 + Q].float()
        L = torch.cumsum(dtc * A, dim=1)               # (b,Q,H)
        diff = L[:, :, None, :] - L[:, None, :, :]     # (b,t,j,H)
        # masked before the exp: above the diagonal diff may be large
        # enough for exp to overflow, and the gradient of an inf that
        # ``where`` drops is still inf * 0 = NaN (the reference's
        # ``_chunked_jnp`` takes exp first); exp(-inf) is exactly 0, so
        # the forward's bits are the same either way
        decay = torch.exp(torch.where(tri[None, :, :, None], diff,
                                      float("-inf")))
        G = torch.einsum("btn,bsn->bts", Cc, Bc)       # (b,Q,Q)
        M = G[..., None] * decay                       # (b,t,s,H)
        xdt = xc * dtc[..., None]
        y = torch.einsum("btsh,bshp->bthp", M, xdt)
        y = y + torch.exp(L)[..., None] * torch.einsum(
            "btn,bhpn->bthp", Cc, state)
        y = y + D[None, None, :, None] * xc
        LQ = L[:, -1, :]                               # (b,H)
        w = torch.exp(LQ[:, None, :] - L) * dtc        # (b,Q,H)
        state = torch.exp(LQ)[..., None, None] * state + torch.einsum(
            "bshp,bsn->bhpn", xc * w[..., None], Bc)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S].to(x.dtype), state


def _states(x, dt, A, B, Q):
    """The state entering each chunk of Q rows (f32, a zero state
    first), from a forward sweep of the state update alone."""
    b, S, H, P = x.shape
    state = torch.zeros((b, H, P, B.shape[-1]), dtype=torch.float32,
                        device=x.device)
    out = []
    for c0 in range(0, S, Q):
        out.append(state)
        xc, dtc, Bc = x[:, c0:c0 + Q], dt[:, c0:c0 + Q], B[:, c0:c0 + Q]
        L = torch.cumsum(dtc * A, dim=1)
        w = torch.exp(L[:, -1:, :] - L) * dtc
        state = torch.exp(L[:, -1, :])[..., None, None] * state \
            + torch.einsum("bshp,bsn->bhpn", xc * w[..., None], Bc)
    return out


def _exclusive_cumsum(v: torch.Tensor, dim: int) -> torch.Tensor:
    """sum over i < k along ``dim`` (0 at k = 0), without subtracting."""
    c = torch.cumsum(v.narrow(dim, 0, v.shape[dim] - 1), dim=dim)
    return torch.cat([torch.zeros_like(v.narrow(dim, 0, 1)), c], dim=dim)


def ssd_scan_bwd_ref(x, dt, A, B, C, D, dy, d_final=None,
                     chunk: int = MAX_CHUNK) -> tuple:
    """The gradient of ``ssd_scan(x, dt, A, B, C, D, chunk)`` against dy
    (b, S, H, P) and the final state's gradient ``d_final`` (b, H, P, N;
    None is zeros), by the chunk formulas written out (the card kernel's
    math, in f32, vectorised over rows and heads): per chunk of Q rows,
    in reverse, with s = dt A, L = cumsum(s), S- the state entering the
    chunk and dS the gradient of the one leaving it,

      dx_j  = D dy_j + dt_j sum_{t>=j} (C_t.B_j) e^{L_t-L_j} dy_t
              + e^{L_Q-L_j} dt_j dS B_j
      dB_j  = sum_{t>=j} e^{L_t-L_j} dt_j (dy_t.x_j) C_t
              + e^{L_Q-L_j} dt_j dS^T x_j              (summed over heads)
      dC_t  = sum_{j<=t} e^{L_t-L_j} dt_j (dy_t.x_j) B_j
              + e^{L_t} S-^T dy_t                      (summed over heads)
      ddt_j = sum_{t>=j} (C_t.B_j) e^{L_t-L_j} (dy_t.x_j)
              + e^{L_Q-L_j} x_j^T dS B_j + A ds_j,   dA = sum dt_j ds_j,

    where ds_k sums every term whose exponent spans step k (pairs j < k
    <= t directly, not as a difference of cumulative sums), and dS <-
    e^{L_Q} dS + sum_t e^{L_t} dy_t C_t^T carries back.  The exp is
    taken only where the mask keeps it.  -> (dx in x's dtype, ddt f32,
    dA f32, dB and dC in B's dtype, dD f32)."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, S)
    xf, dtf, Bf, Cf = _padded(x.float(), dt.float(), B.float(), C.float(),
                              Q)
    dyf = F.pad(dy.float(), (0, 0, 0, 0, 0, xf.shape[1] - S))
    A, D = A.float(), D.float()
    dev = xf.device
    tri = torch.ones((Q, Q), dtype=torch.bool, device=dev).tril()
    states = _states(xf, dtf, A, Bf, Q)
    dS = (torch.zeros((b, H, P, N), dtype=torch.float32, device=dev)
          if d_final is None else d_final.float().clone())
    dx, ddt, dB, dC = (torch.zeros_like(t) for t in (xf, dtf, Bf, Cf))
    dA = torch.zeros(H, dtype=torch.float32, device=dev)
    dD = torch.einsum("bthp,bthp->h", dyf, xf)
    for c in reversed(range(len(states))):
        sl = slice(c * Q, (c + 1) * Q)
        xc, dtc, Bc, Cc, dyc = xf[:, sl], dtf[:, sl], Bf[:, sl], Cf[:, sl], \
            dyf[:, sl]
        Sm = states[c]
        L = torch.cumsum(dtc * A, dim=1)                   # (b,Q,H)
        LQ = L[:, -1]                                      # (b,H)
        diff = L[:, :, None, :] - L[:, None, :, :]         # (b,t,j,H)
        seg = torch.exp(torch.where(tri[None, :, :, None], diff,
                                    float("-inf")))
        G = torch.einsum("btn,bjn->btj", Cc, Bc)
        E = torch.einsum("bthp,bjhp->btjh", dyc, xc)
        Mg = G[..., None] * seg                            # (b,t,j,H)
        W = seg * dtc[:, None] * E
        Z = Mg * E
        tail = torch.exp(LQ[:, None] - L)                  # (b,Q,H)
        dSB = torch.einsum("bhpn,bjn->bjhp", dS, Bc)
        r = torch.einsum("bjhp,bjhp->bjh", xc, dSB)        # x_j^T dS B_j
        dx[:, sl] = D[None, None, :, None] * dyc + dtc[..., None] * (
            torch.einsum("btjh,bthp->bjhp", Mg, dyc)) \
            + (tail * dtc)[..., None] * dSB
        dB[:, sl] = torch.einsum("btjh,btn->bjn", W, Cc) + torch.einsum(
            "bjh,bhpn,bjhp->bjn", tail * dtc, dS, xc)
        dyS = torch.einsum("bthp,bhpn->bthn", dyc, Sm)     # S-^T dy_t
        eL = torch.exp(L)
        dC[:, sl] = torch.einsum("btjh,bjn->btn", W, Bc) + torch.einsum(
            "bth,bthn->btn", eL, dyS)
        # ds_k: intra pairs j < k <= t, state terms t >= k, the carried
        # state's decay (every k), the update terms j < k
        V = dtc[:, None] * Z
        pref = _exclusive_cumsum(V, 2)                     # sum_{j<k} V_tj
        ds = (pref * tri[None, :, :, None]).sum(1)         # sum_{t>=k}
        u = eL * torch.einsum("bthn,btn->bth", dyS, Cc)
        ds = ds + torch.flip(torch.cumsum(torch.flip(u, [1]), 1), [1])
        ds = ds + (torch.exp(LQ) * (dS * Sm).sum((2, 3)))[:, None]
        ds = ds + _exclusive_cumsum(tail * dtc * r, 1)
        ddt[:, sl] = Z.sum(1) + tail * r + A * ds
        dA = dA + (dtc * ds).sum((0, 1))
        dS = torch.exp(LQ)[..., None, None] * dS + torch.einsum(
            "bth,bthp,btn->bhpn", eL, dyc, Cc)
    return (dx[:, :S].to(x.dtype), ddt[:, :S], dA, dB[:, :S].to(B.dtype),
            dC[:, :S].to(B.dtype), dD)


def ssd_scan_seq_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     B: torch.Tensor, C: torch.Tensor, D: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-timestep recurrence (the reference's ``ssd_scan_ref``
    oracle): S steps of ``ssd_step`` from a zero state."""
    b, S, H, P = x.shape
    state = torch.zeros((b, H, P, B.shape[-1]), dtype=torch.float32,
                        device=x.device)
    xf = x.float()
    ys = []
    for t in range(S):
        y, state = ssd_step(state, xf[:, t], dt[:, t], A, B[:, t], C[:, t],
                            D)
        ys.append(y)
    return torch.stack(ys, dim=1).to(x.dtype), state


def ssd_step(state: torch.Tensor, x_t: torch.Tensor, dt_t: torch.Tensor,
             A: torch.Tensor, B_t: torch.Tensor, C_t: torch.Tensor,
             D: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token decode update.  state (b, H, P, N) f32; x_t (b, H,
    P); dt_t (b, H); B_t, C_t (b, N).  -> (y_t (b, H, P) in x_t's dtype,
    the new state, a new tensor)."""
    dtf = dt_t.float()
    a = torch.exp(dtf * A.float()[None, :])                      # (b,H)
    upd = (dtf[..., None, None] * x_t.float()[..., :, None]
           * B_t.float()[:, None, None, :])
    state = a[..., None, None] * state + upd
    y = torch.einsum("bhpn,bn->bhp", state, C_t.float())
    y = y + D.float()[None, :, None] * x_t
    return y.to(x_t.dtype), state


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = library("ssd_scan")
    fn = lib.ssd_scan_launch
    fn.argtypes = list(LAUNCH_ARGTYPES)
    fn.restype = ctypes.c_int
    return lib, fn


def _check_operands(x, dt, A, B, C, D) -> None:
    """The CUDA kernel's contract: everything on x's device; x, B, C of
    one dtype (f32 or bf16); a (P, N) it is built for.  (The wrapper
    makes them contiguous and dt, A, D f32.)"""
    for arg, t in (("dt", dt), ("A", A), ("B", B), ("C", C), ("D", D)):
        if t.device != x.device:
            raise ValueError(f"ssd_scan: {arg} must be on {x.device}, got "
                             f"{t.device}")
    if x.dtype not in DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"ssd_scan: x, B, C must share one dtype of "
                         f"{DTYPES}, got {x.dtype}, {B.dtype}, {C.dtype}")
    P, N = x.shape[-1], B.shape[-1]
    if (P, N) not in SHAPES:
        raise NotImplementedError(f"ssd_scan: (P, N) = {(P, N)} has no "
                                  f"kernel build (built for {SHAPES})")


def _forward_kernel(x, dt, A, B, C, D, chunk: int):
    """One launch of the forward kernel on CUDA tensors (no graph)."""
    b, S, H, P = x.shape
    Q = min(chunk, S)
    if Q > MAX_CHUNK:
        raise NotImplementedError(f"ssd_scan: chunk {Q} > {MAX_CHUNK}, "
                                  "the kernel's shared-memory chunk")
    _check_operands(x, dt, A, B, C, D)
    x, B, C = x.contiguous(), B.contiguous(), C.contiguous()
    dt = dt.float().contiguous()
    A, D = A.float().contiguous(), D.float().contiguous()
    N = B.shape[-1]
    y = torch.empty_like(x)
    fin = torch.empty((b, H, P, N), dtype=torch.float32, device=x.device)
    if b and H:
        lib, fn = _launcher()
        with device_guard(x):
            err = fn(ptr(x), ptr(dt), ptr(A), ptr(B), ptr(C), ptr(D),
                     ptr(y), ptr(fin), b, S, H, P, N, Q,
                     int(x.dtype == torch.bfloat16), stream_of(x))
        check_launch(err, lib, "ssd_scan")
        ssd_scan.launches += 1
    return y, fin


@functools.lru_cache(maxsize=None)
def _bwd_launcher():
    lib = library("ssd_scan_bwd")
    fn = lib.ssd_scan_bwd_launch
    fn.argtypes = list(BWD_LAUNCH_ARGTYPES)
    fn.restype = ctypes.c_int
    return lib, fn


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                 dy: torch.Tensor, d_final=None,
                 chunk: int = MAX_CHUNK) -> tuple:
    """The gradient of ``ssd_scan(x, dt, A, B, C, D, chunk)`` against dy
    (b, S, H, P) and the final state's gradient ``d_final`` (b, H, P, N;
    None is zeros) -> (dx in x's dtype, ddt f32, dA f32, dB and dC in B's
    dtype, dD f32).  On a CUDA tensor it launches
    ``csrc/ssd_scan_bwd.cu`` (three kernels a call, one launch counted:
    the chunk-entry states into scratch, the reverse sweep writing
    per-head partials of dB and dC, their sum in head order; the
    gradient does not depend on ``chunk``, and the kernel takes steps of
    ``BWD_ROWS``); on a CPU tensor it runs ``ssd_scan_bwd_ref``."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    if tuple(dy.shape) != tuple(x.shape) or (
            d_final is not None and tuple(d_final.shape) != (b, H, P, N)):
        raise ValueError(f"ssd_scan_bwd: x {tuple(x.shape)}, dy "
                         f"{tuple(dy.shape)}, d_final "
                         f"{None if d_final is None else tuple(d_final.shape)}")
    if not on_cuda(x):
        return ssd_scan_bwd_ref(x, dt, A, B, C, D, dy, d_final, chunk)
    return _launch_bwd(x, dt, A, B, C, D, dy, d_final, plant=0)


def _launch_bwd(x, dt, A, B, C, D, dy, d_final, plant: int) -> tuple:
    """``ssd_scan_bwd`` on CUDA tensors; ``plant`` (one of
    ``BWD_PLANTS``' values) plants a fault in the kernel, for the card's
    check alone (``check.check_bwd_plants``)."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    _check_operands(x, dt, A, B, C, D)
    for arg, t in (("dy", dy), ("d_final", d_final)):
        if t is not None and t.device != x.device:
            raise ValueError(f"ssd_scan_bwd: {arg} must be on {x.device}, "
                             f"got {t.device}")
    x, B, C = x.contiguous(), B.contiguous(), C.contiguous()
    dy = dy.to(x.dtype).contiguous()
    dt = dt.float().contiguous()
    A, D = A.float().contiguous(), D.float().contiguous()
    if d_final is not None:
        d_final = d_final.float().contiguous()
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    ddt = torch.empty((b, S, H), **f32)
    dA, dD = torch.empty(H, **f32), torch.empty(H, **f32)
    if not (b and H):
        return dx, ddt, dA.zero_(), dB.zero_(), dC.zero_(), dD.zero_()
    steps = -(-S // BWD_ROWS)
    states = torch.empty((b, steps, H, P, N), **f32)
    dBh, dCh = (torch.empty((b, S, H, N), **f32) for _ in range(2))
    dAp, dDp = (torch.empty((b, H), **f32) for _ in range(2))
    lib, fn = _bwd_launcher()
    with device_guard(x):
        err = fn(ptr(x), ptr(dt), ptr(A), ptr(B), ptr(C), ptr(D), ptr(dy),
                 None if d_final is None else ptr(d_final), ptr(dx),
                 ptr(ddt), ptr(dA), ptr(dB), ptr(dC), ptr(dD), ptr(states),
                 ptr(dBh), ptr(dCh), ptr(dAp), ptr(dDp), b, S, H, P, N,
                 int(x.dtype == torch.bfloat16), int(plant), stream_of(x))
    check_launch(err, lib, "ssd_scan_bwd")
    ssd_scan_bwd.launches += 1
    return dx, ddt, dA, dB, dC, dD


ssd_scan_bwd.launches = 0


class SSDScanFn(torch.autograd.Function):
    """The forward kernel with ``ssd_scan_bwd`` as its gradient (CUDA
    tensors under grad).  Gradients come back in the inputs' dtypes;
    a final state nothing reads has no gradient (None, read as zeros)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, chunk):
        y, fin = _forward_kernel(x, dt, A, B, C, D, chunk)
        ctx.save_for_backward(x, dt, A, B, C, D)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, fin

    @staticmethod
    def backward(ctx, dy, d_final):
        x, dt, A, B, C, D = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        dx, ddt, dA, dB, dC, dD = ssd_scan_bwd(x, dt, A, B, C, D, dy,
                                               d_final, ctx.chunk)
        return (dx, ddt.to(dt.dtype), dA.to(A.dtype), dB, dC.to(C.dtype),
                dD.to(D.dtype), None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
             chunk: int = MAX_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, S, H, P); dt: (b, S, H); A, D: (H,); B, C: (b, S, N) ->
    (y (b, S, H, P) in x's dtype, final state (b, H, P, N) f32);
    differentiable on both devices."""
    b, S, H, P = x.shape
    if B.ndim != 3 or B.shape != C.shape or B.shape[:2] != (b, S) \
            or tuple(dt.shape) != (b, S, H) or tuple(A.shape) != (H,) \
            or tuple(D.shape) != (H,):
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}, D "
                         f"{tuple(D.shape)} (one group of B and C)")
    if S == 0 or chunk < 1:
        raise ValueError(f"ssd_scan: S {S}, chunk {chunk}")
    if not on_cuda(x):
        return ssd_scan_ref(x, dt, A, B, C, D, chunk)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B, C, D)):
        return SSDScanFn.apply(x, dt, A, B, C, D, chunk)
    return _forward_kernel(x, dt, A, B, C, D, chunk)


ssd_scan.launches = 0
