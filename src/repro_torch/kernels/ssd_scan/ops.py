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
model's prefill (``models.ssm``) calls it once a layer.

Under autograd (grad mode on and an input that requires grad) a CUDA
call raises NotImplementedError: the scan's backward kernel is ROADMAP
item 12g.1b, and the kernel's output has no graph.  A CPU call runs
``ssd_scan_ref`` under autograd, the reference's CPU gradient.

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
                                  refuse_grad, stream_of)
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
    ``_chunked_jnp``, f32 throughout, y in x's dtype."""
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
        # selected, not multiplied: exp above the diagonal may be inf
        decay = torch.where(tri[None, :, :, None], torch.exp(diff), 0.0)
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


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
             chunk: int = MAX_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, S, H, P); dt: (b, S, H); A, D: (H,); B, C: (b, S, N) ->
    (y (b, S, H, P) in x's dtype, final state (b, H, P, N) f32)."""
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
    refuse_grad("ssd_scan", x, dt, A, B, C, D,
                why="no backward kernel on the card yet (ROADMAP item "
                "12g.1b, the ssd_scan backward kernel): the ssm and hybrid "
                "families train on the CPU only")
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


ssd_scan.launches = 0
