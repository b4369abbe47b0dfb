"""Batched min-cost assignment (Jonker-Volgenant).

``assign_batch(costs, eff_n=None, err=None)`` takes K square finite f32
cost matrices (K, N, N) and returns the matched column per row, (K, N)
int32 — a permutation per matrix.  ``eff_n`` (one int for the batch)
restricts every solve to the leading (eff_n, eff_n) square: rows past it
report column 0.  Equal-cost ties go to the first column, exactly as the JAX
package's ``solve_one`` breaks them, so on the same matrices both return
the same columns.

On a CUDA tensor it launches ``csrc/assign.cu`` (one warp per matrix);
on a CPU tensor it runs ``assign_batch_ref``, the plain PyTorch version:
a loop copy of ``solve_one`` with its update order.  Non-finite costs
raise in both (the kernel caps every loop and flags a solve that hits
the cap).  Given ``err``, a (1,) int32 tensor on costs' device, both
set ``err[0]`` to 1 instead of raising and do not read it, so a caller
can check one flag after many launches without a sync for each (the
columns of a failed solve are meaningless).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import (check_launch, device_guard, on_cuda, ptr,
                                  refuse_grad, stream_of)
from repro_torch.kernels._build import library

MAX_N = 2048        # the solve's scratch stays under 48 KB of shared memory
NOT_CONVERGED = "assign: the JV solve did not converge (non-finite costs)"
# assign_launch(costs, out, err, K, n, eff_n, stream)
LAUNCH_ARGTYPES = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3
                   + (ctypes.c_void_p,))


def solve_one_ref(cost: torch.Tensor, eff_n: Optional[int] = None
                  ) -> torch.Tensor:
    """cost: (N, N) finite f32 -> (N,) int32 column per row: the JAX
    package's ``solve_one`` line by line (1-indexed potentials, the
    argmin's first index on ties, ``cur = (a[i0] - u[i0]) - v``)."""
    N = cost.shape[0]
    dev = cost.device
    eff = N if eff_n is None else int(eff_n)
    a = torch.nn.functional.pad(cost.to(torch.float32), (1, 0, 1, 0))
    rows1 = torch.arange(N + 1, dtype=torch.int32, device=dev)
    col_ok = rows1 <= eff
    inf = torch.full((N + 1,), float("inf"), device=dev)
    u = torch.zeros(N + 1, device=dev)
    v = torch.zeros(N + 1, device=dev)
    p = torch.zeros(N + 1, dtype=torch.int32, device=dev)
    for i in range(1, min(eff, N) + 1):     # rows past eff_n are no-ops
        p[0] = i
        j0 = 0
        way = torch.zeros(N + 1, dtype=torch.int32, device=dev)
        minv = inf.clone()
        used = torch.zeros(N + 1, dtype=torch.bool, device=dev)
        while int(p[j0]) != 0:
            used[j0] = True
            i0 = int(p[j0])
            cur = (a[i0] - u[i0]) - v
            free = ~used
            take = free & (cur < minv)
            minv = torch.where(take, cur, minv)
            way = torch.where(take, j0, way).to(torch.int32)
            masked = torch.where(free & col_ok, minv, inf)
            j1 = int(torch.argmin(masked))          # first index on ties
            delta = masked[j1]
            r = p[used].long()              # matched rows are distinct
            u[r] = u[r] + delta
            v = torch.where(used, v - delta, v)
            minv = torch.where(free, minv - delta, minv)
            j0 = j1
        while j0:
            j1 = int(way[j0])
            p[j0] = p[j1]
            j0 = j1
    # invert p; columns that own no row write the dropped index N
    idx = torch.where(p[1:] > 0, p[1:] - 1, N).long()
    out = torch.zeros(N + 1, dtype=torch.int32, device=dev)
    out[idx] = torch.arange(N, dtype=torch.int32, device=dev)
    return out[:N]


def assign_batch_ref(costs: torch.Tensor, eff_n: Optional[int] = None,
                     err: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: (K, N, N) -> (K, N) int32, one ``solve_one_ref``
    per matrix.  Non-finite costs raise, as the kernel's step cap does
    (``jnp.argmin`` would take a NaN for the minimum and end the search
    with a meaningless answer); given ``err``, they set it instead."""
    K, N, _ = costs.shape
    if not bool(torch.isfinite(costs).all()):
        if err is None:
            raise RuntimeError(NOT_CONVERGED)
        err.fill_(1)
        return torch.zeros((K, N), dtype=torch.int32, device=costs.device)
    if K == 0 or N == 0:
        return torch.zeros((K, N), dtype=torch.int32, device=costs.device)
    return torch.stack([solve_one_ref(c, eff_n) for c in costs])


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = library("assign")
    fn = lib.assign_launch
    fn.argtypes = list(LAUNCH_ARGTYPES)
    fn.restype = ctypes.c_int
    return lib, fn


def check_err(err: Optional[torch.Tensor], like: torch.Tensor, op: str
              ) -> None:
    """An ``err`` argument must be a (1,) int32 tensor on ``like``'s
    device."""
    if err is not None and (err.shape != (1,) or err.dtype != torch.int32
                            or err.device != like.device):
        raise ValueError(f"{op}: err must be a (1,) int32 tensor on "
                         f"{like.device}, got {tuple(err.shape)} "
                         f"{err.dtype} on {err.device}")


def assign_batch(costs: torch.Tensor, eff_n: Optional[int] = None,
                 err: Optional[torch.Tensor] = None) -> torch.Tensor:
    """costs: (K, N, N) finite f32 -> (K, N) int32 matched column per
    row, on costs' device; ``eff_n`` (default N) restricts every solve
    to the leading (eff_n, eff_n) square.  ``err`` (optional, (1,)
    int32 on costs' device): a failed solve sets it, and the call
    neither reads it nor raises."""
    if costs.ndim != 3 or costs.shape[1] != costs.shape[2]:
        raise ValueError("assign_batch: costs must be (K, N, N), got "
                         f"{tuple(costs.shape)}")
    check_err(err, costs, "assign_batch")
    if not on_cuda(costs):
        return assign_batch_ref(costs, eff_n, err)
    refuse_grad("assign_batch", costs)
    K, N, _ = costs.shape
    eff = N if eff_n is None else max(0, min(int(eff_n), N))
    if N > MAX_N:
        raise ValueError(f"assign_batch: N = {N} > {MAX_N}")
    costs = costs.to(torch.float32).contiguous()
    out = torch.empty((K, N), dtype=torch.int32, device=costs.device)
    if K == 0 or N == 0:
        return out
    flag = torch.zeros(1, dtype=torch.int32, device=costs.device) \
        if err is None else err
    lib, fn = _launcher()
    with device_guard(costs):
        rc = fn(ptr(costs), ptr(out), ptr(flag), K, N, eff,
                stream_of(costs))
    check_launch(rc, lib, "assign_batch")
    assign_batch.launches += 1
    if err is None and int(flag.item()):
        raise RuntimeError(NOT_CONVERGED)
    return out


assign_batch.launches = 0
