"""The ``assign`` kernel against its plain version on the card: the
cases, the matrices and the rule, one copy for ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.

Rule: bit for bit.  The kernel's matched columns equal those of
``assign_batch_ref`` on a CPU copy of the same matrices (the plain
version is a Python loop of tiny tensor ops, so it runs on the host); a
batch the plain version refuses (non-finite costs) makes the kernel
raise too, and with ``err`` given, set the flag instead.

The cases hold the JV's argmin to its tie rule (the first index wins,
-0.0 equals +0.0, an argmin over no finite value is column 0): costs
quantised to 1/64 (frequent ties); all-equal rows (ties across lanes);
two equal minima 32 columns apart (one lane's two slots); many zeros of
either sign; a row of +inf (a step with no finite free column, which
must end in the step cap); N = 256, whose rows do not all fit in shared
memory; and a solve at ``MAX_N``, which takes the large-matrix
instance.  ``jv_steps`` counts a solve's steps, the JV's unit of time.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.assign.ops import (MAX_N, assign_batch,
                                            assign_batch_ref)

SEED = 0
# (name, K, N, eff_n, kind): ``kind`` names the matrices (``costs``)
CASES = (("N8", 4, 8, None, "quantised"),
         ("N64", 4, 64, None, "quantised"),
         ("N128", 4, 128, None, "quantised"),
         ("N128 eff40", 4, 128, 40, "quantised"),
         ("equal rows N64", 4, 64, None, "equal_rows"),
         ("minima 32 apart N128", 4, 128, None, "minima_32_apart"),
         ("signed zeros N64", 4, 64, None, "signed_zeros"),
         ("N256", 4, 256, None, "quantised"),
         ("N2048", 1, MAX_N, None, "uniform"))
# batches that must raise: (name, K, N, kind)
RAISE_CASES = (("NaN", 2, 8, "nan"),
               ("all-inf step", 2, 64, "inf_row"))


def costs(kind: str, K: int, N: int, seed: int) -> np.ndarray:
    """(K, N, N) f32 cost matrices of one ``kind``."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 256, (K, N, N)).astype(np.float32) / 64.0
    if kind == "quantised":
        return q
    if kind == "uniform":
        return rng.random((K, N, N), dtype=np.float32)
    if kind == "equal_rows":
        # matrix 0 all equal, the others one level a row
        out = np.broadcast_to(rng.integers(0, 8, (K, N, 1)) / 64.0,
                              (K, N, N)).astype(np.float32)
        out[0] = 1.0
        return out
    if kind == "minima_32_apart":
        c = rng.integers(0, N - 32, (K, N))
        k, r = np.indices((K, N))
        q += 1.0
        q[k, r, c] = q[k, r, c + 32] = 0.5
        return q
    if kind == "signed_zeros":
        # half the costs 0, of either sign; row 0 puts +0 before -0
        zero = rng.random((K, N, N)) < 0.5
        sign = np.where(rng.random((K, N, N)) < 0.5, -1.0, 1.0)
        out = np.where(zero, sign * 0.0, q + 1 / 64).astype(np.float32)
        out[:, 0, :2] = (0.0, -0.0)
        return out
    if kind == "nan":
        return np.full((K, N, N), np.nan, np.float32)
    if kind == "inf_row":
        q[:, 3] = np.inf
        return q
    raise ValueError(f"no cost kind {kind!r}")


def case_costs(case) -> torch.Tensor:
    """The CPU matrices of one of ``CASES`` (seeded by its place)."""
    name, K, N, _, kind = case
    return torch.from_numpy(costs(kind, K, N, SEED + CASES.index(case)))


def jv_steps(cost: np.ndarray, eff: Optional[int] = None
             ) -> Tuple[int, int]:
    """(search steps, augmentation hops) of one solve of ``solve_one``'s
    update order on ``cost`` restricted to its leading ``eff`` square:
    a numpy loop over the same plain solve, for ns a step."""
    cost = np.asarray(cost, np.float32)
    N = cost.shape[0]
    eff = N if eff is None else eff
    a = np.zeros((N + 1, N + 1), np.float32)
    a[1:, 1:] = cost
    col_ok = np.arange(N + 1) <= eff
    u = np.zeros(N + 1, np.float32)
    v = np.zeros(N + 1, np.float32)
    p = np.zeros(N + 1, np.int64)
    inf = np.float32(np.inf)
    steps = hops = 0
    for i in range(1, eff + 1):
        p[0] = i
        j0 = 0
        way = np.zeros(N + 1, np.int64)
        minv = np.full(N + 1, inf, np.float32)
        used = np.zeros(N + 1, bool)
        while p[j0] != 0:
            steps += 1
            used[j0] = True
            i0 = p[j0]
            cur = (a[i0] - u[i0]) - v
            free = ~used
            take = free & (cur < minv)
            minv[take] = cur[take]
            way[take] = j0
            masked = np.where(free & col_ok, minv, inf)
            j1 = int(np.argmin(masked))
            delta = masked[j1]
            u[p[used]] += delta
            v[used] -= delta
            minv[free] -= delta
            j0 = j1
        while j0:
            hops += 1
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    return steps, hops


def check_case(case, device) -> dict:
    """One launch of the kernel on one of ``CASES`` against the plain
    version; raises AssertionError unless they are equal.  -> the
    record: shape, the steps of each matrix's solve."""
    name, K, N, eff, _ = case
    host = case_costs(case)
    dev = host.to(device)
    before = assign_batch.launches
    got = assign_batch(dev, eff)
    torch.cuda.synchronize()
    if assign_batch.launches != before + 1:
        raise AssertionError(f"assign {name}: "
                             f"{assign_batch.launches - before} launches")
    want = assign_batch_ref(host, eff)
    got = got.cpu()
    if got.dtype != torch.int32 or not torch.equal(got, want):
        bad = (got != want).nonzero()
        raise AssertionError(f"assign {name}: kernel != plain version at "
                             f"{len(bad)} rows, first {bad[:1].tolist()}")
    steps = [jv_steps(c, eff) for c in host.numpy()]
    return dict(case=name, K=K, N=N, eff_n=eff, max_abs_err=0.0,
                steps=[s for s, _ in steps], hops=[h for _, h in steps])


def check_raises(case, device) -> str:
    """The kernel on one of ``RAISE_CASES``: it must raise where the
    plain version does, and with ``err`` given set the flag and return.
    -> the kernel's message."""
    name, K, N, kind = case
    host = torch.from_numpy(costs(kind, K, N, SEED))
    try:
        assign_batch_ref(host)
    except RuntimeError:
        pass
    else:
        raise AssertionError(f"assign {name}: the plain version answered")
    dev = host.to(device)
    try:
        assign_batch(dev)
    except RuntimeError as exc:
        if "did not converge" not in str(exc):
            raise
        msg = str(exc)
    else:
        raise AssertionError(f"assign {name}: the kernel answered")
    err = torch.zeros(1, dtype=torch.int32, device=device)
    assign_batch(dev, err=err)
    if int(err.item()) != 1:
        raise AssertionError(f"assign {name}: err was not set")
    return msg
