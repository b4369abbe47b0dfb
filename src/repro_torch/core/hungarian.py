"""Hungarian algorithm (min-cost assignment), host-side numpy.

The port's copy of the JAX package's host solvers: ``hungarian`` (scipy's
C solver when present, else the pure-numpy Jonker-Volgenant
``_hungarian_np``), and the f32 twin of the device JV solver
(``solve_device_np``) that the recurrent tracker's association runs
through ``hungarian_device_np``.  Rectangular matrices are padded with a
large cost; pairs matched to padding are reported as unmatched.  Used by
the recurrent tracker and the SORT tracker.  ``hungarian_batch`` solves
many problems in one launch of the ``assign`` kernel.  ``optimality_gap``
measures how far an f32 twin's assignment lies from the exact optimum of
its padded square.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import Device, resolve_device
from repro_torch.kernels.assign import assign_batch

try:                                    # optional dependency
    from scipy.optimize import linear_sum_assignment as _lsa
except ImportError:                     # pragma: no cover
    _lsa = None

BIG = 1e9
# finite forbidden sentinel for the f32 device solver: large enough that
# any assignment using fewer forbidden edges wins (N * max real cost
# <= 64 * 2 << 2^13), small enough that f32 potential updates keep real
# cost differences resolvable
FORBIDDEN_DEVICE = 2.0 ** 13
# the f32 solver is not exact: its potentials carry sentinel-scale
# values, where f32 resolves costs only to its spacing at
# FORBIDDEN_DEVICE (2^-10), so its assignment can be dearer than the
# optimum by about that spacing (tools/jv_gap.py measures it); a check
# that holds one run's assignments to another's allows four spacings
DEVICE_JV_GAP = 4 * FORBIDDEN_DEVICE * 2.0 ** -23


def hungarian(cost: np.ndarray) -> List[Tuple[int, int]]:
    """cost: (n, m) -> list of (row, col) matched pairs (only real pairs;
    entries with cost >= BIG/2 are treated as forbidden).

    Dispatches to scipy's C implementation when available;
    ``_hungarian_np`` is the dependency-free fallback.
    Both return a min-cost assignment — tie-breaking between equal-cost
    optima may differ, totals never do."""
    n, m = cost.shape
    if n == 0 or m == 0:
        return []
    if _lsa is not None:
        rows, cols = _lsa(cost)
        return [(int(r), int(c)) for r, c in zip(rows, cols)
                if cost[r, c] < BIG / 2]
    return _hungarian_np(cost)


def _hungarian_np(cost: np.ndarray) -> List[Tuple[int, int]]:
    """Pure-numpy Jonker-Volgenant: rectangular matrices are solved
    directly with rows = the SHORT side (transposing when n > m), so a
    few detections against max_tracks tracks runs min(n, m) augmenting
    paths instead of max(n, m).  Pairs come back row-sorted (the same
    ordering scipy's dispatch path emits)."""
    n, m = cost.shape
    if n == 0 or m == 0:
        return []
    if n > m:
        # invert the transposed solution with an O(n) counting pass —
        # the old path swapped axes then ran a full comparison sort on
        # output the solver had already ordered once
        col_of = np.full(n, -1, np.int64)
        for c, r in _hungarian_np(cost.T):
            col_of[r] = c
        return [(r, int(c)) for r, c in enumerate(col_of) if c >= 0]
    a = np.full((n + 1, m + 1), BIG, np.float64)
    a[1:, 1:] = cost
    u = np.zeros(n + 1)
    v = np.zeros(m + 1)
    p = np.zeros(m + 1, np.int64)         # p[j] = row matched to col j
    way = np.zeros(m + 1, np.int64)
    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = np.full(m + 1, np.inf)
        used = np.zeros(m + 1, bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            cur = a[i0, 1:] - u[i0] - v[1:]
            # vectorized column scan: update minv/way over unused columns
            # and pick the argmin (first index on ties, matching the
            # scalar loop this replaces — it dominated association cost
            # at max_tracks=64)
            free = ~used[1:]
            take = free & (cur < minv[1:])
            minv[1:][take] = cur[take]
            way[1:][take] = j0
            masked = np.where(free, minv[1:], np.inf)
            j1 = int(np.argmin(masked)) + 1
            delta = masked[j1 - 1]
            u[p[used]] += delta
            v[np.flatnonzero(used)] -= delta
            minv[~used] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    # emit ROW-sorted (the contract, matching scipy) via linear inversion
    # of the col -> row matching instead of sorting afterwards
    col_of = np.full(n, -1, np.int64)
    for j in range(1, m + 1):
        i = int(p[j])
        if i >= 1 and cost[i - 1, j - 1] < BIG / 2:
            col_of[i - 1] = j - 1
    return [(r, int(c)) for r, c in enumerate(col_of) if c >= 0]


def solve_device_np(cost: np.ndarray) -> np.ndarray:
    """Numpy float32 twin of ``kernels.assign.kernel.solve_one`` — a
    line-by-line port (same update order, same first-index argmin
    tie-break, same f32 arithmetic), so its output is bit-identical to
    the device solver on the same matrix.  cost: (N, N) finite f32 ->
    (N,) int32 matched column per row (full permutation)."""
    cost = np.asarray(cost, np.float32)
    N = cost.shape[0]
    a = np.zeros((N + 1, N + 1), np.float32)
    a[1:, 1:] = cost
    rows1 = np.arange(N + 1, dtype=np.int32)
    u = np.zeros(N + 1, np.float32)
    v = np.zeros(N + 1, np.float32)
    p = np.zeros(N + 1, np.int32)
    for i in range(1, N + 1):
        p[0] = i
        j0 = 0
        way = np.zeros(N + 1, np.int32)
        minv = np.full(N + 1, np.inf, np.float32)
        used = np.zeros(N + 1, bool)
        while p[j0] != 0:
            used[j0] = True
            i0 = p[j0]
            cur = (a[i0] - u[i0]) - v                    # f32 (N+1,)
            free = ~used
            take = free & (cur < minv)
            minv = np.where(take, cur, minv)
            way = np.where(take, j0, way).astype(np.int32)
            masked = np.where(free, minv, np.float32(np.inf))
            j1 = int(np.argmin(masked))                  # first index on ties
            delta = masked[j1]
            row_hit = ((p[None, :] == rows1[:, None])
                       & used[None, :]).any(1)
            u = np.where(row_hit, u + delta, u).astype(np.float32)
            v = np.where(used, v - delta, v).astype(np.float32)
            minv = np.where(free, minv - delta, minv).astype(np.float32)
            j0 = j1
        while j0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    col_of = np.zeros(N, np.int32)
    col_of[p[1:] - 1] = np.arange(N, dtype=np.int32)
    return col_of


def assoc_side(n: int, m: int, min_bucket: int = 8) -> int:
    """Canonical square size for tracker association: the power-of-two
    bucket of max(n, m), floored at ``min_bucket``.  Every association
    path — this host twin, the per-frame fused kernel, and the chunk
    scan (via ``solve_one``'s dynamic ``eff_n``) — solves EXACTLY this
    square, because f32 JV results are not invariant to the padded
    size: a forced forbidden match pushes sentinel-scale deltas through
    the potentials, and the rounding of real-cost differences then
    depends on which padding columns the search walked."""
    side = max(1, min_bucket)
    need = max(n, m)
    while side < need:
        side *= 2
    return side


def hungarian_device_np(cost: np.ndarray) -> List[Tuple[int, int]]:
    """Host twin of the DEVICE association path: pad to the canonical
    ``assoc_side`` square with the finite ``FORBIDDEN_DEVICE``
    sentinel, solve with the f32 JV twin, filter forbidden pairs — the
    same contract as ``hungarian_batch`` for a batch of one, minus the
    device dispatch.

    Used by ``RecurrentTracker`` so that its pair selection (ties
    included) is bit-identical to ``kernels.track_step``'s on-device
    assignment, which restricts its solve to the same square via
    ``solve_one(eff_n=...)`` no matter how many slots its buffers
    carry."""
    n, m = cost.shape
    if n == 0 or m == 0:
        return []
    side = assoc_side(n, m)
    sq = np.full((side, side), FORBIDDEN_DEVICE, np.float32)
    sq[:n, :m] = np.minimum(cost, FORBIDDEN_DEVICE)
    cols = solve_device_np(sq)
    return [(r, int(cols[r])) for r in range(n)
            if cols[r] < m and cost[r, cols[r]] < BIG / 2]


def optimality_gap(cost: np.ndarray, pairs) -> float:
    """How much dearer ``pairs`` (``hungarian_device_np``'s answer for
    ``cost``, or any set of real pairs) is than the exact optimum of the
    padded square that solver solves: both totals in float64, every row
    left out of ``pairs`` at ``FORBIDDEN_DEVICE``, the optimum by scipy's
    exact solver.  0 for an optimal assignment; at least about
    ``FORBIDDEN_DEVICE`` less the real costs for one with fewer real
    pairs than the most it could have."""
    if _lsa is None:                     # pragma: no cover
        raise RuntimeError("optimality_gap needs scipy")
    n, m = cost.shape
    side = assoc_side(n, m)
    sq = np.full((side, side), FORBIDDEN_DEVICE, np.float64)
    sq[:n, :m] = np.minimum(np.asarray(cost, np.float64), FORBIDDEN_DEVICE)
    rows, cols = _lsa(sq)
    pairs = list(pairs)
    total = sum(float(sq[t, d]) for t, d in pairs) + \
        (side - len(pairs)) * FORBIDDEN_DEVICE
    return total - float(sq[rows, cols].sum())


def hungarian_batch(costs: Sequence[np.ndarray], device: Device = "cuda"
                    ) -> List[List[Tuple[int, int]]]:
    """Solve K independent (possibly rectangular) assignment problems in
    ONE launch of the batched ``assign`` kernel on ``device`` (its plain
    version for ``device="cpu"``).

    Same contract as ``hungarian`` per problem: entries >= BIG/2 are
    forbidden and never reported.  Matrices are padded to a common square
    with the finite ``FORBIDDEN_DEVICE`` sentinel (the solver runs f32, so
    real costs must stay << 2^13 — association costs here are <= 1).
    Tie-breaking between equal-cost optima may differ from the host
    solvers; totals never do."""
    mats = [np.asarray(c, np.float32) for c in costs]
    if not mats:
        return []
    side = max(max(c.shape[0] for c in mats), max(c.shape[1] for c in mats))
    if side == 0 or all(c.shape[0] == 0 or c.shape[1] == 0 for c in mats):
        return [[] for _ in mats]
    batch = np.full((len(mats), side, side), FORBIDDEN_DEVICE, np.float32)
    for k, c in enumerate(mats):
        n, m = c.shape
        batch[k, :n, :m] = np.minimum(c, FORBIDDEN_DEVICE)
    cols = assign_batch(torch.from_numpy(batch).to(resolve_device(device)))
    cols = cols.cpu().numpy()
    out: List[List[Tuple[int, int]]] = []
    for k, c in enumerate(mats):
        n, m = c.shape
        out.append([(r, int(cols[k, r])) for r in range(n)
                    if cols[k, r] < m and c[r, cols[k, r]] < BIG / 2])
    return out
