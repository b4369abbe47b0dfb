"""The bookkeeping of the port's register JV solve (``csrc/jv.cuh``,
``solve_regs``), modelled in numpy and held to the JAX package's
``solve_one`` bit for bit on the CPU.

The model keeps what the kernel keeps: lane l owns columns l + 32 s;
per column v, minv, way, the matched row p and that row's potential
``uc[j] = u[p[j]]`` (moved along the augmenting path); an argmin in two
stages (each lane's first slot holding its least finite minv, then the
warp's least order-preserving u32 key of those values, -0.0 folded onto
+0.0 and a lane with no finite value at the key of +inf, and the lowest
column holding it);
the winner's minv, p and uc taken from its lane as a shuffle would.
Three planted mistakes (ties to the last index, a raw float-bits key
that puts -0.0 before +0.0, an all-inf step that takes the first inf
column instead of column 0) must each disagree on at least one of the
card check's kinds of matrix (``repro_torch.kernels.assign.check``), so
those cases can catch them in the kernel.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.assign.kernel import assign_pallas, solve_one  # noqa: E402
from repro.kernels.assign.ops import _solve_vmapped  # noqa: E402
from repro_torch.kernels.assign.check import costs as check_costs  # noqa: E402
from repro_torch.kernels.assign.check import jv_steps  # noqa: E402
from repro_torch.kernels.assign.ops import solve_one_ref  # noqa: E402

F32 = np.float32
KEY_INF = 0xFF800000


_solve_eff = jax.jit(solve_one)


class Capped(Exception):
    """The model's step cap: the kernel's error flag."""


def order_key(x):
    """The kernel's u32 key; ``raw`` below skips the fold of -0.0."""
    b = np.asarray(x, F32).view(np.uint32).astype(np.uint64)
    b = np.where(b == 0x80000000, 0, b)
    return np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)


def raw_key(x):
    b = np.asarray(x, F32).view(np.uint32).astype(np.uint64)
    return np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)


def solve_model(cost, eff=None, tie_last=False, key=order_key,
                all_inf_first=False):
    """(N,) int32 column per row, as ``solve_regs`` computes it; raises
    Capped where the kernel would set its error flag."""
    with np.errstate(invalid="ignore"):     # inf - inf after an all-inf step
        return _solve_model(np.asarray(cost, F32), eff, tie_last, key,
                            all_inf_first)


def _solve_model(cost, eff, tie_last, key, all_inf_first):
    N = cost.shape[0]
    eff = N if eff is None else eff
    S = (eff + 32) // 32
    C = 32 * S                              # column j = lane + 32 s
    col = np.arange(C)
    inrange = (col >= 1) & (col <= eff)
    v = np.zeros(C, F32)
    uc = np.zeros(C, F32)
    pc = np.zeros(C, np.int64)
    inf = F32(np.inf)
    for i in range(1, eff + 1):
        minv = np.full(C, inf, F32)
        way = np.zeros(C, np.int64)
        used = np.zeros(C, bool)
        pc[0], uc[0] = i, F32(0)
        j0, i0, ui0 = 0, i, F32(0)
        steps = 0
        while True:
            steps += 1
            if steps > eff + 1:
                raise Capped
            used[j0] = True
            act = ~used & inrange
            row = np.zeros(C, F32)
            row[1:eff + 1] = cost[i0 - 1, :eff]
            cur = (row - ui0) - v
            take = act & (cur < minv)
            minv = np.where(take, cur, minv)
            way = np.where(take, j0, way)
            finite = act & (minv < inf)
            vals = np.where(finite, minv, inf).reshape(S, 32)  # [slot, lane]
            if all_inf_first and not finite.any():
                vals = np.where(act, 0, inf).reshape(S, 32)
            lanes = np.arange(32)
            if tie_last:                        # last slot, last lane
                bs = S - 1 - np.argmin(vals[::-1], axis=0)
            else:                               # each lane's first slot
                bs = np.argmin(vals, axis=0)
            bval = vals[bs, lanes]
            bk = np.where(bval < inf, key(np.where(bval < inf, bval, 0)),
                          KEY_INF)
            holders = [int(bs[l]) * 32 + l for l in range(32)
                       if bk[l] == bk.min()]
            j1 = max(holders) if tie_last else min(holders)
            # the winner's lane sends its masked minv, p and uc
            delta = minv[j1] if act[j1] else inf
            p1, u1 = pc[j1], uc[j1]
            uc = np.where(used, uc + delta, uc).astype(F32)
            v = np.where(used, v - delta, v).astype(F32)
            minv = np.where(act, minv - delta, minv).astype(F32)
            j0, i0, ui0 = j1, p1, u1
            if p1 == 0:
                break
        hops = 0
        while j0 != 0:                          # the warp walks way[]
            hops += 1
            if hops > eff + 1:
                raise Capped
            j1 = way[j0]
            pc[j0], uc[j0] = pc[j1], uc[j1]
            j0 = j1
    out = np.zeros(N, np.int32)
    for j in range(1, eff + 1):
        if pc[j] > 0:
            out[pc[j] - 1] = j - 1
    return out


def reference(cost, eff=None):
    """The JAX package's solve_one on the CPU."""
    if eff is None:
        return np.asarray(_solve_vmapped(jnp.asarray(cost[None])))[0]
    return np.asarray(_solve_eff(jnp.asarray(cost), eff))


def _matrices(seed):
    """Seeded matrices of every kind the card check holds, plus padded
    squares with FORBIDDEN rows and columns."""
    rng = np.random.default_rng(seed)
    out = []
    for kind, N in (("quantised", 8), ("quantised", 40), ("equal_rows", 16),
                    ("minima_32_apart", 48), ("signed_zeros", 24),
                    ("uniform", 36)):
        out += [(kind, c, None) for c in check_costs(kind, 2, N, seed)]
    for N, eff in ((16, 9), (40, 33), (70, 64)):
        c = rng.integers(0, 256, (N, N)).astype(F32) / 64
        T, n = rng.integers(1, eff + 1, 2)
        c[T:, :] = 8192.0                       # dead rows
        c[:, n:] = 8192.0                       # padding columns
        c[rng.random((N, N)) < 0.3] = 8192.0    # forbidden pairs
        out.append(("forbidden", c, int(eff)))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_model_equals_reference(seed):
    for kind, cost, eff in _matrices(seed):
        want = reference(cost, eff)
        np.testing.assert_array_equal(solve_model(cost, eff), want,
                                      err_msg=kind)
        got_ref = solve_one_ref(torch.from_numpy(cost), eff).numpy()
        np.testing.assert_array_equal(got_ref, want, err_msg=kind)


def test_model_equals_pallas_interpret():
    cost = check_costs("signed_zeros", 3, 40, 7)
    want = np.asarray(assign_pallas(jnp.asarray(cost), interpret=True))
    for k in range(3):
        np.testing.assert_array_equal(solve_model(cost[k]), want[k])


def test_signed_zero_ties_take_the_first_index():
    """-0.0 and +0.0 share a key: a +0 before a -0 wins, as in
    jnp.argmin; a raw bits key takes the -0."""
    row = np.array([0.5, 0.0, -0.0, 0.25], F32)
    assert order_key(row[1]) == order_key(row[2])
    assert raw_key(row[2]) < raw_key(row[1])
    assert np.all(np.diff(order_key(np.array(
        [-np.inf, -2.0, -0.0, 0.0, 1e-30, 3.0, np.inf], F32)).astype(
            np.int64)) >= 0)


def test_all_inf_step_ends_in_the_cap():
    """A row of +inf leaves no finite free column: the argmin is column
    0 (used), and every later step of the row too, until the cap."""
    cost = check_costs("inf_row", 1, 64, 0)[0]
    with pytest.raises(Capped):
        solve_model(cost)


# each planted mistake and the card check's kind of matrix that catches it
PLANTED = (("ties to the last index", dict(tie_last=True), "equal_rows"),
           ("ties to the last index", dict(tie_last=True),
            "minima_32_apart"),
           ("raw float-bits key", dict(key=raw_key), "signed_zeros"),
           ("all-inf step takes the first inf column",
            dict(all_inf_first=True), "inf_row"))


@pytest.mark.parametrize("name,planted,kind", PLANTED,
                         ids=[f"{p[0]}-{p[2]}" for p in PLANTED])
def test_planted_mistakes_fail_a_check_case(name, planted, kind):
    """Each mistake gives another answer than the reference on a batch of
    the card check's kind, or answers where the kernel must raise."""
    caught = 0
    for cost in check_costs(kind, 2, 64, 0):
        try:
            want = reference(cost) if kind != "inf_row" else Capped
            solve_model(cost)
        except Capped:
            want = Capped
        try:
            got = solve_model(cost, **planted)
        except Capped:
            got = Capped
        caught += (got is Capped) != (want is Capped) or (
            want is not Capped and not np.array_equal(got, want))
    assert caught > 0, name


def test_step_count_matches_a_direct_count():
    """``jv_steps`` counts one step per argmin: N steps for a diagonal
    of zeros over ones (each row's first step ends its path)."""
    cost = np.ones((10, 10), F32) - np.eye(10, dtype=F32)
    assert jv_steps(cost) == (10, 10)
    assert jv_steps(cost, 4) == (4, 4)
