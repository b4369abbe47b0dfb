"""The rounding of the port's bf16 ``ssd_scan`` kernel on tensor cores
(``csrc/ssd_scan.cu``, ``ssd_scan_wgmma_kernel``), modelled in PyTorch
on the CPU and held to the plain version (``ssd_scan_ref``) through the
card check's own tolerance (``kernels.ssd_scan.check.within_tolerance``:
y within 2 bf16 ulps or 1e-4 of max |plain|, the f32 state within 1e-4
of max |plain|).

The model rounds where the kernel rounds.  The tensor cores take bf16
operands and sum in f32; x, B and C arrive in bf16, so their products
are exact.  Three operands are f32: M = (C B^T) * decay * dt (dt folded
into M), the carried state, and x * w.  The kernel splits each into
hi = bf16(v) and lo = bf16(v - hi) and feeds both into one f32
accumulator, which the model writes as hi + lo (exact in f32).  The
cumulative sum of dt A (each term rounded first) runs in the kernel's
order: lane l of a warp sums rows 4 l .. 4 l + 3 in turn, a
Hillis-Steele scan combines the 32 lane totals, and each row adds its
lane's exclusive prefix.  The decay and w take e^x as 2^(x log2 e);
exp is evaluated only at or below the diagonal.  The sums of the
products run in another order than the kernel's (f32 rounding only).

The model holds at every case of the card check.  Each single rounding
(M, the state or x * w rounded to bf16 once) fails the tolerance at the
prefill's call and at B 1, S 512, and so does a mask applied by
multiplying after exp (exp above the diagonal overflows, inf * 0 is
NaN): the design needs all three splits and the select.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ssd_scan import check  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import (  # noqa: E402
    _padded, ssd_scan_ref)

LANES, PER_LANE = 32, 4          # the scan's warp: 128 rows a chunk
LOG2E = 1.4426950408889634
SEED = 40                        # the card check's seeds (chip_smoke.py)
CASES = {c[0]: c for c in check.CASES}
FAIL_CASES = ("prefill B4 S500", "B1 S512")


@pytest.fixture(autouse=True)
def _one_thread():
    # small eager ops run faster on one thread at these sizes
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def warp_cumsum(dA: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum over axis 1 (128 rows) in f32, in the
    kernel's order (see the module docstring)."""
    b, T, H = dA.shape
    v = dA.reshape(b, LANES, PER_LANE, H)
    loc = [v[:, :, 0]]
    for k in range(1, PER_LANE):
        loc.append(loc[-1] + v[:, :, k])
    loc = torch.stack(loc, dim=2)
    tot = loc[:, :, -1]
    d = 1
    while d < LANES:
        tot = torch.cat([tot[:, :d], tot[:, d:] + tot[:, :-d]], dim=1)
        d *= 2
    excl = torch.cat([torch.zeros_like(tot[:, :1]), tot[:, :-1]], dim=1)
    return (excl[:, :, None] + loc).reshape(b, T, H)


def exp_approx(x: torch.Tensor) -> torch.Tensor:
    """The kernel's e^x for the decay and w: 2^(x log2 e), the product
    rounded to f32 (the special-function unit's own 2^-22 relative error
    is not modelled)."""
    return torch.exp2(x * LOG2E)


def operand(v: torch.Tensor, split: bool) -> torch.Tensor:
    """An f32 operand as the tensor cores see it: bf16(v), plus
    bf16(v - bf16(v)) when split."""
    hi = v.to(torch.bfloat16).float()
    return hi + (v - hi).to(torch.bfloat16).float() if split else hi


def kernel_model(x, dt, A, B, C, D, chunk: int, split_m: bool = True,
                 split_state: bool = True, split_xw: bool = True,
                 select: bool = True):
    """y (bf16) and the final state (f32) as the kernel rounds them, on
    f32 tensors holding bf16 values of x, B, C."""
    b, S, H, P = x.shape
    Q = min(chunk, S)
    x, dt, B, C = _padded(x, dt, B, C, Q)
    rows = LANES * PER_LANE
    tri = torch.ones((Q, Q), dtype=torch.bool).tril()[None, :, :, None]
    state = torch.zeros((b, H, P, B.shape[-1]))
    ys = []
    for c0 in range(0, x.shape[1], Q):
        xc, dtc = x[:, c0:c0 + Q], dt[:, c0:c0 + Q]
        Bc, Cc = B[:, c0:c0 + Q], C[:, c0:c0 + Q]
        dA = torch.nn.functional.pad(dtc * A, (0, 0, 0, rows - Q))
        L = warp_cumsum(dA)[:, :Q]                            # (b,t,H)
        LQ = L[:, -1]
        G = torch.einsum("btn,bjn->btj", Cc, Bc)[..., None]   # (b,t,j,1)
        decay = exp_approx(L[:, :, None] - L[:, None])        # (b,t,j,H)
        if select:
            M = torch.where(tri, G * decay * dtc[:, None], 0.0)
        else:
            M = G * decay * dtc[:, None] * tri
        y = torch.exp(L)[..., None] * torch.einsum(
            "btn,bhpn->bthp", Cc, operand(state, split_state))
        y = y + torch.einsum("btjh,bjhp->bthp", operand(M, split_m), xc)
        ys.append(y + D[None, None, :, None] * xc)
        w = exp_approx(LQ[:, None] - L) * dtc
        xw = operand(xc * w[..., None], split_xw)
        state = torch.exp(LQ)[..., None, None] * state + torch.einsum(
            "bthp,btn->bhpn", xw, Bc)
    return torch.cat(ys, dim=1)[:, :S].to(torch.bfloat16), state


@functools.lru_cache(maxsize=None)
def case_data(name: str):
    """The card check's bf16 operands of a case (as f32 tensors) and the
    plain version's y and state on them, on the CPU."""
    i = [c[0] for c in check.CASES].index(name)
    _, b, S, H, P, N, chunk = CASES[name]
    args = tuple(a.float() for a in check.operands(
        b, S, H, P, N, torch.bfloat16, "cpu", SEED + i))
    with torch.inference_mode():
        return args, chunk, ssd_scan_ref(*args, chunk=chunk)


def outside(name: str, **variant) -> int:
    args, chunk, (y_plain, state_plain) = case_data(name)
    with torch.inference_mode():
        y, state = kernel_model(*args, chunk, **variant)
    return check.within_tolerance(y, y_plain, state, state_plain)


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_rounding_holds_the_card_tolerance(name):
    assert outside(name) == 0


@pytest.mark.parametrize("name", FAIL_CASES)
@pytest.mark.parametrize("variant", ["split_m", "split_state",
                                     "split_xw"])
def test_rounding_an_f32_operand_once_fails_it(name, variant):
    assert outside(name, **{variant: False}) > 0


@pytest.mark.parametrize("name", FAIL_CASES)
def test_masking_by_multiplying_after_exp_fails_it(name):
    args, chunk, _ = case_data(name)
    with torch.inference_mode():
        y, _ = kernel_model(*args, chunk, select=False)
    assert torch.isnan(y).any()
    assert outside(name, select=False) > 0


def test_the_scan_order_is_a_cumulative_sum():
    dA = -torch.rand((2, LANES * PER_LANE, 3), dtype=torch.float64)
    torch.testing.assert_close(warp_cumsum(dA), torch.cumsum(dA, dim=1))
