"""The ``ssd_scan`` kernel and its backward kernel against their plain
versions on the card: the operands, the shapes, the tolerances and the
kernels' names, one copy for ``chip_smoke.py`` and
``tests/test_torch_cuda.py``; the forward's tolerance
(``within_tolerance``) also holds the CPU model of the bf16 kernel's
rounding in ``tests/test_torch_ssd_design.py``.

Tolerance: the f32 final state within ``F32_RTOL`` of max |plain|; y in
f32 within the same; y in bf16 at most ``BF16_ULPS`` bf16 values from
the plain version's f32 result on the same (bf16-valued) inputs, or
within the f32 bound near zero (where a bf16 ulp is finer than f32
rounding of O(1) sums).

The backward (``ssd_scan_bwd``) against ``ssd_scan_bwd_ref`` run in f32
on the same inputs: each of dx, ddt, dA, dB, dC and dD within
``BWD_RTOL`` of its max |plain|, and dx, dB and dC in bf16 also passing
within ``BF16_ULPS`` bf16 values of the plain f32 result (they are
rounded once, from f32 sums).  The kernel takes steps of 64 rows where
the plain version takes chunks of Q, and sums in other orders; both are
f32, so the bound is rounding's many times over, while each planted
fault (``BWD_PLANTS``) moves its output by a large share of its max.
"""
from __future__ import annotations

import time

import torch
import torch.nn.functional as F

from repro_torch.kernels import bf16_steps
from repro_torch.kernels.ssd_scan.ops import (  # noqa: F401
    BWD_PLANTS, BWD_ROWS, _launch_bwd, ssd_scan, ssd_scan_bwd,
    ssd_scan_bwd_ref, ssd_scan_ref)

F32_RTOL = 1e-4
BF16_ULPS = 2
# (name, b, S, H, P, N, chunk) at mamba2-370m's H, P, N: the prefill's
# call (S 500, a ragged last chunk), Q = S = 61, whole chunks, Q 100 (a
# chunk ends inside a 64-row tile, so a 128-row tile reaches into the
# next chunk) with a ragged tail, 16 chunks (the state carried through 15
# updates), and a tail of 2 rows past whole chunks (the f32 kernel's last
# 64-row step holds 2 rows); then zamba2-7b's prefill call (H 112, N 64:
# 4 chunks, 8 of the f32 kernel's steps, the state fed back as a register
# operand at each) and a ragged Q 100 at its shape
CASES = (("prefill B4 S500", 4, 500, 32, 64, 128, 128),
         ("B1 S61 (Q 61)", 1, 61, 32, 64, 128, 128),
         ("B1 S512", 1, 512, 32, 64, 128, 128),
         ("B1 S250 Q100", 1, 250, 32, 64, 128, 100),
         ("B1 S2048", 1, 2048, 32, 64, 128, 128),
         ("B2 S130 (a tail of 2)", 2, 130, 32, 64, 128, 128),
         ("hybrid prefill B4 S500 H112 N64", 4, 500, 112, 64, 64, 128),
         ("N64 B1 S250 Q100", 1, 250, 112, 64, 64, 100))
# the zamba2-7b prefill's call, timed in chip_smoke.py beside the first
HYBRID_CASE = CASES[6]
# every CUDA kernel the wrapper may launch: bf16 and f32 (3xTF32), both
# on tensor cores (profiler names contain these)
KERNEL_NAMES = ("ssd_scan_wgmma_kernel", "ssd_scan_tf32_kernel")
F32_KERNEL = "ssd_scan_tf32_kernel"
BWD_RTOL = 1e-4
BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD")
# the three kernels every backward call launches (either dtype)
BWD_KERNEL_NAMES = ("ssd_scan_bwd_states_kernel", "ssd_scan_bwd_kernel",
                    "ssd_scan_bwd_sum_kernel")
# the case whose backward check also feeds a final state's gradient
BWD_FINAL_CASE = CASES[0][0]


def operands(b: int, S: int, H: int, P: int, N: int, dtype: torch.dtype,
             device, seed: int) -> tuple:
    """One layer's scan operands, drawn as the model draws them: x, B, C
    ~ N(0, 1) in ``dtype``, dt = softplus(N(0, 1) + dt_bias) with the
    init's dt_bias (the inverse softplus of U[1e-3, 1e-1]), A = -U[1,
    16], D = 1."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    u = torch.rand(H, generator=gen, device=device) * (0.1 - 1e-3) + 1e-3
    dt = F.softplus(randn(b, S, H) + u + torch.log(-torch.expm1(-u)))
    A = -(torch.rand(H, generator=gen, device=device) * 15 + 1)
    return (randn(b, S, H, P).to(dtype), dt, A, randn(b, S, N).to(dtype),
            randn(b, S, N).to(dtype), torch.ones(H, device=device))


def outside(y: torch.Tensor, y_plain: torch.Tensor) -> torch.Tensor:
    """Mask of the elements of y (f32 or bf16) outside the tolerance of
    ``y_plain`` (f32): more than ``F32_RTOL`` of max |y_plain| away and,
    in bf16, also more than ``BF16_ULPS`` bf16 values away.  A NaN is
    outside (every comparison is written so that NaN fails it)."""
    bad = ~((y.float() - y_plain).abs() <= F32_RTOL * float(
        y_plain.abs().max()))
    if y.dtype == torch.bfloat16:
        bad &= ~(bf16_steps(y, y_plain.to(y.dtype)) <= BF16_ULPS)
    return bad


def tolerance_used(y: torch.Tensor, y_plain: torch.Tensor,
                   state: torch.Tensor, state_plain: torch.Tensor) -> dict:
    """The share of the f32 bound a result uses: max |d| / (``F32_RTOL``
    max |plain|), of y and of the final state (1 is at the bound; bf16's
    y may pass above 1 within ``BF16_ULPS``)."""
    def share(got, want):
        return float((got.float() - want).abs().max()) / (
            F32_RTOL * float(want.abs().max()))
    return {"y": share(y, y_plain), "state": share(state, state_plain)}


def within_tolerance(y: torch.Tensor, y_plain: torch.Tensor,
                     state: torch.Tensor, state_plain: torch.Tensor) -> int:
    """The tolerance of a scan against its plain version: the count of
    elements of y (``outside``) and of the f32 final state (more than
    ``F32_RTOL`` of max |state_plain| away, or NaN) outside it; 0 is
    within."""
    d_state = (state - state_plain).abs()
    return int(outside(y, y_plain).sum()) + int(
        (~(d_state <= F32_RTOL * float(state_plain.abs().max()))).sum())


def check_scan(args: tuple, chunk: int, label: str) -> tuple:
    """One launch of the kernel on ``args`` (CUDA tensors) against the
    plain version run in f32 on the same inputs; raises AssertionError
    outside the tolerance.  -> (max |d| of y, ``tolerance_used``)."""
    x = args[0]
    before = ssd_scan.launches
    with torch.inference_mode():
        y, fin = ssd_scan(*args, chunk=chunk)
        yr, sr = ssd_scan_ref(*(a.float() for a in args), chunk=chunk)
    torch.cuda.synchronize()
    if ssd_scan.launches != before + 1 or y.dtype != x.dtype \
            or fin.dtype != torch.float32 or y.shape != x.shape:
        raise AssertionError(
            f"{label}: {ssd_scan.launches - before} launches, y "
            f"{tuple(y.shape)} {y.dtype}, state {fin.dtype}")
    diff = (y.float() - yr).abs()
    if within_tolerance(y, yr, fin, sr):
        bad = outside(y, yr)
        d_state = float((fin - sr).abs().max())
        at = tuple(int(i) for i in bad.nonzero()[0]) if bad.any() else ()
        raise AssertionError(
            f"{label}: kernel != plain version at {int(bad.sum())} "
            f"elements of y, first {at} (max |d| {float(diff.max())!r}); "
            f"state max |d| {d_state!r}")
    return float(diff.max()), tolerance_used(y, yr, fin, sr)


def kernels_launched(args: tuple, chunk: int, seconds: float = 0.05) -> set:
    """The entries of ``KERNEL_NAMES`` whose names the profiler's trace
    of ``seconds`` of calls on ``args`` (CUDA tensors) holds as device
    kernels, after one untraced call (a trace late in a long process can
    miss the launches of its first milliseconds: 20 calls, about 2 ms of
    the card's time, once held none in eight traces)."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                ssd_scan(*args, chunk=chunk)
            torch.cuda.synchronize()
    return {name for ev in prof.key_averages() for name in KERNEL_NAMES
            if name in ev.key}


def check_refusals(device) -> None:
    """The wrapper refuses, before any launch, a (P, N) the kernel was
    not built for and a chunk over its shared-memory limit."""
    for (b, S, H, P, N), chunk, what in (((1, 32, 2, 32, 16), 128,
                                          "no kernel build"),
                                         ((1, 32, 2, 64, 32), 128,
                                          "no kernel build"),
                                         ((1, 256, 2, 64, 128), 256,
                                          "chunk")):
        args = operands(b, S, H, P, N, torch.float32, device, 0)
        before = ssd_scan.launches
        try:
            ssd_scan(*args, chunk=chunk)
        except NotImplementedError as e:
            if what not in str(e) or ssd_scan.launches != before:
                raise AssertionError(f"ssd_scan refusal: {e}") from e
        else:
            raise AssertionError(f"ssd_scan took (P, N) {(P, N)}, chunk "
                                 f"{chunk}")


def bwd_operands(case, dtype: torch.dtype, device, seed: int) -> tuple:
    """``operands`` of ``case`` (a ``CASES`` entry), dy ~ N(0, 1) in
    ``dtype``, and a final state's gradient ~ N(0, 1) (f32) for
    ``BWD_FINAL_CASE``, else None."""
    name, b, S, H, P, N, _ = case
    args = operands(b, S, H, P, N, dtype, device, seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    dy = torch.randn((b, S, H, P), generator=gen, device=device).to(dtype)
    dfin = (torch.randn((b, H, P, N), generator=gen, device=device)
            if name == BWD_FINAL_CASE else None)
    return (*args, dy, dfin)


def bwd_outside(got, want) -> dict:
    """{output name: count of its elements outside the backward's
    tolerance} for the kernel's gradients ``got`` against the plain
    version's f32 ``want`` (NaN counts as outside)."""
    out = {}
    for name, g, w in zip(BWD_NAMES, got, want):
        bad = ~((g.float() - w).abs() <= BWD_RTOL * float(w.abs().max()))
        if g.dtype == torch.bfloat16:
            bad &= ~(bf16_steps(g, w.to(g.dtype)) <= BF16_ULPS)
        out[name] = int(bad.sum())
    return out


def bwd_shares(got, want) -> dict:
    """{output name: max |d| / (``BWD_RTOL`` max |plain|)}: the share of
    the f32 bound each output uses (bf16 outputs may pass above 1 within
    ``BF16_ULPS``)."""
    return {name: float((g.float() - w).abs().max())
            / (BWD_RTOL * float(w.abs().max()))
            for name, g, w in zip(BWD_NAMES, got, want)}


def check_bwd(args: tuple, label: str) -> tuple:
    """One backward launch on ``args`` (``bwd_operands``: CUDA tensors)
    against the plain backward in f32 on the same inputs; raises
    AssertionError outside the tolerance.  -> (max |d| over the six
    outputs, ``bwd_shares``, the kernel's gradients)."""
    *fwd, dy, dfin = args
    before = ssd_scan_bwd.launches
    with torch.no_grad():
        got = ssd_scan_bwd(*fwd, dy, dfin)
        want = ssd_scan_bwd_ref(*(a.float() for a in fwd), dy.float(),
                                dfin)
    torch.cuda.synchronize()
    if ssd_scan_bwd.launches != before + 1 or got[0].dtype != fwd[0].dtype \
            or got[3].dtype != fwd[3].dtype:
        raise AssertionError(f"{label}: {ssd_scan_bwd.launches - before} "
                             f"launches, dx {got[0].dtype}, dB "
                             f"{got[3].dtype}")
    bad = bwd_outside(got, want)
    shares = bwd_shares(got, want)
    if any(bad.values()):
        raise AssertionError(f"{label}: kernel != plain backward, elements "
                             f"outside the tolerance {bad}; shares of the "
                             f"bound {shares}")
    err = max(float((g.float() - w).abs().max()) for g, w in zip(got, want))
    return err, shares, got


def check_bwd_case(case, dtype: torch.dtype, device, seed: int) -> dict:
    """``check_bwd`` on ``case``; in bf16 a second call must give the
    same bits.  -> {"max_abs_err", "shares"}."""
    args = bwd_operands(case, dtype, device, seed)
    label = f"ssd_scan_bwd {case[0]} {str(dtype).split('.')[-1]}"
    err, shares, got = check_bwd(args, label)
    if dtype == torch.bfloat16:
        _, _, again = check_bwd(args, label + " (again)")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{label}: two calls differ")
    return dict(max_abs_err=err, shares=shares)


def check_bwd_plants(case, dtype: torch.dtype, device, seed: int) -> dict:
    """Each of ``BWD_PLANTS`` planted in the kernel must fail the check
    on ``case``.  -> {fault: {output outside the tolerance: its max |d|
    / max |plain|}}."""
    *fwd, dy, dfin = bwd_operands(case, dtype, device, seed)
    with torch.no_grad():
        want = ssd_scan_bwd_ref(*(a.float() for a in fwd), dy.float(), dfin)
    read = {}
    for fault, plant in BWD_PLANTS.items():
        with torch.no_grad():
            got = _launch_bwd(*fwd, dy, dfin, plant)
        torch.cuda.synchronize()
        bad = bwd_outside(got, want)
        if not any(bad.values()):
            raise AssertionError(f"ssd_scan_bwd {case[0]} planted {fault!r}: "
                                 "passes the tolerance")
        read[fault] = {
            name: float((g.float() - w).abs().max() / w.abs().max())
            for (name, n), g, w in zip(bad.items(), got, want) if n}
    return read


def bwd_kernels_launched(args: tuple, seconds: float = 0.05) -> set:
    """The entries of ``BWD_KERNEL_NAMES`` the profiler's trace of
    ``seconds`` of backward calls on ``args`` holds (after one untraced
    call, as ``kernels_launched``)."""
    from torch.profiler import ProfilerActivity, profile
    *fwd, dy, dfin = args
    with torch.no_grad():
        ssd_scan_bwd(*fwd, dy, dfin)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                ssd_scan_bwd(*fwd, dy, dfin)
            torch.cuda.synchronize()
    return {name for ev in prof.key_averages() for name in BWD_KERNEL_NAMES
            if name in ev.key}


def bwd_bound(b: int, S: int, H: int, P: int, N: int,
              itemsize: int) -> tuple:
    """(bytes, operations) of one backward call: x, dy, dx (b S H P), B,
    C, dB, dC (b S N) at ``itemsize``, dt and ddt (b S H) in f32, each
    moved once; per (row, head, step of ``BWD_ROWS``) R (R + 1) (2 P +
    2 N) flops of pair terms and 10 R P N of state terms, plus C B^T once
    a (row, step) (``csrc/ssd_scan_bwd.cu``'s header), over this call's
    steps (the last one ragged).  The gradient does not depend on the
    forward's chunk, so its pairs are counted at the kernel's steps."""
    n_bytes = (3 * b * S * H * P + 4 * b * S * N) * itemsize \
        + 2 * b * S * H * 4
    n_ops = 0
    for r0 in range(0, S, BWD_ROWS):
        r = min(BWD_ROWS, S - r0)
        n_ops += b * H * (r * (r + 1) * (2 * P + 2 * N) + 10 * r * P * N)
        n_ops += b * r * (r + 1) * N
    return n_bytes, n_ops
