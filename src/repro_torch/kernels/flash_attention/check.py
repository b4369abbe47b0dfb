"""The ``flash_attention`` kernel against its plain version on the card:
the cases, the operands, the comparison and the refusals, one copy for
``chip_smoke.py`` and ``tests/test_torch_cuda.py``; the same for its
backward, ``flash_attention_bwd`` (``BWD_CASES``, ``check_bwd_case``).

Tolerance (``kernel_agrees``, which ``decode_attention.check`` shares):
f32 max |d| at most ``ATTN_F32_ATOL``; bf16 at most one bf16 value
apart from the plain version's bf16 result, except near zero, where a
bf16 ulp is finer than f32 rounding of O(1) sums and the f32 bound
applies.

Tolerance of the backward (``grads_agree``), per gradient (dq, dk, dv)
against ``flash_attention_bwd_ref`` (``torch.autograd.grad`` of the plain
version) on the same inputs: f32 max |d| at most ``GRAD_F32_RTOL`` times
the plain gradient's max |value| (gradients are not O(1): sums over up
to 1500 keys or queries in another order, with exp in f32, move them
about 1e-6 of that); bf16 at most one bf16 value apart, except where
|d| is at most ``GRAD_BF16_RTOL`` (one bf16 ulp at the largest
magnitude) times that max: near zero, and where the kernel's Di =
rowsum(dO * O) reads the forward's output rounded to bf16 (the plain
version's own output is f32 inside its graph): at D 128 that moves Di by
up to a few hundredths and dq two bf16 values at a few elements (0.0041
of max |dq| at one element of the D 128 S 512 case on the card).
Planted faults (``BWD_FAULTS``, applied to
``flash_attention_bwd_model``, the kernel's algorithm in plain PyTorch,
and Di dropped in the kernel itself) read 0.4 to 2.8 of max |plain|.
"""
from __future__ import annotations

import time

import torch

import math
from typing import Optional, Tuple

from repro_torch.kernels import bf16_steps
from repro_torch.kernels.flash_attention.ops import (
    NEG_INF, flash_attention, flash_attention_bwd, flash_attention_bwd_ref,
    flash_attention_ref)

ATTN_F32_ATOL = 1e-5
LOG2E = 1.4426950408889634
B = 4
# qwen2-0.5b's heads: 14 query heads over 2 KV heads of 64
HQ, HKV, D = 14, 2, 64
# zamba2-7b's shared attention block: 32 query heads over 32 KV heads of 112
HYBRID_HEADS = (32, 32, 112)
# deepseek-moe-16b's: 16 query heads over 16 KV heads of 128
MOE_HEADS = (16, 16, 128)
# the other head-dim-128 layouts of the configs: grok-1-314b's 48 over 8,
# deepseek-67b's 64 over 8 and deepseek-coder-33b's 56 over 8 (a group of
# 7, no power of two)
D128_LAYOUTS = {"grok-1-314b": (48, 8, 128), "deepseek-67b": (64, 8, 128),
                "deepseek-coder-33b": (56, 8, 128)}
# (name, dtype, Sq, Skv, causal, kv_valid, (Hq, Hkv, D)): the serving
# shape (S 512) in both dtypes, the prefill's own S 500 (the ragged edge,
# masked in the kernel), Sq 128 < Skv 512 causal (queries at the end of
# the keys), non-causal, kv_valid 500, and Sq 512 > Skv 256 causal, whose
# first 256 rows see no key (they must be 0), at qwen2-0.5b's heads; then
# zamba2-7b's prefill (S 500) and S 512 at head dim 112 (two 64-column
# panels, the second 48 wide), both dtypes; deepseek-moe-16b's the same
# at head dim 128 (two whole panels), and S 512 at each of the other
# head-dim-128 layouts, both dtypes (the f32 cases span 8 query tiles)
CASES = (("S512 causal", torch.bfloat16, 512, 512, True, 0, (HQ, HKV, D)),
         ("S512 causal", torch.float32, 512, 512, True, 0, (HQ, HKV, D)),
         ("S500 causal", torch.bfloat16, 500, 500, True, 0, (HQ, HKV, D)),
         ("S500 causal", torch.float32, 500, 500, True, 0, (HQ, HKV, D)),
         ("Sq128 Skv512 causal", torch.bfloat16, 128, 512, True, 0,
          (HQ, HKV, D)),
         ("S512 non-causal", torch.float32, 512, 512, False, 0,
          (HQ, HKV, D)),
         ("S512 kv_valid 500 non-causal", torch.bfloat16, 512, 512, False,
          500, (HQ, HKV, D)),
         ("Sq512 Skv256 causal (no key for rows < 256)", torch.float32,
          512, 256, True, 0, (HQ, HKV, D)),
         ("D112 S500 causal", torch.bfloat16, 500, 500, True, 0,
          HYBRID_HEADS),
         ("D112 S500 causal", torch.float32, 500, 500, True, 0,
          HYBRID_HEADS),
         ("D112 S512 causal", torch.bfloat16, 512, 512, True, 0,
          HYBRID_HEADS),
         ("D112 S512 causal", torch.float32, 512, 512, True, 0,
          HYBRID_HEADS),
         ("D128 S500 causal", torch.bfloat16, 500, 500, True, 0, MOE_HEADS),
         ("D128 S500 causal", torch.float32, 500, 500, True, 0, MOE_HEADS),
         ("D128 S512 causal", torch.bfloat16, 512, 512, True, 0, MOE_HEADS),
         ("D128 S512 causal", torch.float32, 512, 512, True, 0, MOE_HEADS)
         ) + tuple((f"D128 {arch} S512 causal", dt, 512, 512, True, 0, heads)
                   for arch, heads in D128_LAYOUTS.items()
                   for dt in (torch.bfloat16, torch.float32))
# whisper-small's heads (MHA, 12 of 12 of 64) and pixtral-12b's (32 of 8
# of 128, a group of 4)
WHISPER_HEADS = (12, 12, 64)
PIXTRAL_HEADS = (32, 8, 128)
# the encdec and vlm cells' calls, both dtypes: whisper's encoder (S 1500
# = 11 x 128 + 92 keys, non-causal), its cross-attention (Sq 500 against
# Skv 1500, non-causal: the queries-at-the-end shift must mask nothing),
# its decoder's self-attention (S 500, causal); pixtral's longest prompt
# (S 1524, causal) and S 512.  Kept apart from CASES, whose f32 cases
# tests/test_torch_tf32_design.py models whole on the CPU (these it
# models at one row and one KV head's group: SERVE_CASES there)
SERVE_CASES = tuple(
    (name, dt, Sq, Skv, causal, 0, heads)
    for name, Sq, Skv, causal, heads in (
        ("D64 MHA12 S1500 non-causal", 1500, 1500, False, WHISPER_HEADS),
        ("D64 MHA12 Sq500 Skv1500 non-causal", 500, 1500, False,
         WHISPER_HEADS),
        ("D64 MHA12 S500 causal", 500, 500, True, WHISPER_HEADS),
        ("D128 pixtral-12b S1524 causal", 1524, 1524, True, PIXTRAL_HEADS),
        ("D128 pixtral-12b S512 causal", 512, 512, True, PIXTRAL_HEADS))
    for dt in (torch.bfloat16, torch.float32))
# head dims the wrapper must refuse on a CUDA tensor: no kernel build
UNBUILT_HEAD_DIMS = (32, 96)


# every CUDA kernel the wrapper may launch: bf16 and f32 (3xTF32), both
# on tensor cores (profiler names contain these)
KERNEL_NAMES = ("flash_attention_wgmma_kernel", "flash_attention_tf32_kernel")
F32_KERNEL = "flash_attention_tf32_kernel"


def case_id(case) -> str:
    return f"{case[0]} {str(case[1]).split('.')[-1]}"


def operands(shapes, dtype: torch.dtype, device, seed: int) -> list:
    """N(0, 1) tensors of ``shapes`` in ``dtype``, drawn from ``seed``
    on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return [torch.randn(s, generator=gen, device=device).to(dtype)
            for s in shapes]


def case_operands(case, device, seed: int) -> list:
    """q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D) of one of ``CASES``."""
    _, dtype, Sq, Skv, _, _, (hq, hkv, d) = case
    return operands([(B, Sq, hq, d), (B, Skv, hkv, d), (B, Skv, hkv, d)],
                    dtype, device, seed)


def kernel_agrees(got: torch.Tensor, want: torch.Tensor,
                  label: str) -> float:
    """The kernel against its plain version: f32 max |d| <=
    ``ATTN_F32_ATOL``; bf16 at most one bf16 ulp apart, except near zero,
    where the f32 bound applies.  Raises AssertionError outside it.
    -> max |d|."""
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    bad = diff > ATTN_F32_ATOL
    if got.dtype == torch.bfloat16:
        bad &= bf16_steps(got, want) > 1
    if bad.any():
        at = tuple(int(i) for i in bad.nonzero()[0])
        raise AssertionError(
            f"{label}: kernel != plain version at {int(bad.sum())} "
            f"elements, first {at}: {float(got[at])!r} against "
            f"{float(want[at])!r} (max |d| {err!r})")
    return err


def check_flash(q, k, v, causal: bool, kv_valid: int, label: str) -> float:
    """One launch of the kernel on CUDA tensors against the plain version
    on the same inputs; rows that see no key must be exactly 0.  Raises
    AssertionError otherwise.  -> max |d|."""
    before = flash_attention.launches
    with torch.inference_mode():
        got = flash_attention(q, k, v, causal=causal, kv_valid=kv_valid)
        want = flash_attention_ref(q, k, v, causal=causal,
                                   kv_valid=kv_valid)
    torch.cuda.synchronize()
    if flash_attention.launches != before + 1 or got.dtype != q.dtype \
            or got.shape != q.shape:
        raise AssertionError(f"{label}: {flash_attention.launches - before}"
                             f" launches, out {tuple(got.shape)} "
                             f"{got.dtype}")
    err = kernel_agrees(got, want, label)
    Sq, Skv = q.shape[1], k.shape[1]
    if causal and Sq > Skv and got[:, :Sq - Skv].any():
        raise AssertionError(f"{label}: a row with no visible key is not 0")
    return err


def check_case(case, device, seed: int) -> float:
    """``check_flash`` on one of ``CASES`` or ``SERVE_CASES``.  -> max
    |d|."""
    name, _, _, _, causal, kv_valid, _ = case
    q, k, v = case_operands(case, device, seed)
    return check_flash(q, k, v, causal, kv_valid,
                       f"flash_attention {case_id(case)}")


def _traced_names(call, names, seconds: float) -> set:
    """The entries of ``names`` that the profiler's trace of ``seconds``
    of ``call()`` holds as device kernels, after one untraced call (a
    trace late in a long process can miss the launches of its first
    milliseconds)."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            call()
        torch.cuda.synchronize()
    return {name for ev in prof.key_averages() for name in names
            if name in ev.key}


def kernels_launched(case, device, seconds: float = 0.05) -> set:
    """The entries of ``KERNEL_NAMES`` a trace of ``seconds`` of calls on
    one of ``CASES`` holds (``_traced_names``)."""
    _, _, _, _, causal, kv_valid, _ = case
    q, k, v = case_operands(case, device, 0)
    with torch.inference_mode():
        return _traced_names(lambda: flash_attention(
            q, k, v, causal=causal, kv_valid=kv_valid), KERNEL_NAMES,
            seconds)


def check_refusals(device) -> None:
    """The wrapper refuses, before any launch, the head dims it has no
    build for (``UNBUILT_HEAD_DIMS``), in both dtypes."""
    for d in UNBUILT_HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = operands([(1, 64, 2, d), (1, 64, 1, d),
                                (1, 64, 1, d)], dtype, device, 0)
            before = flash_attention.launches
            try:
                flash_attention(q, k, v)
            except NotImplementedError as e:
                if "head dim" not in str(e) \
                        or flash_attention.launches != before:
                    raise AssertionError(
                        f"flash_attention refusal: {e}") from e
            else:
                raise AssertionError(f"flash_attention took head dim {d} "
                                     f"in {dtype}")


# -- the backward -----------------------------------------------------------

GRAD_F32_RTOL = 1e-5
GRAD_BF16_RTOL = 2.0 ** -7
# the forward's cases the backward is held to: qwen2-0.5b's heads at S
# 512 and 500 (the ragged edge), Sq 128 < Skv 512 causal, non-causal,
# kv_valid 500, Sq 512 > Skv 256 causal (rows < 256 see no key: zero
# gradients), D 112 (32 of 32), D 128 (16 of 16 and pixtral-12b's 32 of
# 8), whisper-small's 1500-key encoder and its Sq 500 against 1500
# cross-attention; each in both dtypes
_BWD_SHAPES = (
    ("S512 causal", 512, 512, True, 0, (HQ, HKV, D)),
    ("S500 causal", 500, 500, True, 0, (HQ, HKV, D)),
    ("Sq128 Skv512 causal", 128, 512, True, 0, (HQ, HKV, D)),
    ("S512 non-causal", 512, 512, False, 0, (HQ, HKV, D)),
    ("S512 kv_valid 500 non-causal", 512, 512, False, 500, (HQ, HKV, D)),
    ("Sq512 Skv256 causal (no key for rows < 256)", 512, 256, True, 0,
     (HQ, HKV, D)),
    ("D112 S500 causal", 500, 500, True, 0, HYBRID_HEADS),
    ("D128 S512 causal", 512, 512, True, 0, MOE_HEADS),
    ("D128 pixtral-12b S512 causal", 512, 512, True, 0, PIXTRAL_HEADS),
    ("D64 MHA12 S1500 non-causal", 1500, 1500, False, 0, WHISPER_HEADS),
    ("D64 MHA12 Sq500 Skv1500 non-causal", 500, 1500, False, 0,
     WHISPER_HEADS))
BWD_CASES = tuple((name, dt, Sq, Skv, causal, kv_valid, heads)
                  for name, Sq, Skv, causal, kv_valid, heads in _BWD_SHAPES
                  for dt in (torch.bfloat16, torch.float32))
# every CUDA kernel the backward may launch: bf16 on tensor cores (dQ,
# dK/dV per query head, and the sum of a KV head's per-head partials
# when Hq > Hkv), f32 on CUDA cores (profiler names contain these)
BWD_KERNEL_NAMES = ("flash_attention_bwd_dq_wgmma_kernel",
                    "flash_attention_bwd_dkdv_wgmma_kernel",
                    "flash_attention_bwd_sum_kernel",
                    "flash_attention_bwd_dq_kernel",
                    "flash_attention_bwd_dkdv_kernel")
# planted faults of flash_attention_bwd_model; each must fail grads_agree
BWD_FAULTS = ("Di dropped", "causal mask one off",
              "dK without the sum over the group")


def bwd_kernel_names(dtype: torch.dtype, group: int) -> tuple:
    """The entries of ``BWD_KERNEL_NAMES`` one call launches in
    ``dtype`` with ``group`` = Hq / Hkv query heads a KV head."""
    if dtype == torch.bfloat16:
        return BWD_KERNEL_NAMES[:3] if group > 1 else BWD_KERNEL_NAMES[:2]
    return BWD_KERNEL_NAMES[3:]


def bwd_kernels_launched(case, device, seconds: float = 0.05) -> set:
    """The entries of ``BWD_KERNEL_NAMES`` a trace of ``seconds`` of
    backward calls on one of ``BWD_CASES`` holds (``_traced_names``)."""
    _, _, _, _, causal, kv_valid, _ = case
    args = bwd_case_operands(case, device, 0)
    return _traced_names(lambda: flash_attention_bwd(
        *args, causal=causal, kv_valid=kv_valid), BWD_KERNEL_NAMES, seconds)


def bwd_case_operands(case, device, seed: int) -> list:
    """q, k, v of the case, the plain forward's output o (in the case's
    dtype) and dout ~ N(0, 1), drawn from ``seed``."""
    _, dtype, Sq, Skv, causal, kv_valid, (hq, _, d) = case
    q, k, v = case_operands(case, device, seed)
    with torch.inference_mode():
        o = flash_attention_ref(q, k, v, causal=causal, kv_valid=kv_valid)
    (dout,) = operands([(B, Sq, hq, d)], dtype, device, seed + 1)
    return [q, k, v, o.clone(), dout]


def grads_agree(got, want, label: str) -> Tuple[float, float]:
    """dq, dk, dv against the plain backward's, each within the stated
    tolerance (module docstring).  Raises AssertionError outside it.
    -> (the largest max |d| of the three, the largest max |d| / max
    |plain|)."""
    worst = worst_abs = 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{label} {name}: {tuple(g.shape)} "
                                 f"{g.dtype} against {tuple(w.shape)} "
                                 f"{w.dtype}")
        diff = (g.float() - w.float()).abs()
        top = float(w.float().abs().max())
        if not torch.isfinite(g.float()).all():
            raise AssertionError(f"{label} {name}: not finite")
        rtol = GRAD_BF16_RTOL if g.dtype == torch.bfloat16 \
            else GRAD_F32_RTOL
        bad = diff > rtol * top
        if g.dtype == torch.bfloat16:
            bad &= bf16_steps(g, w) > 1
        rel = float(diff.max()) / top if top else float(diff.max())
        worst = max(worst, rel)
        worst_abs = max(worst_abs, float(diff.max()))
        if bad.any():
            at = tuple(int(i) for i in bad.nonzero()[0])
            raise AssertionError(
                f"{label} {name}: kernel != plain backward at "
                f"{int(bad.sum())} elements, first {at}: {float(g[at])!r} "
                f"against {float(w[at])!r} (max |d| / max |plain| {rel!r})")
    return worst_abs, worst


def flash_attention_bwd_model(q, k, v, o, dout, causal: bool = True,
                              sm_scale: Optional[float] = None,
                              kv_valid: int = 0,
                              fault: Optional[str] = None):
    """The backward kernels' algorithm in plain PyTorch, f32: each row's
    log-sum-exp in log2 units over its visible keys, Di = rowsum(dO * O),
    P = 2^(S sm_scale log2(e) - lse2), dS = P (dP - Di), dQ = scale dS K;
    per query head the partials P^T dO and dS^T Q, and per KV head dV and
    dK = scale times their sums over the group, in head order.  ``fault``:
    one of ``BWD_FAULTS``, planted ("dK without the sum over the group"
    keeps the group's first partial).  -> (dq, dk, dv) in q's dtype."""
    Bq, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(Dh)
    n_valid = kv_valid if 0 < kv_valid < Skv else Skv
    qf, kf, vf = (t.float() for t in (q, k, v))
    of, dof = o.float(), dout.float()
    kr = kf.repeat_interleave(G, dim=2)             # (B, Skv, Hq, D)
    vr = vf.repeat_interleave(G, dim=2)
    qpos = torch.arange(Sq, device=q.device) + (Skv - Sq)
    kpos = torch.arange(Skv, device=q.device)
    vis = (kpos < n_valid)[None, :].expand(Sq, Skv)
    if causal:
        reach = 1 if fault == "causal mask one off" else 0
        vis = vis & (kpos[None, :] <= qpos[:, None] + reach)
    vis = vis[None, None]                            # (1, 1, Sq, Skv)
    s2 = torch.einsum("bqhd,bkhd->bhqk", qf, kr) * (scale * LOG2E)
    lse2 = torch.logsumexp(torch.where(vis, s2, NEG_INF) / LOG2E, dim=-1,
                           keepdim=True) * LOG2E
    seen = vis.any(dim=-1, keepdim=True)
    p = torch.where(vis & seen, torch.exp2(s2 - lse2), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vr)
    di = (dof * of).sum(-1).transpose(1, 2)[..., None]   # (B, Hq, Sq, 1)
    if fault == "Di dropped":
        di = torch.zeros_like(di)
    ds = p * (dp - di)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) * scale
    dk_h = torch.einsum("bhqk,bqhd->bkhd", ds, qf).reshape(Bq, Skv, Hkv, G,
                                                           Dh)
    dv_h = torch.einsum("bhqk,bqhd->bkhd", p, dof).reshape(Bq, Skv, Hkv, G,
                                                           Dh)
    dk, dv = dk_h[:, :, :, 0], dv_h[:, :, :, 0]
    for g in range(1, G):
        if fault != "dK without the sum over the group":
            dk = dk + dk_h[:, :, :, g]
        dv = dv + dv_h[:, :, :, g]
    return dq.to(q.dtype), (dk * scale).to(k.dtype), dv.to(v.dtype)


def check_bwd(q, k, v, o, dout, causal: bool, kv_valid: int, label: str
              ) -> Tuple[float, float]:
    """One ``flash_attention_bwd`` call (two or three kernels, one
    counted launch) on CUDA tensors against ``flash_attention_bwd_ref`` on
    the same inputs (``grads_agree``); rows that see no key must have zero
    dq; in bf16 a second call must give the same bits (no atomics).  ->
    (max |d|, max |d| / max |plain|), the worst of dq, dk, dv."""
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, dout, causal=causal,
                              kv_valid=kv_valid)
    if q.dtype == torch.bfloat16:
        again = flash_attention_bwd(q, k, v, o, dout, causal=causal,
                                    kv_valid=kv_valid)
        for name, a, b in zip(("dq", "dk", "dv"), got, again):
            if not torch.equal(a.view(torch.int16), b.view(torch.int16)):
                raise AssertionError(f"{label} {name}: two calls differ")
    want = flash_attention_bwd_ref(q, k, v, o, dout, causal=causal,
                                   kv_valid=kv_valid)
    torch.cuda.synchronize()
    calls = 2 if q.dtype == torch.bfloat16 else 1
    if flash_attention_bwd.launches != before + calls:
        raise AssertionError(f"{label}: "
                             f"{flash_attention_bwd.launches - before} "
                             f"launches (want {calls})")
    err = grads_agree(got, want, label)
    Sq, Skv = q.shape[1], k.shape[1]
    if causal and Sq > Skv and got[0][:, :Sq - Skv].any():
        raise AssertionError(f"{label}: a row with no visible key has a "
                             "nonzero dq")
    return err


def check_bwd_case(case, device, seed: int) -> Tuple[float, float]:
    """``check_bwd`` on one of ``BWD_CASES``.  -> (max |d|, max |d| /
    max |plain|)."""
    _, _, _, _, causal, kv_valid, _ = case
    q, k, v, o, dout = bwd_case_operands(case, device, seed)
    return check_bwd(q, k, v, o, dout, causal, kv_valid,
                     f"flash_attention_bwd {case_id(case)}")


def check_bwd_faults(case, device, seed: int) -> dict:
    """The plain model of the kernel's algorithm agrees with the plain
    backward on ``case``, and each of ``BWD_FAULTS`` planted in it reads
    above the tolerance; so does the kernel itself given O = 0 (its Di
    dropped).  -> {fault: its max |d| / max |plain|}."""
    _, _, _, _, causal, kv_valid, _ = case
    q, k, v, o, dout = bwd_case_operands(case, device, seed)
    want = flash_attention_bwd_ref(q, k, v, o, dout, causal=causal,
                                   kv_valid=kv_valid)
    label = f"flash_attention_bwd model {case_id(case)}"
    grads_agree(flash_attention_bwd_model(q, k, v, o, dout, causal,
                                          kv_valid=kv_valid), want, label)
    faults = {f: flash_attention_bwd_model(q, k, v, o, dout, causal,
                                           kv_valid=kv_valid, fault=f)
              for f in BWD_FAULTS}
    if q.is_cuda:
        faults["kernel with Di dropped (O = 0)"] = flash_attention_bwd(
            q, k, v, torch.zeros_like(o), dout, causal=causal,
            kv_valid=kv_valid)
    read = {}
    for name, got in faults.items():
        try:
            grads_agree(got, want, f"{label} {name}")
        except AssertionError:
            read[name] = max(
                float((g.float() - w.float()).abs().max()
                      / w.float().abs().max()) for g, w in zip(got, want))
        else:
            raise AssertionError(f"{label}: planted fault {name!r} passes "
                                 "the tolerance")
    return read
