"""The ``flash_attention`` kernel against its plain version on the card:
the cases, the operands, the comparison and the refusals, one copy for
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.

Tolerance (``kernel_agrees``, which ``decode_attention.check`` shares):
f32 max |d| at most ``ATTN_F32_ATOL``; bf16 at most one bf16 value
apart from the plain version's bf16 result, except near zero, where a
bf16 ulp is finer than f32 rounding of O(1) sums and the f32 bound
applies.
"""
from __future__ import annotations

import time

import torch

from repro_torch.kernels import bf16_steps
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_ref)

ATTN_F32_ATOL = 1e-5
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


def kernels_launched(case, device, seconds: float = 0.05) -> set:
    """The entries of ``KERNEL_NAMES`` whose names the profiler's trace
    of ``seconds`` of calls on one of ``CASES`` holds as device kernels,
    after one untraced call (a trace late in a long process can miss the
    launches of its first milliseconds)."""
    from torch.profiler import ProfilerActivity, profile
    _, _, _, _, causal, kv_valid, _ = case
    q, k, v = case_operands(case, device, 0)
    with torch.inference_mode():
        flash_attention(q, k, v, causal=causal, kv_valid=kv_valid)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                flash_attention(q, k, v, causal=causal, kv_valid=kv_valid)
            torch.cuda.synchronize()
    return {name for ev in prof.key_averages() for name in KERNEL_NAMES
            if name in ev.key}


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
