"""The ``decode_attention`` kernel against its plain version on the card:
the cases, the operands, the comparison and the refusals, one copy for
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.  The tolerance is
``flash_attention.check.kernel_agrees``'s: f32 within 1e-5, bf16 one
bf16 ulp apart (the f32 bound near zero).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                      decode_attention_ref)
from repro_torch.kernels.flash_attention.check import (D128_LAYOUTS,
                                                       kernel_agrees,
                                                       operands)

# (name, B, S, Hq, Hkv, D, kv_len).  run_lm's: the serving call at
# qwen2-0.5b's heads and max_len 1024 with kv_len (1, 61, S/2, S); an
# empty row and lengths on either side of a 64-key tile; a full 16-head
# group (MAX_GROUP); stablelm-1.6b's heads (MHA, 32 of 32 of 64: 512
# clusters of 16 blocks) at the serving call's lengths
LM_CASES = (("B4 S1024 kv_len (1, 61, 512, 1024)", 4, 1024, 14, 2, 64,
             (1, 61, 512, 1024)),
            ("B4 S1024 kv_len (0, 64, 65, 1023)", 4, 1024, 14, 2, 64,
             (0, 64, 65, 1023)),
            ("G16 B2 S256 kv_len (200, 256)", 2, 256, 32, 2, 64,
             (200, 256)),
            ("MHA32 B4 S1024 kv_len (1, 61, 512, 1024)", 4, 1024, 32, 32,
             64, (1, 61, 512, 1024)))
# the zamba2-7b serving call (MHA, 32 of 32 of 112), timed in
# chip_smoke.py beside the first
HYBRID_CASE = ("D112 MHA32 B4 S1024 kv_len (1, 61, 512, 1024)", 4, 1024,
               32, 32, 112, (1, 61, 512, 1024))
# the deepseek-moe-16b serving call (MHA, 16 of 16 of 128), timed
# likewise, and the other head-dim-128 layouts (groups of 6, 8 and 7) at
# its lengths
MOE_CASE = ("D128 MHA16 B4 S1024 kv_len (1, 61, 512, 1024)", 4, 1024, 16,
            16, 128, (1, 61, 512, 1024))
D128_CASES = (MOE_CASE,) + tuple(
    (f"D128 {arch} B4 S1024 kv_len (1, 61, 512, 1024)", 4, 1024, hq, hkv,
     d, (1, 61, 512, 1024)) for arch, (hq, hkv, d) in D128_LAYOUTS.items())
# the encdec cell's calls (whisper-small, MHA, 12 of 12 of 64): the
# decoder's self-attention at the serving lengths and its cross-attention,
# every row over all 1500 frames (whose last 64-key tile holds 28 keys,
# 1500 = 23 x 64 + 28, in a 16-block cluster's split); the vlm cell's
# (pixtral-12b, 32 of 8 of 128) at max_len 2048 with its prompts' lengths
ENCDEC_CASE = ("D64 MHA12 B4 S1024 kv_len (1, 61, 512, 1024)", 4, 1024, 12,
               12, 64, (1, 61, 512, 1024))
CROSS_CASE = ("D64 MHA12 cross B4 S1500 kv_len 1500", 4, 1500, 12, 12, 64,
              (1500,) * 4)
VLM_CASE = ("D128 pixtral-12b B4 S2048 kv_len (1, 1085, 1524, 2048)", 4,
            2048, 32, 8, 128, (1, 1085, 1524, 2048))
SERVE_CASES = (ENCDEC_CASE, CROSS_CASE, VLM_CASE)
CASES = LM_CASES + (HYBRID_CASE,) + D128_CASES + SERVE_CASES
DTYPES = (torch.bfloat16, torch.float32)


def case_operands(case, dtype: torch.dtype, device, seed: int) -> list:
    """q (B, Hq, D), k and v (B, S, Hkv, D) in ``dtype`` and kv_len (B,)
    int32, all on ``device``."""
    _, b, S, Hq, Hkv, D, lens = case
    q, k, v = operands([(b, Hq, D), (b, S, Hkv, D), (b, S, Hkv, D)], dtype,
                       device, seed)
    return [q, k, v, torch.tensor(lens, dtype=torch.int32, device=device)]


def check_decode(q, k, v, kv_len, label: str) -> float:
    """One launch of the kernel on CUDA tensors against the plain version
    on the same inputs; a row with kv_len 0 must be exactly 0.  Raises
    AssertionError otherwise.  -> max |d|."""
    before = decode_attention.launches
    with torch.inference_mode():
        got = decode_attention(q, k, v, kv_len)
        want = decode_attention_ref(q, k, v, kv_len)
    torch.cuda.synchronize()
    if decode_attention.launches != before + 1 or got.dtype != q.dtype \
            or got.shape != q.shape:
        raise AssertionError(f"{label}: {decode_attention.launches - before}"
                             f" launches, out {tuple(got.shape)} "
                             f"{got.dtype}")
    err = kernel_agrees(got, want, label)
    if got[kv_len <= 0].any():
        raise AssertionError(f"{label}: a row with kv_len 0 is not 0")
    return err


def check_case(case, dtype: torch.dtype, device, seed: int) -> float:
    """``check_decode`` on one of ``CASES``.  -> max |d|."""
    return check_decode(*case_operands(case, dtype, device, seed),
                        f"decode_attention {case[0]} {dtype}")


def check_refusals(device) -> None:
    """The wrapper refuses, before any launch, 17 query heads a KV head
    (over ``MAX_GROUP``) and the head dims it has no build for (32,
    96)."""
    for (Hq, Hkv, D), what in (((17, 1, 64), "per KV head"),
                               ((2, 1, 32), "head dim"),
                               ((2, 1, 96), "head dim")):
        q, k, v = operands([(1, Hq, D), (1, 64, Hkv, D), (1, 64, Hkv, D)],
                           torch.float32, device, 0)
        lens = torch.full((1,), 64, dtype=torch.int32, device=device)
        before = decode_attention.launches
        try:
            decode_attention(q, k, v, lens)
        except NotImplementedError as e:
            if what not in str(e) or decode_attention.launches != before:
                raise AssertionError(f"decode_attention refusal: {e}") from e
        else:
            raise AssertionError(f"decode_attention took Hq {Hq}, Hkv "
                                 f"{Hkv}, D {D}")


def check_graph_replay(device, seed: int) -> float:
    """The kernel captured once in a CUDA graph at the serving case's
    shapes, then replayed after kv_len changed in place (it stays on the
    card, read by the kernel: the capture holds no copy of its values),
    agrees with the plain version on the new lengths.  -> max |d|."""
    q, k, v, kv_len = case_operands(CASES[0], torch.bfloat16, device, seed)
    errs = []
    with torch.inference_mode():
        decode_attention(q, k, v, kv_len)   # built and set up before it
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = decode_attention(q, k, v, kv_len)
        for lens in ((1, 61, 512, 1024), (0, 700, 3, 64)):
            kv_len.copy_(torch.tensor(lens, dtype=torch.int32))
            graph.replay()
            torch.cuda.synchronize()
            errs.append(kernel_agrees(
                out, decode_attention_ref(q, k, v, kv_len),
                f"decode_attention graph replay, kv_len {lens}"))
    return max(errs)


def check_cross_graph_replay(device, seed: int, steps: int = 8) -> float:
    """The cross-attention decode (``CROSS_CASE``, every row over all
    1500 frames) captured once in a CUDA graph, then replayed for
    ``steps`` decode steps, a new query copied in place before each (the
    frames and their kv_len stay), each step against the plain version.
    -> max |d|."""
    q, k, v, kv_len = case_operands(CROSS_CASE, torch.bfloat16, device,
                                    seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    errs = []
    with torch.inference_mode():
        decode_attention(q, k, v, kv_len)   # built and set up before it
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = decode_attention(q, k, v, kv_len)
        for step in range(steps):
            q.copy_(torch.randn(q.shape, generator=gen, device=device))
            graph.replay()
            torch.cuda.synchronize()
            errs.append(kernel_agrees(
                out, decode_attention_ref(q, k, v, kv_len),
                f"decode_attention cross graph replay, step {step}"))
    return max(errs)