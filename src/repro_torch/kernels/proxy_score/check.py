"""The ``proxy_score`` kernel against its plain version on the card: the
cases, the operands and the rule, one copy for ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.

Rule: the kernel's scores lie within ``SCORE_ATOL`` of the plain
version's on the same tensors (the kernel sums the C-term dot in another
order and takes its own ``expf``), and both (scores, positives) pass
``check_scores``: held to float64 arithmetic, a cell may come out either
way only where its sigmoid lies within ``FLIP_ULPS`` f32 ulps of the
threshold, and the positives are each implementation's own ``score >
threshold``, strictly.

The cases (``(name, (B, Hc, Wc, C), kind)``): the per-frame path's call
(one frame of 13 x 8 proxy cells of 64 features) and a chunk's (16
frames, ``fused_plan=False``), each at the 0.85 quantile of the float64
sigmoids; the chunk again at a threshold ON one cell's sigmoid (that
cell may flip); C 40, whose rows take the kernel's general float2 loop
(20 of the 32 lanes load); and an odd C, whose rows cannot be read as
float2 and take the scalar loop.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.proxy_score.ops import (check_scores, proxy_score,
                                                 proxy_score_ref)

SEED = 0
SCORE_ATOL = 1e-6
FRAME = (1, 8, 13, 64)              # (B, Hc, Wc, C): the per-frame call
CHUNK = (16, 8, 13, 64)             # a chunk with fused_plan=False
CASES = (("per-frame", FRAME, "quantile"),
         ("chunk", CHUNK, "quantile"),
         ("threshold on a cell", CHUNK, "on_a_cell"),
         ("C 40", (4, 8, 13, 40), "quantile"),
         ("odd C", (4, 8, 13, 13), "quantile"))
# the kernel's instances (profiler names contain this): float2 loads of
# feat and w, or scalar loads
KERNEL_NAMES = ("proxy_score_kernel",)
VEC2_KERNEL = "proxy_score_kernel<true"


def takes_vec2_branch(case) -> bool:
    """The seeded operands are whole allocations, so a row can be read
    as float2 exactly when C is even."""
    return case[1][3] % 2 == 0


def case_operands(case, seed: int = SEED
                  ) -> Tuple[np.ndarray, np.ndarray, np.float32, float]:
    """(feat, w, b, threshold) of one of ``CASES``, on the host: relu
    features, w ~ N(0, 1/C), b 0.1; "quantile" takes the 0.85 quantile
    of the float64 sigmoids, "on_a_cell" one cell's sigmoid in f32."""
    _, (B, hc, wc, C), kind = case
    rng = np.random.default_rng(seed)
    feat = np.maximum(rng.standard_normal((B, hc, wc, C)), 0) \
        .astype(np.float32)
    w = (rng.standard_normal(C) / np.sqrt(C)).astype(np.float32)
    b = np.float32(0.1)
    s64 = 1.0 / (1.0 + np.exp(-(np.einsum(
        "bhwc,c->bhw", feat.astype(np.float64), w.astype(np.float64))
        + b)))
    if kind == "on_a_cell":
        thr = float(np.float32(s64[B // 2, hc // 2, wc // 2]))
    else:
        thr = float(np.quantile(s64, 0.85))
    return feat, w, b, thr


def check_call(feat: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               thr: float, label: str) -> dict:
    """One launch of the kernel on CUDA tensors against the plain version
    on the same tensors, by the rule above; raises AssertionError
    otherwise.  -> dict(max_abs_err, flips: cells whose positives
    differ, band: cells in the kernel's flip band)."""
    before = proxy_score.launches
    with torch.inference_mode():
        sk, pk = proxy_score(feat, w, b, thr)
        sp, pp = proxy_score_ref(feat, w, b, thr)
    torch.cuda.synchronize()
    if proxy_score.launches != before + 1 or sk.dtype != torch.float32 \
            or pk.dtype != torch.int8 or sk.shape != sp.shape \
            or pk.shape != pp.shape:
        raise AssertionError(
            f"proxy_score {label}: {proxy_score.launches - before} "
            f"launches, scores {tuple(sk.shape)} {sk.dtype}, positives "
            f"{tuple(pk.shape)} {pk.dtype}")
    band = check_scores(feat, w, b, thr, sk, pk)
    check_scores(feat, w, b, thr, sp, pp)
    err = float((sk - sp).abs().max()) if sk.numel() else 0.0
    if not err <= SCORE_ATOL:
        raise AssertionError(f"proxy_score {label}: max |d score| {err!r} "
                             f"> {SCORE_ATOL}")
    return dict(max_abs_err=err, flips=int((pk != pp).sum()), band=band)


def check_case(case, device, seed: int = SEED,
               operands: Optional[tuple] = None) -> dict:
    """One of ``CASES`` on ``device`` (a CUDA device), by the rule above.
    ``operands`` replaces the seeded (feat, w, b, threshold) with
    tensors of the case's shapes.  -> the record: name, shape,
    max_abs_err, flips, band, and the operands on the card."""
    name, shape, _ = case
    if operands is None:
        feat, w, b, thr = case_operands(case, seed)
        operands = (torch.from_numpy(feat).to(device),
                    torch.from_numpy(w).to(device),
                    torch.tensor([b], device=device), thr)
    if tuple(operands[0].shape) != shape:
        raise ValueError(f"proxy_score {name}: features "
                         f"{tuple(operands[0].shape)}, want {shape}")
    rec = check_call(*operands, name)
    return dict(case=name, shape=shape, operands=operands, **rec)


def kernels_launched(ops: tuple, seconds: float = 0.05) -> set:
    """The names of the kernel instances that the profiler's trace of
    ``seconds`` of calls on ``ops`` ((feat, w, b, threshold) on the
    card) holds (a trace late in a long process can miss the launches
    of its first milliseconds)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.inference_mode():
            while time.perf_counter() - t0 < seconds:
                proxy_score(*ops)
        torch.cuda.synchronize()
    return {ev.key for ev in prof.key_averages()
            if any(n in ev.key for n in KERNEL_NAMES)}
