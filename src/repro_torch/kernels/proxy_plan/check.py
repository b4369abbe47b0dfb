"""The ``proxy_plan`` kernel against its plain version on the card: the
cases, the operands and the rule, one copy for ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.

Rule: the kernel's plan and the plain version's both pass
``check_plan`` (float64 arithmetic on the same inputs; a grid cell may
flip only where a proxy cell's sigmoid lies within ``FLIP_ULPS`` f32
ulps of the threshold, since the kernel sums the 64-term dot in another
order), and on every frame where the two grids agree the stats rows are
equal too.

The cases (``(name, (B, hp, wp, C, hc, wc), kind)``): the main path's
call (a 16-frame chunk of 13 x 8 proxy cells of 64 features onto the
60 x 34 detector grid) at a threshold between cells, and again at a
threshold ON one cell's sigmoid (that cell may flip); one frame whose
every cell is negative (its stats row must be the sentinel ``[0, hc,
-1, wc, -1, 0, 0, 0]``); B 1; the reduced configuration's shapes (C 32,
a 5 x 3 span matrix of 60 bytes), which take the kernel's branch of
ordinary loads; and an odd C, whose features take scalar loads.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.proxy_plan.ops import (_spans_on, check_plan,
                                                proxy_plan, proxy_plan_ref)

SEED = 0
MAIN = (16, 8, 13, 64, 34, 60)      # (B, hp, wp, C, hc, wc)
CASES = (("main path", MAIN, "quantile"),
         ("threshold on a cell", MAIN, "on_a_cell"),
         ("all-empty frame", MAIN, "empty_frame"),
         ("B1", (1,) + MAIN[1:], "quantile"),
         ("reduced config", (4, 3, 4, 32, 5, 8), "quantile"),
         ("odd C", (4, 8, 13, 13, 34, 60), "quantile"))
EMPTY_FRAME = 5
# the kernel's instances (profiler names contain this): bulk copies into
# shared memory, or ordinary loads (float4 or scalar)
KERNEL_NAMES = ("proxy_plan_kernel",)
BULK_KERNEL = "proxy_plan_kernel<true"


def case_operands(case, seed: int = SEED
                  ) -> Tuple[np.ndarray, np.ndarray, np.float32, float]:
    """(feat, w, b, threshold) of one of ``CASES``, on the host: relu
    features, w ~ N(0, 1/C), b 0.1.  "quantile" takes the 0.85 quantile
    of the float64 sigmoids; "on_a_cell" one cell's sigmoid in f32;
    "empty_frame" makes frame ``EMPTY_FRAME``'s features 10 max(-w, 0)
    in every cell, so that its logits are about -5."""
    _, (B, hp, wp, C, _, _), kind = case
    rng = np.random.default_rng(seed)
    feat = np.maximum(rng.standard_normal((B, hp, wp, C)), 0) \
        .astype(np.float32)
    w = (rng.standard_normal(C) / np.sqrt(C)).astype(np.float32)
    b = np.float32(0.1)
    if kind == "empty_frame":
        feat[EMPTY_FRAME] = 10 * np.maximum(-w, 0)
    s64 = 1.0 / (1.0 + np.exp(-(np.einsum(
        "bhwc,c->bhw", feat.astype(np.float64), w.astype(np.float64))
        + b)))
    if kind == "on_a_cell":
        thr = float(np.float32(s64[B // 2, hp // 2, wp // 2]))
    else:
        thr = float(np.quantile(s64, 0.85))
    return feat, w, b, thr


def check_call(feat: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               thr: float, grid_hw: Tuple[int, int], label: str) -> dict:
    """One launch of the kernel on CUDA tensors against the plain version
    on the same tensors, by the rule above; raises AssertionError
    otherwise.  -> dict(flips: grid cells that differ, reach: cells in
    the band's reach, stats: the kernel's stats on the host)."""
    hc, wc = grid_hw
    _, hp, wp, _ = feat.shape
    sy, sx = _spans_on(feat.device, hc, hp, wc, wp)
    before = proxy_plan.launches
    with torch.inference_mode():
        gk, sk = proxy_plan(feat, w, b, thr, grid_hw=grid_hw)
        gp, sp = proxy_plan_ref(feat, w, b, thr, sy, sx)
    torch.cuda.synchronize()
    if proxy_plan.launches != before + 1 or gk.dtype != torch.int8 \
            or sk.dtype != torch.int32 or gk.shape != gp.shape \
            or sk.shape != sp.shape:
        raise AssertionError(
            f"proxy_plan {label}: {proxy_plan.launches - before} launches, "
            f"grid {tuple(gk.shape)} {gk.dtype}, stats {tuple(sk.shape)} "
            f"{sk.dtype}")
    reach = check_plan(feat, w, b, thr, gk, sk)
    check_plan(feat, w, b, thr, gp, sp)
    diff = gk != gp
    same = ~diff.any(dim=(1, 2))
    if not torch.equal(sk[same], sp[same]):
        raise AssertionError(f"proxy_plan {label}: stats differ on a frame "
                             "no flip touched")
    return dict(flips=int(diff.sum()), reach=reach, stats=sk.cpu())


def check_case(case, device, seed: int = SEED,
               operands: Optional[tuple] = None) -> dict:
    """One of ``CASES`` on ``device`` (a CUDA device), by the rule above;
    the empty frame's stats must be the sentinel.  ``operands`` replaces
    the seeded (feat, w, b, threshold) with tensors of the case's
    shapes.  -> the record: name, shape, flips, reach, max_abs_err (of
    the int8 grids), and the operands on the card."""
    name, (B, hp, wp, C, hc, wc), kind = case
    if operands is None:
        feat, w, b, thr = case_operands(case, seed)
        operands = (torch.from_numpy(feat).to(device),
                    torch.from_numpy(w).to(device),
                    torch.tensor([b], device=device), thr)
    rec = check_call(*operands, (hc, wc), name)
    if kind == "empty_frame":
        want = torch.tensor([0, hc, -1, wc, -1, 0, 0, 0], dtype=torch.int32)
        if not torch.equal(rec["stats"][EMPTY_FRAME], want):
            raise AssertionError(f"proxy_plan {name}: frame {EMPTY_FRAME}'s "
                                 f"stats {rec['stats'][EMPTY_FRAME].tolist()}"
                                 f" are not the sentinel {want.tolist()}")
    return dict(case=name, shape=(B, hp, wp, C, hc, wc), flips=rec["flips"],
                reach=rec["reach"], max_abs_err=float(rec["flips"] > 0),
                operands=operands)


def kernels_launched(operands: tuple, grid_hw: Tuple[int, int],
                     seconds: float = 0.05) -> set:
    """The names of the kernel instances that the profiler's trace of
    ``seconds`` of calls on ``operands`` (CUDA tensors) holds (a trace
    late in a long process can miss the launches of its first
    milliseconds)."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            proxy_plan(*operands, grid_hw=grid_hw)
        torch.cuda.synchronize()
    return {ev.key for ev in prof.key_averages()
            if any(n in ev.key for n in KERNEL_NAMES)}


def takes_bulk_branch(case) -> bool:
    """Whether the kernel stages the case's operands with bulk copies:
    C a multiple of 4, the span matrices' byte sizes multiples of 16 and
    a frame's features within the bulk branch's shared memory
    (``csrc/proxy_plan.cu``, ``proxy_plan_launch``)."""
    _, (B, hp, wp, C, hc, wc), _ = case
    return (C % 4 == 0 and (hc * hp * 4) % 16 == 0
            and (wc * wp * 4) % 16 == 0
            and (hp * wp * C + C + hc * hp + wc * wp) * 4 <= 40 * 1024)
