"""The ``track_step`` kernel against its plain version on the card: the
cases, the operands and the rule, one copy for ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.

Rule: bit for bit on all three outputs (matched, h_upd, h_new), and the
plain version on the card equal to the plain version on the CPU, so that
a mismatch can be placed (the kernel, or PyTorch on the card).  Widths
are the full MultiScope tracker's (H 64, e 32, M 64) with its heads
drawn from ``SEED``.

The cases: the main path's shape (one stream, Q = 128 slots: up to 64
tracks + 64 detections) with 40 live tracks and 30 detections at the
tracker's threshold; 16 streams of random counts at threshold 0.5, where
the untrained heads forbid about half the pairs; every row dead but one;
every column padding but one; Q = 256 (as ``DeviceTracker`` pads a
frame with more than 64 detections) on a square of 64 and of 256, whose
rows do not all fit in shared memory; and Q = 512, which takes the
large-matrix JV instance.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.multiscope import MULTISCOPE_PIPELINE
from repro_torch.core.tracker import _host_params, init_tracker
from repro_torch.kernels.assign.check import jv_steps
from repro_torch.kernels.track_step.ops import (LOG1P_TABLE_2D,
                                                pack_params, track_costs_ref,
                                                track_step, track_step_ref)

SEED = 0
TRACKER = MULTISCOPE_PIPELINE.tracker
# (name, K, Q, (live tracks, valid detections) per stream or None for
# random counts, threshold or None for the tracker's)
CASES = (("K1 (40, 30)", 1, 128, (40, 30), None),
         ("K16 thr 0.5", 16, 128, None, 0.5),
         ("K1 one live row", 1, 128, (1, 30), None),
         ("K1 one valid column", 1, 128, (40, 1), None),
         ("K1 Q256 (40, 30)", 1, 256, (40, 30), None),
         ("K1 Q256 (40, 200)", 1, 256, (40, 200), None),
         ("K1 Q512 (40, 30)", 1, 512, (40, 30), None))
# the device kernels of one step, in launch order (track_assign_kernel
# or, past jv.cuh's kRegMaxN columns, track_assign_large_kernel)
KERNEL_NAMES = ("track_feat_kernel", "track_cost_kernel",
                "track_assign_kernel", "track_assign_large_kernel",
                "track_gru_kernel")


def heads(device) -> Tuple[torch.Tensor, ...]:
    """The tracker heads at full width, drawn from ``SEED``, as the
    kernel's operand tuple on ``device``."""
    return pack_params(_host_params(init_tracker(TRACKER, seed=SEED,
                                                 device="cpu")), device)


def operands(rng, K: int, Q: int, heads: Sequence[torch.Tensor],
             live=None) -> list:
    """Seeded operands in the slot layout: live tracks and valid
    detections as prefixes (``live`` = (T, n) per stream, else random),
    integer gaps, boxes in unit coordinates near each other so that some
    pairs pass the threshold.  CPU tensors."""
    H = heads[2].shape[1]
    e = heads[0].shape[1]
    ops = [np.zeros(s, np.float32) for s in
           ((K, Q, H), (K, Q, 4), (K, Q), (K, Q), (K, Q), (K, Q, e),
            (K, Q, 4), (K, Q))]
    h_r, tbox_r, alive_r, te_gap_r, te_match, x, dbox, dvalid = ops
    for k in range(K):
        T, n = live if live is not None else rng.integers(0, 65, 2)
        # repro-lint: disable=bit-contract -- seeded random operands for the card check; the bits are carried by kernels.track_step and its plain version, which both read these same inputs
        h_r[k, :T] = np.tanh(rng.standard_normal((T, H)))
        tbox_r[k, :T] = rng.random((T, 4)) * [1, 1, 0.1, 0.1]
        alive_r[k, :T] = 1.0
        te_gap_r[k, :T] = rng.integers(1, 9, T)
        te_match[k] = float(rng.integers(1, 4))
        # repro-lint: disable=bit-contract -- seeded random operands for the card check; the bits are carried by kernels.track_step and its plain version, which both read these same inputs
        x[k, :n] = np.tanh(rng.standard_normal((n, e)))
        dbox[k, :n] = rng.random((n, 4)) * [1, 1, 0.1, 0.1]
        dvalid[k, :n] = 1.0
    return [torch.from_numpy(a) for a in ops]


def case_operands(case, heads_cpu) -> Tuple[list, torch.Tensor]:
    """The CPU operands and (1, 1) threshold of one of ``CASES``."""
    _, K, Q, live, thr = case
    rng = np.random.default_rng(SEED + CASES.index(case))
    t = TRACKER.match_threshold if thr is None else thr
    return operands(rng, K, Q, heads_cpu, live), torch.full((1, 1), t)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Exact equality of two outputs, f32 compared as bit patterns."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a.cpu(), b.cpu())


def check_case(case, device, heads_cpu: Optional[tuple] = None) -> dict:
    """One launch of the kernel on one of ``CASES`` against the plain
    version on the card and on the CPU; raises AssertionError unless all
    three agree bit for bit.  -> the record: the live pairs, the matched
    rows, the square side and the JV's steps of each stream."""
    name, K, Q, _, _ = case
    heads_cpu = heads(torch.device("cpu")) if heads_cpu is None \
        else heads_cpu
    ops_cpu, thr_cpu = case_operands(case, heads_cpu)
    table_cpu = torch.from_numpy(LOG1P_TABLE_2D)
    on_dev = [t.to(device) for t in (*ops_cpu, thr_cpu, table_cpu)]
    ops, thr, table = on_dev[:8], on_dev[8], on_dev[9]
    hd = [p.to(device) for p in heads_cpu]
    before = track_step.launches
    got = track_step(*ops, thr, hd, table)
    card = track_step_ref(*ops, thr, hd, table)
    torch.cuda.synchronize()
    if track_step.launches != before + 1:
        raise AssertionError(f"track_step {name}: "
                             f"{track_step.launches - before} launches")
    cpu = track_step_ref(*ops_cpu, thr_cpu, heads_cpu, table_cpu)
    for out, a, b, c in zip(("matched", "h_upd", "h_new"), got, card, cpu):
        if not bits_equal(b, c):
            raise AssertionError(f"track_step {name}: plain version on "
                                 f"the card != on the CPU ({out})")
        if not bits_equal(a, b):
            raise AssertionError(f"track_step {name}: kernel != plain "
                                 f"version ({out})")
    costs, sides = track_costs_ref(ops_cpu[0], ops_cpu[1], ops_cpu[2],
                                   ops_cpu[4], ops_cpu[5], ops_cpu[6],
                                   ops_cpu[7], thr_cpu, heads_cpu,
                                   table_cpu)
    steps = [jv_steps(c.numpy(), s) for c, s in zip(costs, sides)]
    T = (ops_cpu[2] > 0).sum(1)
    n = (ops_cpu[7] > 0).sum(1)
    return dict(case=name, K=K, Q=Q, live_pairs=int((T * n).sum()),
                matched=int((got[0] >= 0).sum()), sides=list(sides),
                steps=[s for s, _ in steps], hops=[h for _, h in steps],
                max_abs_err=0.0)
