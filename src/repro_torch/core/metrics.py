"""Accuracy metrics: pattern-count accuracy (the paper's hand-label
metric, §4) and MOTA (§4.3 cross-check).

Count accuracy: tracks are classified into the profile's spatial patterns
by nearest start/end endpoints against the pattern polylines; per-clip
accuracy = mean over patterns of  1 - |pred - gt| / max(gt, 1), floored at
0 — matching the paper's "percent accuracy averaged over patterns and
clips".

MOTA = 1 - (FN + FP + IDSW) / GT, computed per frame with IoU >= 0.3
Hungarian matching and identity bookkeeping.

The port's copy of the JAX package's ``repro.core.metrics``; with
``assign="batch"`` every frame's match goes through one launch of the
``assign`` kernel (its plain version for ``device="cpu"``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import Device
from repro_torch.core.detector import iou_matrix
from repro_torch.core.hungarian import BIG, hungarian, hungarian_batch
from repro_torch.data.video_synth import Clip, Profile, _interp


def classify_track(track: np.ndarray, profile: Profile) -> Optional[int]:
    """track: (m, 6) world units -> pattern id (nearest path by endpoint
    + midpoint distance) or None for stubs."""
    if len(track) < 2:
        return None
    start, end = track[0, 1:3], track[-1, 1:3]
    mid = track[len(track) // 2, 1:3]
    best, best_d = None, np.inf
    for pid, path in enumerate(profile.paths):
        p0 = np.asarray(_interp(path.waypoints, 0.02))
        p1 = np.asarray(_interp(path.waypoints, 0.98))
        pm = np.asarray(_interp(path.waypoints, 0.5))
        d = (np.linalg.norm(start - p0) + np.linalg.norm(end - p1)
             + 0.5 * np.linalg.norm(mid - pm))
        if d < best_d:
            best_d, best = d, pid
    return best


def pattern_counts(tracks: Sequence[np.ndarray], profile: Profile,
                   min_len: int = 2) -> np.ndarray:
    counts = np.zeros(profile.patterns(), np.int64)
    for t in tracks:
        if len(t) < min_len:
            continue          # ignore single-detection stubs (paper §4.2)
        pid = classify_track(t, profile)
        if pid is not None:
            counts[pid] += 1
    return counts


def count_accuracy(pred_counts: np.ndarray, gt_counts: np.ndarray
                   ) -> float:
    """Mean over patterns of 1 - |pred-gt|/max(gt,1), floored at 0."""
    acc = 1.0 - np.abs(pred_counts - gt_counts) / np.maximum(gt_counts, 1)
    return float(np.clip(acc, 0.0, 1.0).mean())


def clip_count_accuracy(tracks: Sequence[np.ndarray], clip: Clip
                        ) -> float:
    return count_accuracy(pattern_counts(tracks, clip.profile),
                          clip.pattern_counts())


# ---------------------------------------------------------------------------
# MOTA
# ---------------------------------------------------------------------------

def mota(tracks: Sequence[np.ndarray], clip: Clip,
         frames: Optional[Sequence[int]] = None,
         iou_thresh: float = 0.3, assign: str = "host",
         device: Device = "cuda") -> float:
    """Multi-Object Tracking Accuracy against the clip's exact GT.

    ``assign="batch"`` solves EVERY frame's IoU association in one
    launch of the ``assign`` kernel on ``device`` (``hungarian_batch``)
    instead of one host Hungarian per frame — the per-frame cost
    matrices here are mutually independent, unlike the recurrent
    tracker's.  Min-cost totals match the host solver exactly;
    equal-cost tie-breaks may pick different pairs, which can shift
    IDSW on pathological ties, so "host" stays the default."""
    if assign not in ("host", "batch"):
        raise ValueError(f"assign must be 'host' or 'batch', got "
                         f"{assign!r}")
    if frames is None:
        frames = range(clip.n_frames)
    # index predictions: frame -> (boxes, ids)
    pred_by_frame: Dict[int, List[Tuple[np.ndarray, int]]] = {}
    for t in tracks:
        for row in t:
            pred_by_frame.setdefault(int(row[0]), []).append(
                (row[1:5], int(row[5])))
    # first pass: per-frame GT + cost matrices (independent across
    # frames — the batchable part)
    work: List[Tuple[int, np.ndarray, List[Tuple[np.ndarray, int]],
                     Optional[np.ndarray]]] = []
    for f in frames:
        gt = clip.boxes_at(f)
        preds = pred_by_frame.get(f, [])
        if len(gt) == 0 and len(preds) == 0:
            continue
        cost = None
        if len(gt) > 0 and len(preds) > 0:
            pb = np.stack([p[0] for p in preds])
            iou = iou_matrix(gt[:, :4], pb)
            cost = np.where(iou >= iou_thresh, 1.0 - iou, BIG)
        work.append((f, gt, preds, cost))
    if assign == "batch":
        costs = [c for _, _, _, c in work if c is not None]
        solved = iter(hungarian_batch(costs, device=device))
        pairs_for = [next(solved) if c is not None else []
                     for _, _, _, c in work]
    else:
        pairs_for = [hungarian(c) if c is not None else []
                     for _, _, _, c in work]
    # second pass: sequential identity bookkeeping
    fn = fp = idsw = gt_total = 0
    last_match: Dict[int, int] = {}      # gt id -> pred id
    for (f, gt, preds, cost), pairs in zip(work, pairs_for):
        gt_total += len(gt)
        if len(preds) == 0:
            fn += len(gt)
            continue
        matched_gt = set()
        matched_pred = set()
        for gi, pi in pairs:
            gid = int(gt[gi, 4])
            pid = preds[pi][1]
            if gid in last_match and last_match[gid] != pid:
                idsw += 1
            last_match[gid] = pid
            matched_gt.add(gi)
            matched_pred.add(pi)
        fn += len(gt) - len(matched_gt)
        fp += len(preds) - len(matched_pred)
    if gt_total == 0:
        return 1.0 if fp == 0 else 0.0
    return 1.0 - (fn + fp + idsw) / gt_total
