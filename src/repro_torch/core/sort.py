"""SORT heuristic tracker (Bewley et al. 2016, simplified): constant-
velocity prediction + IoU Hungarian matching.

The port's copy: ``pipeline.make_tracker`` selects it whenever θ asks
for SORT or the bank has no recurrent tracker parameters.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.core.detector import iou_matrix
from repro_torch.core.hungarian import hungarian, BIG


@dataclass
class Track:
    track_id: int
    frames: List[int] = field(default_factory=list)
    boxes: List[np.ndarray] = field(default_factory=list)   # (4,) world
    misses: int = 0

    def predict(self, frame: int) -> np.ndarray:
        """Constant-velocity extrapolation to ``frame``."""
        if len(self.boxes) < 2:
            return self.boxes[-1]
        dt = self.frames[-1] - self.frames[-2]
        if dt <= 0:
            return self.boxes[-1]
        vel = (self.boxes[-1][:2] - self.boxes[-2][:2]) / dt
        pred = self.boxes[-1].copy()
        pred[:2] = pred[:2] + vel * (frame - self.frames[-1])
        return pred

    def as_array(self) -> np.ndarray:
        """(n, 6) [frame, cx, cy, w, h, track_id]."""
        out = np.zeros((len(self.frames), 6), np.float32)
        out[:, 0] = self.frames
        out[:, 1:5] = np.stack(self.boxes)
        out[:, 5] = self.track_id
        return out


class SortTracker:
    def __init__(self, iou_threshold: float = 0.15, max_misses: int = 2,
                 min_hits: int = 2):
        self.iou_threshold = iou_threshold
        self.max_misses = max_misses
        self.min_hits = min_hits
        self.active: List[Track] = []
        self.finished: List[Track] = []
        self._next_id = 0

    def step(self, frame: int, dets: np.ndarray,
             pixels: Optional[np.ndarray] = None,
             det_embeds: Optional[np.ndarray] = None) -> None:
        """dets: (n, >=4) [cx, cy, w, h, ...] world units.  ``pixels``
        and ``det_embeds`` are accepted (and ignored) for interface
        parity with the recurrent tracker."""
        del pixels, det_embeds
        preds = np.stack([t.predict(frame) for t in self.active]) \
            if self.active else np.zeros((0, 4), np.float32)
        iou = iou_matrix(preds, dets[:, :4]) if len(dets) else \
            np.zeros((len(preds), 0), np.float32)
        cost = np.where(iou >= self.iou_threshold, 1.0 - iou, BIG)
        pairs = hungarian(cost)
        matched_t = set()
        matched_d = set()
        for ti, di in pairs:
            t = self.active[ti]
            t.frames.append(frame)
            t.boxes.append(dets[di, :4].astype(np.float32))
            t.misses = 0
            matched_t.add(ti)
            matched_d.add(di)
        # age out unmatched tracks
        survivors = []
        for ti, t in enumerate(self.active):
            if ti in matched_t:
                survivors.append(t)
                continue
            t.misses += 1
            if t.misses > self.max_misses:
                self.finished.append(t)
            else:
                survivors.append(t)
        self.active = survivors
        # new tracks for unmatched detections
        for di in range(len(dets)):
            if di in matched_d:
                continue
            t = Track(self._next_id)
            t.frames.append(frame)
            t.boxes.append(dets[di, :4].astype(np.float32))
            self.active.append(t)
            self._next_id += 1

    def result(self) -> List[np.ndarray]:
        """All tracks with >= min_hits detections, as (n, 6) arrays."""
        tracks = self.finished + self.active
        return [t.as_array() for t in tracks
                if len(t.frames) >= self.min_hits]
