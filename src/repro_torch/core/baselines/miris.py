"""Miris baseline (Bastani et al. 2020, adapted per §4): variable-rate
tracking with a PAIRWISE matcher.

Two deliberate limitations vs MultiScope's recurrent tracker (§3.4):
  * the matcher compares detections in two consecutive processed frames
    at a time (we instantiate the tracker model with prefix length 1, so
    the GRU state carries exactly one detection — the paper's GNN-pairwise
    analogue);
  * rate is VARIABLE: processing starts at the maximum gap; when matching
    confidence drops below the error tolerance q (or active tracks go
    unmatched), the gap halves for the next step; confident steps double
    it back.  The tolerance q is the speed-accuracy knob.

Query-agnostic mode: the predicate selects ALL tracks (paper §4).  The
port of the JAX package's ``repro.core.baselines.miris``: the matcher
trains and its crop CNN runs on the bank's device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core import pipeline as pl
from repro_torch.core.metrics import clip_count_accuracy
from repro_torch.core.tracker import (RecurrentTracker, TrackExample,
                                      train_tracker)
from repro_torch.core.tuner import TunerPoint
from repro_torch.data.video_synth import Clip


@dataclass
class MirisBaseline:
    bank: pl.ModelBank
    name: str = "miris"
    pair_params: Optional[dict] = None

    def train(self, examples: Sequence[TrackExample],
              steps: int = 1500) -> None:
        """Pairwise matcher = tracker trained with prefix length 1."""
        self.pair_params, _ = train_tracker(
            self.bank.cfg.tracker, list(examples), steps=steps,
            max_prefix=1, device=self.bank.device)

    def run_clip(self, params: pl.PipelineParams, clip: Clip,
                 tolerance: float) -> pl.RunResult:
        cfg = self.bank.cfg
        detector = self.bank.detectors[params.det_arch]
        W, H = params.det_res
        tracker = RecurrentTracker(cfg.tracker, self.pair_params)
        g_max = max(cfg.tracker.gaps)
        gap = g_max
        f = 0
        processed = 0
        charged = 0.0
        t0 = time.process_time()
        while f < clip.n_frames:
            t_r = time.process_time()
            frame, cost = pl.render_frame(clip, f, W, H)
            charged += cost - (time.process_time() - t_r)
            dets = detector.detect_batch(frame[None], params.det_conf)[0]
            before = {id(t): len(t.frames) for t in tracker.active}
            n_active = len(tracker.active)
            tracker.step(f, dets, frame)
            processed += 1
            # confidence heuristic: fraction of previously active tracks
            # that matched this step
            matched = sum(1 for t in tracker.active
                          if id(t) in before
                          and len(t.frames) > before[id(t)])
            conf = matched / n_active if n_active else 1.0
            if conf < tolerance and gap > 1:
                gap = max(1, gap // 2)          # drop rate, look closer
            elif conf >= tolerance and gap < g_max:
                gap = min(g_max, gap * 2)
            f += gap
        tracks = tracker.result()
        secs = time.process_time() - t0 + max(charged, 0.0)
        return pl.RunResult(tracks, secs, processed, processed,
                            processed, 0)

    def select(self, val_clips: Sequence[Clip],
               tolerances=(0.0, 0.25, 0.5, 0.75, 0.9, 1.0)
               ) -> List[TunerPoint]:
        cfg = self.bank.cfg
        params = pl.PipelineParams(
            det_arch=cfg.detector.archs[-1],
            det_res=cfg.detector.resolutions[0],
            det_conf=cfg.detector.confidences[1], gap=1,
            tracker="recurrent")
        points = []
        for q in tolerances:
            accs, secs = [], 0.0
            for clip in val_clips:
                r = self.run_clip(params, clip, q)
                accs.append(clip_count_accuracy(r.tracks, clip))
                secs += r.seconds
            points.append(TunerPoint(params, float(np.mean(accs)), secs,
                                     f"q={q}"))
        from repro_torch.core.baselines.chameleon import pareto
        return pareto(points)
