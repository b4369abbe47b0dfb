"""BlazeIt baseline (Kang et al. 2019, adapted per §4).

Query-agnostic mode (NoScope-like): a frame-level CLASSIFICATION proxy
(small CNN -> P(frame contains any object)) gates full-frame detection;
frames under the threshold are skipped entirely.  On busy datasets this
yields only the trivial configurations (process everything / skip
everything) — exactly the paper's observation.

Limit-query mode (§4.2, Table 2): a REGRESSION proxy estimates the object
count in a region on every frame; the query phase applies the detector on
frames in descending proxy-score order until it has found the requested
number of matching frames (min spacing enforced).

The port of the JAX package's ``repro.core.baselines.blazeit``: the frame
scorer is ``FrameScorer``, an ``nn.Module`` of the port's ``SameConv2d``
layers, trained by ``train_models._fit`` and run on the bank's device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import pipeline as pl
from repro_torch.core.detector import SameConv2d, to_device
from repro_torch.core.metrics import clip_count_accuracy
from repro_torch.core.sort import SortTracker
from repro_torch.core.train_models import _fit
from repro_torch.core.tuner import TunerPoint
from repro_torch.data.video_synth import Clip


class FrameScorer(nn.Module):
    """Tiny frame-level CNN -> one scalar (classification or count): three
    stride-2 3x3 convs with relu (``enc0``-``enc2``), a 1x1 ``head``,
    then the mean over the head's map.  frames (B, H, W, 3) -> (B,)."""

    def __init__(self, base: int = 8,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.enc = nn.ModuleList()
        cin = 3
        for c in (base, base * 2, base * 4):
            self.enc.append(SameConv2d(cin, c, 3, 2, generator))
            cin = c
        self.head = SameConv2d(cin, 1, 1, 1, generator)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        x = frames.permute(0, 3, 1, 2)
        for conv in self.enc:
            x = F.relu(conv(x))
        return self.head(x).mean(dim=(1, 2, 3))


def init_frame_scorer(seed: int = 0, base: int = 8) -> FrameScorer:
    return FrameScorer(base, torch.Generator().manual_seed(seed))


def frame_score(scorer: FrameScorer, frames: torch.Tensor) -> torch.Tensor:
    return scorer(frames)


def _scorer_loss_cls(scorer: FrameScorer, frames: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
    s = frame_score(scorer, frames)
    y = labels.to(torch.float32)
    bce = torch.clamp(s, min=0) - s * y + torch.log1p(torch.exp(-torch.abs(s)))
    return bce.mean()


def _scorer_loss_reg(scorer: FrameScorer, frames: torch.Tensor,
                     counts: torch.Tensor) -> torch.Tensor:
    s = frame_score(scorer, frames)
    return torch.abs(s - counts.to(torch.float32)).mean()


@dataclass
class BlazeItBaseline:
    bank: pl.ModelBank
    proxy_res: Tuple[int, int] = (64, 48)
    name: str = "blazeit"
    cls_params: Optional[FrameScorer] = None
    reg_params: Optional[FrameScorer] = None

    def _score(self, scorer: FrameScorer, small: np.ndarray) -> float:
        """One (h, w, 3) frame -> the scorer's raw output."""
        with torch.inference_mode():
            return float(frame_score(
                scorer, to_device(small[None], self.bank.device))[0])

    # -- training --------------------------------------------------------------
    def train(self, train_dets: Sequence[Tuple[Clip, int, np.ndarray]],
              steps: int = 150,
              region: Optional[Tuple[float, float, float, float]] = None,
              ) -> None:
        """train_dets: θ_best (clip, frame, detections) labels."""
        W, H = self.proxy_res
        frames = np.stack([c.render(f, W, H) for c, f, _ in train_dets])
        has = np.asarray([float(len(d) > 0) for _, _, d in train_dets])
        counts = np.asarray([
            float(_count_in_region(d, region)) for _, _, d in train_dets])
        rng = np.random.default_rng(0)

        def batches(labels):
            def it():
                for _ in range(steps):
                    idx = rng.integers(len(frames), size=16)
                    yield frames[idx], labels[idx]
            return it()

        dev = self.bank.device
        self.cls_params, _ = _fit(_scorer_loss_cls,
                                  init_frame_scorer(1).to(dev),
                                  batches(has), lr=3e-3)
        self.reg_params, _ = _fit(_scorer_loss_reg,
                                  init_frame_scorer(2).to(dev),
                                  batches(counts), lr=3e-3)

    # -- query-agnostic track extraction ----------------------------------------
    def run_clip(self, params: pl.PipelineParams, clip: Clip,
                 threshold: float) -> pl.RunResult:
        detector = self.bank.detectors[params.det_arch]
        W, H = params.det_res
        tracker = SortTracker()
        skipped = 0
        t0 = time.process_time()
        charged = 0.0
        for f in range(clip.n_frames):
            t_r = time.process_time()
            frame, cost = pl.render_frame(clip, f, W, H)
            charged += cost - (time.process_time() - t_r)
            small = pl._downsample(frame, self.proxy_res)
            logit = self._score(self.cls_params, small)
            score = float(torch.sigmoid(torch.tensor(logit,
                                                     dtype=torch.float32)))
            if score < threshold:
                skipped += 1
                continue
            dets = detector.detect_batch(frame[None], params.det_conf)[0]
            tracker.step(f, dets)
        tracks = tracker.result()
        secs = time.process_time() - t0 + max(charged, 0.0)
        return pl.RunResult(tracks, secs, clip.n_frames - skipped,
                            clip.n_frames - skipped,
                            clip.n_frames - skipped, skipped)

    def select(self, val_clips: Sequence[Clip],
               thresholds=(0.0, 0.2, 0.4, 0.6, 0.8, 0.95)
               ) -> List[TunerPoint]:
        cfg = self.bank.cfg
        params = pl.PipelineParams(
            det_arch=cfg.detector.archs[-1],
            det_res=cfg.detector.resolutions[0],
            det_conf=cfg.detector.confidences[1], gap=1, tracker="sort")
        points = []
        for th in thresholds:
            accs, secs = [], 0.0
            for clip in val_clips:
                r = self.run_clip(params, clip, th)
                accs.append(clip_count_accuracy(r.tracks, clip))
                secs += r.seconds
            pt = TunerPoint(params, float(np.mean(accs)), secs,
                            f"th={th}")
            points.append(pt)
        from repro_torch.core.baselines.chameleon import pareto
        return pareto(points)

    # -- limit query (§4.2) ------------------------------------------------------
    def limit_query(self, clips: Sequence[Clip],
                    params: pl.PipelineParams, *, want: int,
                    min_count: int, region, min_spacing: int
                    ) -> Dict[str, object]:
        """Find ``want`` frames with >= min_count objects in ``region``.

        Returns dict with found frames, preprocessing/query times, and
        detector invocations."""
        W, H = params.det_res
        detector = self.bank.detectors[params.det_arch]
        # pre-processing: regression proxy over EVERY frame (decode at
        # proxy resolution — cheap, like BlazeIt's 64x64 decode)
        t0 = time.process_time()
        scores = []
        for ci, clip in enumerate(clips):
            for f in range(clip.n_frames):
                small = clip.render(f, *self.proxy_res)
                scores.append((self._score(self.reg_params, small), ci, f))
        pre_s = time.process_time() - t0
        # query phase: detector in descending-score order
        t0 = time.process_time()
        scores.sort(key=lambda x: -x[0])
        found: List[Tuple[int, int]] = []
        n_det = 0
        for s, ci, f in scores:
            if len(found) >= want:
                break
            if any(c == ci and abs(f - g) < min_spacing
                   for c, g in found):
                continue
            frame = clips[ci].render(f, W, H)
            dets = detector.detect_batch(frame[None], params.det_conf)[0]
            n_det += 1
            if _count_in_region(dets, region) >= min_count:
                found.append((ci, f))
        query_s = time.process_time() - t0
        return {"found": found, "pre_seconds": pre_s,
                "query_seconds": query_s, "detector_frames": n_det}


def _count_in_region(dets: np.ndarray, region) -> int:
    if len(dets) == 0:
        return 0
    if region is None:
        return len(dets)
    x0, y0, x1, y1 = region
    m = ((dets[:, 0] >= x0) & (dets[:, 0] <= x1)
         & (dets[:, 1] >= y0) & (dets[:, 1] <= y1))
    return int(m.sum())
