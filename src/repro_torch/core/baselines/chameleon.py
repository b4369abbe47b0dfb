"""Chameleon baseline (Jiang et al. 2018, adapted per §4): optimizes the
object-detector input resolution and sampling rate over a grid, with the
SORT tracker — the "tune resolution and rate" reference point.

Parameter selection (per the paper's protocol, using the count-label
metric): evaluate the (arch x resolution x gap) grid on the validation
set and keep the Pareto-optimal points.  The port of the JAX package's
``repro.core.baselines.chameleon``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from repro_torch.core import pipeline as pl
from repro_torch.core.tuner import TunerPoint, _evaluate
from repro_torch.data.video_synth import Clip


def pareto(points: List[TunerPoint]) -> List[TunerPoint]:
    """Keep points not dominated in (faster, more accurate)."""
    out = []
    for p in points:
        dominated = any(
            q.val_seconds <= p.val_seconds
            and q.val_accuracy >= p.val_accuracy and q is not p
            and (q.val_seconds < p.val_seconds
                 or q.val_accuracy > p.val_accuracy)
            for q in points)
        if not dominated:
            out.append(p)
    return sorted(out, key=lambda p: p.val_seconds)


@dataclass
class ChameleonBaseline:
    bank: pl.ModelBank
    name: str = "chameleon"

    def select(self, val_clips: Sequence[Clip]) -> List[TunerPoint]:
        cfg = self.bank.cfg
        points = []
        for arch in cfg.detector.archs:
            for res in cfg.detector.resolutions:
                for gap in cfg.tracker.gaps:
                    params = pl.PipelineParams(
                        det_arch=arch, det_res=res,
                        det_conf=cfg.detector.confidences[1], gap=gap,
                        tracker="sort", refine=False)
                    a, t = _evaluate(self.bank, params, val_clips)
                    points.append(TunerPoint(params, a, t, "grid"))
        return pareto(points)
