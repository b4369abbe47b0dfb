"""MultiScope pipeline configuration (the port's copy of the JAX
package's ``PipelineConfig`` dataclasses).

All knobs here mirror §3 of the paper:
  * proxy module: input resolution (5 pre-trained sizes) + threshold B_proxy
  * detection module: detector architecture + input resolution + confidence
  * tracking module: sampling gap g ∈ G (powers of two)
  * window-size set S of cardinality k=3 (greedy offline selection)
  * tuner: greedy, per-iteration target speedup S=30%
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class ProxyConfig:
    """Segmentation proxy model (§3.3): 5-layer strided conv encoder
    (stride-2 each → 1/32 resolution) + 2-layer decoder → per-cell score."""
    cell: int = 32                       # score one 32x32 cell per output px
    base_channels: int = 8
    resolutions: Tuple[Tuple[int, int], ...] = (
        (416, 256), (352, 224), (288, 192), (224, 128), (160, 96))
    thresholds: Tuple[float, ...] = (
        0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)


@dataclass(frozen=True)
class DetectorConfig:
    """Single-shot anchor-free detector.  Two registered architectures of
    different depths preserve the paper's arch-choice tuning dimension
    (YOLOv3 vs Mask R-CNN in the paper)."""
    archs: Tuple[str, ...] = ("ssd-lite", "ssd-deep")
    resolutions: Tuple[Tuple[int, int], ...] = (
        (960, 544), (832, 480), (704, 416), (608, 352), (512, 288),
        (448, 256), (384, 224), (320, 192))
    stride: int = 32                     # one prediction cell per 32x32 px
    confidences: Tuple[float, ...] = (0.25, 0.4, 0.55, 0.7)
    max_dets: int = 64                   # static shape: detections per frame


@dataclass(frozen=True)
class TrackerConfig:
    """Recurrent reduced-rate tracker (§3.4)."""
    gaps: Tuple[int, ...] = (1, 2, 4, 8, 16, 32)   # maximal gap sequence G
    embed_dim: int = 32                  # detection-level CNN feature size
    rnn_dim: int = 64                    # GRU hidden size (track-level)
    match_hidden: int = 64               # matching MLP hidden
    crop: int = 16                       # detection crop edge (px) fed to CNN
    match_threshold: float = 0.2         # below this a det starts a new track
    max_tracks: int = 64                 # static active-track capacity


@dataclass(frozen=True)
class WindowConfig:
    """Fixed window-size set selection (§3.3)."""
    k: int = 3                           # |S|, incl. the full-frame size
    step: int = 32                       # candidate sizes are multiples of 32
    max_windows: int = 8                 # static per-frame window capacity


@dataclass(frozen=True)
class RefineConfig:
    """Track start/end refinement (§3.4): DBSCAN + grid index + kNN."""
    dbscan_eps: float = 40.0
    dbscan_min_pts: int = 2
    n_points: int = 20                   # N evenly spaced points per track
    knn: int = 10
    grid_cell: int = 64                  # spatial index cell size (px)


@dataclass(frozen=True)
class TunerConfig:
    """Joint greedy parameter tuner (§3.5)."""
    speedup_per_iter: float = 0.30       # S = 30%
    max_iters: int = 12


@dataclass(frozen=True)
class PipelineConfig:
    proxy: ProxyConfig = field(default_factory=ProxyConfig)
    detector: DetectorConfig = field(default_factory=DetectorConfig)
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    windows: WindowConfig = field(default_factory=WindowConfig)
    refine: RefineConfig = field(default_factory=RefineConfig)
    tuner: TunerConfig = field(default_factory=TunerConfig)
    frame_size: Tuple[int, int] = (960, 544)   # native (w, h)
    fps: int = 16

    def reduced(self) -> "PipelineConfig":
        """CPU-friendly pipeline for tests/benchmarks.  Scale is chosen so
        the paper's cost structure survives: the detector at full
        resolution is ~20x the proxy cost and ~6.5x the detector at the
        lowest resolution, so all three tuner modules have real leverage."""
        return PipelineConfig(
            proxy=ProxyConfig(
                cell=8, base_channels=4,
                resolutions=((64, 40), (48, 32), (32, 24)),
                thresholds=(0.1, 0.3, 0.5, 0.7)),
            detector=DetectorConfig(
                archs=("ssd-lite", "ssd-deep"),
                resolutions=((256, 160), (208, 128), (160, 96),
                             (128, 80)),
                stride=16, max_dets=24,
                confidences=(0.4, 0.55, 0.7)),
            tracker=TrackerConfig(gaps=(1, 2, 4, 8), embed_dim=16,
                                  rnn_dim=32, match_hidden=32, crop=8,
                                  max_tracks=32),
            windows=WindowConfig(k=3, step=16, max_windows=4),
            refine=RefineConfig(dbscan_eps=20.0, grid_cell=32),
            tuner=TunerConfig(max_iters=8),
            frame_size=(256, 160),
            fps=8,
        )


MULTISCOPE_PIPELINE = PipelineConfig()
