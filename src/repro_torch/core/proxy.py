"""Segmentation proxy model (§3.3): a small strided-conv encoder scoring
every C x C pixel cell with P(cell intersects a detection).

The port of the JAX package's ``repro.core.proxy`` inference path: the
encoder (log2(C) stride-2 convs, then one 3x3 decoder conv at cell
resolution) is ``ProxyEncoder``; its 1x1 head is applied, thresholded
and mapped onto the detector grid by the fused ``proxy_plan`` kernel in
``ProxyModel.plan_batch``, or applied and thresholded into a score map
by the ``proxy_score`` kernel in ``ProxyModel.scores`` /
``scores_batch`` (the per-frame path and ``fused_plan=False``).  The
threshold sweep and calibration over cached score grids are host numpy.
``proxy_loss`` trains the encoder and its head with autograd, the head
applied as the reference's einsum (the kernels have no backward).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import Device, resolve_device
from repro_torch.core.detector import SameConv2d, pad_to_bucket, to_device
from repro_torch.kernels import views_to_host
from repro_torch.kernels.proxy_plan import proxy_plan
from repro_torch.kernels.proxy_score import proxy_score


def _n_levels(cell: int) -> int:
    n = int(np.log2(cell))
    if 2 ** n != cell:
        raise ValueError(f"cell {cell} must be a power of two")
    return n


def threshold_sweep(score_grids: Sequence[np.ndarray],
                    label_grids: Sequence[np.ndarray],
                    thresholds: Sequence[float]
                    ) -> List[Tuple[float, float, float]]:
    """The paper's threshold sweep over CACHED validation score grids.

    For each candidate threshold: cell-level recall of the labelled
    positive cells (labels = θ_best detections rasterized with
    ``cells_from_detections``) and the positive-cell rate (the proxy's
    selectivity).  A cell is positive iff its score is strictly above
    the threshold, as in ``proxy_score``.

    -> [(threshold, recall, positive_rate)] in input threshold order.
    """
    out: List[Tuple[float, float, float]] = []
    for th in thresholds:
        covered = total = pos = cells = 0
        for s, y in zip(score_grids, label_grids):
            p = s > th
            lab = y > 0
            covered += int((p & lab).sum())
            total += int(lab.sum())
            pos += int(p.sum())
            cells += p.size
        out.append((float(th), covered / max(total, 1),
                    pos / max(cells, 1)))
    return out


def sweep_candidates(score_grids: Sequence[np.ndarray],
                     base_thresholds: Sequence[float] = (),
                     quantiles: Sequence[float] = (0.5, 0.75, 0.9)
                     ) -> List[float]:
    """Candidate thresholds for the sweep: the configured menu plus
    quantiles of the cached score distribution (trained proxies put
    scores far from 0.5, untrained ones in a narrow band around it)."""
    flat = np.concatenate([np.asarray(s).ravel() for s in score_grids])
    qs = [float(np.quantile(flat, q)) for q in quantiles]
    return sorted({round(float(t), 6) for t in
                   list(base_thresholds) + qs})


def calibrate_threshold(score_grids: Sequence[np.ndarray],
                        label_grids: Sequence[np.ndarray],
                        thresholds: Sequence[float] = (),
                        min_recall: float = 0.95) -> float:
    """Pick the LARGEST threshold (sparsest positive grids, cheapest
    window plans) whose cell recall stays >= ``min_recall``; fall back
    to the best-recall candidate when none reaches the target."""
    cand = sweep_candidates(score_grids, thresholds)
    sweep = threshold_sweep(score_grids, label_grids, cand)
    ok = [th for th, recall, _ in sweep if recall >= min_recall]
    if ok:
        return max(ok)
    return max(sweep, key=lambda e: (e[1], e[0]))[0]


def cells_from_detections(dets: np.ndarray, hc: int, wc: int
                          ) -> np.ndarray:
    """Label a cell 1 if any detection box INTERSECTS it (paper wording).

    dets: (n, >=4) [cx, cy, w, h] world units -> (hc, wc) int8."""
    grid = np.zeros((hc, wc), np.int8)
    for row in dets:
        cx, cy, w, h = row[:4]
        x0 = int(np.clip((cx - w / 2) * wc, 0, wc - 1e-6))
        x1 = int(np.clip((cx + w / 2) * wc, 0, wc - 1e-6))
        y0 = int(np.clip((cy - h / 2) * hc, 0, hc - 1e-6))
        y1 = int(np.clip((cy + h / 2) * hc, 0, hc - 1e-6))
        grid[y0:y1 + 1, x0:x1 + 1] = 1
    return grid


class ProxyEncoder(nn.Module):
    """frames (B, H, W, 3) -> features (B, H/C, W/C, channels).  Holds
    the head too (``head_w`` (channels,), ``head_b`` (1,)), which
    ``forward`` does not apply: the plan kernel fuses it."""

    def __init__(self, cell: int, base_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cell = cell
        self.enc = nn.ModuleList()
        cin = 3
        for i in range(_n_levels(cell)):
            c = base_channels * min(2 ** i, 8)
            self.enc.append(SameConv2d(cin, c, 3, 2, generator))
            cin = c
        self.dec0 = SameConv2d(cin, cin, 3, 1, generator)
        self.head_w = nn.Parameter(torch.randn((cin,), generator=generator)
                                   / np.sqrt(cin))
        self.head_b = nn.Parameter(torch.zeros((1,)))

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        x = frames.permute(0, 3, 1, 2)
        for conv in self.enc:
            x = F.relu(conv(x))
        return F.relu(self.dec0(x)).permute(0, 2, 3, 1).contiguous()


def init_proxy(cell: int, base_channels: int, seed: int = 0
               ) -> ProxyEncoder:
    """The port's seeded init (``ProxyModel(..., seed=)`` holds the same
    weights)."""
    return ProxyEncoder(cell, base_channels,
                        torch.Generator().manual_seed(seed))


def proxy_loss(encoder: ProxyEncoder, frames: torch.Tensor,
               cell_labels: torch.Tensor) -> torch.Tensor:
    """cell_labels: (B, Hc, Wc) {0,1} from θ_best detections; the
    class-balanced BCE of the head's logits."""
    feat = encoder(frames)
    logits = torch.einsum("bhwc,c->bhw", feat, encoder.head_w) \
        + encoder.head_b[0]
    y = cell_labels.to(torch.float32)
    bce = torch.clamp(logits, min=0) - logits * y \
        + torch.log1p(torch.exp(-torch.abs(logits)))
    n_pos = torch.clamp(y.sum(), min=1.0)
    n_neg = torch.clamp((1 - y).sum(), min=1.0)
    return (bce * y).sum() / n_pos + (bce * (1 - y)).sum() / n_neg


class ProxyModel:
    """One proxy at one input resolution, on one device."""

    def __init__(self, cell: int, base_channels: int,
                 resolution: Tuple[int, int],
                 encoder: Optional[ProxyEncoder] = None, seed: int = 0,
                 device: Device = "cuda"):
        self.cell = cell
        self.resolution = resolution                      # (W, H)
        self.device = resolve_device(device)
        if encoder is None:
            encoder = init_proxy(cell, base_channels, seed)
        self.encoder = encoder.to(self.device).eval()

    def grid_shape(self) -> Tuple[int, int]:
        W, H = self.resolution
        return H // self.cell, W // self.cell

    def features(self, frames: np.ndarray) -> torch.Tensor:
        """(B, H, W, 3) host frames -> (B, H/C, W/C, ch) device features
        of the frames bucket-padded as ``plan_batch`` pads them."""
        with torch.inference_mode():
            return self.encoder(to_device(pad_to_bucket(frames),
                                          self.device))

    def _scores(self, frames: np.ndarray, threshold: float
                ) -> Tuple[np.ndarray, np.ndarray]:
        feat = self.features(frames)
        with torch.inference_mode():
            s, p = proxy_score(feat, self.encoder.head_w,
                               self.encoder.head_b, threshold)
            # one copy back: on the card both are views of one buffer
            return views_to_host(s, p)

    def scores(self, frame: np.ndarray, threshold: float = 0.5
               ) -> Tuple[np.ndarray, np.ndarray]:
        """One frame (H, W, 3), scored at batch 1 through the
        ``proxy_score`` kernel -> ((Hc, Wc) f32 scores, (Hc, Wc) int8
        positives) on the host."""
        s, p = self._scores(frame[None], threshold)
        return s[0], p[0]

    def scores_batch(self, frames: np.ndarray, threshold: float = 0.5
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Score a CHUNK of frames in one ``proxy_score`` launch.
        frames: (B, H, W, 3) -> ((B, Hc, Wc) scores, (B, Hc, Wc) int8
        positives).  The batch is zero-padded to a power-of-two bucket,
        as the reference pads it; padding rows are dropped."""
        n = int(frames.shape[0])
        if n == 0:
            hc, wc = self.grid_shape()
            return (np.zeros((0, hc, wc), np.float32),
                    np.zeros((0, hc, wc), np.int8))
        s, p = self._scores(frames, threshold)
        return s[:n], p[:n]

    def plan_batch(self, frames: np.ndarray, threshold: float,
                   det_grid: Tuple[int, int]
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Fused score + threshold + detector-grid mapping for a CHUNK
        through the ``proxy_plan`` kernel: only the mapped (B, hc, wc)
        int8 grids and (B, 8) int32 plan stats come back to the host.
        ``det_grid`` is (wc, hc), matching ``pipeline.det_grid``.  The
        batch is zero-padded to a power-of-two bucket, as the reference
        pads it; padding rows are dropped."""
        wc, hc = det_grid
        n = int(frames.shape[0])
        if n == 0:
            return (np.zeros((0, hc, wc), np.int8),
                    np.zeros((0, 8), np.int32))
        feat = self.features(frames)
        with torch.inference_mode():
            grids, stats = proxy_plan(feat, self.encoder.head_w,
                                      self.encoder.head_b, threshold,
                                      grid_hw=(hc, wc))
            return views_to_host(grids[:n], stats[:n])
