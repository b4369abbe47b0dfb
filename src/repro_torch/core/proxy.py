"""Segmentation proxy model (§3.3): a small strided-conv encoder scoring
every C x C pixel cell with P(cell intersects a detection).

The port of the JAX package's ``repro.core.proxy`` inference path: the
encoder (log2(C) stride-2 convs, then one 3x3 decoder conv at cell
resolution) is ``ProxyEncoder``; its 1x1 head is applied, thresholded
and mapped onto the detector grid by the fused ``proxy_plan`` kernel in
``ProxyModel.plan_batch``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import Device, resolve_device
from repro_torch.core.detector import SameConv2d, pad_to_bucket, to_device
from repro_torch.kernels.proxy_plan import proxy_plan


def _n_levels(cell: int) -> int:
    n = int(np.log2(cell))
    if 2 ** n != cell:
        raise ValueError(f"cell {cell} must be a power of two")
    return n


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
            encoder = ProxyEncoder(cell, base_channels,
                                   torch.Generator().manual_seed(seed))
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
            return grids[:n].cpu().numpy(), stats[:n].cpu().numpy()
