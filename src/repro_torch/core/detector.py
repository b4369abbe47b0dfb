"""Single-shot anchor-free object detector (the pipeline's expensive model).

The port of the JAX package's ``repro.core.detector``: a strided conv
backbone to stride 16, then a 1x1 head predicting per cell [objectness,
dx, dy, log w, log h].  The same network runs on full frames and on the
proxy-selected windows (any H x W divisible by the stride).

Layout: public functions take and return NHWC (frames (B, H, W, 3), head
outputs (B, h, w, 5)), as the reference does; the modules permute to
PyTorch's NCHW inside.  Convolutions pad as XLA's "SAME" does, which is
not PyTorch's symmetric ``padding=1`` (see ``same_pads``).

The training half (``detector_raw``, ``detector_loss``, ``make_targets``)
is ordinary autograd over ``DetectorNet``; ``core.train_models`` fits it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import Device, resolve_device

STRIDE = 16

ARCHS: Dict[str, Tuple[Tuple[int, ...], Tuple[int, ...]]] = {
    # name -> (channels per block, extra 3x3 convs per block)
    "ssd-lite": ((12, 24, 48, 96), (0, 0, 0, 0)),
    "ssd-deep": ((16, 32, 64, 128), (1, 1, 1, 1)),
}


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: the output has
    ceil(size / stride) positions and the total padding is split with
    the smaller half BEFORE.  With k=3, stride 2 and an even size that is
    (0, 1), where ``nn.Conv2d(padding=1)`` would pad (1, 1) and shift
    every output by a pixel."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` with XLA "SAME" padding, on NCHW tensors.  Weights
    are OIHW; ``generator`` draws them as the reference does (normal
    with std 1/sqrt(k*k*cin), zero bias)."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cin, cout, k, stride=stride, padding=0)
        with torch.no_grad():
            self.weight.copy_(torch.randn(self.weight.shape,
                                          generator=generator)
                              / np.sqrt(k * k * cin))
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        top, bottom = same_pads(x.shape[2], k, s)
        left, right = same_pads(x.shape[3], k, s)
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight, self.bias, self.stride)


class DetectorNet(nn.Module):
    """frames (B, H, W, 3) -> raw head outputs (B, H/16, W/16, 5).
    Submodule names match the reference's parameter scopes
    (``block{i}_down``, ``block{i}_conv{j}``, ``head``)."""

    def __init__(self, arch: str,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.arch = arch
        chans, extras = ARCHS[arch]
        self.convs = nn.ModuleDict()
        self.order: List[Tuple[str, bool]] = []    # (name, relu)
        cin = 3
        for i, (c, extra) in enumerate(zip(chans, extras)):
            self._add(f"block{i}_down", SameConv2d(cin, c, 3, 2, generator))
            for j in range(extra):
                self._add(f"block{i}_conv{j}",
                          SameConv2d(c, c, 3, 1, generator))
            cin = c
        self._add("head", SameConv2d(cin, 5, 1, 1, generator), relu=False)

    def _add(self, name: str, conv: SameConv2d, relu: bool = True) -> None:
        self.convs[name] = conv
        self.order.append((name, relu))

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        x = frames.permute(0, 3, 1, 2)
        for name, relu in self.order:
            x = self.convs[name](x)
            if relu:
                x = F.relu(x)
        return x.permute(0, 2, 3, 1)


def init_detector(arch: str, seed: int = 0) -> DetectorNet:
    """The port's seeded init (the reference's shapes and scales, not its
    numbers); ``Detector(arch, seed=)`` holds the same weights."""
    return DetectorNet(arch, torch.Generator().manual_seed(seed))


def detector_raw(net: DetectorNet, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, H, W, 3) -> (B, H/S, W/S, 5) raw head outputs:
    ``[..., 0]`` the objectness logit, ``[..., 1:]`` the box."""
    return net(frames)


def detector_loss(net: DetectorNet, frames: torch.Tensor,
                  obj_target: torch.Tensor, box_target: torch.Tensor
                  ) -> torch.Tensor:
    """obj_target: (B, Hc, Wc) {0,1}; box_target: (B, Hc, Wc, 4)."""
    out = detector_raw(net, frames)
    obj_logit = out[..., 0]
    box = out[..., 1:]
    obj = obj_target.to(torch.float32)
    bce = torch.clamp(obj_logit, min=0) - obj_logit * obj \
        + torch.log1p(torch.exp(-torch.abs(obj_logit)))
    # class-balanced normalization: positives are ~5-10% of cells, so a
    # plain mean starves them of gradient
    n_pos = torch.clamp(obj.sum(), min=1.0)
    n_neg = torch.clamp((1 - obj).sum(), min=1.0)
    bce = (bce * obj).sum() / n_pos + (bce * (1 - obj)).sum() / n_neg
    l1 = torch.sum(torch.abs(box - box_target) * obj[..., None]) \
        / (n_pos * 4)
    return bce + l1


def make_targets(boxes_list: List[np.ndarray], hc: int, wc: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """boxes: per-frame (n, >=4) [cx, cy, w, h] world units -> targets."""
    B = len(boxes_list)
    obj = np.zeros((B, hc, wc), np.float32)
    box = np.zeros((B, hc, wc, 4), np.float32)
    for b, boxes in enumerate(boxes_list):
        for row in boxes:
            cx, cy, w, h = row[:4]
            j = min(int(cx * wc), wc - 1)
            i = min(int(cy * hc), hc - 1)
            obj[b, i, j] = 1.0
            # sizes in CELL units: input-resolution invariant
            box[b, i, j] = [cx * wc - j, cy * hc - i,
                            np.log(max(w * wc, 1e-3)),
                            np.log(max(h * hc, 1e-3))]
    return obj, box


def detect_scores(net: DetectorNet, frames: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (objectness scores (B, h, w), box regressions (B, h, w, 4))."""
    out = net(frames)
    return torch.sigmoid(out[..., 0]), out[..., 1:]


def batch_drift(net: DetectorNet, frames: torch.Tensor,
                batches: Sequence[int]) -> Dict[int, float]:
    """How far ``detect_scores`` of a row moves with the batch it rides
    in: for each b in ``batches``, max |Δ| over scores and box outputs
    of the first b rows run as one batch against each row run alone.
    The brokers change a window's batch, so this is what decides whether
    a brokered stream's tracks can equal its solo run's bit for bit."""
    with torch.inference_mode():
        alone = [detect_scores(net, frames[i:i + 1])
                 for i in range(max(batches))]
        out = {}
        for b in batches:
            s, bx = detect_scores(net, frames[:b])
            out[b] = max(
                float((s - torch.cat([a[0] for a in alone[:b]])).abs().max()),
                float((bx - torch.cat([a[1] for a in alone[:b]])).abs().max()))
    return out


def decode_detections(scores: np.ndarray, boxes: np.ndarray,
                      conf: float, origin: Tuple[float, float] = (0.0, 0.0),
                      scale: Tuple[float, float] = (1.0, 1.0),
                      max_dets: int = 64) -> np.ndarray:
    """One frame's head outputs -> (n, 5) [cx, cy, w, h, score] world
    units.  origin/scale place a WINDOW's cells into the full frame:
    world = origin + cell_frac * scale."""
    hc, wc = scores.shape
    ii, jj = np.nonzero(scores > conf)
    if len(ii) == 0:
        return np.zeros((0, 5), np.float32)
    sc = scores[ii, jj]
    order = np.argsort(-sc)[:max_dets * 4]
    ii, jj, sc = ii[order], jj[order], sc[order]
    bx = boxes[ii, jj]
    cx = origin[0] + (jj + np.clip(bx[:, 0], 0, 1)) / wc * scale[0]
    cy = origin[1] + (ii + np.clip(bx[:, 1], 0, 1)) / hc * scale[1]
    w = np.exp(np.clip(bx[:, 2], -5, 5)) / wc * scale[0]
    h = np.exp(np.clip(bx[:, 3], -5, 5)) / hc * scale[1]
    dets = np.stack([cx, cy, w, h, sc], axis=1).astype(np.float32)
    return nms(dets)[:max_dets]


def nms(dets: np.ndarray, iou_thresh: float = 0.45) -> np.ndarray:
    if len(dets) <= 1:
        return dets
    order = np.argsort(-dets[:, 4])
    m = iou_matrix(dets[order, :4], dets[order, :4])
    keep = []
    for i, idx in enumerate(order):
        if not keep or not (m[i, keep] > iou_thresh).any():
            keep.append(i)
    return dets[order[keep]]


def iou(a: np.ndarray, b: np.ndarray) -> float:
    ax0, ay0 = a[0] - a[2] / 2, a[1] - a[3] / 2
    ax1, ay1 = a[0] + a[2] / 2, a[1] + a[3] / 2
    bx0, by0 = b[0] - b[2] / 2, b[1] - b[3] / 2
    bx1, by1 = b[0] + b[2] / 2, b[1] + b[3] / 2
    ix = max(0.0, min(ax1, bx1) - max(ax0, bx0))
    iy = max(0.0, min(ay1, by1) - max(ay0, by0))
    inter = ix * iy
    union = a[2] * a[3] + b[2] * b[3] - inter
    return inter / union if union > 0 else 0.0


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a: (n,4), b: (m,4) [cx,cy,w,h] -> (n,m) IoU."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    ax0 = a[:, 0] - a[:, 2] / 2
    ay0 = a[:, 1] - a[:, 3] / 2
    ax1 = a[:, 0] + a[:, 2] / 2
    ay1 = a[:, 1] + a[:, 3] / 2
    bx0 = b[:, 0] - b[:, 2] / 2
    by0 = b[:, 1] - b[:, 3] / 2
    bx1 = b[:, 0] + b[:, 2] / 2
    by1 = b[:, 1] + b[:, 3] / 2
    ix = np.maximum(0, np.minimum(ax1[:, None], bx1[None]) -
                    np.maximum(ax0[:, None], bx0[None]))
    iy = np.maximum(0, np.minimum(ay1[:, None], by1[None]) -
                    np.maximum(ay0[:, None], by0[None]))
    inter = ix * iy
    union = (a[:, 2] * a[:, 3])[:, None] + (b[:, 2] * b[:, 3])[None] - inter
    return np.where(union > 0, inter / union, 0.0).astype(np.float32)


def next_bucket(n: int, min_bucket: int = 1) -> int:
    """Smallest power-of-two >= n (>= min_bucket).  Batch dims are padded
    to these buckets exactly as the reference pads them, so the port is
    held against it at the same batch composition."""
    b = max(1, min_bucket)
    while b < n:
        b *= 2
    return b


def pad_to_bucket(arr: np.ndarray, min_bucket: int = 1) -> np.ndarray:
    """Zero-pad arr's leading (batch) dim to the next power-of-two
    bucket.  Returns arr unchanged when already bucket-sized."""
    n = int(arr.shape[0])
    b = next_bucket(n, min_bucket)
    if b == n:
        return arr
    padded = np.zeros((b,) + tuple(arr.shape[1:]),
                      np.asarray(arr).dtype)
    padded[:n] = arr
    return padded


def to_device(frames, device: torch.device) -> torch.Tensor:
    """Host numpy (or a tensor) -> a contiguous f32 tensor on device."""
    if isinstance(frames, torch.Tensor):
        return frames.to(device=device, dtype=torch.float32).contiguous()
    arr = np.ascontiguousarray(frames, dtype=np.float32)
    return torch.from_numpy(arr).to(device)


class Detector:
    """One detector architecture with its weights on one device."""

    def __init__(self, arch: str, net: Optional[DetectorNet] = None,
                 seed: int = 0, device: Device = "cuda"):
        self.arch = arch
        self.device = resolve_device(device)
        if net is None:
            net = init_detector(arch, seed)
        self.net = net.to(self.device).eval()
        # dispatch counter: one per detect_batch call (bench and
        # RunResult bookkeeping, as the reference's).  Kept a plain
        # per-instance int; each increment also folds into the registry.
        self.dispatches = 0
        from repro_torch.obs.metrics import REGISTRY
        self._m_dispatches = REGISTRY.counter("detector.dispatches")

    def detect_batch(self, frames, conf: float,
                     origins: Optional[Sequence] = None,
                     scales: Optional[Sequence] = None, max_dets: int = 64,
                     n_valid: Optional[int] = None) -> List[np.ndarray]:
        """frames: (B, H, W, 3) host array or device tensor -> list of
        (n, 5) world-unit detections.

        origins/scales: per-frame window placement (see
        decode_detections); default full frame.  n_valid: decode only the
        first n_valid rows (the rest are bucket padding)."""
        self.dispatches += 1
        self._m_dispatches.inc()
        with torch.inference_mode():
            scores_t, boxes_t = detect_scores(
                self.net, to_device(frames, self.device))
            scores = scores_t.cpu().numpy()
            n = frames.shape[0] if n_valid is None else n_valid
            hit = (scores[:n] > conf).any(axis=(1, 2))
            boxes = boxes_t.cpu().numpy() if hit.any() else None
        empty = np.zeros((0, 5), np.float32)
        out = []
        for b in range(n):
            if not hit[b]:
                out.append(empty)
                continue
            o = origins[b] if origins is not None else (0.0, 0.0)
            s = scales[b] if scales is not None else (1.0, 1.0)
            out.append(decode_detections(scores[b], boxes[b], conf,
                                         origin=o, scale=s,
                                         max_dets=max_dets))
        return out

    def detect_batch_bucketed(self, frames: np.ndarray, conf: float,
                              origins: Optional[Sequence] = None,
                              scales: Optional[Sequence] = None,
                              max_dets: int = 64) -> List[np.ndarray]:
        """detect_batch with the batch dim zero-padded to a power-of-two
        bucket (the reference's padding); padding rows are never
        decoded."""
        n = int(frames.shape[0])
        if n == 0:
            return []
        return self.detect_batch(pad_to_bucket(frames), conf,
                                 origins=origins, scales=scales,
                                 max_dets=max_dets, n_valid=n)
