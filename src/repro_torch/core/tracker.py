"""Recurrent reduced-rate tracker (§3.4), inference only.

The port of the JAX package's ``repro.core.tracker`` host path:

  1. detection-level features: the crop CNN (``CropCNN``, on the device)
     over each detection's image crop, batched per chunk by
     ``embed_dets_chunk``; the te-dependent projection runs on the host;
  2. track-level features: an incremental GRU per track;
  3. a matching MLP scoring (track, detection) pairs, then the f32 JV
     assignment ``hungarian_device_np`` with a threshold below which a
     detection starts a new track.

Every host head goes through ``core.fastmath``'s ``np_*`` functions, so
fed the same detections and crop embeddings the port's tracks are
bit-identical to the reference's host tracker.

Parameters are a dict: ``"crop_cnn"`` -> ``CropCNN`` and the reference's
``"det_proj"``, ``"gru"`` and ``"match"`` dicts of numpy arrays.
Training, the device tracker and ``assign="device"`` are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import Device, resolve_device
from repro_torch.configs.multiscope import TrackerConfig
from repro_torch.core import fastmath as fm
from repro_torch.core.detector import SameConv2d, next_bucket, to_device
from repro_torch.core.hungarian import BIG, hungarian_device_np

BOX_FEATS = 6      # cx, cy, w, h, t_elapsed/8, log1p(t_elapsed)
REL_FEATS = 6      # dcx, dcy, dcx/te, dcy/te, dw, dh (candidate vs track)


class CropCNN(nn.Module):
    """crops (N, C, C, 3) -> (N, e) crop embeddings: two stride-2 3x3
    convs with relu, the NHWC flatten of the reference, then
    tanh(x @ wd + bd)."""

    def __init__(self, cfg: TrackerConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        e, C = cfg.embed_dim, cfg.crop
        self.conv0 = SameConv2d(3, e // 2, 3, 2, generator)
        self.conv1 = SameConv2d(e // 2, e, 3, 2, generator)
        flat = (C // 4) * (C // 4) * e
        self.wd = nn.Parameter(torch.randn((flat, e), generator=generator)
                               / np.sqrt(flat))
        self.bd = nn.Parameter(torch.zeros((e,)))

    def forward(self, crops: torch.Tensor) -> torch.Tensor:
        x = crops.permute(0, 3, 1, 2)
        x = F.relu(self.conv0(x))
        x = F.relu(self.conv1(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return torch.tanh(x @ self.wd + self.bd)


def init_tracker(cfg: TrackerConfig, seed: int = 0,
                 device: Device = "cuda") -> Dict[str, object]:
    """Untrained tracker parameters drawn from a ``torch.Generator``
    with the reference's shapes and scales (not its numbers)."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    e, h = cfg.embed_dim, cfg.rnn_dim

    def normal(*shape):
        return (torch.randn(shape, generator=g) / np.sqrt(shape[-2])
                ).numpy()

    def zeros(n):
        return np.zeros((n,), np.float32)

    return {
        "crop_cnn": CropCNN(cfg, g).to(dev).eval(),
        "det_proj": {"w": normal(e + BOX_FEATS, e), "b": zeros(e)},
        "gru": {"wz": normal(e + h, h), "wr": normal(e + h, h),
                "wh": normal(e + h, h), "bz": zeros(h), "br": zeros(h),
                "bh": zeros(h)},
        "match": {"w0": normal(h + e + REL_FEATS, cfg.match_hidden),
                  "b0": zeros(cfg.match_hidden),
                  "w1": normal(cfg.match_hidden, 1), "b1": zeros(1)},
    }


def crop_embed(cnn: CropCNN, crops) -> np.ndarray:
    """crops: (N, C, C, 3) host array -> (N, e) host crop embeddings
    (the te-independent part of the detection embedding)."""
    dev = next(cnn.parameters()).device
    with torch.inference_mode():
        return cnn(to_device(crops, dev)).cpu().numpy()


def extract_crops(frame: np.ndarray, boxes: np.ndarray, crop: int
                  ) -> np.ndarray:
    """(n, >=4) boxes -> (n, crop, crop, 3) nearest-neighbour crops, one
    vectorized gather per frame."""
    H, W = frame.shape[:2]
    n = len(boxes)
    if n == 0:
        return np.zeros((0, crop, crop, 3), frame.dtype)
    b = np.asarray(boxes)[:, :4]
    x0, x1 = (b[:, 0] - b[:, 2] / 2) * W, (b[:, 0] + b[:, 2] / 2) * W
    y0, y1 = (b[:, 1] - b[:, 3] / 2) * H, (b[:, 1] + b[:, 3] / 2) * H
    xs = np.clip(np.linspace(x0, x1, crop, axis=1).astype(np.int64),
                 0, W - 1)
    ys = np.clip(np.linspace(y0, y1, crop, axis=1).astype(np.int64),
                 0, H - 1)
    return frame[ys[:, :, None], xs[:, None, :]]


@dataclass
class _ActiveTrack:
    track_id: int
    h: np.ndarray                # GRU state
    frames: List[int]
    boxes: List[np.ndarray]
    misses: int = 0

    def as_array(self) -> np.ndarray:
        out = np.zeros((len(self.frames), 6), np.float32)
        out[:, 0] = self.frames
        out[:, 1:5] = np.stack(self.boxes)
        out[:, 5] = self.track_id
        return out


def _pad(n: int, mult: int = 8) -> int:
    return max(mult, ((n + mult - 1) // mult) * mult)


def _host_params(params) -> Dict[str, np.ndarray]:
    """Flat f32 numpy copies of the small heads (det_proj, gru, match)."""
    return {f"{scope}/{k}": np.asarray(v, np.float32)
            for scope in ("det_proj", "gru", "match")
            for k, v in params[scope].items()}


class RecurrentTracker:
    """Online inference: incremental GRU states + JV matching, on the
    host.  The crop CNN runs on the device, once per chunk under the
    executor (``embed_dets_chunk``) or once per frame when ``step`` is
    given no embeddings."""

    def __init__(self, cfg: TrackerConfig, params, max_misses: int = 2,
                 min_hits: int = 2):
        self.cfg = cfg
        self.params = params
        self.np_params = _host_params(params)
        self.max_misses = max_misses
        self.min_hits = min_hits
        self.active: List[_ActiveTrack] = []
        self.finished: List[_ActiveTrack] = []
        self._next_id = 0
        self._last_frame: Optional[int] = None
        # device dispatches issued by this tracker (per-frame crop CNN)
        self.dispatches = 0

    def _det_feats_np(self, x: np.ndarray, boxes: np.ndarray,
                      te: np.ndarray) -> np.ndarray:
        """x: (N, e) crop embeddings -> (N, e) detection features."""
        p = self.np_params
        te = np.asarray(te, np.float32)
        extra = np.stack([boxes[:, 0], boxes[:, 1], boxes[:, 2],
                          boxes[:, 3], te * np.float32(0.125),
                          fm.np_log1p_int(te)],
                         axis=1).astype(np.float32)
        d = np.concatenate([x, extra], axis=1)
        return fm.np_tanh(fm.np_matmul(d, p["det_proj/w"])
                          + p["det_proj/b"])

    def _gru_np(self, h: np.ndarray, feat: np.ndarray) -> np.ndarray:
        p = self.np_params
        hf = np.concatenate([feat, h], axis=-1)
        z = fm.np_sigmoid(fm.np_matmul(hf, p["gru/wz"]) + p["gru/bz"])
        r = fm.np_sigmoid(fm.np_matmul(hf, p["gru/wr"]) + p["gru/br"])
        hf2 = np.concatenate([feat, r * h], axis=-1)
        cand = fm.np_tanh(fm.np_matmul(hf2, p["gru/wh"]) + p["gru/bh"])
        # single-multiply blend == h + z*(cand - h)
        return fm.np_fmadd(z, cand - h, h)

    def _match_np(self, hs: np.ndarray, tboxes: np.ndarray,
                  feats: np.ndarray, dboxes: np.ndarray,
                  te: np.ndarray) -> np.ndarray:
        p = self.np_params
        T, N = hs.shape[0], feats.shape[0]
        d = dboxes[None, :, :] - tboxes[:, None, :]
        tesafe = np.maximum(te, np.float32(1.0))[None, :, None]
        rel = np.concatenate([d[..., :2], d[..., :2] / tesafe,
                              d[..., 2:]], axis=-1)
        pair = np.concatenate([
            np.broadcast_to(hs[:, None], (T, N, hs.shape[1])),
            np.broadcast_to(feats[None], (T, N, feats.shape[1])),
            rel,
        ], axis=-1)
        hid = fm.np_tanh(fm.np_matmul(pair.reshape(T * N, -1),
                                      p["match/w0"]) + p["match/b0"])
        return (fm.np_matmul(hid, p["match/w1"])
                + p["match/b1"]).reshape(T, N)

    def step(self, frame_idx: int, dets: np.ndarray,
             frame: np.ndarray,
             det_embeds: Optional[np.ndarray] = None) -> None:
        """dets: (n, >=4) world-unit detections; frame: rendered pixels.

        det_embeds: optional precomputed (n, embed_dim) CROP embeddings
        (one device dispatch per CHUNK instead of per frame);
        te-dependent features are derived from them on the host."""
        cfg = self.cfg
        n = len(dets)
        te_scalar = 0.0 if self._last_frame is None else \
            float(frame_idx - self._last_frame)
        self._last_frame = frame_idx
        C = cfg.crop
        if det_embeds is not None:
            x = det_embeds
        elif n > 0:
            crops = extract_crops(frame, dets, C)
            crops_p = np.zeros((_pad(n), C, C, 3), np.float32)
            crops_p[:n] = crops
            self.dispatches += 1
            x = crop_embed(self.params["crop_cnn"], crops_p)[:n]
        else:
            x = np.zeros((0, cfg.embed_dim), np.float32)
        boxes = dets[:, :4].astype(np.float32) if n > 0 else \
            np.zeros((0, 4), np.float32)

        T = len(self.active)
        pairs = []
        if T > 0 and n > 0:
            feats = self._det_feats_np(
                x, boxes, np.full((n,), te_scalar, np.float32))
            hs = np.stack([t.h for t in self.active])
            tboxes = np.stack([t.boxes[-1] for t in self.active])
            te_arr = np.full((n,), max(te_scalar, 1.0), np.float32)
            logits = self._match_np(hs, tboxes, feats, boxes, te_arr)
            probs = fm.np_sigmoid(logits)
            cost = np.where(
                probs >= np.float32(cfg.match_threshold),
                np.float32(1.0) - probs, np.float32(BIG))
            pairs = hungarian_device_np(cost)

        matched_t, matched_d = set(), set()
        upd_feats, upd_tracks = [], []
        for ti, di in pairs:
            t = self.active[ti]
            # GRU update uses the WITHIN-TRACK gap
            gap = float(frame_idx - t.frames[-1])
            upd_tracks.append(t)
            upd_feats.append((di, gap))
            t.frames.append(frame_idx)
            t.boxes.append(dets[di, :4].astype(np.float32))
            t.misses = 0
            matched_t.add(ti)
            matched_d.add(di)
        # age out unmatched
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

        # GRU advance: matched-track updates (t_elapsed = within-track
        # gap, h = track state) and new-track starts (t_elapsed = 0,
        # h = 0) reuse the crop embeddings — no second CNN pass
        new_idx = [di for di in range(n) if di not in matched_d]
        n_upd = len(upd_tracks)
        m = n_upd + len(new_idx)
        if m > 0:
            rows = [di for di, _ in upd_feats] + new_idx
            te_u = np.asarray([g for _, g in upd_feats]
                              + [0.0] * len(new_idx), np.float32)
            hs_p = np.zeros((m, self.cfg.rnn_dim), np.float32)
            for k, t in enumerate(upd_tracks):
                hs_p[k] = t.h
            f_u = self._det_feats_np(x[rows], boxes[rows], te_u)
            h_out = self._gru_np(hs_p, f_u)
            for k, t in enumerate(upd_tracks):
                t.h = h_out[k]
            for k, di in enumerate(new_idx):
                t = _ActiveTrack(self._next_id, h_out[n_upd + k],
                                 [frame_idx],
                                 [dets[di, :4].astype(np.float32)])
                self.active.append(t)
                self._next_id += 1
        # cap active set (static max_tracks capacity)
        if len(self.active) > self.cfg.max_tracks:
            self.active.sort(key=lambda t: -len(t.frames))
            self.finished.extend(self.active[self.cfg.max_tracks:])
            self.active = self.active[:self.cfg.max_tracks]

    def step_chunk(self, frame_ids: Sequence[int],
                   dets_per_frame: Sequence[np.ndarray],
                   frames: Sequence[np.ndarray],
                   embeds: Optional[Sequence[np.ndarray]] = None
                   ) -> None:
        """Feed one chunk in frame order."""
        for k, f in enumerate(frame_ids):
            self.step(int(f), dets_per_frame[k], frames[k],
                      det_embeds=None if embeds is None else embeds[k])

    def result(self) -> List[np.ndarray]:
        tracks = self.finished + self.active
        return [t.as_array() for t in tracks
                if len(t.frames) >= self.min_hits]


def embed_dets_chunk(params, cfg: TrackerConfig,
                     frames: Sequence[np.ndarray],
                     dets_per_frame: Sequence[np.ndarray],
                     min_bucket: int = 8) -> List[np.ndarray]:
    """Run the crop CNN over every detection in a CHUNK in one
    bucket-padded dispatch (the executor's TRACK-stage batching), padded
    exactly as the reference pads it.  Returns per-frame (n_i,
    embed_dim) crop embeddings."""
    C = cfg.crop
    counts = [len(d) for d in dets_per_frame]
    total = sum(counts)
    if total == 0:
        return [np.zeros((0, cfg.embed_dim), np.float32)
                for _ in counts]
    crops = np.zeros((next_bucket(total, min_bucket=min_bucket), C, C, 3),
                     np.float32)
    k = 0
    for frame, dets in zip(frames, dets_per_frame):
        if len(dets):
            crops[k:k + len(dets)] = extract_crops(frame, dets, C)
            k += len(dets)
    x = crop_embed(params["crop_cnn"], crops)
    out = []
    k = 0
    for n in counts:
        out.append(x[k:k + n])
        k += n
    return out
