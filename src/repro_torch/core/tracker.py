"""Recurrent reduced-rate tracker (§3.4), inference only.

The port of the JAX package's ``repro.core.tracker``:

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

Steps 2 and 3 also run on the device, through the ``track_step`` kernel
(``kernels/track_step``), with the same tracks bit for bit:
``RecurrentTracker(assign="device")`` launches it once per frame and
replays its outputs onto the host track objects; ``DeviceTracker`` keeps
the track state in slot buffers on the device for a whole chunk (one
launch per frame, the slot bookkeeping in PyTorch ops on the device) and
replays the chunk's events on the host once.  Both run on the device of
the crop CNN's weights.  With a cross-stream ``executor.TrackBroker``
handle attached (``_track_handle``), a device step is submitted to the
broker, which launches ``track_step`` once for the steps of K streams.

Parameters are a dict: ``"crop_cnn"`` -> ``CropCNN`` and the reference's
``"det_proj"``, ``"gru"`` and ``"match"`` dicts of numpy arrays.

Training (gap-randomized, §3.4) holds every parameter in one
``TrackerNet`` on one device and fits the reference's listwise BCE
(``_train_loss``: embed each slot, a masked GRU over the prefix slots,
the match MLP on each candidate) with ``train_models._fit``; the example
sampler is the reference's numpy, draw for draw.  ``train_tracker``
returns the dict form above, so the inference path takes trained
weights unchanged.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import Device, resolve_device
from repro_torch.configs.multiscope import TrackerConfig
from repro_torch.core import fastmath as fm
from repro_torch.core.detector import SameConv2d, next_bucket, to_device
from repro_torch.core.hungarian import BIG, hungarian_device_np
from repro_torch.core.train_models import _fit
from repro_torch.kernels.track_step import (LOG1P_TABLE_2D, pack_params,
                                            track_step)
from repro_torch.kernels.track_step.ops import NOT_CONVERGED

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
        # repro-lint: disable=bit-contract -- crop CNN runs upstream of the host/device split: one impl, both paths consume its output
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
    """Online inference: incremental GRU states + JV matching.  The crop
    CNN runs on the device, once per chunk under the executor
    (``embed_dets_chunk``) or once per frame when ``step`` is given no
    embeddings.  With ``assign="host"`` the rest of a step runs on the
    host in numpy; with ``assign="device"`` it is one ``track_step``
    launch per frame (detection features, match logits, cost, JV
    assignment and both GRU batches), whose outputs the host replays onto
    its track objects."""

    def __init__(self, cfg: TrackerConfig, params, max_misses: int = 2,
                 min_hits: int = 2, assign: str = "host"):
        if assign not in ("host", "device"):
            raise ValueError(f"assign must be 'host' or 'device', got "
                             f"{assign!r}")
        self.cfg = cfg
        self.params = params
        self.np_params = _host_params(params)
        self.max_misses = max_misses
        self.min_hits = min_hits
        self.assign = assign
        self.device = next(params["crop_cnn"].parameters()).device
        self.active: List[_ActiveTrack] = []
        self.finished: List[_ActiveTrack] = []
        self._next_id = 0
        self._last_frame: Optional[int] = None
        # device-step operands, moved to the device once (lazily: a host
        # tracker never needs them)
        self._packed = None
        # the threshold on the host: a broker groups steps by its value
        self._thr_host = np.full((1, 1), cfg.match_threshold, np.float32)
        # cross-stream TrackBroker handle, attached by the executor
        self._track_handle = None
        # device dispatches issued by this tracker (per-frame crop CNN,
        # track-step launches; one per chunk for DeviceTracker's scan)
        self.dispatches = 0

    def _device_operands(self):
        """(packed heads, log1p table (T, 1), threshold (1, 1)) on the
        tracker's device."""
        if self._packed is None:
            dev = self.device
            self._packed = (
                pack_params(self.np_params, dev),
                torch.from_numpy(LOG1P_TABLE_2D).to(dev),
                torch.full((1, 1), self.cfg.match_threshold,
                           dtype=torch.float32, device=dev))
        return self._packed

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
        use_dev = self.assign == "device" and n > 0
        h_upd = h_new = None
        if use_dev:
            pairs, h_upd, h_new = self._device_step(
                frame_idx, te_scalar, x, boxes)
        else:
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
            if use_dev:
                t.h = np.asarray(h_upd[ti], np.float32)
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
        # h = 0) reuse the crop embeddings — no second CNN pass.  On the
        # device path both GRU batches already ran in the kernel; the
        # loop only scatters the returned rows.
        new_idx = [di for di in range(n) if di not in matched_d]
        n_upd = len(upd_tracks)
        m = n_upd + len(new_idx)
        if use_dev:
            for di in new_idx:
                t = _ActiveTrack(self._next_id,
                                 np.asarray(h_new[di], np.float32),
                                 [frame_idx],
                                 [dets[di, :4].astype(np.float32)])
                self.active.append(t)
                self._next_id += 1
        elif m > 0:
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

    def _device_step(self, frame_idx: int, te_scalar: float,
                     x: np.ndarray, boxes: np.ndarray):
        """One tracker step as one ``track_step`` launch: the active set
        (live tracks as the row prefix, in active-list order) and the
        frame's detections (the column prefix) packed into Q slots.
        Returns (pairs, h_upd rows per track row, h_new rows per
        detection column) on the host.  The kernel restricts its JV
        solve to the ``assoc_side`` square the host solves, so any Q
        gives the host tracker's result, and so does a ``TrackBroker``
        launch that pads the step into a batch of streams."""
        T, n = len(self.active), len(boxes)
        e, H = self.cfg.embed_dim, self.cfg.rnn_dim
        Q = next_bucket(max(T, n, 1), min_bucket=8)
        h_r = np.zeros((Q, H), np.float32)
        tbox_r = np.zeros((Q, 4), np.float32)
        alive_r = np.zeros((Q,), np.float32)
        te_gap_r = np.zeros((Q,), np.float32)
        for ti, t in enumerate(self.active):
            h_r[ti] = t.h
            tbox_r[ti] = t.boxes[-1]
            alive_r[ti] = 1.0
            te_gap_r[ti] = frame_idx - t.frames[-1]
        te_match = np.full((Q,), te_scalar, np.float32)
        x_p = np.zeros((Q, e), np.float32)
        x_p[:n] = x
        dbox = np.zeros((Q, 4), np.float32)
        dbox[:n] = boxes
        dvalid = np.zeros((Q,), np.float32)
        dvalid[:n] = 1.0
        params, table, thr = self._device_operands()
        self.dispatches += 1
        ops = [torch.from_numpy(a).to(self.device)
               for a in (h_r, tbox_r, alive_r, te_gap_r, te_match, x_p,
                         dbox, dvalid)]
        if self._track_handle is not None:
            matched, h_upd, h_new = self._track_handle.step(
                *ops, self._thr_host, params, table,
                params_key=id(self.params))
        else:
            matched, h_upd, h_new = (
                o[0].cpu().numpy() for o in
                track_step(*(o[None] for o in ops), thr, params, table))
        pairs = [(ti, int(matched[ti])) for ti in range(T)
                 if matched[ti] >= 0]
        return pairs, h_upd, h_new

    def step_chunk(self, frame_ids: Sequence[int],
                   dets_per_frame: Sequence[np.ndarray],
                   frames: Sequence[np.ndarray],
                   embeds: Optional[Sequence[np.ndarray]] = None
                   ) -> None:
        """Feed one chunk in frame order (``DeviceTracker`` overrides
        this with its chunk scan)."""
        for k, f in enumerate(frame_ids):
            self.step(int(f), dets_per_frame[k], frames[k],
                      det_embeds=None if embeds is None else embeds[k])

    def result(self) -> List[np.ndarray]:
        tracks = self.finished + self.active
        return [t.as_array() for t in tracks
                if len(t.frames) >= self.min_hits]


# sorting key for dead slots: past any live track's recency rank
_BIGK = 1 << 30


def _set_drop(buf: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """``buf.at[idx].set(val, mode="drop")``: rows of ``idx`` equal to
    len(buf) are dropped.  The write goes to a buffer one row longer, so
    the dropped index is never out of range on the device."""
    ext = torch.cat([buf, buf[:1]])
    ext[idx] = val
    return ext[:buf.shape[0]]


def _device_chunk_scan(carry, fidx: Sequence[int], te_m: Sequence[float],
                       x: torch.Tensor, dbox: torch.Tensor,
                       dvalid: torch.Tensor, thr, params, table, *,
                       max_misses: int, max_tracks: int):
    """The whole chunk's tracker recurrence on the device: the JAX
    package's ``_device_chunk_scan`` with its ``lax.scan`` as a loop over
    the chunk's frames, one ``track_step`` launch per frame and the slot
    bookkeeping in PyTorch ops on the device.

    carry (slot space, Q slots, on the device): h (Q, H), tbox (Q, 4),
    alive (Q,) f32, last_f/misses/length/order (Q,) int32, next_key ()
    int32 (the next active-list rank to issue).  Per frame b: its index
    fidx[b] and the gap te_m[b] since the previously processed frame (0
    for the first frame of a stream); x (B, Q, e), dbox (B, Q, 4) and
    dvalid (B, Q) hold each frame's detections as a column prefix.

    ``order`` is the host tracker's active-LIST position (matched tracks
    keep their rank, new tracks append, a max_tracks overflow re-sorts by
    track length); each step gathers slots into rank order, so the kernel
    sees exactly the rows the per-frame path would build.

    The JV's error flag stays on the device for the whole chunk: every
    frame's launch sets the one flag, which is read once after the loop,
    so no frame waits on a sync; a solve that hit its cap raises here,
    before any event leaves the device.

    Returns the per-frame events, stacked on the device: matched
    detection column per slot (or -1), assigned slot per detection
    column (Q for none), and the post-step h per slot."""
    h, tbox, alive, last_f, misses, length, order, next_key = carry
    Q = h.shape[0]
    dev = h.device
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    slot = torch.arange(Q, dtype=torch.int32, device=dev)
    dead_key = _BIGK + slot
    m_ev, new_ev, h_ev = [], [], []
    for b, f in enumerate(fidx):
        xk, dbk, dvk = x[b], dbox[b], dvalid[b]
        live = alive > 0
        # ranks first, dead slots after (keys are unique: stable or not,
        # the sort is the same; stable as jnp.argsort is)
        perm = torch.argsort(torch.where(live, order, dead_key), stable=True)
        alive_r = alive[perm]
        te_gap_r = torch.where(alive_r > 0,
                               (f - last_f[perm]).to(torch.float32), 0.0)
        te_match = torch.full((1, Q), float(te_m[b]), device=dev)
        matched_r, h_upd_r, h_new = (o[0] for o in track_step(
            h[perm][None], tbox[perm][None], alive_r[None],
            te_gap_r[None], te_match, xk[None], dbk[None], dvk[None], thr,
            params, table, err=err))
        # back to slot space; apply matched-track updates
        m_slot = torch.empty_like(matched_r)
        m_slot[perm] = matched_r
        is_m = m_slot >= 0
        mcol = m_slot.clamp(0, Q - 1).long()
        h_upd = torch.zeros_like(h)
        h_upd[perm] = h_upd_r
        h = torch.where(is_m[:, None], h_upd, h)
        tbox = torch.where(is_m[:, None], dbk[mcol], tbox)
        last_f = torch.where(is_m, f, last_f)
        length = torch.where(is_m, length + 1, length)
        misses = torch.where(is_m, 0, misses)
        # age out unmatched live tracks
        aged = live & ~is_m
        misses = torch.where(aged, misses + 1, misses)
        alive = torch.where(aged & (misses > max_misses), 0.0, alive)
        # unmatched detections start new tracks in ascending free slots,
        # ranks appended after every existing track (host list append)
        det_hit = _set_drop(torch.zeros(Q, dtype=torch.int32, device=dev),
                            torch.where(matched_r >= 0, matched_r, Q).long(),
                            1)
        new_mask = (dvk > 0) & (det_hit == 0)
        free = alive <= 0
        free_rank = torch.cumsum(free.to(torch.int32), 0,
                                 dtype=torch.int32) - 1
        slot_for_rank = _set_drop(torch.full_like(slot, Q),
                                  torch.where(free, free_rank, Q).long(),
                                  slot)
        new_rank = torch.cumsum(new_mask.to(torch.int32), 0,
                                dtype=torch.int32) - 1
        tgt = torch.where(new_mask,
                          slot_for_rank[new_rank.clamp(0, Q - 1).long()], Q)
        ti = tgt.long()
        alive = _set_drop(alive, ti, 1.0)
        h = _set_drop(h, ti, h_new)
        tbox = _set_drop(tbox, ti, dbk)
        last_f = _set_drop(last_f, ti, f)
        misses = _set_drop(misses, ti, 0)
        length = _set_drop(length, ti, 1)
        order = _set_drop(order, ti, next_key + new_rank)
        next_key = next_key + new_mask.sum(dtype=torch.int32)
        # capacity overflow: keep the max_tracks longest tracks (stable on
        # list order, the host's in-place sort) and renumber ranks;
        # jnp.lexsort((a, b)) is two stable sorts, the secondary key first
        over = (alive > 0).sum() > max_tracks
        a_live = alive > 0
        by_rank = torch.argsort(torch.where(a_live, order, dead_key),
                                stable=True)
        by_len = torch.where(a_live, -length, _BIGK)[by_rank]
        perm2 = by_rank[torch.argsort(by_len, stable=True)]
        pos = torch.empty_like(slot)
        pos[perm2] = slot
        alive = torch.where(over & a_live & (pos >= max_tracks), 0.0, alive)
        order = torch.where(over, pos, order)
        next_key = torch.where(over, max_tracks, next_key)
        m_ev.append(m_slot)
        new_ev.append(tgt)
        h_ev.append(h)
    if int(err.item()):
        raise RuntimeError(NOT_CONVERGED)
    return torch.stack(m_ev), torch.stack(new_ev), torch.stack(h_ev)


class DeviceTracker(RecurrentTracker):
    """Chunk-scan tracker: the track state of a whole chunk stays in
    padded slot buffers on the device, with one ``track_step`` launch per
    frame (``_device_chunk_scan``), and the host materialises track
    objects once per chunk by replaying the scan's (matched, new-slot, h)
    events.  Same tracks, bit for bit, as ``RecurrentTracker``.

    ``dispatches`` counts a chunk as one dispatch, as the JAX package's
    one scan dispatch, although the chunk launches ``track_step`` once a
    frame: a readout of launches reads ``track_step.launches``.  With a
    cross-stream ``TrackBroker`` handle attached the chunk takes the
    per-frame path instead (the broker batches steps ACROSS streams,
    which a per-stream chunk loop cannot)."""

    def __init__(self, cfg: TrackerConfig, params, max_misses: int = 2,
                 min_hits: int = 2):
        super().__init__(cfg, params, max_misses=max_misses,
                         min_hits=min_hits, assign="device")

    def step_chunk(self, frame_ids: Sequence[int],
                   dets_per_frame: Sequence[np.ndarray],
                   frames: Sequence[np.ndarray],
                   embeds: Optional[Sequence[np.ndarray]] = None
                   ) -> None:
        B = len(frame_ids)
        if B == 0:
            return
        if self._track_handle is not None:
            super().step_chunk(frame_ids, dets_per_frame, frames, embeds)
            return
        cfg = self.cfg
        if embeds is None:
            self.dispatches += 1
            embeds = embed_dets_chunk(self.params, cfg, frames,
                                      dets_per_frame)
        T = len(self.active)
        D = max((len(d) for d in dets_per_frame), default=0)
        Q = next_bucket(max(T, cfg.max_tracks) + D, min_bucket=8)
        H, e = cfg.rnn_dim, cfg.embed_dim
        h0 = np.zeros((Q, H), np.float32)
        tbox0 = np.zeros((Q, 4), np.float32)
        alive0 = np.zeros((Q,), np.float32)
        ints0 = np.zeros((4, Q), np.int32)     # last_f, misses, length, order
        for i, t in enumerate(self.active):
            h0[i] = t.h
            tbox0[i] = t.boxes[-1]
            alive0[i] = 1.0
            ints0[:, i] = (t.frames[-1], t.misses, len(t.frames), i)
        fidx = [int(f) for f in frame_ids]
        te_m, prev = [], self._last_frame
        for f in fidx:
            te_m.append(0.0 if prev is None else float(f - prev))
            prev = f
        x = np.zeros((B, Q, e), np.float32)
        dbox = np.zeros((B, Q, 4), np.float32)
        dvalid = np.zeros((B, Q), np.float32)
        for k in range(B):
            n = len(dets_per_frame[k])
            if n:
                x[k, :n] = embeds[k]
                dbox[k, :n] = np.asarray(
                    dets_per_frame[k], np.float32)[:, :4]
                dvalid[k, :n] = 1.0
        dev = self.device
        ints = torch.from_numpy(ints0).to(dev)
        carry = (torch.from_numpy(h0).to(dev),
                 torch.from_numpy(tbox0).to(dev),
                 torch.from_numpy(alive0).to(dev), ints[0], ints[1],
                 ints[2], ints[3],
                 torch.tensor(T, dtype=torch.int32, device=dev))
        params, table, thr = self._device_operands()
        self.dispatches += 1
        m_ev, new_ev, h_ev = (t.cpu().numpy() for t in _device_chunk_scan(
            carry, fidx, te_m, torch.from_numpy(x).to(dev),
            torch.from_numpy(dbox).to(dev), torch.from_numpy(dvalid).to(dev),
            thr, params, table, max_misses=self.max_misses,
            max_tracks=cfg.max_tracks))

        # replay the event stream onto host track objects; ``slots``
        # stays parallel to ``self.active``
        slots = list(range(T))
        for k in range(B):
            f = fidx[k]
            dets = dets_per_frame[k]
            ms, hs = m_ev[k], h_ev[k]
            keep_t: List[_ActiveTrack] = []
            keep_s: List[int] = []
            for t, s in zip(self.active, slots):
                di = int(ms[s])
                if di >= 0:
                    t.h = hs[s].copy()
                    t.frames.append(f)
                    t.boxes.append(dets[di, :4].astype(np.float32))
                    t.misses = 0
                    keep_t.append(t)
                    keep_s.append(s)
                else:
                    t.misses += 1
                    if t.misses > self.max_misses:
                        self.finished.append(t)
                    else:
                        keep_t.append(t)
                        keep_s.append(s)
            self.active, slots = keep_t, keep_s
            for di in range(len(dets)):
                s = int(new_ev[k][di])
                if s < Q:
                    t = _ActiveTrack(self._next_id, hs[s].copy(), [f],
                                     [dets[di, :4].astype(np.float32)])
                    self.active.append(t)
                    slots.append(s)
                    self._next_id += 1
            if len(self.active) > cfg.max_tracks:
                ranked = sorted(zip(self.active, slots),
                                key=lambda ts: -len(ts[0].frames))
                self.finished.extend(
                    t for t, _ in ranked[cfg.max_tracks:])
                self.active = [t for t, _ in ranked[:cfg.max_tracks]]
                slots = [s for _, s in ranked[:cfg.max_tracks]]
            self._last_frame = f


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


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

HEAD_SCOPES = ("det_proj", "gru", "match")


class TrackerNet(nn.Module):
    """Every tracker parameter in one module on one device: the crop CNN
    (a copy of ``params["crop_cnn"]``) and the three heads as
    ``nn.ParameterDict``s under the reference's names."""

    def __init__(self, params):
        super().__init__()
        self.crop_cnn = copy.deepcopy(params["crop_cnn"])
        dev = next(self.crop_cnn.parameters()).device
        for scope in HEAD_SCOPES:
            setattr(self, scope, nn.ParameterDict({
                k: nn.Parameter(torch.from_numpy(
                    np.array(v, dtype=np.float32)).to(dev))
                for k, v in params[scope].items()}))

    def to_params(self) -> Dict[str, object]:
        """-> the tracker-param dict: a ``CropCNN`` copy in eval mode on
        this module's device, the heads as numpy."""
        out: Dict[str, object] = {
            "crop_cnn": copy.deepcopy(self.crop_cnn).eval()}
        for scope in HEAD_SCOPES:
            out[scope] = {k: v.detach().cpu().numpy().copy()
                          for k, v in getattr(self, scope).items()}
        return out


def embed_dets(net: TrackerNet, crops: torch.Tensor, boxes: torch.Tensor,
               t_elapsed: torch.Tensor) -> torch.Tensor:
    """crops: (N, C, C, 3); boxes: (N, 4); t_elapsed: (N,) -> (N, e)."""
    x = net.crop_cnn(crops)
    te = t_elapsed.to(torch.float32)
    extra = torch.stack([boxes[:, 0], boxes[:, 1], boxes[:, 2],
                         boxes[:, 3], te / 8.0, torch.log1p(te)], dim=1)
    d = torch.cat([x, extra], dim=1)
    dp = net.det_proj
    # repro-lint: disable=bit-contract -- train-only head; inference twins are _det_feats_np (host) / kernels.track_step (device)
    return torch.tanh(d @ dp["w"] + dp["b"])


def gru_step(net: TrackerNet, h: torch.Tensor, feat: torch.Tensor
             ) -> torch.Tensor:
    """h: (..., H); feat: (..., e) -> new h."""
    g = net.gru
    hf = torch.cat([feat, h], dim=-1)
    # repro-lint: disable=bit-contract -- train-only head; inference twins are _gru_np (host) / kernels.track_step (device)
    z = torch.sigmoid(hf @ g["wz"] + g["bz"])
    # repro-lint: disable=bit-contract -- train-only head; inference twins are _gru_np (host) / kernels.track_step (device)
    r = torch.sigmoid(hf @ g["wr"] + g["br"])
    hf2 = torch.cat([feat, r * h], dim=-1)
    # repro-lint: disable=bit-contract -- train-only head; inference twins are _gru_np (host) / kernels.track_step (device)
    cand = torch.tanh(hf2 @ g["wh"] + g["bh"])
    return (1 - z) * h + z * cand


def _rel_features(track_boxes: torch.Tensor, det_boxes: torch.Tensor,
                  te: torch.Tensor) -> torch.Tensor:
    """track_boxes: (T, 4); det_boxes: (N, 4); te: (N,) -> (T, N, 6)."""
    d = det_boxes[None, :, :] - track_boxes[:, None, :]      # (T, N, 4)
    tesafe = torch.clamp(te, min=1.0)[None, :, None]
    return torch.cat([d[..., :2], d[..., :2] / tesafe, d[..., 2:]],
                     dim=-1)


def match_logits(net: TrackerNet, track_h: torch.Tensor,
                 track_boxes: torch.Tensor, det_feats: torch.Tensor,
                 det_boxes: torch.Tensor, te: torch.Tensor) -> torch.Tensor:
    """track_h: (T, H); track_boxes: (T, 4) last box per track;
    det_feats: (N, e); det_boxes: (N, 4); te: (N,) -> (T, N) logits."""
    m = net.match
    T, N = track_h.shape[0], det_feats.shape[0]
    rel = _rel_features(track_boxes, det_boxes, te)
    pair = torch.cat([
        track_h[:, None].expand(T, N, track_h.shape[1]),
        det_feats[None].expand(T, N, det_feats.shape[1]),
        rel,
    ], dim=-1)
    # repro-lint: disable=bit-contract -- train-only head; inference twins are _match_np (host) / kernels.track_step (device)
    hid = torch.tanh(pair @ m["w0"] + m["b0"])
    # repro-lint: disable=bit-contract -- train-only head; inference twins are _match_np (host) / kernels.track_step (device)
    return (hid @ m["w1"] + m["b1"])[..., 0]


def _train_loss(net: TrackerNet, crops, boxes, te, prefix_mask, cand_mask,
                labels, last_box) -> torch.Tensor:
    """One batch of listwise examples.

    crops/boxes/te: (B, L + K, C, C, 3)/(B, L+K, 4)/(B, L+K) — first L
    slots are the prefix detections (masked by prefix_mask (B, L)), the
    remaining K are candidates (masked by cand_mask (B, K));
    labels: (B, K) {0,1} (the true continuation has 1).  The
    reference's prefix scan is a loop of L masked GRU steps.
    """
    B, LK = boxes.shape[:2]
    feats = embed_dets(net, crops.reshape(B * LK, *crops.shape[2:]),
                       boxes.reshape(B * LK, 4), te.reshape(B * LK))
    feats = feats.reshape(B, LK, -1)
    L = prefix_mask.shape[1]
    K = cand_mask.shape[1]
    pre, cand = feats[:, :L], feats[:, L:]
    H = net.gru["bz"].shape[0]
    h = torch.zeros((B, H), dtype=torch.float32, device=feats.device)
    for slot in range(L):
        h2 = gru_step(net, h, pre[:, slot])
        h = torch.where(prefix_mask[:, slot, None] > 0, h2, h)
    # score each candidate against its own example's track feature,
    # with relative-motion features vs the prefix's LAST box
    m = net.match
    cboxes = boxes[:, L:]                               # (B, K, 4)
    cte = torch.clamp(te[:, L:], min=1.0)[..., None]
    d = cboxes - last_box[:, None, :]
    rel = torch.cat([d[..., :2], d[..., :2] / cte, d[..., 2:]], dim=-1)
    pair = torch.cat([h[:, None].expand(B, K, H), cand, rel], dim=-1)
    # repro-lint: disable=bit-contract -- training loss; never on the serving path
    hid = torch.tanh(pair @ m["w0"] + m["b0"])
    # repro-lint: disable=bit-contract -- training loss; never on the serving path
    logits = (hid @ m["w1"] + m["b1"])[..., 0]          # (B, K)
    y = labels.to(torch.float32)
    bce = torch.clamp(logits, min=0) - logits * y \
        + torch.log1p(torch.exp(-torch.abs(logits)))
    return (bce * cand_mask).sum() / torch.clamp(cand_mask.sum(), min=1.0)


def extract_crop(frame: np.ndarray, box: np.ndarray, crop: int
                 ) -> np.ndarray:
    """Nearest-neighbor resample of the box region to (crop, crop, 3)."""
    return extract_crops(frame, np.asarray(box)[None], crop)[0]


@dataclass
class TrackExample:
    """One θ_best track on one clip, with crops pre-extracted."""
    frames: np.ndarray           # (n,)
    boxes: np.ndarray            # (n, 4)
    crops: np.ndarray            # (n, C, C, 3)
    clip_key: int = 0            # same-clip grouping for hard negatives


def build_examples(tracks: Sequence[np.ndarray],
                   frame_getter, crop: int,
                   clip_key: int = 0) -> List[TrackExample]:
    """tracks: (n, 6) [frame, cx, cy, w, h, id] arrays; frame_getter(f)
    -> rendered frame."""
    out = []
    for tr in tracks:
        if len(tr) < 3:
            continue
        crops = np.stack([
            extract_crop(frame_getter(int(f)), b, crop)
            for f, b in zip(tr[:, 0], tr[:, 1:5])])
        out.append(TrackExample(tr[:, 0].astype(np.int64), tr[:, 1:5],
                                crops, clip_key))
    return out


def tracker_batches(cfg: TrackerConfig, examples: List[TrackExample],
                    steps: int, batch: int, rng: np.random.Generator,
                    max_prefix: int = 6, n_cand: int = 6
                    ) -> Iterator[Tuple[np.ndarray, ...]]:
    """The reference's example sampler, draw for draw: ``steps`` batches
    of (crops, boxes, te, prefix_mask, cand_mask, labels, last_box)."""
    C = cfg.crop
    gaps = cfg.gaps

    def sample_example():
        ex = examples[rng.integers(len(examples))]
        g = int(gaps[rng.integers(len(gaps))])
        # subsample at gap g: next det >= g frames after the previous
        idx = [0]
        for i in range(1, len(ex.frames)):
            if ex.frames[i] - ex.frames[idx[-1]] >= g:
                idx.append(i)
        if len(idx) < 2:
            return None
        split = int(rng.integers(1, len(idx)))
        prefix, pos = idx[:split], idx[split]
        prefix = prefix[-max_prefix:]
        pos_frame = int(ex.frames[pos])
        # distractors: same-frame detections of other tracks; SAME-CLIP
        # tracks preferred (hard negatives) with random-clip fallback
        negs = []
        same = [o for o in examples
                if o is not ex and o.clip_key == ex.clip_key]
        pools = (same, examples)
        for pool in pools:
            for _ in range(3 * (n_cand - 1)):
                if len(negs) >= n_cand - 1 or not pool:
                    break
                other = pool[rng.integers(len(pool))]
                if other is ex:
                    continue
                j = np.searchsorted(other.frames, pos_frame)
                j = min(j, len(other.frames) - 1)
                # same-clip negatives must actually overlap in time
                if pool is same and abs(int(other.frames[j])
                                        - pos_frame) > 8:
                    continue
                negs.append((other, j))
            if len(negs) >= n_cand - 1:
                break
        return ex, prefix, pos, negs

    L, K = max_prefix, n_cand
    for _ in range(steps):
        crops = np.zeros((batch, L + K, C, C, 3), np.float32)
        boxes = np.zeros((batch, L + K, 4), np.float32)
        te = np.zeros((batch, L + K), np.float32)
        pmask = np.zeros((batch, L), np.float32)
        cmask = np.zeros((batch, K), np.float32)
        labels = np.zeros((batch, K), np.float32)
        last_box = np.zeros((batch, 4), np.float32)
        b = 0
        while b < batch:
            s = sample_example()
            if s is None:
                continue
            ex, prefix, pos, negs = s
            off = L - len(prefix)
            prev_f = None
            for slot, i in enumerate(prefix):
                crops[b, off + slot] = ex.crops[i]
                boxes[b, off + slot] = ex.boxes[i]
                te[b, off + slot] = 0 if prev_f is None else \
                    ex.frames[i] - prev_f
                pmask[b, off + slot] = 1
                prev_f = ex.frames[i]
            last_box[b] = ex.boxes[prefix[-1]]
            t_gap = float(ex.frames[pos] - ex.frames[prefix[-1]])
            crops[b, L] = ex.crops[pos]
            boxes[b, L] = ex.boxes[pos]
            te[b, L] = t_gap
            cmask[b, 0] = 1
            labels[b, 0] = 1
            for slot, (other, j) in enumerate(negs):
                crops[b, L + 1 + slot] = other.crops[j]
                boxes[b, L + 1 + slot] = other.boxes[j]
                te[b, L + 1 + slot] = t_gap
                cmask[b, 1 + slot] = 1
            b += 1
        yield crops, boxes, te, pmask, cmask, labels, last_box


def train_tracker(cfg: TrackerConfig, examples: List[TrackExample],
                  steps: int = 1500, batch: int = 32, seed: int = 0,
                  lr: float = 3e-3, max_prefix: int = 6, n_cand: int = 6,
                  device: Device = "cuda"):
    """Fit the tracker on θ_best examples from ``init_tracker(cfg,
    seed)``; -> (tracker-param dict, losses)."""
    dev = resolve_device(device)
    params = init_tracker(cfg, seed, dev)
    if not examples:
        return params, []
    net = TrackerNet(params).to(dev)
    rng = np.random.default_rng(seed)
    net, losses = _fit(_train_loss, net,
                       tracker_batches(cfg, examples, steps, batch, rng,
                                       max_prefix, n_cand), lr=lr)
    return net.to_params(), losses
