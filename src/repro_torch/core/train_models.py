"""Offline model training for the pipeline: detector pre-training, and
the generic fit that proxy, tracker and BlazeIt training share.

The port of the JAX package's ``repro.core.train_models``.  The paper
assumes a PRE-TRAINED detector; here the stand-in detector is trained
once per dataset on synthetic ground truth, outside the benchmarked
runtime.  Proxy and tracker training follow the paper: labels come from
the θ_best configuration's outputs, never from ground truth.

Training is plain autograd on the module's device (cuDNN and cuBLAS on
the card, with the package's float32 settings: TF32 off, deterministic
cuDNN), stepped by the port's own ``optim.adamw``.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import Device, resolve_device
from repro_torch.core import detector as det_mod
from repro_torch.data.video_synth import Clip
from repro_torch.optim import adamw


def _on(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def _fit(loss_fn: Callable[..., torch.Tensor], module: nn.Module,
         batches: Iterable[Tuple], lr: float = 3e-3,
         log: Optional[Callable[[str], None]] = None,
         timing: Optional[Dict[str, float]] = None
         ) -> Tuple[nn.Module, List[float]]:
    """Generic Adam fit of ``module`` in place: each batch is a tuple of
    arrays (numpy or tensors, moved to the module's device) and
    ``loss_fn(module, *batch)`` its scalar loss.  -> (module, losses).

    ``timing``, if given, gains ``batch_s`` (seconds spent drawing
    batches: host rendering and sampling), ``step_s`` (forward, backward
    and update, closed by reading the loss back, which waits for the
    device) and ``steps``."""
    dev = next(module.parameters()).device
    opt = adamw(module.parameters(), lr=lr, weight_decay=0.0)
    module.train()
    losses: List[float] = []
    t_batch = t_step = 0.0
    it = iter(batches)
    while True:
        t0 = time.perf_counter()
        try:
            args = next(it)
        except StopIteration:
            break
        t1 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(module, *(_on(a, dev) for a in args))
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        t_batch += t1 - t0
        t_step += time.perf_counter() - t1
        if log and len(losses) % 50 == 0:
            log(f"  step {len(losses)} loss {np.mean(losses[-50:]):.4f}")
    module.eval()
    if timing is not None:
        timing["batch_s"] = timing.get("batch_s", 0.0) + t_batch
        timing["step_s"] = timing.get("step_s", 0.0) + t_step
        timing["steps"] = timing.get("steps", 0) + len(losses)
    return module, losses


# ---------------------------------------------------------------------------
# Detector
# ---------------------------------------------------------------------------

def detector_batches(clips: Sequence[Clip],
                     resolutions: Sequence[Tuple[int, int]], steps: int,
                     batch: int, rng: np.random.Generator):
    """The reference's detector batches, draw for draw: resolutions in
    turn, frames drawn uniformly from the clips; -> (frames, obj, box).
    Frames come through the pipeline's bounded render cache (the same
    pixels as ``clip.render``): a run draws each of its few hundred
    distinct frames many times, and rendering paces the card."""
    from repro_torch.core.pipeline import render_frame
    S = det_mod.STRIDE
    for step in range(steps):
        W, H = resolutions[step % len(resolutions)]
        hc, wc = H // S, W // S
        frames, boxes = [], []
        for _ in range(batch):
            clip = clips[rng.integers(len(clips))]
            f = int(rng.integers(clip.n_frames))
            frames.append(render_frame(clip, f, W, H)[0])
            boxes.append(clip.boxes_at(f))
        obj, box = det_mod.make_targets(boxes, hc, wc)
        yield np.stack(frames), obj, box


def train_detector(arch: str, clips: Sequence[Clip],
                   resolutions: Sequence[Tuple[int, int]],
                   steps: int = 240, batch: int = 8, seed: int = 0,
                   lr: float = 3e-3, device: Device = "cuda",
                   timing: Optional[Dict[str, float]] = None
                   ) -> Tuple[det_mod.Detector, List[float]]:
    """Multi-resolution detector pre-training on synthetic GT boxes, from
    ``init_detector(arch, seed)``; ``timing`` as in ``_fit``."""
    dev = resolve_device(device)
    net = det_mod.init_detector(arch, seed).to(dev)
    rng = np.random.default_rng(seed)
    net, losses = _fit(det_mod.detector_loss, net,
                       detector_batches(clips, resolutions, steps, batch,
                                        rng), lr=lr, timing=timing)
    return det_mod.Detector(arch, net, device=dev), losses


def detector_f1(detector: det_mod.Detector, clips: Sequence[Clip],
                res: Tuple[int, int], conf: float = 0.4,
                n_frames: int = 40) -> float:
    """Quick detection quality check against GT (IoU>=0.3 matching)."""
    tp = fp = fn = 0
    rng = np.random.default_rng(1)
    for _ in range(n_frames):
        clip = clips[rng.integers(len(clips))]
        f = int(rng.integers(clip.n_frames))
        frame = clip.render(f, res[0], res[1])
        dets = detector.detect_batch(frame[None], conf)[0]
        gt = clip.boxes_at(f)
        iou = det_mod.iou_matrix(dets[:, :4], gt[:, :4])
        matched_gt = set()
        for i in np.argsort(-dets[:, 4] if len(dets) else []):
            j = int(np.argmax(iou[i])) if iou.shape[1] else -1
            if j >= 0 and iou[i, j] >= 0.3 and j not in matched_gt:
                matched_gt.add(j)
                tp += 1
            else:
                fp += 1
        fn += len(gt) - len(matched_gt)
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    return 2 * prec * rec / max(prec + rec, 1e-9)
