"""Card-against-CPU parity of the three trainers at full width.

Each trainer takes ``STEPS`` steps of ``train_models._fit`` from one
seeded init (the port's), copied to each device, on identical batches
built from one ``caldot1`` train clip:

  * ``detector``: ssd-deep at 960x544, batch 2, targets from the clip's
    ground-truth boxes (``detector_loss``);
  * ``proxy``: the full proxy (cell 32) at 416x256, batch 4, cell labels
    from the same boxes (``proxy_loss``);
  * ``tracker``: the full ``TrackerConfig``, batch 32, from the
    reference's example sampler over the clip's ground-truth tracks
    (``tracker._train_loss``).

``check_trainer`` runs the CPU once and the card twice and holds the
card to the CPU on what a training step computes:

  * every step's loss within ``LOSS_RTOL`` (relative);
  * the first step's gradients (identical parameters, identical batch)
    within ``GRAD_RTOL`` of max |CPU| of each tensor;
  * the final parameters' loss on one more batch, both evaluated on the
    CPU, within ``FRESH_RTOL``: the two fits are the same function.

The parameters themselves are reported, not held elementwise: AdamW
normalises each element's step, so an element whose gradient sits at the
devices' rounding noise (a ReLU net has many: a sum of cancelling
terms) steps by up to ``lr`` either way on the two devices, and the
next step's gradients move with it.  On the card (NVIDIA H100) the conv
nets' parameters drift apart by up to a few percent of a tensor's max
after 3 steps while their losses agree to 1e-6 (``PERF.md``).
``chip_smoke.py`` runs all three, ``tests/test_torch_cuda.py`` one.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.multiscope import MULTISCOPE_PIPELINE
from repro_torch.core import detector as det_mod
from repro_torch.core import tracker as trk_mod
from repro_torch.core.proxy import cells_from_detections, init_proxy, proxy_loss
from repro_torch.core.train_models import _fit
from repro_torch.data.video_synth import Clip, make_clip

TRAINERS = ("detector", "proxy", "tracker")
STEPS = 3
SEED = 0
LOSS_RTOL = 1e-4        # each step's loss, card against CPU
GRAD_RTOL = 1e-4        # first-step gradients, of max |CPU| per tensor
# the final parameters' loss on a fresh batch (the card read 9.6e-5 for
# the detector, 1.8e-5 for the proxy, 0 for the tracker: NVIDIA H100)
FRESH_RTOL = 1e-3
PARAM_RTOL = 1e-4       # the share of parameters within this is reported
BATCH = {"detector": 2, "proxy": 4, "tracker": 32}


def _gt_tracks(clip: Clip) -> List[np.ndarray]:
    return [np.column_stack([t.frames, t.boxes,
                             np.full(len(t.frames), t.track_id)]
                            ).astype(np.float32)
            for t in clip.tracks if len(t.frames)]


def trainer_case(name: str, clip: Clip
                 ) -> Tuple[nn.Module, Callable, List[Tuple]]:
    """-> (the seeded init on the CPU, its loss, ``STEPS`` + 1 batches:
    the fit's and a fresh one)."""
    cfg = MULTISCOPE_PIPELINE
    rng = np.random.default_rng(SEED)
    B = BATCH[name]
    if name == "detector":
        W, H = cfg.detector.resolutions[0]
        S = det_mod.STRIDE
        batches = []
        for _ in range(STEPS + 1):
            fs = rng.integers(clip.n_frames, size=B)
            obj, box = det_mod.make_targets(
                [clip.boxes_at(int(f)) for f in fs], H // S, W // S)
            batches.append((np.stack([clip.render(int(f), W, H)
                                      for f in fs]), obj, box))
        return (det_mod.init_detector("ssd-deep", SEED),
                det_mod.detector_loss, batches)
    if name == "proxy":
        pc = cfg.proxy
        W, H = pc.resolutions[0]
        batches = []
        for _ in range(STEPS + 1):
            fs = rng.integers(clip.n_frames, size=B)
            labels = np.stack([cells_from_detections(
                clip.boxes_at(int(f)), H // pc.cell, W // pc.cell)
                for f in fs])
            batches.append((np.stack([clip.render(int(f), W, H)
                                      for f in fs]), labels))
        return (init_proxy(pc.cell, pc.base_channels, SEED), proxy_loss,
                batches)
    if name == "tracker":
        tc = cfg.tracker
        W, H = cfg.detector.resolutions[0]
        examples = trk_mod.build_examples(
            _gt_tracks(clip), lambda f: clip.render(f, W, H), tc.crop)
        init = trk_mod.init_tracker(tc, SEED, "cpu")
        return (trk_mod.TrackerNet(init), trk_mod._train_loss,
                list(trk_mod.tracker_batches(tc, examples, STEPS + 1, B,
                                            rng)))
    raise ValueError(f"unknown trainer {name!r} (expected one of "
                     f"{TRAINERS})")


def fit_on(module: nn.Module, loss_fn, batches, device
           ) -> Tuple[List[float], Dict[str, np.ndarray],
                      Dict[str, np.ndarray]]:
    """``_fit`` on a copy of ``module`` on ``device``; -> (losses, every
    parameter after the last step, every gradient of the first step),
    on the host."""
    m = copy.deepcopy(module).to(device)
    first: Dict[str, np.ndarray] = {}

    def keep(name):
        def hook(p):
            if name not in first:
                first[name] = p.grad.detach().cpu().numpy().copy()
        return hook
    hooks = [p.register_post_accumulate_grad_hook(keep(k))
             for k, p in m.named_parameters()]
    m, losses = _fit(loss_fn, m, batches)
    for h in hooks:
        h.remove()
    params = {k: v.detach().cpu().numpy() for k, v in m.named_parameters()}
    return losses, params, {k: first.get(k, np.zeros_like(v))
                            for k, v in params.items()}


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.max(np.abs(a.astype(np.float64) - b), initial=0.0)
                 / max(float(np.max(np.abs(b), initial=0.0)), 1e-30))


def _loss_at(module: nn.Module, loss_fn, params, batch) -> float:
    m = copy.deepcopy(module)
    with torch.no_grad():
        for k, p in m.named_parameters():
            p.copy_(torch.from_numpy(params[k]))
        return float(loss_fn(m, *(torch.from_numpy(np.ascontiguousarray(a))
                                  for a in batch)))


def check_trainer(name: str, device, clip: Clip = None) -> Dict[str, object]:
    """The CPU once and ``device`` twice; raises if the card strays past
    the tolerances.  -> the largest differences found."""
    if clip is None:
        clip = make_clip("caldot1", "train", SEED, n_frames=32)
    module, loss_fn, batches = trainer_case(name, clip)
    fit, fresh = batches[:STEPS], batches[STEPS]
    cpu_l, cpu_p, cpu_g = fit_on(module, loss_fn, fit, "cpu")
    (card_l, card_p, card_g), (again_l, again_p, _) = (
        fit_on(module, loss_fn, fit, device) for _ in range(2))
    loss_rel = max(abs(g - w) / max(abs(w), 1e-30)
                   for g, w in zip(card_l, cpu_l))
    grad_rel = {k: _rel(card_g[k], v) for k, v in cpu_g.items()}
    param_rel = {k: _rel(card_p[k], v) for k, v in cpu_p.items()}
    within = sum(int((np.abs(card_p[k].astype(np.float64) - v)
                      <= PARAM_RTOL * np.max(np.abs(v))).sum())
                 for k, v in cpu_p.items())
    f_cpu = _loss_at(module, loss_fn, cpu_p, fresh)
    f_card = _loss_at(module, loss_fn, card_p, fresh)
    out: Dict[str, object] = dict(
        trainer=name, batch=BATCH[name], steps=STEPS, losses_cpu=cpu_l,
        losses_card=card_l, loss_rel=loss_rel,
        grad_rel=max(grad_rel.values()),
        grad_worst=max(grad_rel, key=grad_rel.get),
        fresh_cpu=f_cpu, fresh_card=f_card,
        fresh_rel=abs(f_card - f_cpu) / max(abs(f_cpu), 1e-30),
        param_rel=max(param_rel.values()),
        param_worst=max(param_rel, key=param_rel.get),
        param_within=within / sum(v.size for v in cpu_p.values()),
        card_to_card_loss=max(abs(a - b) for a, b in zip(card_l, again_l)),
        card_to_card_param=max(
            float(np.max(np.abs(card_p[k] - again_p[k]), initial=0.0))
            for k in cpu_p))
    if not np.isfinite(cpu_l).all() or loss_rel > LOSS_RTOL:
        raise AssertionError(f"{name}: card losses {card_l} against CPU "
                             f"{cpu_l} (rel {loss_rel} > {LOSS_RTOL})")
    if out["grad_rel"] > GRAD_RTOL:
        raise AssertionError(f"{name}: first-step gradient of "
                             f"{out['grad_worst']} {out['grad_rel']} of max "
                             f"|CPU| > {GRAD_RTOL}")
    if out["fresh_rel"] > FRESH_RTOL:
        raise AssertionError(f"{name}: the final parameters' loss on a "
                             f"fresh batch {f_card} against {f_cpu} (rel "
                             f"{out['fresh_rel']} > {FRESH_RTOL})")
    return out
