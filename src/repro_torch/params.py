"""Weights for the port: the bridge from the JAX package's parameter
dicts.

The JAX package keeps parameters as nested dicts of arrays, with conv
weights in HWIO layout.  The ``*_from_params`` functions take such a
dict (any leaves ``np.asarray`` accepts; the tests pass the reference's
own initialised weights) and build the port's modules, with conv weights
moved to PyTorch's OIHW.  The tracker's ``det_proj``, ``gru`` and
``match`` dicts stay numpy, as the host tracker uses them.

The port's own untrained weights, drawn from a ``torch.Generator`` with
the reference's shapes and scales, come from ``Detector(arch, seed=)``,
``ProxyModel(..., seed=)`` and ``tracker.init_tracker(cfg, seed=)``, so
the port runs without JAX (as ``chip_smoke.py`` does).  The two inits do
not give the same numbers.

The ``*_to_params`` functions go the other way: the port's modules
(trained or not) -> the reference's numpy dicts (conv weights back to
HWIO), so a bank the port trains loads into either package.  Both
directions are copies: a round trip is bit for bit.

``lm_from_params`` does the same for the language model: it carries the
reference's ``Model.init_params`` tree (layers stacked; any LM family,
through the family's ``param_specs``) over into the port's
``TransformerLM`` (``EncDecLM`` for the encdec family), whose own init
is ``Model.init_params(seed)``; ``lm_to_params`` goes the other way, for
the weights or their gradients (``grads=True``).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch import Device, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.multiscope import TrackerConfig
from repro_torch.core.baselines.blazeit import FrameScorer
from repro_torch.core.detector import DetectorNet, SameConv2d
from repro_torch.core.proxy import ProxyEncoder
from repro_torch.core.tracker import HEAD_SCOPES, CropCNN
from repro_torch.models.model import lm_param_specs, new_lm
from repro_torch.models.transformer import LMWeights


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _load_conv(conv: SameConv2d, w_hwio, b) -> None:
    w = _f32(w_hwio).permute(3, 2, 0, 1)            # HWIO -> OIHW
    if tuple(w.shape) != tuple(conv.weight.shape):
        raise ValueError(f"conv weight {tuple(w.shape)} != "
                         f"{tuple(conv.weight.shape)}")
    with torch.no_grad():
        conv.weight.copy_(w)
        conv.bias.copy_(_f32(b).reshape(conv.bias.shape))


def _load(p: nn.Parameter, value) -> None:
    with torch.no_grad():
        p.copy_(_f32(value).reshape(p.shape))


def detector_from_params(arch: str, params: Mapping) -> DetectorNet:
    """The reference's ``init_detector`` / trained dict -> DetectorNet."""
    net = DetectorNet(arch)
    for name, conv in net.convs.items():
        _load_conv(conv, params[name]["w"], params[name]["b"])
    return net


def proxy_from_params(cell: int, base_channels: int, params: Mapping
                      ) -> ProxyEncoder:
    """The reference's ``init_proxy`` / trained dict -> ProxyEncoder."""
    enc = ProxyEncoder(cell, base_channels)
    for i, conv in enumerate(enc.enc):
        _load_conv(conv, params[f"enc{i}"]["w"], params[f"enc{i}"]["b"])
    _load_conv(enc.dec0, params["dec0"]["w"], params["dec0"]["b"])
    _load(enc.head_w, params["head"]["w"])
    _load(enc.head_b, params["head"]["b"])
    return enc


def tracker_from_params(cfg: TrackerConfig, params: Mapping,
                        device: Device = "cuda") -> Dict[str, object]:
    """The reference's ``init_tracker`` / trained dict -> the port's
    tracker params (``CropCNN`` on ``device`` + numpy head dicts)."""
    p = params["crop_cnn"]
    cnn = CropCNN(cfg)
    _load_conv(cnn.conv0, p["w0"], p["b0"])
    _load_conv(cnn.conv1, p["w1"], p["b1"])
    _load(cnn.wd, p["wd"])
    _load(cnn.bd, p["bd"])
    out: Dict[str, object] = {
        "crop_cnn": cnn.to(resolve_device(device)).eval()}
    for scope in ("det_proj", "gru", "match"):
        out[scope] = {k: np.array(v, dtype=np.float32)
                      for k, v in params[scope].items()}
    return out


def frame_scorer_from_params(params: Mapping, base: int = 8
                             ) -> FrameScorer:
    """The reference's BlazeIt ``def_frame_scorer`` dict -> FrameScorer."""
    scorer = FrameScorer(base)
    for i, conv in enumerate(scorer.enc):
        _load_conv(conv, params[f"enc{i}"]["w"], params[f"enc{i}"]["b"])
    _load_conv(scorer.head, params["head"]["w"], params["head"]["b"])
    return scorer


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32, copy=True)


def _conv_params(conv: SameConv2d) -> Dict[str, np.ndarray]:
    return {"w": _np(conv.weight.permute(2, 3, 1, 0)),     # OIHW -> HWIO
            "b": _np(conv.bias)}


def detector_to_params(net: DetectorNet) -> Dict[str, Dict]:
    """DetectorNet -> the reference's ``init_detector`` dict."""
    return {name: _conv_params(conv) for name, conv in net.convs.items()}


def proxy_to_params(enc: ProxyEncoder) -> Dict[str, Dict]:
    """ProxyEncoder -> the reference's ``init_proxy`` dict."""
    out = {f"enc{i}": _conv_params(conv) for i, conv in enumerate(enc.enc)}
    out["dec0"] = _conv_params(enc.dec0)
    out["head"] = {"w": _np(enc.head_w), "b": _np(enc.head_b)}
    return out


def tracker_to_params(params: Mapping) -> Dict[str, Dict]:
    """The port's tracker params (``CropCNN`` + numpy head dicts) -> the
    reference's ``init_tracker`` dict."""
    cnn = params["crop_cnn"]
    c0, c1 = _conv_params(cnn.conv0), _conv_params(cnn.conv1)
    out: Dict[str, Dict] = {"crop_cnn": {
        "w0": c0["w"], "b0": c0["b"], "w1": c1["w"], "b1": c1["b"],
        "wd": _np(cnn.wd), "bd": _np(cnn.bd)}}
    for scope in HEAD_SCOPES:
        out[scope] = {k: np.array(v, dtype=np.float32)
                      for k, v in params[scope].items()}
    return out


def frame_scorer_to_params(scorer: FrameScorer) -> Dict[str, Dict]:
    """FrameScorer -> the reference's BlazeIt ``def_frame_scorer`` dict."""
    out = {f"enc{i}": _conv_params(conv)
           for i, conv in enumerate(scorer.enc)}
    out["head"] = _conv_params(scorer.head)
    return out


def _leaf(tree: Mapping, path: str):
    node = tree
    for part in path.split("/"):
        if not isinstance(node, Mapping) or part not in node:
            raise ValueError(f"parameter tree has no {path!r}")
        node = node[part]
    return node


def _leaf_paths(tree: Mapping, prefix: str = ""):
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            yield from _leaf_paths(val, path + "/")
        else:
            yield path


def lm_from_params(cfg: ModelConfig, tree: Mapping,
                   device: Device = "cuda") -> LMWeights:
    """The reference's ``Model.init_params`` tree (any leaves
    ``np.asarray`` accepts; layer parameters stacked on leading axes:
    ``(n_layers,)``, for the hybrid family ``(n_groups,
    ssm_per_group)`` under ``groups/ssm_layers`` and one axis under
    ``shared`` and ``tail``, for the encdec family ``(n_encoder_layers,)``
    under ``encoder`` and ``(n_layers,)`` under ``decoder``) -> the
    port's weights module on ``device``.  Every parameter's shape is
    checked against the port's specs, and a leaf the specs do not know
    raises."""
    dev = resolve_device(device)
    specs = lm_param_specs(cfg)
    extra = sorted(set(_leaf_paths(tree)) - {s.path for s in specs})
    if extra:
        raise ValueError(f"parameters the {cfg.name} model does not have: "
                         f"{extra}")
    model = new_lm(cfg, dev)
    for spec in specs:
        value = _f32(_leaf(tree, spec.path))
        if tuple(value.shape) != spec.shape:
            raise ValueError(f"{spec.path}: shape {tuple(value.shape)}, "
                             f"expected {spec.shape}")
        model.load_(spec.path, value.to(dev))
    return model.eval()


def lm_to_params(weights: LMWeights, grads: bool = False) -> Dict:
    """The inverse of ``lm_from_params``: the port's weights module -> the
    reference's ``Model.init_params`` tree (nested dicts, layers stacked
    on the leading axes of each path), numpy f32 leaves.  With ``grads``
    each leaf is the parameters' ``.grad`` instead (zeros where a
    parameter has none), so gradients compare leaf by leaf with
    ``jax.grad``'s."""
    tree: Dict = {}
    for spec in lm_param_specs(weights.cfg):
        _, sites = weights.sites(spec.path)
        parts = []
        for module, name in sites:
            p = getattr(module, name)
            t = p.grad if grads else p
            parts.append(_np(t) if t is not None
                         else np.zeros(tuple(p.shape), np.float32))
        node = tree
        *heads, last = spec.path.split("/")
        for part in heads:
            node = node.setdefault(part, {})
        node[last] = np.stack(parts).reshape(spec.shape)
    return tree
