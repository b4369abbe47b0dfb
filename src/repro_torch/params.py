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

``lm_from_params`` does the same for the language model: it carries the
reference's ``Model.init_params`` tree (layers stacked; the dense or the
ssm family, through the family's ``param_specs``) over into the port's
``TransformerLM``, whose own init is ``Model.init_params(seed)``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch import Device, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.multiscope import TrackerConfig
from repro_torch.core.detector import DetectorNet, SameConv2d
from repro_torch.core.proxy import ProxyEncoder
from repro_torch.core.tracker import CropCNN
from repro_torch.models.transformer import TransformerLM, param_specs


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
                   device: Device = "cuda") -> TransformerLM:
    """The reference's ``Model.init_params`` tree (any leaves
    ``np.asarray`` accepts; layer parameters stacked on a leading
    ``(n_layers,)`` axis) -> the port's ``TransformerLM`` on ``device``.
    Every parameter's shape is checked against the port's specs, and a
    leaf the specs do not know raises."""
    dev = resolve_device(device)
    specs = param_specs(cfg)
    extra = sorted(set(_leaf_paths(tree)) - {s.path for s in specs})
    if extra:
        raise ValueError(f"parameters the {cfg.name} model does not have: "
                         f"{extra}")
    model = TransformerLM(cfg, dev)
    for spec in specs:
        value = _f32(_leaf(tree, spec.path))
        if tuple(value.shape) != spec.shape:
            raise ValueError(f"{spec.path}: shape {tuple(value.shape)}, "
                             f"expected {spec.shape}")
        model.load_(spec.path, value.to(dev))
    return model.eval()
