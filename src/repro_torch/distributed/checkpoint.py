"""Manifest-based checkpointing with async save and integrity hashes: the
port of the JAX package's ``repro.distributed.checkpoint``, with the
same files on disk, so a checkpoint written by either package restores
in the other.

Layout (one directory per step):

    <root>/step_000123/
        manifest.json         {step, leaves: {path: {file, shape, dtype,
                               sha256}}, meta}
        p00000_<name>.npy     one file per leaf

  * a leaf's path joins its keys with "/": a dict's key, a tuple's or
    list's index, and a named tuple's field as ".field" (JAX's
    ``GetAttrKey`` printed); files are numbered in sorted path order;
  * each leaf file is written to a temporary name, then renamed, and
    hashed (sha256); the manifest is written LAST, so a checkpoint
    without one is ignored by ``latest_step`` (the commit point);
  * async mode copies every leaf to the host first (the caller may
    update its tensors in place as soon as ``save`` returns), then
    writes on a worker thread.

A tree is nested dicts, tuples, lists and named tuples over tensors,
numpy arrays and numbers.  A ``TrainState`` (the live weights module and
its ``optim.AdamW``) checkpoints as the reference's ``(params,
AdamWState(step, m, v))`` tuple: parameters and moments in the
reference's stacked layout (``lm_param_specs``), ``v`` as (int8, scale)
pairs under ``quantize_v``.  ``restore`` into a ``TrainState`` copies
every parameter and moment in place; into any other template it returns
a new tree whose leaves take the template leaves' types (a tensor on
the template's device and dtype, else a numpy array).

Not ported: ``owned_only`` and restore ``shardings`` (one process, one
device; items 12g.3 and 14b).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.model import lm_param_specs
from repro_torch.models.transformer import LMWeights
from repro_torch.optim.adamw import AdamW, _quantize_v

PyTree = Any


@dataclasses.dataclass
class TrainState:
    """The state a train step updates in place: the weights module and its
    optimizer, checkpointed as the reference's ``(params, AdamWState)``."""
    weights: LMWeights
    optimizer: AdamW

    def _sites(self):
        """(spec, [parameter per stacked layer]) for every leaf of the
        reference's parameter tree."""
        w = self.weights
        return [(spec, [getattr(m, n) for m, n in w.sites(spec.path)[1]])
                for spec in lm_param_specs(w.cfg)]

    def _quantized(self) -> bool:
        return any(g["quantize_v"] for g in self.optimizer.param_groups)

    def paths(self) -> List[str]:
        """Every leaf path, in the reference's spelling."""
        out = ["1/.step"]
        for spec, _ in self._sites():
            out += [f"0/{spec.path}", f"1/.m/{spec.path}"]
            out += ([f"1/.v/{spec.path}/0", f"1/.v/{spec.path}/1"]
                    if self._quantized() else [f"1/.v/{spec.path}"])
        return out

    def leaves(self) -> Dict[str, np.ndarray]:
        """{path: host copy}; moments not made yet (before the first
        step) are the reference's init: zeros, quantized under
        ``quantize_v``."""
        opt = self.optimizer
        quant = self._quantized()
        out = {"1/.step": np.asarray(opt.n_steps, np.int32)}
        for spec, params in self._sites():
            def stacked(parts, shape):
                return np.stack(parts).reshape(shape)
            out[f"0/{spec.path}"] = stacked(
                [_host(p.float()) for p in params], spec.shape)
            ms, vs = [], []
            for p in params:
                st = opt.state.get(p)
                if st:
                    ms.append(_host(st["m"]))
                    vs.append(st["v"])
                else:
                    zero = torch.zeros(p.shape, dtype=torch.float32)
                    ms.append(zero.numpy())
                    vs.append(_quantize_v(zero) if quant else zero)
            out[f"1/.m/{spec.path}"] = stacked(ms, spec.shape)
            if quant:
                if not params[0].shape:
                    raise ValueError(f"{spec.path}: a row scale needs a "
                                     "parameter of one axis or more")
                out[f"1/.v/{spec.path}/0"] = stacked(
                    [_host(q) for q, _ in vs], spec.shape)
                out[f"1/.v/{spec.path}/1"] = stacked(
                    [_host(s) for _, s in vs], spec.shape[:-1] + (1,))
            else:
                out[f"1/.v/{spec.path}"] = stacked(
                    [_host(v) for v in vs], spec.shape)
        return out

    @torch.no_grad()
    def load_(self, arrays: Dict[str, np.ndarray]) -> None:
        """Copy the parameters, moments and step count of ``arrays``
        (``leaves``' paths) in place; every kept activation-dtype copy
        of a weight is made again."""
        opt = self.optimizer
        quant = self._quantized()
        for spec, params in self._sites():
            n, shape = len(params), tuple(params[0].shape)

            def parts(key, tail=shape):
                return np.asarray(arrays[key]).reshape((n,) + tail)
            self.weights.load_(spec.path, torch.from_numpy(
                np.ascontiguousarray(arrays[f"0/{spec.path}"])))
            m = parts(f"1/.m/{spec.path}")
            if quant:
                q = parts(f"1/.v/{spec.path}/0")
                s = parts(f"1/.v/{spec.path}/1", shape[:-1] + (1,))
            else:
                v = parts(f"1/.v/{spec.path}")
            for i, p in enumerate(params):
                st = opt.state[p]
                st["m"] = _to(m[i], p.device, torch.float32)
                st["v"] = ((_to(q[i], p.device, torch.int8),
                            _to(s[i], p.device, torch.float32)) if quant
                           else _to(v[i], p.device, torch.float32))
        opt.n_steps = int(np.asarray(arrays["1/.step"]))
        self.weights.refresh_casts()


def _host(t) -> np.ndarray:
    """A host copy of a tensor, array or number as numpy (never a view of
    memory the caller may update in place)."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            raise ValueError("bf16 leaves have no numpy dtype: checkpoint "
                             "the f32 masters")
        return t.to("cpu", copy=True).numpy()
    return np.array(t, copy=True)


def _to(a: np.ndarray, device, dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                        dtype=dtype)


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of an inner node in JAX's flattening order, or
    None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def _leaf_paths(tree: PyTree) -> Dict[str, Any]:
    """{path: leaf} in flattening order."""
    out: Dict[str, Any] = {}

    def walk(node, prefix):
        kids = _children(node)
        if kids is None:
            out[prefix] = node
            return
        for key, child in kids:
            walk(child, f"{prefix}/{key}" if prefix else key)
    walk(tree, "")
    return out


def _rebuild(template: PyTree, arrays: Dict[str, np.ndarray],
             prefix: str = "") -> PyTree:
    """``template``'s structure over ``arrays``, each leaf as the
    template leaf's type."""
    kids = _children(template)
    if kids is None:
        a = arrays[prefix]
        if isinstance(template, torch.Tensor):
            return _to(a, template.device, template.dtype)
        return np.asarray(a)
    rebuilt = [_rebuild(child, arrays, f"{prefix}/{key}" if prefix else key)
               for key, child in kids]
    if isinstance(template, dict):
        return dict(zip(sorted(template), rebuilt))
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*rebuilt)
    return type(template)(rebuilt)


def _sanitize(key: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", key)[:120]


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _write_atomic(path: str, arr: np.ndarray) -> str:
    tmp = path + ".tmp"
    np.save(tmp, arr, allow_pickle=False)
    os.replace(tmp + ".npy" if not tmp.endswith(".npy") else tmp, path)
    return _sha256(path)


class Checkpointer:
    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(root, exist_ok=True)

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree: PyTree, meta: Optional[dict] = None,
             async_: bool = False) -> str:
        # every leaf on the host before the writer thread starts
        leaves = (tree.leaves() if isinstance(tree, TrainState) else
                  {k: _host(v) for k, v in _leaf_paths(tree).items()})
        if async_:
            self.wait()
            self._thread = threading.Thread(
                target=self._save_sync, args=(step, leaves, meta))
            self._thread.start()
            return self._dir(step)
        return self._save_sync(step, leaves, meta)

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def _save_sync(self, step: int, leaves: Dict[str, np.ndarray],
                   meta: Optional[dict]) -> str:
        d = self._dir(step)
        os.makedirs(d, exist_ok=True)
        manifest = {"step": step, "meta": meta or {}, "leaves": {}}
        for i, (key, arr) in enumerate(sorted(leaves.items())):
            fname = f"p{i:05d}_{_sanitize(key)}.npy"
            digest = _write_atomic(os.path.join(d, fname), arr)
            manifest["leaves"][key] = {
                "file": fname, "shape": list(arr.shape),
                "dtype": str(arr.dtype), "sha256": digest}
        # manifest last = commit point
        tmp = os.path.join(d, "manifest.json.tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)
        os.replace(tmp, os.path.join(d, "manifest.json"))
        self._gc()
        return d

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._dir(s), ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in sorted(os.listdir(self.root)):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(
                    os.path.join(self.root, name, "manifest.json")):
                out.append(int(m.group(1)))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: PyTree, step: Optional[int] = None,
                verify: bool = True) -> Tuple[PyTree, dict]:
        """Restore into the structure of ``template`` (a ``TrainState``:
        in place, returning it) -> (the tree, the manifest)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = self._dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        keys = (template.paths() if isinstance(template, TrainState)
                else list(_leaf_paths(template)))
        arrays = {}
        for key in keys:
            ent = manifest["leaves"].get(key)
            if ent is None:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            path = os.path.join(d, ent["file"])
            arr = np.load(path, allow_pickle=False)
            if verify and _sha256(path) != ent["sha256"]:
                raise IOError(f"hash mismatch for {key} in {d}")
            arrays[key] = arr
        if isinstance(template, TrainState):
            template.load_(arrays)
            return template, manifest
        return _rebuild(template, arrays), manifest
