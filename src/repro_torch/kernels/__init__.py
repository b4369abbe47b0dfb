"""Hand-written CUDA kernels of the port, one subpackage each.

Every kernel has, in its ``ops.py``:

  * a wrapper (the public op) that dispatches on the device of the
    tensor it is given, with no mode switch: a CPU tensor goes to the
    plain PyTorch version, a CUDA tensor launches the kernel (or raises —
    there is no fallback), any other device raises;
  * the plain PyTorch version (``*_ref``), which the CPU tests hold
    against the JAX package and ``chip_smoke.py`` holds the kernel
    against on the card;
  * a ``launches`` counter on the wrapper: a plain integer, raised by one
    where the kernel is launched and nowhere else.

Under autograd (grad mode on, an input that requires grad) a CUDA call
differentiates (``flash_attention`` and ``ssd_scan``, through their
backward kernels) or raises (``decode_attention``): no wrapper hands
back an output with no graph.

Kernels (sources in ``repro_torch/csrc/``, built by ``_build``):
  proxy_plan    — fused proxy head + threshold + detector-grid mapping +
                  per-frame plan stats, one block per frame: the frame's
                  features, w and spans in one wave of bulk copies into
                  shared memory, the head 4 threads a cell, the spans as
                  bitmasks mapped with AND/OR (replaces the JAX package's
                  ``kernels/proxy_plan`` Pallas kernel).
  proxy_score   — proxy head + sigmoid + strict threshold into a score
                  map and a positive grid, one warp per cell, every load
                  issued first (float2 where C is even), both outputs in
                  one buffer (replaces ``kernels/proxy_score``'s
                  ``proxy_score_pallas``).
  window_gather — crop one size class of windows out of a chunk of
                  frames by a (frame, cy, cx) table, or out of one frame
                  by a (cy, cx) table, with one kernel body: a block per
                  window and band of rows, every 16-byte load of the band
                  before the first store; a host table's rows carried by
                  the launch (replace ``kernels/window_gather``'s
                  ``window_gather_batch_pallas`` and
                  ``window_gather_pallas``).
  assign        — batched Jonker-Volgenant assignment, one warp per
                  matrix with its per-column state in registers and the
                  matrix in shared memory (replaces ``kernels/assign``'s
                  ``assign_pallas``; its solve, ``csrc/jv.cuh``, also runs
                  inside track_step).
  track_step    — one fused recurrent-tracker step for K streams:
                  detection features, match MLP, cost, JV and both GRU
                  batches (replaces ``kernels/track_step``'s
                  ``track_step_pallas``).  Both take an optional ``err``
                  flag that they set instead of raising, so a caller
                  checks many launches with one read.
  flash_attention — causal or full GQA attention with an online softmax
                  on tensor cores (wgmma fed by TMA), f32 as 3xTF32
                  (replaces
                  ``kernels/flash_attention``'s ``flash_attention_pallas``;
                  the LM prefill and the train step's forward).
  flash_attention_bwd — its gradient, dQ then dK and dV (the group of
                  query heads summed inside a block, no atomics), f32
                  FMAs on CUDA cores (replaces no TPU kernel: the
                  reference differentiates its forward; the LM train
                  step's backward, through ``FlashAttentionFn``).
  decode_attention — one query token per row against a KV cache masked
                  by kv_len, a KV head's query heads packed together,
                  the keys split over a cluster of 16 blocks (replaces
                  ``kernels/decode_attention``'s
                  ``decode_attention_pallas``; every LM decode step).
  ssd_scan      — Mamba2's SSD chunked scan, one block per (head, row)
                  walking the chunks on tensor cores (wgmma fed by TMA,
                  the f32 state in registers), f32 as 3xTF32 in steps of
                  64 rows (replaces ``kernels/ssd_scan``'s
                  ``ssd_scan_pallas``; the Mamba2 prefill and the SSM
                  train step's forward).
  ssd_scan_bwd  — its gradient: the chunk-entry states by a forward
                  sweep, then one block per (head, row) walking 64-row
                  steps in reverse with the state's gradient in shared
                  memory, f32 FMAs on CUDA cores, dB and dC as per-head
                  partials summed in head order, no atomics (replaces no
                  TPU kernel: the reference differentiates its plain
                  chunked scan; the SSM train step's backward, through
                  ``SSDScanFn``).

The attention kernels share ``csrc/attention.cuh`` (f32 / bf16 loads
and rounding); ``csrc/hopper.cuh`` holds the PTX of TMA, mbarriers, 1-D
bulk copies and wgmma (bf16 and tf32) and the host's cached TMA tensor
maps (flash_attention, ssd_scan and proxy_plan's bulk copies use it).
``ssd_scan.check``, ``flash_attention.check``, ``decode_attention.check``,
``assign.check``, ``track_step.check``, ``proxy_plan.check``,
``proxy_score.check`` and ``window_gather.check`` (both gathers) hold
those kernels against their plain versions
on the card (``chip_smoke.py`` and ``tests/test_torch_cuda.py`` share
them).

assign and track_step give the host tracker's f32 bits: their math goes
through ``csrc/fastmath.cuh`` and they are built with -fmad=false
(``_build.SOURCE_FLAGS``).
"""
from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import torch


def on_cuda(t: torch.Tensor) -> bool:
    """The dispatch rule: True for a CUDA tensor (launch the kernel),
    False for a CPU tensor (plain version).  Any other device raises."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


# The helpers below run on every launch (24 a decode step), whose host
# time can exceed the kernel's: they read device indices and pass
# pointers and the stream as plain ints (ctypes converts them through
# each launcher's c_void_p argtypes), building no torch.device or ctypes
# object.

def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on the tensor's device, as the raw
    ``cudaStream_t`` (read on every call: a stream context or a CUDA
    graph's capture changes it)."""
    return torch.cuda.current_stream(t.get_device()).cuda_stream


def device_guard(t: torch.Tensor):
    """The context a launch on ``t``'s device runs in: that device made
    current, or nothing to do when it already is."""
    idx = t.get_device()
    if idx == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(idx)


def bf16_steps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Element by element, how many bf16 values apart two bf16 tensors
    are (0: equal, 1: adjacent, one ulp apart): bit patterns mapped to a
    monotonic integer key."""
    def key(t):
        bits = t.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (key(got) - key(want)).abs()


def views_to_host(*views: torch.Tensor) -> tuple:
    """Contiguous tensors as host numpy arrays: one device-to-host copy
    of the bytes that spans them all when they view one storage (as
    ``proxy_plan`` and ``proxy_score`` return their outputs on the card),
    one copy each otherwise.  Each array views the copied bytes at its
    tensor's offset, shape and dtype.  The host's time here is mostly
    the copy's, so the split is plain numpy."""
    store = views[0].untyped_storage().data_ptr()
    spans = []
    for v in views:
        if not v.is_contiguous() or v.untyped_storage().data_ptr() != store:
            return tuple(t.cpu().numpy() for t in views)
        size = v.element_size()
        spans.append((v.storage_offset() * size, v.numel() * size))
    lo = min(a for a, _ in spans)
    hi = max(a + n for a, n in spans)
    raw = views[0].view(torch.uint8).as_strided((hi - lo,), (1,), lo) \
        .cpu().numpy()
    return tuple(raw[a - lo:a - lo + n].view(_numpy_dtype(v.dtype))
                 .reshape(v.shape) for v, (a, n) in zip(views, spans))


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    dt = _NUMPY_DTYPES.get(dtype)
    return dt if dt is not None else torch.empty(0, dtype=dtype).numpy().dtype


_NUMPY_DTYPES = {torch.float32: np.dtype(np.float32),
                 torch.int32: np.dtype(np.int32),
                 torch.int8: np.dtype(np.int8),
                 torch.uint8: np.dtype(np.uint8)}


def refuse_grad(name: str, *args, why: str = "the kernel has no "
                "backward") -> None:
    """Raise NotImplementedError when grad mode is on and a tensor among
    ``args`` (or among a dict's values) requires grad: a kernel's output
    has no autograd graph, so its inputs would silently get no gradient.
    Called on CUDA tensors only, after the dispatch rule."""
    if not torch.is_grad_enabled():
        return
    for a in args:
        for t in (a.values() if isinstance(a, dict) else (a,)):
            if isinstance(t, torch.Tensor) and t.requires_grad:
                raise NotImplementedError(
                    f"{name} on {t.device} under autograd: {why}")


def check_launch(err: int, lib: ctypes.CDLL, name: str) -> None:
    """Raise if the C launcher reported a CUDA error (a refused launch
    never runs, and a later synchronise would not report it)."""
    if err != 0:
        fn = lib.kernel_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        msg = fn(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
