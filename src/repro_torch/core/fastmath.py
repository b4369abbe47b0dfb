"""Bitwise-pinned math for the recurrent tracker, in three flavours.

The port's host tracker runs its small heads (detection projection, GRU,
match MLP) in numpy through the ``np_*`` functions, exactly as the JAX
package's host tracker does, so that fed the same detections and crop
embeddings both produce the same track bits.  The device tracker's plain
PyTorch version (``kernels/track_step``'s ``track_step_ref``) runs the
same algorithms on tensors through the ``t_*`` functions, and its CUDA
kernel through ``csrc/fastmath.cuh``; all three give the same f32 bits
on the CPU and on the card.  Each function pins one algorithm:

* ``np_fmadd`` — a single-rounding f32 fma emulated in f64 via
  Boldo-Melquiond round-to-odd (the 24+24-bit product is exact in f64;
  a TwoSum residual decides the odd-rounding nudge before the final f32
  cast).
* ``np_exp`` — Cody-Waite range reduction + the Cephes ``expf`` degree-5
  polynomial, every step either an ``np_fmadd`` or an exact op.
* ``np_sigmoid`` — ``1 / (1 + exp(-x))`` with the input clamped to
  [-30, 30] so ``exp`` stays normal.
* ``np_tanh`` — ``2 * sigmoid(2x) - 1`` (both multiplies exact).
* ``np_log1p_int`` — a 4096-entry f32 table of ``log1p`` over integer
  frame gaps; gaps beyond the table clamp to the last entry.
* ``np_matmul`` — the sequential double-rounded accumulation over k
  (multiply, round, add, round; no fma), which ``einsum`` with
  ``optimize=False`` computes in exactly that order.  Single-column
  weights are padded to 8 columns (einsum switches to a SIMD dot at
  width 1) and the result sliced back.

The torch flavour keeps every operation a separate eager PyTorch call,
so each rounds to f32 on its own: ``a * b + c`` is two roundings and
``t_fmadd`` is the only multiply-add; ``torch.addcmul``, ``torch.lerp``,
``@``, ``torch.matmul``, ``einsum`` and ``addmm`` (BLAS sums in other
orders) do not appear on this path.  Division is written tensor by
tensor: PyTorch computes ``1 / t`` as ``t.reciprocal() * 1`` and, on the
card, ``t / s`` for a Python scalar ``s`` as ``t * (1 / s)``.
"""
from __future__ import annotations

import numpy as np
import torch

_LOG2E = np.float32(1.44269504088896341)
# Cody-Waite split of ln2 (Cephes expf): ln2 ~= LN2_HI + LN2_LO
_LN2_HI = np.float32(0.693359375)
_LN2_LO = np.float32(-2.12194440e-4)
# Cephes expf minimax polynomial on [-0.5 ln2, 0.5 ln2]
_EXP_POLY = tuple(np.float32(c) for c in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
    4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1))
# clip keeps 2^k a normal f32 (k in [-126, 127]) and the final scale
# exact; sigmoid's tighter clamp is what the tracker actually relies on
_EXP_LO = np.float32(-87.0)
_EXP_HI = np.float32(88.0)
_SIG_CLAMP = np.float32(30.0)
_ONE = np.float32(1.0)
_TWO = np.float32(2.0)
_HALF = np.float32(0.5)

LOG1P_TABLE_SIZE = 4096
LOG1P_TABLE = np.log1p(
    np.arange(LOG1P_TABLE_SIZE, dtype=np.float64)).astype(np.float32)


# ---------------------------------------------------------------------------
# numpy flavor (host)
# ---------------------------------------------------------------------------

def np_fmadd(a, b, c) -> np.ndarray:
    """Exact f32 fma(a, b, c) — bit-identical to XLA CPU's contracted
    ``a * b + c``.  f64 holds the 24x24-bit product exactly; TwoSum
    recovers the residual of the f64 add, and round-to-odd on the f64
    intermediate makes the final f32 cast single-rounded."""
    a64 = np.asarray(a, np.float64)
    b64 = np.asarray(b, np.float64)
    c64 = np.asarray(c, np.float64)
    p = a64 * b64                       # exact
    s = p + c64
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)   # exact: s + err == p + c
    s = np.ascontiguousarray(np.broadcast_to(s, err.shape))
    bits = s.view(np.int64)
    fix = (err != 0) & ((bits & 1) == 0) & np.isfinite(s)
    dirn = np.where(err > 0, np.float64(np.inf), np.float64(-np.inf))
    s = np.where(fix, np.nextafter(s, dirn), s)
    return s.astype(np.float32)


def _np_pow2(k: np.ndarray) -> np.ndarray:
    ki = k.astype(np.int32)
    return np.ascontiguousarray((ki + np.int32(127)) << np.int32(23)) \
        .view(np.float32)


def np_exp(x: np.ndarray) -> np.ndarray:
    x = np.clip(np.asarray(x, np.float32), _EXP_LO, _EXP_HI)
    k = np.floor(np_fmadd(x, _LOG2E, _HALF))
    r = np_fmadd(k, -_LN2_HI, x)
    r = np_fmadd(k, -_LN2_LO, r)
    p = np_fmadd(_EXP_POLY[0], r, _EXP_POLY[1])
    for c in _EXP_POLY[2:]:
        p = np_fmadd(p, r, c)
    s = np_fmadd(p, r * r, r) + _ONE
    return (s * _np_pow2(k)).astype(np.float32)


def np_sigmoid(x: np.ndarray) -> np.ndarray:
    x = np.clip(np.asarray(x, np.float32), -_SIG_CLAMP, _SIG_CLAMP)
    return _ONE / (_ONE + np_exp(-x))


def np_tanh(x: np.ndarray) -> np.ndarray:
    return _TWO * np_sigmoid(_TWO * np.asarray(x, np.float32)) - _ONE


def np_log1p_int(te: np.ndarray) -> np.ndarray:
    """log1p of integer-valued nonnegative f32 (frame gaps)."""
    idx = np.clip(np.asarray(te).astype(np.int32), 0,
                  LOG1P_TABLE_SIZE - 1)
    return LOG1P_TABLE[idx]


def np_matmul(a: np.ndarray, w: np.ndarray) -> np.ndarray:
    """(n, k) @ (k, m) with the pinned sequential-over-k accumulation
    (double rounding per term, ascending k) — bit-identical to
    ``jx_matmul``.  NOT BLAS: ``einsum(optimize=False)`` runs the naive
    C loops in exactly that order."""
    a = np.asarray(a, np.float32)
    w = np.asarray(w, np.float32)
    if w.shape[1] == 1:
        wp = np.zeros((w.shape[0], 8), np.float32)
        wp[:, :1] = w
        return np.einsum("ik,kh->ih", a, wp, optimize=False)[:, :1]
    return np.einsum("ik,kh->ih", a, w, optimize=False)


# ---------------------------------------------------------------------------
# torch flavour (plain versions of the device tracker, CPU or card)
# ---------------------------------------------------------------------------

def _t64(v):
    """float64 view of an operand: tensors are cast (exact), scalars stay
    Python floats (a float32 constant is exact in float64)."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.float64)
    return float(v)


def t_fmadd(a, b, c) -> torch.Tensor:
    """Exact f32 fma(a, b, c): ``np_fmadd``'s float64 round-to-odd
    algorithm on tensors (``torch.nextafter`` for the odd nudge).  At
    least one operand is a tensor; the result is f32 on its device."""
    like = next(v for v in (a, b, c) if isinstance(v, torch.Tensor))
    a64, b64, c64 = (_t64(v) for v in (a, b, c))
    p = a64 * b64                       # exact
    if not isinstance(p, torch.Tensor):
        p = torch.tensor(p, dtype=torch.float64, device=like.device)
    s = p + c64
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)   # exact: s + err == p + c
    s = s.expand_as(err).contiguous()
    bits = s.view(torch.int64)
    fix = (err != 0) & ((bits & 1) == 0) & torch.isfinite(s)
    inf = torch.full_like(s, float("inf"))
    s = torch.where(fix, torch.nextafter(s, torch.where(err > 0, inf, -inf)),
                    s)
    return s.to(torch.float32)


def _t_pow2(k: torch.Tensor) -> torch.Tensor:
    ki = k.to(torch.int32)
    return ((ki + 127) << 23).view(torch.float32)


def t_exp(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32).clamp(float(_EXP_LO), float(_EXP_HI))
    k = torch.floor(t_fmadd(x, _LOG2E, _HALF))
    r = t_fmadd(k, -_LN2_HI, x)
    r = t_fmadd(k, -_LN2_LO, r)
    p = t_fmadd(_EXP_POLY[0], r, _EXP_POLY[1])
    for c in _EXP_POLY[2:]:
        p = t_fmadd(p, r, c)
    s = t_fmadd(p, r * r, r) + 1.0
    return s * _t_pow2(k)


def t_sigmoid(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32).clamp(-float(_SIG_CLAMP), float(_SIG_CLAMP))
    den = 1.0 + t_exp(-x)
    return torch.ones_like(den) / den


def t_tanh(x: torch.Tensor) -> torch.Tensor:
    return 2.0 * t_sigmoid(2.0 * x.to(torch.float32)) - 1.0


def t_log1p_int(te: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """log1p of integer-valued nonnegative f32 gaps by lookup in
    ``table`` (``LOG1P_TABLE`` as a flat f32 tensor on te's device)."""
    idx = te.to(torch.int32).clamp(0, table.shape[0] - 1)
    return table[idx.long()]


def t_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(n, k) x (k, m) with ``np_matmul``'s pinned accumulation: from
    zeros, ``acc + a[:, k] * w[k]`` in ascending k, the product and the
    sum each rounded to f32.  Single-column weights are padded to 8
    columns, as ``np_matmul`` pads them, and the result sliced back."""
    a = a.to(torch.float32)
    w = w.to(torch.float32)
    if w.shape[1] == 1:
        return t_matmul(a, torch.nn.functional.pad(w, (0, 7)))[:, :1]
    acc = torch.zeros((a.shape[0], w.shape[1]), dtype=torch.float32,
                      device=a.device)
    for k in range(a.shape[1]):
        acc = acc + a[:, k, None] * w[None, k, :]
    return acc
