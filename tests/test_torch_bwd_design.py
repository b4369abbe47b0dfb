"""The rounding of the port's bf16 flash-attention backward on tensor
cores (``csrc/flash_attention_bwd.cu``: ``flash_attention_bwd_dq_wgmma_kernel``,
``flash_attention_bwd_dkdv_wgmma_kernel`` and ``flash_attention_bwd_sum_kernel``),
modelled in PyTorch on the CPU and held to the plain backward
(``flash_attention_bwd_ref``) through the card check's own tolerance,
``kernels.flash_attention.check.grads_agree``.

The model rounds where the kernels round.  Every product takes bf16
operands, whose products are exact in f32, and each wgmma adds one
16-wide K step of them to its f32 accumulator and truncates the sum
(modelled as the step's sum rounded toward zero onto the accumulator).
S = Q K^T and dP = dO V^T take D / 16 such steps; dQ += dS K runs one
chain through every key tile of a query tile (64 keys, 4 steps a tile),
and dV += P^T dO and dK += dS^T Q one chain through every query tile of
a key tile and query head.  The softmax is in log2 units: S is scaled by
sm_scale log2 e in f32, each row's max and sum are taken over tiles of
64 keys with ``ex2.approx`` (its relative error of about 2^-22 added as
seeded noise), lse2 = m + log2 l, and P = ex2(S c - lse2); the dK/dV
kernel recomputes the same P from the same S and lse2 (the instruction
is deterministic, so the model reuses it).  Di = rowsum(dO O) reads the
forward's output in bf16.  P and dS = P (dP - Di) enter the second
products as bf16 A operands: rounded once (hi) or as hi + lo, both
products into the same accumulator (hi steps, then lo steps, per tile).
With G = Hq / Hkv > 1, each query head's dK and dV are f32 partials,
summed over the group in head order by the third kernel, which scales dK
by sm_scale; with G = 1 the dK/dV kernel scales and rounds itself.

The model runs at every ``BWD_CASES`` shape in bf16, at batch row 0 and
KV head 0 with its group of query heads (the kernels compute each row
and KV head's group on their own, so their rounding is the full
case's).  The shipped variant (``SHIP``: P and dS as hi + lo) passes
``grads_agree`` there, and its rounding, measured against the same
algorithm in f64, stays within ``SHIP_MARGIN`` of max |exact|: under a
sixtieth of the tolerance's near-zero band (``GRAD_BF16_RTOL``, 2^-7 of
max), which the final bf16 roundings of both versions and Di's bf16 O
already use up to half of.  The other variant (P and dS rounded to bf16
once) reads 0.0010-0.0031 of max at these cases, 13-40% of the band
(``OTHER_READ`` records two).  The planted faults of ``check.BWD_FAULTS``,
planted in the model, fail.
"""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import (  # noqa: E402
    check as flash_check)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    NEG_INF, flash_attention_bwd_ref, flash_attention_ref)

LOG2E = 1.4426950408889634
EX2_REL_ERR = 2.0 ** -22          # ex2.approx.f32, modelled as noise
TILE = 64                         # keys (dQ) or query rows (dK/dV) a tile
STEP = 16                         # a bf16 wgmma's K
SEED = 120
BF16 = {c[0]: c for c in flash_check.BWD_CASES if c[1] == torch.bfloat16}
# the variant the kernel ships: P and dS as bf16 hi + lo
SHIP = dict(lo=True)
# its rounding against the f64 algorithm, as a share of max |exact|
# (it reads 2e-6 to 7e-6)
SHIP_MARGIN = 2.0 ** -13
FAULT_CASE = "S500 causal"


@pytest.fixture(autouse=True)
def _one_thread():
    # the other test workers share the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def add_toward_zero(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b (f32) rounded toward zero: the nearest sum, stepped one ulp
    toward zero where it lies beyond the exact sum (TwoSum's error term
    and the sum differ in sign)."""
    s = a + b
    t = s - a
    err = (a - (s - t)).add_(b - t)
    beyond = err.mul_(s) < 0
    return s.view(torch.int32).sub_(beyond.int()).view(torch.float32)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def steps(eq: str, a: torch.Tensor, b: torch.Tensor, axis_a: int,
          axis_b: int, acc, tile: int = 0):
    """``acc + einsum(eq, a, b)`` as a chain of wgmma steps of 16 along
    the contracted axis (``axis_a`` of a, ``axis_b`` of b), each
    truncating its sum onto the f32 accumulator.  ``a`` may be a list
    of parts (hi, lo): per ``tile`` of the axis, every step of the first
    part, then of the next."""
    parts = a if isinstance(a, list) else [a]
    n = parts[0].shape[axis_a]
    tile = tile or n
    out = acc
    for t0 in range(0, n, tile):
        for x in parts:
            for k0 in range(t0, min(t0 + tile, n), STEP):
                w = min(STEP, n - k0)
                step = torch.einsum(eq, x.narrow(axis_a, k0, w),
                                    b.narrow(axis_b, k0, w))
                out = step if out is None else add_toward_zero(out, step)
    return out


class Ex2:
    """2^x as ``ex2.approx``: exact 2^x of the f32 argument times (1 +
    e), e drawn uniformly within the instruction's relative error."""

    def __init__(self, seed: int):
        self.gen = torch.Generator().manual_seed(seed)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        e = (torch.rand(x.shape, generator=self.gen) * 2 - 1) * EX2_REL_ERR
        return torch.exp2(x) * (1 + e)


def visible(Sq: int, Skv: int, causal: bool, kv_valid: int,
            reach: int = 0) -> torch.Tensor:
    """(Sq, Skv): key j visible to query i (queries at the end of the
    keys); ``reach`` lets a causal row see that many keys past its
    own."""
    n_valid = kv_valid if 0 < kv_valid < Skv else Skv
    qpos = torch.arange(Sq) + (Skv - Sq)
    kpos = torch.arange(Skv)
    vis = (kpos < n_valid)[None, :].expand(Sq, Skv)
    if causal:
        vis = vis & (kpos[None, :] <= qpos[:, None] + reach)
    return vis


def bwd_model(q, k, v, o, dout, causal: bool, kv_valid: int = 0,
              lo: bool = True, exact: bool = False, fault=None,
              seed: int = 0):
    """(dq, dk, dv) before the final bf16 rounding, as the bf16 kernels
    compute them (f32), or with ``exact`` the same algorithm in f64 with
    no rounding.  ``fault``: one of ``check.BWD_FAULTS``, planted."""
    Bq, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    ft = torch.float64 if exact else torch.float32
    qf, kf, vf, of, dof = (t.to(ft) for t in (q, k, v, o, dout))
    scale = float(np.float32(1.0 / math.sqrt(D)))
    c = float(np.float32(np.float32(scale) * np.float32(LOG2E)))
    ex2 = torch.exp2 if exact else Ex2(seed)
    kr = kf.repeat_interleave(G, dim=2)                # (B, Skv, Hq, D)
    vr = vf.repeat_interleave(G, dim=2)
    reach = 1 if fault == "causal mask one off" else 0
    vis = visible(Sq, Skv, causal, kv_valid, reach)[None, None]

    def prod(eq, a, b, axis_a, axis_b, tile=0):
        if exact:
            a = sum(a) if isinstance(a, list) else a
            return torch.einsum(eq, a, b)
        return steps(eq, a, b, axis_a, axis_b, None, tile)

    # S and dP: D / 16 steps each (B, Hq, Sq, Skv)
    s = prod("bqhd,bkhd->bhqk", qf, kr, 3, 3) * c
    dp = prod("bqhd,bkhd->bhqk", dof, vr, 3, 3)
    # pass 1: each row's max and sum in log2 units, over tiles of 64 keys
    m = torch.full(s.shape[:-1] + (1,), NEG_INF, dtype=ft)
    l = torch.zeros_like(m)
    for k0 in range(0, Skv, TILE):
        st, vt = s[..., k0:k0 + TILE], vis[..., k0:k0 + TILE]
        if not vt.any():
            continue
        mx = torch.where(vt, st, NEG_INF).amax(dim=-1, keepdim=True)
        m_new = torch.maximum(m, mx)
        alpha = ex2(m - m_new)
        p = torch.where(vt, ex2(st - m_new), 0.0)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        m = m_new
    lse2 = torch.where(l > 0, m + torch.log2(l), math.inf)
    p = torch.where(vis, ex2(s - lse2), 0.0)
    di = (dof * of).sum(-1).transpose(1, 2)[..., None]  # (B, Hq, Sq, 1)
    if fault == "Di dropped":
        di = torch.zeros_like(di)
    ds = p * (dp - di)
    if exact:
        p_parts, ds_parts = p, ds
    else:
        p_parts, ds_parts = [bf16(p)], [bf16(ds)]
        if lo:
            p_parts.append(bf16(p - p_parts[0]))
            ds_parts.append(bf16(ds - ds_parts[0]))
    dq = prod("bhqk,bkhd->bqhd", ds_parts, kr, 3, 1, TILE) * scale
    # per query head: f32 partials, then the group's sum in head order
    dk_h = prod("bhqk,bqhd->bkhd", ds_parts, qf, 2, 1, TILE)
    dv_h = prod("bhqk,bqhd->bkhd", p_parts, dof, 2, 1, TILE)
    dk_h = dk_h.reshape(Bq, Skv, Hkv, G, D)
    dv_h = dv_h.reshape(Bq, Skv, Hkv, G, D)
    dk, dv = dk_h[:, :, :, 0], dv_h[:, :, :, 0]
    if fault != "dK without the sum over the group":
        for g in range(1, G):
            dk = dk + dk_h[:, :, :, g]
    for g in range(1, G):
        dv = dv + dv_h[:, :, :, g]
    return dq, dk * scale, dv


@functools.lru_cache(maxsize=None)
def design_case(name: str):
    """The card check's bf16 operands of a ``BWD_CASES`` shape (drawn as
    ``bwd_case_operands`` draws them) at batch row 0 and KV head 0's
    group, o from the plain forward on them, and the plain backward's
    (dq, dk, dv) in bf16."""
    case = BF16[name]
    _, dtype, Sq, Skv, causal, kv_valid, (hq, hkv, d) = case
    seed = SEED + list(BF16).index(name)
    q, k, v = flash_check.case_operands(case, "cpu", seed)
    (dout,) = flash_check.operands([(flash_check.B, Sq, hq, d)], dtype,
                                   "cpu", seed + 1)
    G = hq // hkv
    q, dout = q[:1, :, :G].contiguous(), dout[:1, :, :G].contiguous()
    k, v = k[:1, :, :1].contiguous(), v[:1, :, :1].contiguous()
    with torch.inference_mode():
        o = flash_attention_ref(q, k, v, causal=causal, kv_valid=kv_valid)
    want = flash_attention_bwd_ref(q, k, v, o, dout, causal=causal,
                                   kv_valid=kv_valid)
    return (q, k, v, o, dout), want


@functools.lru_cache(maxsize=None)
def exact_of(name: str):
    ops, _ = design_case(name)
    _, _, _, _, causal, kv_valid, _ = BF16[name]
    with torch.inference_mode():
        return bwd_model(*ops, causal, kv_valid, exact=True)


def model_of(name: str, **variant):
    ops, _ = design_case(name)
    _, _, _, _, causal, kv_valid, _ = BF16[name]
    with torch.inference_mode():
        return bwd_model(*ops, causal, kv_valid, **variant)


def rounding_of(got, exact) -> float:
    """The largest max |got - exact| / max |exact| of the three
    gradients."""
    return max(float((g.double() - e).abs().max() / e.abs().max())
               for g, e in zip(got, exact))


def to_bf16(grads):
    return tuple(g.to(torch.bfloat16) for g in grads)


@pytest.mark.parametrize("name", list(BF16))
def test_shipped_model_holds_the_card_tolerance(name):
    got = model_of(name, **SHIP)
    flash_check.grads_agree(to_bf16(got), design_case(name)[1], name)
    off = rounding_of(got, exact_of(name))
    assert off <= SHIP_MARGIN, (name, off)
    _, _, Sq, Skv, causal, _, _ = BF16[name]
    if causal and Sq > Skv:
        assert not got[0][:, :Sq - Skv].any()    # no visible key: dq 0


# the variant not shipped (P and dS rounded to bf16 once): its rounding
# (the worst of max |d| / max |exact|: dq's at the first, dv's at the
# second) at two cases, which the design chose the split on
OTHER_READ = {"S512 non-causal": 0.003115, "Sq128 Skv512 causal": 0.002693}


@pytest.mark.parametrize("name", list(OTHER_READ))
def test_the_unsplit_variant_reads_as_recorded(name):
    off = rounding_of(model_of(name, lo=False), exact_of(name))
    assert off == pytest.approx(OTHER_READ[name], rel=0.05), (name, off)
    assert off > 0.25 * flash_check.GRAD_BF16_RTOL


@pytest.mark.parametrize("fault", flash_check.BWD_FAULTS)
def test_planted_faults_fail_the_tolerance(fault):
    got = model_of(FAULT_CASE, fault=fault, **SHIP)
    with pytest.raises(AssertionError):
        flash_check.grads_agree(to_bf16(got), design_case(FAULT_CASE)[1],
                                f"{FAULT_CASE} {fault}")


def test_the_check_model_is_the_design_in_f32():
    """``check.flash_attention_bwd_model`` (the algorithm in plain f32,
    the per-head partials summed in head order) agrees with the design
    model in f64 to f32 rounding."""
    ops, _ = design_case("D128 pixtral-12b S512 causal")
    _, _, _, _, causal, kv_valid, _ = BF16["D128 pixtral-12b S512 causal"]
    f32 = [t.float() for t in ops]
    with torch.inference_mode():
        got = flash_check.flash_attention_bwd_model(*f32, causal,
                                                    kv_valid=kv_valid)
        want = bwd_model(*f32, causal, kv_valid, exact=True)
    for g, w in zip(got, want):
        assert float((g.double() - w).abs().max()) \
            <= 1e-5 * float(w.abs().max())
