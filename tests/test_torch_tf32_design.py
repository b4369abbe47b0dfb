"""The rounding of the port's f32 kernels on tensor cores, 3xTF32
(``csrc/ssd_scan.cu``'s ``ssd_scan_tf32_kernel`` and
``csrc/flash_attention.cu``'s ``flash_attention_tf32_kernel``), modelled
in PyTorch on the CPU and held to the plain versions through the card
checks' own tolerances (``kernels.ssd_scan.check.within_tolerance``: y
and the final state within 1e-4 of max |plain|;
``kernels.flash_attention.check.kernel_agrees``: max |d| <= 1e-5).

The model rounds where the kernels round.  The tensor cores read an f32
operand's top 19 bits (tf32 by truncation: sign, exponent, 10 mantissa
bits); each wgmma adds its 8 exact products to the f32 accumulator and
truncates the sum (modelled as the exact sum rounded toward zero), so a
long chain of products in one accumulator drifts toward zero by up to
an ulp a step.  Every f32 operand v is split into hi = trunc(v) and lo =
v - hi (exact in f32; the tensor cores truncate lo in turn), and each
product is hi hi' + hi lo' + lo hi' in one accumulator, one wgmma each
per 8-wide K step, in the kernels' order.  The kernels use the raw f32
word as hi (a TMA tile or an accumulator register fed as it is) and
write lo themselves.  Both take e^x as 2^(x log2 e) on the
special-function unit (``ex2.approx``), whose own relative error (at
most about 2^-22) the model adds as seeded noise of that size; exp(L)
and exp(L_Q) in the scan are ``expf``.

The scan runs in steps of 64 rows whatever the chunk Q (each step an
exact step of the recurrence); L is the cumulative sum of dt A (each term
rounded first) in the kernel's order: lane l of a warp sums rows 2 l and
2 l + 1, a Hillis-Steele scan combines the 32 lane totals, and each row
adds its lane's exclusive prefix; the decay is selected, never multiplied
after exp.  Flash attention takes S = Q K^T unscaled, over d 0-31 and
32-63 in two accumulators added in f32, scales it by sm_scale log2 e in
f32, and runs the online softmax over tiles of 64 keys with a masked
key's p exactly 0; each tile's P V is summed in its own accumulator and
added as O = alpha O + P V in f32.

The model holds at every f32 case of both card checks (the flash
kernel's ``SERVE_CASES``, whose full size would take many minutes here,
at batch row 0 and the query heads of KV head 0: the kernel computes
each (row, head) on its own, so their rounding is the full case's);
one tf32 product
per operand (truncated or rounded to nearest) fails the check at the
prefill's scan and at S 512 causal attention: the split is needed.  At a
small case the model agrees with the JAX package's Pallas kernels in
interpret mode.  The register-operand bookkeeping (an accumulator fed as
the A operand with its K order permuted, the B operand's rows written in
the matching order) is checked as index algebra.
"""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_pallas)
from repro.kernels.ssd_scan.kernel import ssd_scan_pallas  # noqa: E402

from repro_torch.kernels.flash_attention import (  # noqa: E402
    check as flash_check)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    NEG_INF, flash_attention_ref)
from repro_torch.kernels.ssd_scan import check as ssd_check  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import ssd_scan_ref  # noqa: E402

LOG2E = 1.4426950408889634
EX2_REL_ERR = 2.0 ** -22          # ex2.approx.f32, modelled as noise
STEP = 64                         # the scan's rows a step
LANES, PER_LANE = 32, 2           # its cumulative sum: 64 rows a warp
KEYS = 64                         # flash attention's keys a tile
SSD_SEED, FLASH_SEED = 60, 80
SSD_CASES = {c[0]: c for c in ssd_check.CASES}
FLASH_F32 = {c[0]: c for c in flash_check.CASES if c[1] == torch.float32}
# the cases the split is shown to be needed at
SSD_FAIL, FLASH_FAIL = "prefill B4 S500", "S512 causal"


@pytest.fixture(autouse=True)
def _one_thread():
    # the other test workers share the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# tf32 arithmetic
# ---------------------------------------------------------------------------

def tf32(v: torch.Tensor, rounding: str = "trunc") -> torch.Tensor:
    """f32 -> tf32 (as f32): the low 13 mantissa bits dropped (the
    tensor cores' reading of an f32 word) or rounded to nearest, ties
    away (``cvt.rna.tf32.f32``)."""
    bits = v.contiguous().view(torch.int32)
    if rounding == "rna":
        bits = bits + 0x1000
    return (bits & -0x2000).view(torch.float32)


def add_toward_zero(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b (f32) rounded toward zero: the nearest sum, stepped one ulp
    toward zero (its bit pattern less one) where it lies beyond the exact
    sum, that is where TwoSum's error term and the sum differ in sign."""
    s = a + b
    t = s - a
    err = (a - (s - t)).add_(b - t)
    beyond = err.mul_(s) < 0
    return s.view(torch.int32).sub_(beyond.int()).view(torch.float32)


def product(eq: str, a: torch.Tensor, b: torch.Tensor, split: bool = True,
            rounding: str = "trunc", acc=None) -> torch.Tensor:
    """``acc + einsum(eq, a, b)`` as the tensor cores compute it: 3xTF32
    (hi hi' + hi lo' + lo hi') or, unsplit, one tf32 product, as wgmma
    steps of 8 along the contracted index, each adding its products (in
    f32) to the f32 accumulator and truncating."""
    (ia, ib), io = eq.split("->")[0].split(","), eq.split("->")[1]
    k = next(c for c in ia if c in ib and c not in io)
    ka, kb = ia.index(k), ib.index(k)
    ah, bh = tf32(a, rounding), tf32(b, rounding)
    terms = [(ah, bh)]
    if split:
        terms += [(ah, tf32(b - bh)), (tf32(a - ah), bh)]
    out = acc
    for k0 in range(0, a.shape[ka], 8):
        n = min(8, a.shape[ka] - k0)        # a ragged tail: zeros past it
        for x, y in terms:
            step = torch.einsum(eq, x.narrow(ka, k0, n), y.narrow(kb, k0, n))
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


# ---------------------------------------------------------------------------
# ssd_scan_tf32_kernel
# ---------------------------------------------------------------------------

def warp_cumsum(dA: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum over axis 1 (64 rows) in f32, in the
    kernel's order (see the module docstring)."""
    b, T, H = dA.shape
    v = dA.reshape(b, LANES, PER_LANE, H)
    loc = torch.stack([v[:, :, 0], v[:, :, 0] + v[:, :, 1]], dim=2)
    tot = loc[:, :, -1]
    d = 1
    while d < LANES:
        tot = torch.cat([tot[:, :d], tot[:, d:] + tot[:, :-d]], dim=1)
        d *= 2
    excl = torch.cat([torch.zeros_like(tot[:, :1]), tot[:, :-1]], dim=1)
    return (excl[:, :, None] + loc).reshape(b, T, H)


def ssd_model(x, dt, A, B, C, D, split: bool = True,
              rounding: str = "trunc", seed: int = 0):
    """y and the final state (f32) as ``ssd_scan_tf32_kernel`` rounds
    them: steps of 64 rows (the tail padded by dt = 0 rows, as the
    kernel's TMA fills rows past S with zeros), per step
      G = C B^T, M = G * 2^((L_t - L_j) log2 e) * dt_j (j <= t),
      y = exp(L) (C state^T) + M x + D x,
      state = exp(L_Q) state + x^T (w B), w = 2^((L_Q - L) log2 e) dt,
    every product 3xTF32."""
    b, S, H, P = x.shape
    pad = (-S) % STEP
    x, dt, B, C = (torch.nn.functional.pad(t, (0, 0) * (t.ndim - 2)
                                           + (0, pad))
                   for t in (x, dt, B, C))
    ex2 = Ex2(seed)
    prod = functools.partial(product, split=split, rounding=rounding)
    tri = torch.ones((STEP, STEP), dtype=torch.bool).tril()[None, :, :, None]
    state = torch.zeros((b, H, P, B.shape[-1]))
    ys = []
    for t0 in range(0, S + pad, STEP):
        xc, dtc = x[:, t0:t0 + STEP], dt[:, t0:t0 + STEP]
        Bc, Cc = B[:, t0:t0 + STEP], C[:, t0:t0 + STEP]
        L = warp_cumsum(dtc * A)                               # (b,t,H)
        LQ = L[:, -1]
        G = prod("btn,bjn->btj", Cc, Bc)[..., None]            # (b,t,j,1)
        diff = L[:, :, None] - L[:, None]                      # (b,t,j,H)
        M = torch.where(tri, G * ex2(diff * LOG2E) * dtc[:, None], 0.0)
        # the kernel's y^T = state C^T (the state as the A operand)
        y = torch.exp(L)[..., None] * prod("bhpn,btn->bthp", state, Cc)
        y = prod("btjh,bjhp->bthp", M, xc, acc=y)
        ys.append(y + D[None, None, :, None] * xc)
        w = ex2((LQ[:, None] - L) * LOG2E) * dtc               # (b,j,H)
        Bw = w[..., None] * Bc[:, :, None, :]                  # (b,j,H,N)
        state = prod("bjhp,bjhn->bhpn", xc, Bw,
                     acc=torch.exp(LQ)[..., None, None] * state)
    return torch.cat(ys, dim=1)[:, :S], state


@functools.lru_cache(maxsize=None)
def ssd_case(name: str):
    """The card check's f32 operands of a case, drawn on the CPU, and
    the plain version's y and state on them."""
    i = list(SSD_CASES).index(name)
    _, b, S, H, P, N, chunk = SSD_CASES[name]
    args = ssd_check.operands(b, S, H, P, N, torch.float32, "cpu",
                              SSD_SEED + i)
    with torch.inference_mode():
        return args, ssd_scan_ref(*args, chunk=chunk)


def ssd_outside(name: str, **variant) -> int:
    args, (y_plain, state_plain) = ssd_case(name)
    with torch.inference_mode():
        y, state = ssd_model(*args, **variant)
    return ssd_check.within_tolerance(y, y_plain, state, state_plain)


@pytest.mark.parametrize("name", list(SSD_CASES))
def test_scan_model_holds_the_card_tolerance(name):
    assert ssd_outside(name) == 0


@pytest.mark.parametrize("rounding", ["trunc", "rna"])
def test_scan_with_one_tf32_product_fails_it(rounding):
    assert ssd_outside(SSD_FAIL, split=False, rounding=rounding) > 0


def test_the_scan_order_is_a_cumulative_sum():
    dA = -torch.rand((2, STEP, 3), dtype=torch.float64)
    torch.testing.assert_close(warp_cumsum(dA), torch.cumsum(dA, dim=1))


# ---------------------------------------------------------------------------
# flash_attention_tf32_kernel
# ---------------------------------------------------------------------------

def flash_model(q, k, v, causal: bool, kv_valid: int = 0,
                split: bool = True, rounding: str = "trunc",
                seed: int = 0) -> torch.Tensor:
    """The output as ``flash_attention_tf32_kernel`` rounds it."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    n_valid = kv_valid if 0 < kv_valid < Skv else Skv
    scale_log2 = float(np.float32(np.float32(1.0 / math.sqrt(D))
                                  * np.float32(LOG2E)))
    ex2 = Ex2(seed)
    prod = functools.partial(product, split=split, rounding=rounding)
    qh = q.reshape(B, Sq, Hkv, Hq // Hkv, D)
    eq, half = "bqhgd,bkhd->bqhgk", D // 2
    s_all = (prod(eq, qh[..., :half], k[..., :half])
             + prod(eq, qh[..., half:], k[..., half:])) * scale_log2
    qpos = torch.arange(Sq) + (Skv - Sq)
    m = torch.full(qh.shape[:-1] + (1,), NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qh)
    for k0 in range(0, n_valid, KEYS):
        s = s_all[..., k0:k0 + KEYS]
        kpos = torch.arange(k0, k0 + s.shape[-1])
        vis = (kpos < n_valid)[None, :].expand(Sq, -1)
        if causal:
            vis = vis & (kpos[None, :] <= qpos[:, None])
        vis = vis[None, :, None, None, :]
        mx = torch.where(vis, s, NEG_INF).amax(dim=-1, keepdim=True)
        m_new = torch.maximum(m, mx)
        alpha = ex2(m - m_new)
        p = torch.where(vis, ex2(s - m_new), 0.0)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + prod("bqhgk,bkhd->bqhgd", p,
                                 v[:, k0:k0 + KEYS])
        m = m_new
    inv = torch.where(l == 0.0, 0.0, 1.0 / l)
    return (acc * inv).reshape(B, Sq, Hq, D)


@functools.lru_cache(maxsize=None)
def flash_case(name: str):
    """The card check's f32 operands of a case, drawn on the CPU, and
    the plain version's output on them."""
    case = FLASH_F32[name]
    q, k, v = flash_check.case_operands(
        case, "cpu", FLASH_SEED + list(FLASH_F32).index(name))
    with torch.inference_mode():
        return (q, k, v), flash_attention_ref(q, k, v, causal=case[4],
                                              kv_valid=case[5])


def flash_model_of(name: str, **variant) -> torch.Tensor:
    (q, k, v), _ = flash_case(name)
    case = FLASH_F32[name]
    with torch.inference_mode():
        return flash_model(q, k, v, case[4], case[5], **variant)


@pytest.mark.parametrize("name", list(FLASH_F32))
def test_attention_model_holds_the_card_tolerance(name):
    got = flash_model_of(name)
    flash_check.kernel_agrees(got, flash_case(name)[1], name)
    _, Sq, Skv, causal = FLASH_F32[name][1:5]
    if causal and Sq > Skv:
        assert not got[:, :Sq - Skv].any()       # no visible key: 0


SERVE_F32 = {c[0]: c for c in flash_check.SERVE_CASES
             if c[1] == torch.float32}


@pytest.mark.parametrize("name", list(SERVE_F32))
def test_attention_model_holds_the_card_tolerance_at_serve_cases(name):
    """The encdec and vlm cells' f32 cases (up to 1524 keys, 24 tiles of
    O = alpha O + P V) at the card check's own operands, batch row 0 and
    KV head 0 with its group of query heads."""
    case = SERVE_F32[name]
    _, _, Sq, Skv, causal, kv_valid, (hq, hkv, d) = case
    q, k, v = flash_check.case_operands(
        case, "cpu", FLASH_SEED + 40 + list(SERVE_F32).index(name))
    q, k, v = q[:1, :, :hq // hkv], k[:1, :, :1], v[:1, :, :1]
    with torch.inference_mode():
        want = flash_attention_ref(q, k, v, causal=causal,
                                   kv_valid=kv_valid)
        got = flash_model(q, k, v, causal, kv_valid)
    flash_check.kernel_agrees(got, want, name)


@pytest.mark.parametrize("rounding", ["trunc", "rna"])
def test_attention_with_one_tf32_product_fails_it(rounding):
    got = flash_model_of(FLASH_FAIL, split=False, rounding=rounding)
    with pytest.raises(AssertionError):
        flash_check.kernel_agrees(got, flash_case(FLASH_FAIL)[1],
                                  FLASH_FAIL)


# ---------------------------------------------------------------------------
# the models against the JAX package's kernels (interpret mode)
# ---------------------------------------------------------------------------

def test_scan_model_matches_the_pallas_kernel():
    rng = np.random.default_rng(7)
    b, S, H, P, N = 1, 64, 4, 64, 128
    x = rng.standard_normal((b, S, H, P))
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)) - 2.0))
    A = -rng.uniform(1.0, 16.0, H)
    B = rng.standard_normal((b, S, N))
    C = rng.standard_normal((b, S, N))
    D = np.ones(H)
    arrs = [np.asarray(a, np.float32) for a in (x, dt, A, B, C, D)]
    yj, sj = ssd_scan_pallas(*(jnp.asarray(a) for a in arrs), chunk=S,
                             interpret=True)
    with torch.inference_mode():
        y, state = ssd_model(*(torch.from_numpy(a) for a in arrs))
    assert ssd_check.within_tolerance(
        y, torch.from_numpy(np.asarray(yj)), state,
        torch.from_numpy(np.asarray(sj))) == 0


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_attention_model_matches_the_pallas_kernel(causal):
    rng = np.random.default_rng(8)
    q, k, v = (np.asarray(rng.standard_normal(s), np.float32)
               for s in ((1, 64, 4, 64), (1, 64, 2, 64), (1, 64, 2, 64)))
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  block_q=64, block_k=64, interpret=True)
    with torch.inference_mode():
        got = flash_model(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=causal)
    flash_check.kernel_agrees(got, torch.from_numpy(np.asarray(want)),
                              "small case")


# ---------------------------------------------------------------------------
# the register A operand: an accumulator fed with its K order permuted
# ---------------------------------------------------------------------------

def k_col(slot: int) -> int:
    """The accumulator column a K slot of an A operand taken from an
    accumulator holds, within its group of 8 (hopper.cuh): 0 2 4 6 1 3 5
    7."""
    return (slot & ~7) | ((slot & 3) << 1) | ((slot >> 2) & 1)


def k_slot(col: int) -> int:
    """The inverse (``hopper::tf32_k_slot``)."""
    return (col & ~7) | ((col & 1) << 2) | ((col & 7) >> 1)


def test_the_k_permutation_round_trips():
    assert [k_col(s) for s in range(8)] == [0, 2, 4, 6, 1, 3, 5, 7]
    assert all(k_slot(k_col(s)) == s for s in range(128))


def test_an_accumulator_fed_as_the_a_operand_gives_the_product():
    """Lane l, register e of an m64n64 f32 accumulator's 8-column block j
    holds row l / 4 + 8 (e / 2) (of its warp's 16), column 8 j + 2 (l %
    4) + e % 2; the m64k8 tf32 A operand's registers a0..a3 hold row l /
    4 (+ 8 for a1, a3), column l % 4 (+ 4 for a2, a3).  Feeding (d0, d2,
    d1, d3) of block j as the A operand of k-step j, against a B operand
    whose K row s holds row k_col(s) of B, gives the product D B; the
    state's columns written through the B tile's rows k_col(n) make the
    state's accumulator the A operand in natural K order."""
    rng = np.random.default_rng(0)
    Dm = rng.integers(-3, 4, (16, 64)).astype(np.float64)   # one warp
    Bm = rng.integers(-3, 4, (64, 64)).astype(np.float64)
    # the accumulator, by lane and register
    acc = np.zeros((32, 32))
    for lane in range(32):
        for j in range(8):
            for e in range(4):
                acc[lane, 4 * j + e] = Dm[lane // 4 + 8 * (e // 2),
                                          8 * j + 2 * (lane % 4) + e % 2]
    out = np.zeros((16, 64))
    for j in range(8):                          # k-step j: K slots 8 j ..
        b_rows = np.stack([Bm[8 * j + k_col(s)] for s in range(8)])
        for lane in range(32):
            a = acc[lane, [4 * j, 4 * j + 2, 4 * j + 1, 4 * j + 3]]
            r, c = lane // 4, lane % 4
            for reg, (row, slot) in enumerate(((r, c), (r + 8, c),
                                               (r, c + 4), (r + 8, c + 4))):
                out[row] += a[reg] * b_rows[slot]
    np.testing.assert_array_equal(out, Dm @ Bm)
    # the state: accumulator column c holds state column k_slot(c), so
    # slot s of k-step j reads column k_col(s) = state column s
    perm = [k_slot(c) for c in range(64)]
    assert [perm[k_col(s)] for s in range(64)] == list(range(64))
