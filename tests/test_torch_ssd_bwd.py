"""The SSD scan's gradient on the CPU: the plain backward
(``ssd_scan_bwd_ref``, the card kernel's chunk formulas written out)
against ``jax.grad`` of the JAX package's ``ssd_scan`` (its
``_chunked_jnp`` on the CPU) and against autograd through the port's
plain scans; the repair of the plain scan's masked exp (its forward bits
unchanged, its gradient finite where the reference's is NaN); and a
reduced ``mamba2-370m`` train step at chunk 128 whose gradients stay
finite where the unrepaired scan's are NaN.

Tolerances (f32, each output against max |want|): ``GRAD_RTOL`` 2e-5.
The packages sum in other orders; the largest gaps read are dA's (a sum
over b S rows of terms that cancel): 2.6e-6 of max against autograd
through the chunked scan, 2.1e-6 against ``jax.grad``, 4.5e-7 against
the recurrence; every other output stays under 1.3e-6.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan.ops import ssd_scan as jx_scan  # noqa: E402

import repro_torch.models.ssm as lm_ssm  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    ssd_scan, ssd_scan_bwd, ssd_scan_bwd_ref, ssd_scan_ref,
    ssd_scan_seq_ref)
from repro_torch.kernels.ssd_scan.ops import _padded  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import build_train_step  # noqa: E402

GRAD_RTOL = 2e-5
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD")
# (b, S, H, P, N, chunk, dt scale, d_final): a ragged S with chunk < S
# and a final-state gradient, S = Q, and several chunks at larger dt
# (the reference stays finite at each)
CASES = ((2, 45, 3, 8, 6, 16, 0.5, True),
         (1, 32, 2, 4, 4, 32, 0.5, False),
         (2, 96, 2, 8, 8, 32, 1.5, True))
# the overflow case: one chunk of 128 rows, dt 0.1, A (-16, -1): a
# head's sum of |dt A| over the chunk is 204.8 > 88.7, where exp
# overflows in f32
OVERFLOW = dict(b=1, S=128, H=2, P=4, N=8, chunk=128, dt=0.1,
                A=(-16.0, -1.0), seed=7)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, S, H, P, N, dt_scale, final, seed):
    """x, dt, A, B, C, D, dy and d_final (or None) as numpy f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P))
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)))) * dt_scale
    A = -np.exp(rng.standard_normal(H) * 0.3)
    B = rng.standard_normal((b, S, N)) * 0.5
    C = rng.standard_normal((b, S, N)) * 0.5
    D = rng.standard_normal(H) * 0.1
    dy = rng.standard_normal((b, S, H, P))
    dfin = rng.standard_normal((b, H, P, N)) if final else None
    return [None if a is None else np.asarray(a, np.float32)
            for a in (x, dt, A, B, C, D, dy, dfin)]


def _overflow_inputs():
    o = OVERFLOW
    rng = np.random.default_rng(o["seed"])
    b, S, H, P, N = o["b"], o["S"], o["H"], o["P"], o["N"]
    x = rng.standard_normal((b, S, H, P))
    dt = np.full((b, S, H), o["dt"])
    A = np.asarray(o["A"])
    B = rng.standard_normal((b, S, N))
    C = rng.standard_normal((b, S, N))
    D = np.ones(H)
    dy = rng.standard_normal((b, S, H, P))
    return [np.asarray(a, np.float32) for a in (x, dt, A, B, C, D, dy)]


def _autograd(fn, args, dy, dfin, **kw):
    args = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, fin = fn(*args, **kw)
    loss = (y * torch.from_numpy(dy)).sum()
    if dfin is not None:
        loss = loss + (fin * torch.from_numpy(dfin)).sum()
    return torch.autograd.grad(loss, args)


def _jax_grads(args, dy, dfin, chunk):
    (y, fin), vjp = jax.vjp(lambda *a: jx_scan(*a, chunk=chunk),
                            *(jnp.asarray(a) for a in args))
    return vjp((jnp.asarray(dy), jnp.zeros_like(fin) if dfin is None
                else jnp.asarray(dfin)))


def _assert_close(got, want, label, rtol=GRAD_RTOL):
    for name, g, w in zip(NAMES, got, want):
        g = np.asarray(g, np.float64)
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape, (label, name, g.shape, w.shape)
        assert np.isfinite(g).all(), (label, name)
        gap = np.abs(g - w).max() / np.abs(w).max()
        assert gap <= rtol, (label, name, gap)


def _bwd_ref(args, dy, dfin, chunk):
    t = [torch.from_numpy(a) for a in args]
    return [g.numpy() for g in ssd_scan_bwd_ref(
        *t, torch.from_numpy(dy),
        None if dfin is None else torch.from_numpy(dfin), chunk=chunk)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"S{c[1]}Q{c[5]}")
def test_plain_backward_matches_jax_grad(case):
    b, S, H, P, N, chunk, dts, final = case
    *args, dy, dfin = _inputs(b, S, H, P, N, dts, final, seed=S)
    want = _jax_grads(args, dy, dfin, chunk)
    _assert_close(_bwd_ref(args, dy, dfin, chunk), want, "jax.grad")


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"S{c[1]}Q{c[5]}")
def test_plain_backward_matches_autograd_of_the_plain_scans(case):
    b, S, H, P, N, chunk, dts, final = case
    *args, dy, dfin = _inputs(b, S, H, P, N, dts, final, seed=S)
    got = _bwd_ref(args, dy, dfin, chunk)
    _assert_close(got, _autograd(ssd_scan_ref, args, dy, dfin, chunk=chunk),
                  "autograd of ssd_scan_ref")
    _assert_close(got, _autograd(ssd_scan_seq_ref, args, dy, dfin),
                  "autograd of ssd_scan_seq_ref")
    # the CPU wrapper is the plain backward
    t = [torch.from_numpy(a) for a in args]
    wrapped = ssd_scan_bwd(*t, torch.from_numpy(dy), None if dfin is None
                           else torch.from_numpy(dfin), chunk=chunk)
    for g, w in zip(wrapped, got):
        assert np.array_equal(g.numpy(), w)


def test_overflow_case_is_finite_and_matches_the_recurrence():
    *args, dy = _overflow_inputs()
    chunk = OVERFLOW["chunk"]
    want = _autograd(ssd_scan_seq_ref, args, dy, None)
    _assert_close(_bwd_ref(args, dy, None, chunk), want,
                  "plain backward, overflow")
    _assert_close(_autograd(ssd_scan_ref, args, dy, None, chunk=chunk),
                  want, "autograd of the repaired ssd_scan_ref, overflow")


def test_reference_gradient_is_nan_in_the_overflow_case():
    """The stated difference: jax.grad of the reference's scan is NaN in
    dt and A where the port's is finite (ROADMAP, Semantics changed on
    purpose)."""
    *args, dy = _overflow_inputs()
    got = _jax_grads(args, dy, None, OVERFLOW["chunk"])
    nan = {name: bool(np.isnan(np.asarray(g)).any())
           for name, g in zip(NAMES, got)}
    assert nan == {"dx": False, "ddt": True, "dA": True, "dB": False,
                   "dC": False, "dD": False}, nan


def _unrepaired_ref(x, dt, A, B, C, D, chunk=128):
    """``ssd_scan_ref`` as it was before the repair: exp, then the mask
    (the reference's ``_chunked_jnp``)."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, S)
    x, dt, B, C = _padded(x, dt, B, C, Q)
    A, D = A.float(), D.float()
    tri = torch.ones((Q, Q), dtype=torch.bool).tril()
    state = torch.zeros((b, H, P, N))
    ys = []
    for c0 in range(0, x.shape[1], Q):
        xc, dtc = x[:, c0:c0 + Q].float(), dt[:, c0:c0 + Q].float()
        Bc, Cc = B[:, c0:c0 + Q].float(), C[:, c0:c0 + Q].float()
        L = torch.cumsum(dtc * A, dim=1)
        diff = L[:, :, None, :] - L[:, None, :, :]
        decay = torch.where(tri[None, :, :, None], torch.exp(diff), 0.0)
        M = torch.einsum("btn,bsn->bts", Cc, Bc)[..., None] * decay
        y = torch.einsum("btsh,bshp->bthp", M, xc * dtc[..., None])
        y = y + torch.exp(L)[..., None] * torch.einsum(
            "btn,bhpn->bthp", Cc, state)
        y = y + D[None, None, :, None] * xc
        LQ = L[:, -1, :]
        w = torch.exp(LQ[:, None, :] - L) * dtc
        state = torch.exp(LQ)[..., None, None] * state + torch.einsum(
            "bshp,bsn->bhpn", xc * w[..., None], Bc)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S].to(x.dtype), state


def test_repair_keeps_the_forward_bits():
    *args, _ = _overflow_inputs()
    cases = [(args, OVERFLOW["chunk"])]
    for b, S, H, P, N, chunk, dts, final in CASES:
        cases.append((_inputs(b, S, H, P, N, dts, final, seed=S)[:6], chunk))
    for a, chunk in cases:
        t = [torch.from_numpy(v) for v in a]
        for got, want in zip(ssd_scan_ref(*t, chunk=chunk),
                             _unrepaired_ref(*t, chunk=chunk)):
            assert torch.equal(got, want)


def _train_grads(cfg, dt_bias: float, scan):
    """The first step's gradients (``TrainStep.grads``) of a fresh
    reduced model (seed 0) with every ``dt_bias`` set to ``dt_bias``, the
    scan routed through ``scan``."""
    model = build_model(cfg)
    weights = model.init_params(0, device="cpu")
    with torch.no_grad():
        for name, p in weights.named_parameters():
            if name.endswith("dt_bias"):
                p.fill_(dt_bias)
    ts = build_train_step(model, adamw(weights.parameters()))
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int64))}
    saved = lm_ssm.ssd_scan
    lm_ssm.ssd_scan = scan
    try:
        g, _ = ts.grads(weights, batch)
    finally:
        lm_ssm.ssd_scan = saved
    return g


@pytest.mark.parametrize("dt_bias,old_finite", [(-3.0, True), (3.0, False)],
                         ids=["small-dt", "overflowing-dt"])
def test_train_step_at_chunk_128(dt_bias, old_finite):
    """mamba2-370m reduced, f32, chunks of 128 at S 64 (one chunk):
    dt_bias -3 gives dt near 0.05 (a chunk's |dt A| sum under the
    overflow), 3 gives dt near 3 (far over it).  The repaired scan's
    gradients are finite; where the unrepaired scan's are finite too,
    they are the same bits."""
    base = get_config("mamba2-370m").reduced()
    cfg = dataclasses.replace(base, dtype="float32", ssm=dataclasses.replace(
        base.ssm, chunk_size=128))
    new = _train_grads(cfg, dt_bias, ssd_scan)
    old = _train_grads(cfg, dt_bias, lambda *a, chunk: _unrepaired_ref(
        *a, chunk=chunk))
    assert all(bool(torch.isfinite(g).all()) for g in new)
    old_ok = all(bool(torch.isfinite(g).all()) for g in old)
    assert old_ok == old_finite
    if old_ok:
        assert all(torch.equal(a, b) for a, b in zip(new, old))


def test_bound_counts_the_kernels_steps_and_reads_bytes_at_the_train_call():
    """``check.bwd_bound`` counts the pair terms at the kernel's 64-row
    steps (the gradient does not depend on the forward's chunk), so at
    mamba2-370m's train call (B 4, S 1024, H 32, P 64, N 128, bf16) the
    bytes bound it: 55.6 MB at 3.35 TB/s over 14.0 GFLOP at 989 TFLOP/s;
    a ragged S counts its last step's rows alone."""
    from repro_torch.kernels.ssd_scan import check
    n_bytes, n_ops = check.bwd_bound(4, 1024, 32, 64, 128, 2)
    R = check.BWD_ROWS
    step = 4 * 32 * (R * (R + 1) * 384 + 10 * R * 64 * 128) \
        + 4 * R * (R + 1) * 128
    assert R == 64 and n_ops == 16 * step and n_bytes == 55_574_528
    assert n_bytes / 3.35e12 > n_ops / 989e12
    _, ragged = check.bwd_bound(1, 70, 2, 64, 128, 2)
    assert ragged == sum(2 * (r * (r + 1) * 384 + 10 * r * 64 * 128)
                         + r * (r + 1) * 128 for r in (64, 6))
