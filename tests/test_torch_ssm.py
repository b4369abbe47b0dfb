"""The port's Mamba2 serving stack (``ssm`` family) against the JAX
package's, on the CPU.

The SSD scan: the port's plain versions (``ssd_scan_ref``, chunked, and
``ssd_scan_seq_ref``, the per-timestep recurrence) against the
reference's Pallas kernel in interpret mode, its ``_chunked_jnp`` and
its recurrence oracle, at the reference's atol of 1e-4 (f32; 2e-2 of
max |y| with bf16 x, B, C).  The model: ``mamba2-370m`` reduced (2
layers, d_model 64, 8 SSM heads of P 16, N 16, chunk 16, vocab 256) at
float32 and at the config's bfloat16, with the reference's
``init_params(0)`` weights carried over by ``params.lm_from_params`` and
inputs from seeded numpy; logits held to 1e-4 of max |logit| in f32 and
2e-2 in bf16 (``test_torch_lm.assert_close``), greedy tokens equal in
f32.  The decode states (SSM state and conv tail) are held to 1e-4 of
their max in f32; in bf16 to 2e-2 of their RMS (``assert_state_close``):
a state sums many bf16-rounded inputs of the layers below, and single
entries of a deeper layer's state move by up to 2.3% of its max between
the two frameworks (measured; 0.8-1.1% of its RMS), by rounding alone.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.ssm as jx_ssm  # noqa: E402
import repro.models.transformer as jx_tf  # noqa: E402
from repro.configs import get_config as jx_get  # noqa: E402
from repro.kernels.ssd_scan.kernel import ssd_scan_pallas  # noqa: E402
from repro.kernels.ssd_scan.ops import (  # noqa: E402
    _chunked_jnp as jx_chunked, ssd_scan as jx_scan, ssd_step as jx_step)
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jx_seq  # noqa: E402
from repro.models.model import build_model as jx_build  # noqa: E402
from repro.serve import ServeEngine as JxServe  # noqa: E402

import repro_torch.models.transformer as tf  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    ssd_scan, ssd_scan_ref, ssd_scan_seq_ref, ssd_step)
from repro_torch.models.common import ParamSpec, init_tensor  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.ssm import init_ssm_state  # noqa: E402
from repro_torch.params import lm_from_params  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from test_torch_lm import (DTYPES, assert_close, f32, jx_arr,  # noqa: E402
                           port_cfg, pt_arr)


@pytest.fixture(autouse=True)
def _one_thread():
    # small eager ops run faster on one thread at these sizes
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------

def _scan_inputs(b, S, H, P, N, seed):
    """x, dt (post-softplus), A < 0, B, C, D as numpy f32, the
    distributions of tests/test_kernels.py."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P))
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)))) * 0.5
    A = -np.exp(rng.standard_normal(H) * 0.3)
    B = rng.standard_normal((b, S, N)) * 0.5
    C = rng.standard_normal((b, S, N)) * 0.5
    D = rng.standard_normal(H) * 0.1
    return [np.asarray(a, np.float32) for a in (x, dt, A, B, C, D)]


def assert_state_close(got, want, dtype: str) -> None:
    if dtype == "float32":
        assert_close(got, want, dtype)
        return
    got, want = f32(got), f32(want)
    assert got.shape == want.shape
    rms = float(np.sqrt(((got - want) ** 2).mean()))
    assert rms <= 2e-2 * float(np.sqrt((want ** 2).mean())), rms


def _close(got, want, atol=1e-4):
    np.testing.assert_allclose(f32(got), f32(want), atol=atol, rtol=0)


# (b, S, H, P, N, chunk): tests/test_kernels.py's three, S not a multiple
# of the chunk, S below the chunk (Q = S)
SCAN_SHAPES = [(2, 64, 4, 16, 8, 16), (1, 128, 2, 32, 16, 32),
               (2, 96, 3, 8, 8, 32), (1, 25, 2, 8, 8, 16),
               (2, 61, 2, 16, 16, 128)]


@pytest.mark.parametrize("b,S,H,P,N,chunk", SCAN_SHAPES)
def test_ssd_scan_matches_jax(b, S, H, P, N, chunk):
    """y and the final state of the port's wrapper (padding, then the
    chunked plain version) and of its recurrence, against the
    reference's oracle, wrapper and Pallas kernel (interpret mode, on
    the same padded inputs)."""
    arrs = _scan_inputs(b, S, H, P, N, seed=S)
    jx = [jnp.asarray(a) for a in arrs]
    pt = [torch.from_numpy(a) for a in arrs]
    y, s = ssd_scan(*pt, chunk=chunk)
    assert y.shape == (b, S, H, P) and s.shape == (b, H, P, N)
    assert s.dtype == torch.float32
    yq, sq = ssd_scan_seq_ref(*pt)
    yr, sr = jx_seq(*jx)
    yw, sw = jx_scan(*jx, chunk=chunk)
    Q = min(chunk, S)
    pad = (-S) % Q
    padded = [jnp.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
              if a.ndim >= 3 else a for a in jx]
    yp, sp = ssd_scan_pallas(*padded, chunk=Q, interpret=True)
    for got in ((y, s), (yq, sq)):
        for want in ((yr, sr), (yw, sw), (yp[:, :S], sp)):
            _close(got[0], want[0])
            _close(got[1], want[1])
    yc, sc = jx_chunked(*padded, Q)
    yo, so = ssd_scan_ref(*pt, chunk=chunk)
    _close(yo, yc[:, :S])
    _close(so, sc)


@pytest.mark.parametrize("chunk", [16, 128])
def test_ssd_scan_bfloat16_matches_jax(chunk):
    """x, B, C in bf16 (as the model feeds them): y in bf16 within 2e-2
    of max |y| of the reference's chunked path; the state in f32."""
    arrs = _scan_inputs(2, 40, 3, 16, 16, seed=7)
    jx = [jnp.asarray(a) for a in arrs]
    pt = [torch.from_numpy(a) for a in arrs]
    for i in (0, 3, 4):
        jx[i] = jx[i].astype(jnp.bfloat16)
        pt[i] = pt[i].to(torch.bfloat16)
    y, s = ssd_scan(*pt, chunk=chunk)
    yw, sw = jx_scan(*jx, chunk=chunk)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    assert_close(y, yw, "bfloat16")
    _close(s, sw)


def test_ssd_scan_decay_mask_takes_no_nan():
    """Steps of dt A near -30 make L_t - L_j thousands above the
    diagonal: exp there is inf and must be selected away, not
    multiplied by 0."""
    x, dt, A, B, C, D = _scan_inputs(1, 64, 2, 8, 8, seed=3)
    dt = dt * 0 + 20.0
    A = A * 0 - 1.5
    pt = [torch.from_numpy(a) for a in (x, dt, A, B, C, D)]
    y, s = ssd_scan(*pt, chunk=32)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    yr, sr = jx_seq(*(jnp.asarray(a) for a in (x, dt, A, B, C, D)))
    _close(y, yr)
    _close(s, sr)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_step_matches_jax_and_extends_the_scan(dtype):
    """The decode update against the reference's, and scan(S) then one
    step against scan(S + 1)."""
    b, S, H, P, N = 2, 32, 3, 8, 16
    x, dt, A, B, C, D = _scan_inputs(b, S + 1, H, P, N, seed=11)
    rng = np.random.default_rng(12)
    state = rng.standard_normal((b, H, P, N)).astype(np.float32)
    xt = x[:, S]
    got = ssd_step(torch.from_numpy(state), pt_arr(xt, dtype),
                   torch.from_numpy(dt[:, S]), torch.from_numpy(A),
                   torch.from_numpy(B[:, S]), torch.from_numpy(C[:, S]),
                   torch.from_numpy(D))
    want = jx_step(jnp.asarray(state), jx_arr(xt, dtype),
                   jnp.asarray(dt[:, S]), jnp.asarray(A),
                   jnp.asarray(B[:, S]), jnp.asarray(C[:, S]),
                   jnp.asarray(D))
    assert got[0].dtype == getattr(torch, dtype)
    assert_close(got[0], want[0], dtype)
    _close(got[1], want[1], 1e-5)
    pt = [torch.from_numpy(a) for a in (x, dt, A, B, C, D)]
    y_full, s_full = ssd_scan(*pt, chunk=16)
    _, s_pre = ssd_scan(*(a[:, :S] if a.ndim >= 3 else a for a in pt),
                        chunk=16)
    y1, s1 = ssd_step(s_pre, pt[0][:, S], pt[1][:, S], pt[2], pt[3][:, S],
                      pt[4][:, S], pt[5])
    _close(y1, y_full[:, S], 1e-5)
    _close(s1, s_full, 1e-5)


def test_ssd_scan_wrapper_checks_and_dispatch():
    """A CPU tensor takes the plain version (no launch); shapes the
    kernel cannot take and other devices raise."""
    pt = [torch.from_numpy(a) for a in _scan_inputs(1, 8, 2, 16, 16, 0)]
    before = ssd_scan.launches
    y, s = ssd_scan(*pt)
    assert ssd_scan.launches == before and y.device.type == "cpu"
    with pytest.raises(ValueError):
        ssd_scan(pt[0], pt[1], pt[2], pt[3][:, :4], pt[4], pt[5])
    with pytest.raises(ValueError):
        ssd_scan(*pt, chunk=0)
    meta = [torch.empty(a.shape, device="meta") for a in pt]
    with pytest.raises(ValueError):
        ssd_scan(*meta)


# ---------------------------------------------------------------------------
# the SSM block
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def pair(dtype: str):
    """(reference config, model, its init_params(0) tree as numpy, port
    config, model, weights carried over from that tree)."""
    jc = dataclasses.replace(jx_get("mamba2-370m").reduced(), dtype=dtype)
    jm = jx_build(jc)
    tree = jax.tree.map(np.asarray, jm.init_params(0))
    pc = port_cfg(jc)
    return jc, jm, tree, pc, build_model(pc), lm_from_params(pc, tree,
                                                             device="cpu")


def _layer0(tree):
    return jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"]["ssm"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_block_full_matches(dtype):
    """``SSMBlock.forward`` against ``ssm_block_full`` over two and a
    half chunks: the output, the final SSM state and the pre-conv tail."""
    jc, _, tree, _, _, params = pair(dtype)
    x = np.random.default_rng(20).standard_normal((2, 37, jc.d_model))
    want, wst = jx_ssm.ssm_block_full(_layer0(tree), jx_arr(x, dtype), jc,
                                      return_state=True)
    with torch.inference_mode():
        got, gst = params.layers[0].ssm(pt_arr(x, dtype), return_state=True)
    assert got.dtype == getattr(torch, dtype)
    assert gst["ssm"].dtype == torch.float32
    assert gst["conv"].dtype == getattr(torch, dtype)
    assert_close(got, want, dtype)
    for k in ("ssm", "conv"):
        assert tuple(gst[k].shape) == wst[k].shape
        assert_state_close(gst[k], wst[k], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_block_decode_matches(dtype):
    """Two decode steps from a random state: outputs, and both states
    updated in place."""
    jc, _, tree, pc, _, params = pair(dtype)
    rng = np.random.default_rng(21)
    st0 = init_ssm_state(pc, 3, getattr(torch, dtype), "cpu")
    ssm0 = rng.standard_normal(tuple(st0["ssm"].shape)) * 0.3
    conv0 = rng.standard_normal(tuple(st0["conv"].shape))
    wst = {"ssm": jnp.asarray(ssm0, jnp.float32),
           "conv": jx_arr(conv0, dtype)}
    gst = {"ssm": torch.from_numpy(ssm0).float(),
           "conv": pt_arr(conv0, dtype)}
    ids = {k: id(v) for k, v in gst.items()}
    for step in range(2):
        x = rng.standard_normal((3, 1, jc.d_model))
        want, wst = jx_ssm.ssm_block_decode(_layer0(tree), jx_arr(x, dtype),
                                            wst, jc)
        with torch.inference_mode():
            got = params.layers[0].ssm.decode(pt_arr(x, dtype), gst)
        assert got.shape == (3, 1, jc.d_model)
        assert_close(got, want, dtype)
        for k in ("ssm", "conv"):
            assert id(gst[k]) == ids[k]
            assert_state_close(gst[k], wst[k], dtype)


# ---------------------------------------------------------------------------
# configs, specs, init
# ---------------------------------------------------------------------------

def test_registry_holds_mamba2_as_the_reference_does():
    cfg = get_config("mamba2-370m")
    assert dataclasses.asdict(cfg) == \
        dataclasses.asdict(jx_get("mamba2-370m"))
    assert cfg.param_count() == 368_338_432
    s = cfg.ssm
    assert (cfg.n_layers, cfg.d_model, s.d_inner(cfg.d_model),
            s.n_heads(cfg.d_model), s.head_dim, s.d_state, s.d_conv) == \
        (48, 1024, 2048, 32, 64, 128, 4)
    assert tf.param_specs(cfg)[2].shape == (48, 1024, 4384)    # in_proj


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_ssm_param_specs_are_the_reference_tree(reduced):
    ref = jx_get("mamba2-370m")
    ref = ref.reduced() if reduced else ref
    shapes = jx_build(ref).param_shapes()
    flat = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    model = build_model(port_cfg(ref))
    assert {s.path: s.shape for s in model.param_specs()} == flat
    assert model.param_count() == ref.param_count() \
        == jx_build(ref).param_count()
    if not reduced:
        assert model.param_count() == 368_338_432


def test_ssm_inits_land_in_their_ranges():
    """``ssm_a``: A_log = log U[1, 16]; ``ssm_dt``: softplus(dt_bias) in
    [1e-3, 1e-1]; name-seeded, so the same seed gives the same numbers;
    ``conv_w`` normal with fan_in = d_conv."""
    a = init_tensor(ParamSpec("layers/ssm/A_log", (4, 4096), "ssm_a"), 0,
                    "cpu")
    assert float(a.min()) >= 0.0 and float(a.max()) <= np.log(16.0) + 1e-6
    assert abs(float(torch.exp(a).mean()) - 8.5) < 0.2
    dt = init_tensor(ParamSpec("layers/ssm/dt_bias", (4, 4096), "ssm_dt"),
                     0, "cpu")
    sp = torch.nn.functional.softplus(dt)
    assert float(sp.min()) >= 1e-3 * (1 - 1e-5)
    assert float(sp.max()) <= 1e-1 * (1 + 1e-5)
    assert float(dt.max()) < 0.0
    assert torch.equal(dt, init_tensor(
        ParamSpec("layers/ssm/dt_bias", (4, 4096), "ssm_dt"), 0, "cpu"))
    _, _, _, _, pm, _ = pair("float32")
    params = pm.init_params(0, device="cpu")
    w = torch.stack([layer.ssm.conv_w for layer in params.layers])
    assert abs(float(w.std()) - 0.5) < 0.05                  # 1/sqrt(4)
    assert torch.equal(params.layers[1].ssm.D, torch.ones(8))


# ---------------------------------------------------------------------------
# the LM: forward with cache capture, prefill and decode, caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_lm_forward_logits_and_cache(dtype):
    jc, jm, tree, _, pm, params = pair(dtype)
    toks = np.random.default_rng(22).integers(0, jc.vocab_size, (2, 37))
    wl, _, wc = jm.forward(tree, {"tokens": jnp.asarray(toks, jnp.int32)},
                           return_cache=True)
    gl, aux, gc = pm.forward(params, {"tokens": toks}, return_cache=True)
    assert gl.dtype == torch.float32 and float(aux) == 0.0
    assert_close(gl, wl, dtype)
    for k in ("ssm", "conv"):
        assert tuple(gc["layers"][k].shape) == wc["layers"][k].shape
        assert_state_close(gc["layers"][k], wc["layers"][k], dtype)
    at = np.array([36, 4])
    one, _, _ = pm.forward(params, {"tokens": toks}, logits_at=at)
    assert_close(one, gl[torch.arange(2), torch.from_numpy(at)], "float32")


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_prefill_and_decode_match(dtype):
    """``prefill`` then three decode steps (``pos`` not read): logits and
    both state trees."""
    jc, jm, tree, _, pm, params = pair(dtype)
    rng = np.random.default_rng(23)
    toks = rng.integers(0, jc.vocab_size, (2, 19))
    wl, wcache = jm.prefill(tree, {"tokens": jnp.asarray(toks, jnp.int32)},
                            max_len=32)
    gl, gcache = pm.prefill(params, {"tokens": toks}, max_len=32)
    assert_close(gl, wl, dtype)
    pos = np.array([19, 19], np.int32)
    for step in range(3):
        tok = rng.integers(0, jc.vocab_size, (2, 1)).astype(np.int32)
        wl, wcache = jm.decode_step(tree, jnp.asarray(tok),
                                    jnp.asarray(pos + step), wcache)
        gl, gcache = pm.decode_step(params, torch.from_numpy(tok),
                                    torch.from_numpy(pos + step), gcache)
        assert gl.shape == (2, jc.vocab_size)
        assert_close(gl, wl, dtype)
    for k in ("ssm", "conv"):
        assert_state_close(gcache["layers"][k], wcache["layers"][k], dtype)


def test_ssm_make_cache_and_pad_cache_match():
    jc, _, _, pc, pm, _ = pair("bfloat16")
    want, _ = jx_tf.make_cache(jc, 3, 20, mode="init")
    got = pm.make_cache(3, 20, device="cpu")
    for k, dt in (("ssm", torch.float32), ("conv", torch.bfloat16)):
        g = got["layers"][k]
        assert tuple(g.shape) == want["layers"][k].shape and g.dtype == dt
        assert not g.any()
    assert tf.pad_cache(pc, got, 99)["layers"] is got["layers"]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _prompts(kind: str):
    rng = np.random.default_rng(24)
    lens = {"equal": (21, 21, 21), "ragged": (20, 5, 33, 3, 1)}[kind]
    return [[int(t) for t in rng.integers(0, 256, n)] for n in lens]


@pytest.mark.parametrize("kind", ["equal", "ragged"])
def test_ssm_generate_greedy_matches_reference_float32(kind):
    """Greedy serving, token for token; ragged rows reproduce the
    reference's absorbed padding."""
    _, jm, tree, _, pm, params = pair("float32")
    ps = _prompts(kind)
    want = JxServe(jm, tree, max_len=64).generate(ps, max_new_tokens=8)
    got = ServeEngine(pm, params, max_len=64).generate(ps, max_new_tokens=8)
    assert got == want
    assert [len(g) for g in got] == [len(p) + 8 for p in ps]


def test_ssm_generate_runs_past_max_len_as_the_reference():
    """An SSM state has no length: the reference decodes past max_len
    correctly, and the port gives the same tokens."""
    _, jm, tree, _, pm, params = pair("float32")
    ps = _prompts("ragged")[:2]
    want = JxServe(jm, tree, max_len=16).generate(ps, max_new_tokens=12)
    got = ServeEngine(pm, params, max_len=16).generate(ps, 12)
    assert got == want and len(got[0]) == 32


def test_ssm_generate_first_token_logits_bfloat16():
    """At bf16 the logits that choose the first token (each row's last
    real position after a ragged prefill) stay within the bf16
    tolerance of the reference's."""
    _, jm, tree, _, pm, params = pair("bfloat16")
    ps = _prompts("ragged")
    lens = np.array([len(p) for p in ps])
    toks = np.zeros((len(ps), lens.max()), np.int32)
    for i, p in enumerate(ps):
        toks[i, :len(p)] = p
    wl, _, _ = jm.forward(tree, {"tokens": jnp.asarray(toks)})
    want = f32(wl)[np.arange(len(ps)), lens - 1]
    got, _, _ = pm.forward(params, {"tokens": toks}, logits_at=lens - 1)
    assert_close(got, want, "bfloat16")


def test_ssm_longest_row_is_served_as_alone():
    """Padding is absorbed only by rows shorter than the longest: the
    longest prompt gets the same tokens alone and in the batch (and a
    repeat gives the same tokens)."""
    _, _, _, _, pm, params = pair("float32")
    eng = ServeEngine(pm, params, max_len=64)
    ps = _prompts("ragged")
    out = eng.generate(ps, 6)
    assert out == eng.generate(ps, 6)
    assert eng.generate([ps[2]], 6)[0] == out[2]


@pytest.mark.parametrize("prompts", [[[7]], [[7, 8]], [[7], [1, 2]]],
                         ids=["one", "two", "batch-of-short"])
def test_ssm_generate_rejects_a_batch_shorter_than_the_conv_tail(prompts):
    """The reference fails there on a shape (its conv tail is shorter
    than its cache); the port raises naming the limit.  A short row in
    a batch with a long one is served (see the ragged test)."""
    _, _, _, _, pm, params = pair("float32")
    with pytest.raises(ValueError, match="d_conv - 1 = 3"):
        ServeEngine(pm, params, max_len=16).generate(prompts, 2)
    with pytest.raises(ValueError, match="d_conv - 1 = 3"):
        pm.prefill(params, {"tokens": np.array(prompts[0])[None]})
