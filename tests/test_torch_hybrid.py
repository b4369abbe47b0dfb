"""The port's Zamba2 serving stack (``hybrid`` family) against the JAX
package's, on the CPU.

Configs: ``zamba2-7b`` reduced (2 groups of 1 Mamba2 layer, 2 shared
blocks, 1 tail layer, d_model 64, 4 q heads over 2 KV heads of 16, SSM
P 16, N 16, chunk 16, vocab 256) and a wide-head variant of it with the
full model's kernel shapes at that depth (2 of 2 heads of 112, SSM head
dim 64 and d_state 64, chunk 16); each at float32 and at the config's
bfloat16.  Weights are the reference's ``init_params(0)`` carried over by
``params.lm_from_params``; inputs come from seeded numpy.  The
reference's attention and scan run their CPU paths (``_chunked_jnp``,
``_jnp_fallback``, the jnp scan), the port's its plain versions (CPU
tensors).  The reference takes its parameters as jnp arrays: it indexes
the stacked shared blocks with a traced group index.

Tolerances are ``test_torch_lm``'s on logits and K/V: float32 1e-4 *
max(1, max|ref|) and greedy tokens equal; bfloat16 2e-2 * max(1,
max|ref|).  SSM states: float32 the same; bfloat16 no further (RMS) from
the reference's float32 run on the same inputs than twice the
reference's own bfloat16 run is (``assert_rounding_close``).  Rounding
alone sets their bf16 gap at this depth: the deepest (tail) state is
1.9-2.4% of its RMS from the float32 one in the reference's own bf16 run
(measured, after the prefill and after four decode steps), and 0.019 of
a max of 0.68 after the decode, so neither ``test_torch_ssm``'s 2% of the
RMS nor 2e-2 * max(1, max|ref|) separates it from rounding.  Two cases
plant a fault the reference's own weights might hide (the two shared
blocks made clearly unequal; zeros for the embedding the shared blocks
read) and check that the forward comparison rejects it.
"""
import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.transformer as jx_tf  # noqa: E402
from repro.configs import get_config as jx_get  # noqa: E402
from repro.models.model import build_model as jx_build  # noqa: E402
from repro.serve import ServeEngine as JxServe  # noqa: E402

import repro_torch.models.transformer as tf  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.params import lm_from_params  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from test_torch_lm import (DTYPES, assert_close, f32, jx_arr,  # noqa: E402
                           port_cfg, pt_arr)

CONFIGS = ("reduced", "wide")


def _reference_cfg(config: str, dtype: str):
    jc = dataclasses.replace(jx_get("zamba2-7b").reduced(), dtype=dtype)
    if config == "wide":
        jc = dataclasses.replace(
            jc, n_heads=2, n_kv_heads=2, head_dim=112,
            ssm=dataclasses.replace(jc.ssm, d_state=64, head_dim=64,
                                    chunk_size=16))
    return jc


@pytest.fixture(autouse=True)
def _one_thread():
    # small eager ops run faster on one thread at these sizes
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def pair(dtype: str, config: str = "reduced"):
    """(reference config, model, its init_params(0) tree as jnp arrays and
    as numpy, port config, port model, weights carried over)."""
    jc = _reference_cfg(config, dtype)
    jm = jx_build(jc)
    jtree = jm.init_params(0)
    tree = jax.tree.map(np.asarray, jtree)
    pc = port_cfg(jc)
    return (jc, jm, jtree, tree, pc, build_model(pc),
            lm_from_params(pc, tree, device="cpu"))


def _tokens(jc, shape, seed):
    return np.random.default_rng(seed).integers(0, jc.vocab_size, shape)


def _rms(a) -> float:
    return float(np.sqrt((f32(a) ** 2).mean()))


def assert_rounding_close(got, want, exact) -> float:
    """A bf16 result ``got`` no further (RMS) from ``exact``, the
    reference's float32 result on the same inputs, than twice the
    reference's own bf16 result ``want`` is.  -> the ratio."""
    got, want, exact = f32(got), f32(want), f32(exact)
    assert got.shape == want.shape == exact.shape
    ratio = _rms(got - exact) / max(_rms(want - exact), 1e-30)
    assert ratio <= 2.0, ratio
    return ratio


def _assert_cache_close(got, want, dtype, exact=None):
    """The hybrid cache: SSM states of the groups and the tail (in bf16
    against ``exact``, the reference's float32 cache), and the shared
    blocks' K/V."""
    for key in ("groups", "tail"):
        for k in ("ssm", "conv"):
            assert tuple(got[key][k].shape) == want[key][k].shape
            if dtype == "float32":
                assert_close(got[key][k], want[key][k], dtype)
            else:
                assert_rounding_close(got[key][k], want[key][k],
                                      exact[key][k])
    for g, w in zip(got["shared_kv"], want["shared_kv"]):
        assert tuple(g.shape) == w.shape
        assert_close(g, w, dtype)


def _exact(config: str, batch: dict, **kw):
    """The reference's float32 run (``Model.forward`` with the cache) on
    ``batch``: the yardstick of bf16 rounding."""
    _, jm, jtree, *_ = pair("float32", config)
    return jm.forward(jtree, batch, return_cache=True, **kw)[2]


# ---------------------------------------------------------------------------
# configs and specs
# ---------------------------------------------------------------------------

def test_registry_holds_zamba2_as_the_reference_does():
    cfg = get_config("zamba2-7b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jx_get("zamba2-7b"))
    h = cfg.hybrid
    assert (h.n_groups, h.ssm_per_group, h.tail_ssm, h.n_shared_blocks,
            h.total_layers) == (13, 5, 3, 2, 81)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.ssm.d_state, cfg.ssm.head_dim,
            cfg.ssm.n_heads(cfg.d_model)) == (3584, 32, 32, 112, 64, 64, 112)


@pytest.mark.parametrize("config", ("full",) + CONFIGS)
def test_hybrid_param_specs_are_the_reference_tree(config):
    """Paths and shapes (two stacked axes under groups/ssm_layers, one
    under shared and tail) are the reference's tree, in shape mode, and
    ``param_count`` is the analytic count; the full width's is
    6,225,549,632."""
    ref = (jx_get("zamba2-7b") if config == "full"
           else _reference_cfg(config, "bfloat16"))
    shapes = jx_build(ref).param_shapes()
    flat = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    model = build_model(port_cfg(ref))
    assert {s.path: s.shape for s in model.param_specs()} == flat
    # the shapes' sizes summed in Python: the reference's own
    # Model.param_count takes each product in int32, which a full-width
    # leaf of 3.4e9 elements overflows
    assert model.param_count() == ref.param_count() \
        == sum(math.prod(shape) for shape in flat.values())
    if config == "full":
        assert model.param_count() == 6_225_549_632
        assert flat["groups/ssm_layers/ssm/in_proj/w"] == (13, 5, 3584,
                                                           14_576)
        assert flat["shared/attn/wq/w"] == (2, 7168, 3584)
        assert flat["shared/mlp/w_gate"] == (2, 7168, 14_336)


def test_lm_from_params_rejects_a_wrong_two_level_stack():
    """A ``groups/ssm_layers`` leaf stacked (n_groups, ssm_per_group) the
    wrong way round, or flattened to one axis, raises naming the path; so
    does a leaf the specs do not know."""
    _, _, _, tree, pc, _, _ = pair("float32")
    for shape in ((1, 2, 64), (2, 64)):
        bad = jax.tree.map(lambda a: a, tree)
        bad["groups"]["ssm_layers"]["ln"]["scale"] = np.ones(shape,
                                                             np.float32)
        with pytest.raises(ValueError, match="groups/ssm_layers/ln/scale"):
            lm_from_params(pc, bad, device="cpu")
    extra = jax.tree.map(lambda a: a, tree)
    extra["shared"]["attn"]["wq"]["b"] = np.zeros((2, 64), np.float32)
    with pytest.raises(ValueError, match="shared/attn/wq/b"):
        lm_from_params(pc, extra, device="cpu")
    params = pair("float32")[-1]
    with pytest.raises(ValueError, match="stacked"):
        params.load_("groups/ssm_layers/ln/scale", torch.ones(1, 2, 64))


# ---------------------------------------------------------------------------
# the shared block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_shared_block_matches(dtype, config):
    """``SharedBlock`` against ``_shared_block_fwd`` (cache capture) for
    each of the two blocks: the output and the site's K/V."""
    jc, _, jtree, _, _, _, params = pair(dtype, config)
    rng = np.random.default_rng(30)
    h = rng.standard_normal((2, 37, jc.d_model))
    he = rng.standard_normal((2, 37, jc.d_model))
    for i in range(jc.hybrid.n_shared_blocks):
        sp = jax.tree.map(lambda a: a[i], jtree["shared"])
        want, (wk, wv) = jx_tf._shared_block_fwd(
            sp, jx_arr(h, dtype), jx_arr(he, dtype), jc, True)
        with torch.inference_mode():
            got, (k, v) = params.shared[i](pt_arr(h, dtype),
                                           pt_arr(he, dtype))
        assert got.dtype == getattr(torch, dtype)
        assert k.shape == (2, 37, jc.n_kv_heads, jc.head_dim)
        assert_close(got, want, dtype)
        assert_close(k, wk, dtype)
        assert_close(v, wv, dtype)


# ---------------------------------------------------------------------------
# the LM: forward with cache capture, prefill and decode, caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_hybrid_lm_forward_logits_and_cache(dtype, config):
    jc, jm, jtree, _, _, pm, params = pair(dtype, config)
    toks = _tokens(jc, (2, 37), 31)
    wl, _, wc = jm.forward(jtree, {"tokens": jnp.asarray(toks, jnp.int32)},
                           return_cache=True)
    gl, aux, gc = pm.forward(params, {"tokens": toks}, return_cache=True)
    assert gl.dtype == torch.float32 and float(aux) == 0.0
    assert_close(gl, wl, dtype)
    _assert_cache_close(gc, wc, dtype, None if dtype == "float32" else
                        _exact(config, {"tokens": jnp.asarray(toks,
                                                              jnp.int32)}))
    at = np.array([36, 4])
    one, _, _ = pm.forward(params, {"tokens": toks}, logits_at=at)
    assert_close(one, gl[torch.arange(2), torch.from_numpy(at)], "float32")


def _decode_inputs(jc):
    """A 19-token batch of 2 and four decode steps' tokens, and the rows'
    positions at the first step (19, and 12: a row that overwrites its
    padding)."""
    rng = np.random.default_rng(32)
    toks = rng.integers(0, jc.vocab_size, (2, 19))
    steps = [rng.integers(0, jc.vocab_size, (2, 1)).astype(np.int32)
             for _ in range(4)]
    return toks, steps, np.array([19, 12], np.int32)


def _reference_decode(jm, jtree, jc):
    """The reference's prefill (max_len 32) and four decode steps. ->
    (logits of the prefill and of each step, the final cache)."""
    toks, steps, pos = _decode_inputs(jc)
    wl, cache = jm.prefill(jtree, {"tokens": jnp.asarray(toks, jnp.int32)},
                           max_len=32)
    logits = [wl]
    for i, tok in enumerate(steps):
        wl, cache = jm.decode_step(jtree, jnp.asarray(tok),
                                   jnp.asarray(pos + i), cache)
        logits.append(wl)
    return logits, cache


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_hybrid_prefill_and_decode_match(dtype, config):
    """``prefill`` (the KV cache grown to max_len) then four decode steps
    at per-row positions: logits every step, then the whole cache."""
    jc, jm, jtree, _, _, pm, params = pair(dtype, config)
    want, wcache = _reference_decode(jm, jtree, jc)
    toks, steps, pos = _decode_inputs(jc)
    gl, gcache = pm.prefill(params, {"tokens": toks}, max_len=32)
    assert_close(gl, want[0], dtype)
    assert gcache["shared_kv"][0].shape[2] == 32
    for i, tok in enumerate(steps):
        gl, gcache = pm.decode_step(params, torch.from_numpy(tok),
                                    torch.from_numpy(pos + i), gcache)
        assert gl.shape == (2, jc.vocab_size)
        assert_close(gl, want[i + 1], dtype)
    exact = None
    if dtype != "float32":
        _, jm32, jtree32, *_ = pair("float32", config)
        exact = _reference_decode(jm32, jtree32, jc)[1]
    _assert_cache_close(gcache, wcache, dtype, exact)


@pytest.mark.parametrize("config", CONFIGS)
def test_hybrid_make_cache_and_pad_cache_match(config):
    jc, _, _, _, pc, pm, _ = pair("bfloat16", config)
    want, _ = jx_tf.make_cache(jc, 3, 20, mode="init")
    got = pm.make_cache(3, 20, device="cpu")
    assert set(got) == {"groups", "shared_kv", "tail"}
    for key in ("groups", "tail"):
        for k, dt in (("ssm", torch.float32), ("conv", torch.bfloat16)):
            g = got[key][k]
            assert tuple(g.shape) == want[key][k].shape and g.dtype == dt
            assert not g.any()
    for g, w in zip(got["shared_kv"], want["shared_kv"]):
        assert tuple(g.shape) == w.shape and g.dtype == torch.bfloat16
        assert not g.any()
    k = np.random.default_rng(33).standard_normal(
        (2, 3, 5, jc.n_kv_heads, jc.head_dim))
    cache = {"groups": "states", "tail": "states"}
    wp = jx_tf.pad_cache(jc, {**cache, "shared_kv": (jx_arr(k, "float32"),)
                              * 2}, 9)
    gp = tf.pad_cache(pc, {**cache, "shared_kv": (pt_arr(k, "float32"),)
                           * 2}, 9)
    assert gp["groups"] == "states" and gp["tail"] == "states"
    for g, w in zip(gp["shared_kv"], wp["shared_kv"]):
        assert g.shape[2] == 9 and np.array_equal(f32(g), f32(w))


@pytest.mark.parametrize("dtype", DTYPES)
def test_param_dtype_bfloat16_forward_matches_the_reference(dtype):
    """Weights held in bf16 (``param_dtype``): every parameter is held in
    bf16; the logits are the reference's, in bf16 activations by the
    rounding rule of the states (no further, in RMS, from the reference's
    float32-activation run on the same bf16 weights than twice the
    reference's own bf16 run: rounding alone puts these logits at the
    edge of 2e-2 * max|ref|, with float32 weights too)."""
    logits = {}
    toks = _tokens(jx_get("zamba2-7b").reduced(), (2, 29), 42)
    for dt in ("float32", dtype):
        jc = dataclasses.replace(jx_get("zamba2-7b").reduced(), dtype=dt,
                                 param_dtype="bfloat16")
        jm = jx_build(jc)
        jtree = jm.init_params(0)
        pc = port_cfg(jc)
        params = lm_from_params(pc, jax.tree.map(np.asarray, jtree),
                                device="cpu")
        assert {p.dtype for p in params.parameters()} == {torch.bfloat16}
        wl, _, _ = jm.forward(jtree, {"tokens": jnp.asarray(toks,
                                                            jnp.int32)})
        gl, _, _ = build_model(pc).forward(params, {"tokens": toks})
        logits[dt] = (gl, wl)
    gl, wl = logits[dtype]
    if dtype == "float32":
        assert_close(gl, wl, dtype)
    else:
        assert_rounding_close(gl, wl, logits["float32"][1])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _prompts():
    rng = np.random.default_rng(34)
    return [[int(t) for t in rng.integers(0, 256, n)] for n in (20, 5, 33, 3)]


@pytest.mark.parametrize("config", CONFIGS)
def test_hybrid_generate_greedy_matches_reference_float32(config):
    """Greedy serving on ragged prompts, token for token: the attention
    sites mask by kv_len and the SSM states absorb the right padding, as
    the reference's."""
    _, jm, jtree, _, _, pm, params = pair("float32", config)
    ps = _prompts()
    want = JxServe(jm, jtree, max_len=48).generate(ps, max_new_tokens=8)
    got = ServeEngine(pm, params, max_len=48).generate(ps, max_new_tokens=8)
    assert got == want
    assert [len(g) for g in got] == [len(p) + 8 for p in ps]


def test_hybrid_cache_has_length_and_max_len_bounds_generate():
    """The shared blocks' KV cache holds max_len positions: a generate
    that would pass it raises (the reference drops the writes)."""
    _, _, _, _, pc, pm, params = pair("float32")
    assert pm.cache_has_length and tf.cache_has_length(pc)
    eng = ServeEngine(pm, params, max_len=12)
    assert len(eng.generate([[1, 2, 3, 4]], 8)[0]) == 12
    with pytest.raises(ValueError, match="max_len"):
        eng.generate([[1, 2, 3, 4, 5]], 8)


def test_hybrid_generate_rejects_a_batch_shorter_than_the_conv_tail():
    _, _, _, _, _, pm, params = pair("float32")
    with pytest.raises(ValueError, match="d_conv - 1 = 3"):
        ServeEngine(pm, params, max_len=16).generate([[7, 8]], 2)


# ---------------------------------------------------------------------------
# the checks see the faults they must
# ---------------------------------------------------------------------------

def _forward_gap(jc, jm, jtree, pm, params, dtype):
    toks = _tokens(jc, (2, 29), 35)
    wl, _, _ = jm.forward(jtree, {"tokens": jnp.asarray(toks, jnp.int32)})
    gl, _, _ = pm.forward(params, {"tokens": toks})
    return gl, wl


@functools.lru_cache(maxsize=None)
def _unequal_blocks(dtype: str):
    """The reduced config with shared block 1 made block 0 with its two
    output projections (``attn/wo``, ``mlp/w_down``) negated: the blocks
    add opposite terms to h at the same scale.  -> (reference config,
    model, jnp tree, port config, port model, port weights)."""
    jc, jm, _, tree, pc, pm, _ = pair(dtype)
    tree = jax.tree.map(lambda a: a.copy(), tree)
    shared = tree["shared"]
    for leaf in jax.tree.leaves(shared):
        leaf[1] = leaf[0]
    for w in (shared["attn"]["wo"]["w"], shared["mlp"]["w_down"]):
        w[1] = -w[0]
    return (jc, jm, jax.tree.map(jnp.asarray, tree), pc, pm,
            lm_from_params(pc, tree, device="cpu"))


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_port_that_uses_shared_block_0_everywhere_fails(dtype):
    jc, jm, jtree, _, pm, params = _unequal_blocks(dtype)
    assert_close(*_forward_gap(jc, jm, jtree, pm, params, dtype), dtype)
    block1 = params.shared[1]
    params.shared[1] = params.shared[0]       # every site uses block 0
    try:
        with pytest.raises(AssertionError):
            assert_close(*_forward_gap(jc, jm, jtree, pm, params, dtype),
                         dtype)
    finally:
        params.shared[1] = block1


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_port_that_feeds_zeros_for_h_embed_fails(dtype, monkeypatch):
    jc, jm, jtree, _, _, pm, params = pair(dtype)
    forward = tf.SharedBlock.forward

    def blind(self, h, h_embed, rope=None):
        return forward(self, h, torch.zeros_like(h_embed), rope)
    monkeypatch.setattr(tf.SharedBlock, "forward", blind)
    with pytest.raises(AssertionError):
        assert_close(*_forward_gap(jc, jm, jtree, pm, params, dtype), dtype)
