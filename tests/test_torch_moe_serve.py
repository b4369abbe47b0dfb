"""The port's mixture-of-experts LM (``moe`` family) against the JAX
package's, on the CPU: the forward with both cache stacks at
``param_dtype`` f32 and bf16, prefill and decode, the caches, greedy
serving, and two planted faults (the top-k gates renormalised to sum to
1; the shared experts skipped) that the forward comparison must reject.

Configs, weights, inputs, tolerances and the bf16 holding of tokens whose
routing differs are ``test_torch_moe``'s (its module docstring).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.models.transformer as jx_tf  # noqa: E402
from repro.serve import ServeEngine as JxServe  # noqa: E402

import repro_torch.models.moe as moe  # noqa: E402
import repro_torch.models.transformer as tf  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from test_torch_lm import (DTYPES, assert_close, f32, jx_arr,  # noqa: E402
                           pt_arr)
from test_torch_moe import (CONFIGS, _routings, _tokens,  # noqa: E402
                            pair, spying, touched)


@pytest.fixture(autouse=True)
def _one_thread():
    # small eager ops run faster on one thread at these sizes
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the LM: forward with cache capture, prefill and decode, caches
# ---------------------------------------------------------------------------

def _cache_keys(jc):
    return ("dense_layers", "layers") if jc.moe.dense_first_n \
        else ("layers",)


def _hold(jc, dtype, port, ref) -> np.ndarray:
    """The (B, S) tokens to hold to the reference: all in f32, where the
    routing must be the reference's; in bf16 those whose routing agrees
    at every layer (at most 10% may differ).  -> that mask."""
    moved = touched(port, ref, jc.moe.n_experts)
    if dtype == "float32":
        assert not moved.any()
    assert moved.sum() <= 0.1 * moved.size, moved.sum()
    return ~moved


def _assert_cache_close(got, want, dtype, keys, rows):
    assert set(got) == set(want) == set(keys)
    for key in keys:
        for g, w in zip(got[key], want[key]):
            assert tuple(g.shape) == w.shape
            # (layers, B, S, H, D): positions of the tokens held
            assert_close(f32(g)[:, rows], f32(w)[:, rows], dtype)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_lm_forward_logits_aux_and_cache(dtype, config, param_dtype):
    jc, jm, tree, _, pm, params = pair(dtype, config, param_dtype)
    toks = _tokens(jc, (2, 37), 53)
    with spying() as spy:
        wl, waux, wc = jm.forward(
            tree, {"tokens": jnp.asarray(toks, jnp.int32)},
            return_cache=True)
    gl, aux, gc = pm.forward(params, {"tokens": toks}, return_cache=True)
    rows = _hold(jc, dtype, _routings(params), spy.routings())
    assert gl.dtype == torch.float32 and aux.dtype == torch.float32
    assert_close(f32(gl)[rows], f32(wl)[rows], dtype)
    if dtype == "float32":
        assert abs(float(aux) - float(waux)) <= 1e-6
    else:
        assert_close(aux, waux, dtype)
    _assert_cache_close(gc, wc, dtype, _cache_keys(jc), rows)
    at = np.array([36, 4])
    one, _, _ = pm.forward(params, {"tokens": toks}, logits_at=at)
    assert_close(one, gl[torch.arange(2), torch.from_numpy(at)], "float32")


def _decode_inputs(jc):
    """A 19-token batch of 2 and four decode steps' tokens, and the rows'
    positions at the first step (19, and 12: a row that overwrites its
    padding)."""
    rng = np.random.default_rng(54)
    toks = rng.integers(0, jc.vocab_size, (2, 19))
    steps = [rng.integers(0, jc.vocab_size, (2, 1)).astype(np.int32)
             for _ in range(4)]
    return toks, steps, np.array([19, 12], np.int32)


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_prefill_and_decode_match(dtype, config):
    """``prefill`` (both KV stacks grown to max_len) then four decode
    steps at per-row positions (one token a row: capacity 1, no drop):
    logits every step, then the whole cache.  In bf16 a row's prefill
    logits are held where its last token's routing agrees, its decode
    logits until its routing differs at a step (its later steps read a
    different cache row), and the cache at the positions of the tokens
    whose routing agreed."""
    jc, jm, tree, _, pm, params = pair(dtype, config)
    toks, steps, pos = _decode_inputs(jc)
    n_moe = len(params.layers)
    with spying() as spy:
        wl, wcache = jm.prefill(
            tree, {"tokens": jnp.asarray(toks, jnp.int32)}, max_len=32)
        gl, gcache = pm.prefill(params, {"tokens": toks}, max_len=32)
        prompt_rows = _hold(jc, dtype, _routings(params), spy.routings())
        held = prompt_rows[:, -1]
        assert held.any()
        assert_close(f32(gl)[held], f32(wl)[held], dtype)
        held = np.ones(2, bool)
        for key in _cache_keys(jc):
            assert gcache[key][0].shape[2] == 32
        for i, tok in enumerate(steps):
            wl, wcache = jm.decode_step(tree, jnp.asarray(tok),
                                        jnp.asarray(pos + i), wcache)
            gl, gcache = pm.decode_step(params, torch.from_numpy(tok),
                                        torch.from_numpy(pos + i), gcache)
            assert gl.shape == (2, jc.vocab_size)
            ref = spy.routings()[n_moe * (i + 1):n_moe * (i + 2)]
            held &= _hold(jc, dtype, _routings(params), ref)[:, 0]
            assert held.any()
            assert_close(f32(gl)[held], f32(wl)[held], dtype)
    # the cache rows of the prompts' held tokens and of the held rows'
    # decode steps
    rows = np.zeros((2, 32), bool)
    rows[:, :19] = prompt_rows
    for b, p in enumerate(pos):
        rows[b, p:p + len(steps)] = held[b]
    _assert_cache_close(gcache, wcache, dtype, _cache_keys(jc), rows)


@pytest.mark.parametrize("config", CONFIGS)
def test_moe_make_cache_and_pad_cache_match(config):
    jc, _, _, pc, pm, _ = pair("bfloat16", config)
    want, _ = jx_tf.make_cache(jc, 3, 20, mode="init")
    got = pm.make_cache(3, 20, device="cpu")
    keys = _cache_keys(jc)
    assert set(got) == set(want) == set(keys)
    for key in keys:
        for g, w in zip(got[key], want[key]):
            assert tuple(g.shape) == w.shape and g.dtype == torch.bfloat16
            assert not g.any()
    rng = np.random.default_rng(55)
    kv = {key: rng.standard_normal((n, 3, 5, jc.n_kv_heads, jc.head_dim))
          for key, n in tf.attn_stack_sizes(pc)}
    wp = jx_tf.pad_cache(jc, {k: (jx_arr(a, "float32"),) * 2
                              for k, a in kv.items()}, 9)
    gp = tf.pad_cache(pc, {k: (pt_arr(a, "float32"),) * 2
                           for k, a in kv.items()}, 9)
    for key in keys:
        for g, w in zip(gp[key], wp[key]):
            assert g.shape[2] == 9 and np.array_equal(f32(g), f32(w))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _prompts():
    rng = np.random.default_rng(56)
    return [[int(t) for t in rng.integers(0, 256, n)] for n in (20, 5, 33, 3)]


@pytest.mark.parametrize("config", CONFIGS)
def test_moe_generate_greedy_matches_reference_float32(config):
    """Greedy serving on ragged prompts, token for token (the prefill's
    capacity follows the padded length, as the reference's)."""
    _, jm, tree, _, pm, params = pair("float32", config)
    ps = _prompts()
    want = JxServe(jm, tree, max_len=48).generate(ps, max_new_tokens=8)
    got = ServeEngine(pm, params, max_len=48).generate(ps, max_new_tokens=8)
    assert got == want
    assert [len(g) for g in got] == [len(p) + 8 for p in ps]


def test_moe_cache_has_length_and_max_len_bounds_generate():
    _, _, _, pc, pm, params = pair("float32")
    assert pm.cache_has_length and tf.cache_has_length(pc)
    eng = ServeEngine(pm, params, max_len=12)
    assert len(eng.generate([[1, 2, 3, 4]], 8)[0]) == 12
    with pytest.raises(ValueError, match="max_len"):
        eng.generate([[1, 2, 3, 4, 5]], 8)


# ---------------------------------------------------------------------------
# the checks see the faults they must
# ---------------------------------------------------------------------------

def _forward_gap(jc, jm, tree, pm, params):
    toks = _tokens(jc, (2, 29), 57)
    wl, _, _ = jm.forward(tree, {"tokens": jnp.asarray(toks, jnp.int32)})
    gl, _, _ = pm.forward(params, {"tokens": toks})
    return gl, wl


@pytest.mark.parametrize("config", ("reduced", "wide"))
@pytest.mark.parametrize("dtype", DTYPES)
def test_a_port_that_renormalises_the_gates_fails(dtype, config,
                                                  monkeypatch):
    jc, jm, tree, _, pm, params = pair(dtype, config)
    assert_close(*_forward_gap(jc, jm, tree, pm, params), dtype)
    route = moe.route

    def renormalised(x, router, m):
        r = route(x, router, m)
        gates = r.gate_vals / r.gate_vals.sum(dim=-1, keepdim=True)
        return dataclasses.replace(
            r, gate_vals=gates,
            w_sort=gates.reshape(r.order.shape).gather(1, r.order))
    monkeypatch.setattr(moe, "route", renormalised)
    with pytest.raises(AssertionError):
        assert_close(*_forward_gap(jc, jm, tree, pm, params), dtype)


@pytest.mark.parametrize("config", ("reduced", "wide"))
@pytest.mark.parametrize("dtype", DTYPES)
def test_a_port_that_skips_the_shared_experts_fails(dtype, config,
                                                    monkeypatch):
    jc, jm, tree, _, pm, params = pair(dtype, config)
    for layer in params.layers:
        monkeypatch.setattr(layer.moe, "n_shared", 0)
    with pytest.raises(AssertionError):
        assert_close(*_forward_gap(jc, jm, tree, pm, params), dtype)
