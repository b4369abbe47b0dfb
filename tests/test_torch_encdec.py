"""The port's encoder-decoder family (``whisper-small``) against the JAX
package's, on the CPU.

Configs: ``whisper-small`` reduced (2 encoder and 2 decoder layers, d 64,
4 query heads over 2 KV heads of 16, d_ff 128, vocab 256, 8 audio
frames, QKV bias, tied embeddings) and an MHA variant (4 of 4 heads, as
the full config's 12 of 12); each at float32 and at the config's
bfloat16.  Weights are the reference's ``init_params(0)`` carried over by
``params.lm_from_params``; audio embeddings and tokens come from seeded
numpy.  The reference's attention runs its CPU path, the port's its
plain versions (CPU tensors).

Tolerances, on the max |difference| against the reference's output, as
``tests/test_torch_lm.py``: float32 1e-4 * max(1, max|reference|) (the
two sum in other orders) and greedy tokens equal; bfloat16 2e-2 *
max(1, max|reference|) (XLA's and torch's CPU bf16 matmuls and GELUs
round differently by an ulp here and there, and the layers carry it).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.attention as jx_attn  # noqa: E402
import repro.models.encdec as jx_ed  # noqa: E402
import repro.models.layers as jx_layers  # noqa: E402
from repro.configs import get_config as jx_get  # noqa: E402
from repro.models.model import build_model as jx_build  # noqa: E402
from repro.serve import ServeEngine as JxServe  # noqa: E402

import repro_torch.models.encdec as ed  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.params import lm_from_params  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

from test_torch_lm import (assert_close, f32, jx_arr, port_cfg,  # noqa: E402
                           pt_arr)

DTYPES = ["float32", "bfloat16"]
VARIANTS = {"base": {}, "mha": dict(n_kv_heads=4)}


@pytest.fixture(autouse=True)
def _one_thread():
    # small eager ops are slow on many threads in a shared sandbox
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def pair(dtype: str, variant: str = "base"):
    """(reference config, reference model, its init_params(0) tree as
    numpy, port model, port weights from that tree)."""
    jc = dataclasses.replace(jx_get("whisper-small").reduced(), dtype=dtype,
                             **VARIANTS[variant])
    jm = jx_build(jc)
    tree = jax.tree.map(np.asarray, jm.init_params(0))
    pc = port_cfg(jc)
    return jc, jm, tree, build_model(pc), lm_from_params(pc, tree,
                                                         device="cpu")


def audio(batch: int, cfg, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.frontend.n_embeds, cfg.d_model)).astype(np.float32)


def _layer(tree, stack: str, i: int = 0):
    return jax.tree.map(lambda a: jnp.asarray(a[i]), tree[stack])


def _jx_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# config, specs
# ---------------------------------------------------------------------------

def test_registry_holds_whisper_as_the_reference_does():
    import repro_torch.configs.base as pt_base
    cfg = pt_base.get_config("whisper-small")
    assert dataclasses.asdict(cfg) == \
        dataclasses.asdict(jx_get("whisper-small"))
    assert cfg.param_count() == 263_309_568
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.qkv_bias,
            cfg.tie_embeddings, cfg.frontend.n_embeds) == \
        (12, 12, 64, True, True, 1500)


def unbiased_count_gap(cfg) -> int:
    """The parameters the analytic ``param_count`` leaves out of the
    encdec family: the LayerNorms' biases (two an encoder layer, three a
    decoder layer, two final norms) and the GELU MLPs' (d_ff + d a
    layer).  The reference's own test allows the two counts 3% apart."""
    d, n_enc, n_dec = cfg.d_model, cfg.n_encoder_layers, cfg.n_layers
    return (2 * n_enc + 3 * n_dec + 2) * d + (n_enc + n_dec) * (cfg.d_ff
                                                                 + d)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_param_specs_are_the_reference_tree(reduced):
    """Paths and shapes of the port's specs are the reference's
    ``param_shapes()`` (nothing allocated at full width); the count is
    the tree's, summed in Python, which is the analytic count plus the
    biases it leaves out."""
    ref = jx_get("whisper-small")
    ref = ref.reduced() if reduced else ref
    shapes = jx_build(ref).param_shapes()
    flat = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    model = build_model(port_cfg(ref))
    assert {s.path: s.shape for s in model.param_specs()} == flat
    assert model.param_count() == jx_build(ref).param_count() \
        == sum(int(np.prod(s)) for s in flat.values()) \
        == ref.param_count() + unbiased_count_gap(ref)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_layernorm_matches(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)) * 3 + 1
    scale, bias = rng.standard_normal(64), rng.standard_normal(64)
    want = jx_layers.layernorm({"scale": jnp.asarray(scale, jnp.float32),
                                "bias": jnp.asarray(bias, jnp.float32)},
                               jx_arr(x, dtype), 1e-5)
    norm = layers.LayerNorm(64, 1e-5, "cpu")
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
    got = norm(pt_arr(x, dtype))
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gelu_mlp_is_the_tanh_approximation(dtype):
    """``mlp_gelu`` with ``jax.nn.gelu``'s default (tanh); torch's erf
    GELU would read about 1e-3 off at these inputs, past the f32
    tolerance."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 64))
    p = {"w_in": rng.standard_normal((64, 128)) / 4,
         "b_in": rng.standard_normal(128),
         "w_out": rng.standard_normal((128, 64)) / 8,
         "b_out": rng.standard_normal(64)}
    want = jx_layers.mlp_gelu({k: jnp.asarray(v, jnp.float32)
                               for k, v in p.items()}, jx_arr(x, dtype))
    mlp = layers.GeluMLP(64, 128, "cpu")
    with torch.no_grad():
        for k, v in p.items():
            getattr(mlp, k).copy_(torch.from_numpy(v))
    assert_close(mlp(pt_arr(x, dtype)), want, dtype)
    if dtype == "float32":
        h = torch.from_numpy(x).float() @ mlp.w_in + mlp.b_in
        erf = torch.nn.functional.gelu(h) @ mlp.w_out + mlp.b_out
        assert float((erf - torch.from_numpy(np.array(want))).abs()
                     .max()) > 1e-3


@pytest.mark.parametrize("n,dim", [(1500, 768), (8, 64), (3, 6)])
def test_sinusoidal_positions_match(n, dim):
    """Sines then cosines (not interleaved), frequency step log(10000) /
    (half - 1).  Within two f32 ulps of the largest angle (n - 1
    radians, 1.8e-4 at 1500): XLA's and torch's exp round a frequency
    differently now and then, and an angle near 1500 moves by its ulp
    (1.2e-4)."""
    want = np.asarray(jx_layers.sinusoidal_positions(n, dim))
    got = layers.sinusoidal_positions(n, dim).numpy()
    assert got.shape == want.shape == (n, dim)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 * max(n - 1, 1) * 2.0 ** -23)
    assert np.array_equal(got[0], np.r_[np.zeros(dim // 2),
                                        np.ones(dim // 2)])


# ---------------------------------------------------------------------------
# attention pieces and layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_kv_and_cross_attention_match(dtype, variant):
    """``cross_kv`` of an encoder output, then full attention of 21
    queries against its 8 frames (non-causal, no rope), and the
    encoder's own bidirectional attention."""
    jc, _, tree, _, params = pair(dtype, variant)
    rng = np.random.default_rng(3)
    enc = rng.standard_normal((2, jc.frontend.n_embeds, jc.d_model))
    x = rng.standard_normal((2, 21, jc.d_model))
    lp = _layer(tree, "decoder")["cross_attn"]
    wk, wv = jx_attn.cross_kv(lp, jx_arr(enc, dtype), jc)
    layer = params.decoder[0]
    with torch.inference_mode():
        gk, gv = layer.cross_attn.cross_kv(pt_arr(enc, dtype))
        assert_close(gk, wk, dtype)
        assert_close(gv, wv, dtype)
        want = jx_attn.attention_full(lp, jx_arr(x, dtype), jc,
                                      causal=False, kv_override=(wk, wv))
        got, _ = layer.cross_attn(pt_arr(x, dtype), causal=False,
                                  kv=(gk, gv))
        assert_close(got, want, dtype)
        ep = _layer(tree, "encoder")["attn"]
        want = jx_attn.attention_full(ep, jx_arr(enc, dtype), jc,
                                      causal=False, use_rope=False)
        got, _ = params.encoder[0].attn(pt_arr(enc, dtype), causal=False)
        assert_close(got, want, dtype)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_decode_matches_and_writes_nothing(dtype, variant):
    """One decode token over the cross cache, every row masked by F
    (``update_cache=False``): the output, and the cache left as it
    was."""
    jc, _, tree, _, params = pair(dtype, variant)
    rng = np.random.default_rng(4)
    F = jc.frontend.n_embeds
    x = rng.standard_normal((3, 1, jc.d_model))
    ck, cv = (rng.standard_normal((3, F, jc.n_kv_heads, jc.head_dim))
              for _ in range(2))
    flen = np.full(3, F, np.int32)
    want, _, _ = jx_attn.attention_decode(
        _layer(tree, "decoder")["cross_attn"], jx_arr(x, dtype),
        jx_arr(ck, dtype), jx_arr(cv, dtype), jnp.asarray(flen), jc,
        use_rope=False, update_cache=False)
    tk, tv = pt_arr(ck, dtype), pt_arr(cv, dtype)
    before = (tk.clone(), tv.clone())
    with torch.inference_mode():
        got = params.decoder[0].cross_attn.decode_cross(
            pt_arr(x, dtype), tk, tv, torch.from_numpy(flen))
    assert_close(got, want, dtype)
    assert torch.equal(tk, before[0]) and torch.equal(tv, before[1])


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_matches(dtype):
    jc, _, tree, _, params = pair(dtype)
    a = audio(2, jc, 5)
    want = jx_ed.encode(_jx_tree(tree), jc, jnp.asarray(a))
    with torch.inference_mode():
        got = ed.encode(params, torch.from_numpy(a))
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_decoder_layer_matches_both_reference_routes(dtype, variant):
    """One decoder layer: the reference's prefill with cache capture
    (self-attention through ``flash_attention`` on unrotated q, k) and
    its forward without (``attention_full(use_rope=False)``) give the
    same numbers; the port's one path equals both, and its self K/V
    equal the captured ones."""
    jc, _, tree, _, params = pair(dtype, variant)
    rng = np.random.default_rng(6)
    h = rng.standard_normal((2, 13, jc.d_model))
    enc = rng.standard_normal((2, jc.frontend.n_embeds, jc.d_model))
    lp = _layer(tree, "decoder", 1)
    w_cap, ((wk, wv), (wck, wcv)) = jx_ed._dec_layer_full(
        lp, jx_arr(h, dtype), jx_arr(enc, dtype), jc, True)
    w_plain, _ = jx_ed._dec_layer_full(lp, jx_arr(h, dtype),
                                       jx_arr(enc, dtype), jc, False)
    layer = params.decoder[1]
    with torch.inference_mode():
        kv = layer.cross_attn.cross_kv(pt_arr(enc, dtype))
        got, (gk, gv) = layer(pt_arr(h, dtype), kv)
    for want in (w_cap, w_plain):
        assert_close(got, want, dtype)
    for g, w in ((gk, wk), (gv, wv), (kv[0], wck), (kv[1], wcv)):
        assert_close(g, w, dtype)


# ---------------------------------------------------------------------------
# the model: forward with cache capture, prefill, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_logits_and_caches(dtype, variant):
    jc, jm, tree, pm, params = pair(dtype, variant)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jc.vocab_size, (2, 19))
    a = audio(2, jc, 8)
    wl, _, wc = jm.forward(tree, {"tokens": jnp.asarray(toks, jnp.int32),
                                  "audio_embeds": jnp.asarray(a)},
                           return_cache=True)
    gl, aux, gc = pm.forward(params, {"tokens": toks, "audio_embeds": a},
                             return_cache=True)
    assert gl.dtype == torch.float32 and float(aux) == 0.0
    assert_close(gl, wl, dtype)
    for key in ("self", "cross"):
        for got, want in zip(gc[key], wc[key]):
            assert got.dtype == getattr(torch, dtype)
            assert_close(got, want, dtype)
    # torch tensors are taken as numpy arrays are, and logits at one
    # position a row are the same numbers
    at = np.array([18, 3])
    one, _, _ = pm.forward(params, {"tokens": torch.from_numpy(toks),
                                    "audio_embeds": torch.from_numpy(a)},
                           logits_at=at)
    assert_close(one, gl[torch.arange(2), torch.from_numpy(at)], "float32")


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_match(dtype, variant):
    """``prefill`` to a longer self cache (the cross cache stays at F),
    then three decode steps at ragged positions: logits and every cache
    row."""
    jc, jm, tree, pm, params = pair(dtype, variant)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, jc.vocab_size, (2, 17))
    a = audio(2, jc, 10)
    batch = {"tokens": toks, "audio_embeds": a}
    wl, wcache = jm.prefill(tree, {"tokens": jnp.asarray(toks, jnp.int32),
                                   "audio_embeds": jnp.asarray(a)},
                            max_len=32)
    gl, gcache = pm.prefill(params, batch, max_len=32)
    assert_close(gl, wl, dtype)
    for key in ("self", "cross"):
        assert gcache[key][0].shape == wcache[key][0].shape
    assert gcache["self"][0].shape[2] == 32
    assert gcache["cross"][0].shape[2] == jc.frontend.n_embeds
    pos = np.array([17, 6], np.int32)
    for step in range(3):
        tok = rng.integers(0, jc.vocab_size, (2, 1)).astype(np.int32)
        wl, wcache = jm.decode_step(tree, jnp.asarray(tok),
                                    jnp.asarray(pos + step), wcache)
        gl, gcache = pm.decode_step(params, torch.from_numpy(tok),
                                    torch.from_numpy(pos + step), gcache)
        assert gl.shape == (2, jc.vocab_size)
        assert_close(gl, wl, dtype)
    for key in ("self", "cross"):
        for got, want in zip(gcache[key], wcache[key]):
            assert_close(got, want, dtype)


def test_make_cache_matches():
    jc, _, _, pm, _ = pair("bfloat16")
    want, _ = jx_ed.make_encdec_cache(jc, 3, 20, mode="init")
    got = pm.make_cache(3, 20, device="cpu")
    for key in ("self", "cross"):
        for g, w in zip(got[key], want[key]):
            assert g.shape == w.shape and g.dtype == torch.bfloat16
            assert not g.any()


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _prompts(vocab: int):
    rng = np.random.default_rng(11)
    return [[int(t) for t in rng.integers(0, vocab, n)]
            for n in (20, 5, 33, 1)]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_generate_greedy_matches_reference_float32(variant):
    """Greedy serving on ragged prompts, token for token, at float32."""
    jc, jm, tree, pm, params = pair("float32", variant)
    ps = _prompts(jc.vocab_size)
    a = audio(len(ps), jc, 12)
    want = JxServe(jm, tree, max_len=48).generate(
        ps, max_new_tokens=8, extras={"audio_embeds": jnp.asarray(a)})
    got = ServeEngine(pm, params, max_len=48).generate(
        ps, max_new_tokens=8, extras={"audio_embeds": a})
    assert got == want
    assert [len(g) for g in got] == [len(p) + 8 for p in ps]


def test_generate_first_token_logits_bfloat16():
    """At bf16 the first sampled token's logits (each row's last real
    position) stay within the bf16 tolerance of the reference's."""
    jc, jm, tree, pm, params = pair("bfloat16")
    ps = _prompts(jc.vocab_size)
    a = audio(len(ps), jc, 13)
    lens = np.array([len(p) for p in ps])
    toks = np.zeros((len(ps), lens.max()), np.int32)
    for i, p in enumerate(ps):
        toks[i, :len(p)] = p
    wl, _, _ = jm.forward(tree, {"tokens": jnp.asarray(toks),
                                 "audio_embeds": jnp.asarray(a)})
    want = f32(wl)[np.arange(len(ps)), lens - 1]
    got, _, _ = pm.forward(params, {"tokens": toks, "audio_embeds": a},
                           logits_at=lens - 1)
    assert_close(got, want, "bfloat16")


def test_ragged_rows_are_independent():
    """Each prompt served alone (with its own audio) gives the tokens it
    gets in the batch: padding never leaks into either attention."""
    jc, _, _, pm, params = pair("float32")
    eng = ServeEngine(pm, params, max_len=48)
    ps = _prompts(jc.vocab_size)
    a = audio(len(ps), jc, 14)
    out = eng.generate(ps, 6, extras={"audio_embeds": a})
    assert out == eng.generate(ps, 6, extras={"audio_embeds": a})
    assert [eng.generate([p], 6, extras={"audio_embeds": a[i:i + 1]})[0]
            for i, p in enumerate(ps)] == out


@pytest.mark.parametrize("batch", [
    {"patch_embeds": np.zeros((1, 8, 64), np.float32)},
    {"loss_mask": np.ones((1, 4), np.int8)}, {}],
    ids=["patch_embeds", "loss_mask", "no-audio"])
def test_forward_refuses_keys_it_does_not_read(batch):
    """A batch key the family does not read raises, as does a batch
    without the audio embeddings."""
    jc, _, _, pm, params = pair("float32")
    full = {"tokens": np.zeros((1, 4), np.int64),
            "audio_embeds": audio(1, jc, 0)}
    if batch:
        full.update(batch)
    else:
        del full["audio_embeds"]
    with pytest.raises(ValueError, match="audio_embeds|batch keys"):
        pm.forward(params, full)


def test_generate_refuses_positions_past_the_table():
    """The reference's gather clamps a position past ``dec_pos``; the
    port refuses the request."""
    _, _, _, pm, params = pair("float32")
    eng = ServeEngine(pm, params, max_len=ed.MAX_DEC_POS + 8)
    with pytest.raises(ValueError, match="position table"):
        eng.generate([[1, 2, 3]], ed.MAX_DEC_POS)
