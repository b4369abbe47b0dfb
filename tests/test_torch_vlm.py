"""The port's vision-language family (``pixtral-12b``) against the JAX
package's, on the CPU.

The vision frontend is a stub in both packages: precomputed patch
embeddings take the first ``n_embeds`` positions of the token stream,
and the rest is the dense stack (RMSNorm, rope at theta 1e6, SwiGLU, an
untied head).  Configs: ``pixtral-12b`` reduced (2 layers, d 64, 4 query
heads over 2 KV heads of 16, d_ff 128, vocab 256, 8 patch embeddings)
and a variant of 8 query heads over 2 (the full config's group of 4);
each at float32 and at the config's bfloat16.  Weights are the
reference's ``init_params(0)`` carried over by ``params.lm_from_params``;
patch embeddings and tokens come from seeded numpy.

Tolerances, as ``tests/test_torch_lm.py``: float32 1e-4 * max(1,
max|reference|) and greedy tokens equal; bfloat16 2e-2 * max(1,
max|reference|).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jx_get  # noqa: E402
from repro.models.model import build_model as jx_build  # noqa: E402
from repro.serve import ServeEngine as JxServe  # noqa: E402

import repro_torch.configs.base as pt_base  # noqa: E402
import repro_torch.models.transformer as tf  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.params import lm_from_params  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

from test_torch_lm import assert_close, f32, port_cfg  # noqa: E402

DTYPES = ["float32", "bfloat16"]
VARIANTS = {"base": {}, "group4": dict(n_heads=8, n_kv_heads=2)}


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
    jc = dataclasses.replace(jx_get("pixtral-12b").reduced(), dtype=dtype,
                             **VARIANTS[variant])
    jm = jx_build(jc)
    tree = jax.tree.map(np.asarray, jm.init_params(0))
    pc = port_cfg(jc)
    return jc, jm, tree, build_model(pc), lm_from_params(pc, tree,
                                                         device="cpu")


def patches(batch: int, cfg, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.frontend.n_embeds, cfg.d_model)).astype(np.float32)


def _jx_batch(toks, p):
    batch = {"tokens": jnp.asarray(toks, jnp.int32)}
    if p is not None:
        batch["patch_embeds"] = jnp.asarray(p)
    return batch


# ---------------------------------------------------------------------------
# config, specs
# ---------------------------------------------------------------------------

def test_registry_holds_pixtral_as_the_reference_does():
    cfg = pt_base.get_config("pixtral-12b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jx_get("pixtral-12b"))
    assert cfg.param_count() == build_model(cfg).param_count() \
        == 12_247_782_400
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.rope_theta,
            cfg.tie_embeddings, cfg.frontend.n_embeds) == \
        (32, 8, 128, 1e6, False, 1024)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_param_specs_are_the_reference_tree(reduced):
    """Paths and shapes of the port's specs are the reference's
    ``param_shapes()`` (nothing allocated at full width).  The count is
    summed in Python: the reference's ``Model.param_count`` multiplies
    leaf shapes in int32, which the (40, 5120, 14336) MLP stacks
    overflow at full width."""
    ref = jx_get("pixtral-12b")
    ref = ref.reduced() if reduced else ref
    shapes = jx_build(ref).param_shapes()
    flat = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    model = build_model(port_cfg(ref))
    assert {s.path: s.shape for s in model.param_specs()} == flat
    assert model.param_count() == ref.param_count() \
        == sum(int(np.prod(s)) for s in flat.values())


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_logits_and_cache(dtype, variant):
    """The patch merge and the dense stack after it: logits and every
    layer's K/V (the patch positions' too), and the same numbers from
    torch tensors."""
    jc, jm, tree, pm, params = pair(dtype, variant)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jc.vocab_size, (2, 23))
    p = patches(2, jc, 2)
    wl, _, wc = jm.forward(tree, _jx_batch(toks, p), return_cache=True)
    gl, aux, gc = pm.forward(params, {"tokens": toks, "patch_embeds": p},
                             return_cache=True)
    assert gl.dtype == torch.float32 and float(aux) == 0.0
    assert gl.shape == (2, 23, jc.vocab_size)
    assert_close(gl, wl, dtype)
    for got, want in zip(gc["layers"], wc["layers"]):
        assert got.dtype == getattr(torch, dtype)
        assert_close(got, want, dtype)
    at = np.array([22, 9])
    one, _, _ = pm.forward(params, {"tokens": torch.from_numpy(toks),
                                    "patch_embeds": torch.from_numpy(p)},
                           logits_at=at)
    assert_close(one, gl[torch.arange(2), torch.from_numpy(at)], "float32")


@pytest.mark.parametrize("dtype", DTYPES)
def test_patches_replace_the_first_positions_only(dtype):
    """Without ``patch_embeds`` the family is the dense stack (the
    reference's ``batch.get``); with them, the logits move, and the token
    ids under the patches are not read."""
    jc, jm, tree, pm, params = pair(dtype)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jc.vocab_size, (2, 15))
    wl, _, _ = jm.forward(tree, _jx_batch(toks, None))
    plain, _, _ = pm.forward(params, {"tokens": toks})
    assert_close(plain, wl, dtype)
    p = patches(2, jc, 4)
    merged, _, _ = pm.forward(params, {"tokens": toks, "patch_embeds": p})
    assert float((merged - plain).abs().max()) > 1.0
    other = toks.copy()
    other[:, :jc.frontend.n_embeds] = 0
    again, _, _ = pm.forward(params, {"tokens": other, "patch_embeds": p})
    assert torch.equal(again, merged)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_match(dtype, variant):
    """``prefill`` with patches to a longer cache, then two decode steps
    at ragged positions: logits and every cache row."""
    jc, jm, tree, pm, params = pair(dtype, variant)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jc.vocab_size, (2, 19))
    p = patches(2, jc, 6)
    wl, wcache = jm.prefill(tree, _jx_batch(toks, p), max_len=32)
    gl, gcache = pm.prefill(params, {"tokens": toks, "patch_embeds": p},
                            max_len=32)
    assert_close(gl, wl, dtype)
    assert gcache["layers"][0].shape == wcache["layers"][0].shape
    pos = np.array([19, 11], np.int32)
    for step in range(2):
        tok = rng.integers(0, jc.vocab_size, (2, 1)).astype(np.int32)
        wl, wcache = jm.decode_step(tree, jnp.asarray(tok),
                                    jnp.asarray(pos + step), wcache)
        gl, gcache = pm.decode_step(params, torch.from_numpy(tok),
                                    torch.from_numpy(pos + step), gcache)
        assert_close(gl, wl, dtype)
    for got, want in zip(gcache["layers"], wcache["layers"]):
        assert_close(got, want, dtype)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _prompts(vocab: int):
    """Ragged prompts, each the 8 image positions' placeholder ids and
    some text; one shorter than the patches (its last real position is
    an image position)."""
    rng = np.random.default_rng(7)
    return [[int(t) for t in rng.integers(0, vocab, n)]
            for n in (20, 11, 33, 5)]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_generate_greedy_matches_reference_float32(variant):
    jc, jm, tree, pm, params = pair("float32", variant)
    ps = _prompts(jc.vocab_size)
    p = patches(len(ps), jc, 8)
    want = JxServe(jm, tree, max_len=48).generate(
        ps, max_new_tokens=8, extras={"patch_embeds": jnp.asarray(p)})
    got = ServeEngine(pm, params, max_len=48).generate(
        ps, max_new_tokens=8, extras={"patch_embeds": p})
    assert got == want
    assert [len(g) for g in got] == [len(q) + 8 for q in ps]


def test_generate_first_token_logits_bfloat16():
    jc, jm, tree, pm, params = pair("bfloat16")
    ps = _prompts(jc.vocab_size)
    p = patches(len(ps), jc, 9)
    lens = np.array([len(q) for q in ps])
    toks = np.zeros((len(ps), lens.max()), np.int32)
    for i, q in enumerate(ps):
        toks[i, :len(q)] = q
    wl, _, _ = jm.forward(tree, _jx_batch(toks, p))
    want = f32(wl)[np.arange(len(ps)), lens - 1]
    got, _, _ = pm.forward(params, {"tokens": toks, "patch_embeds": p},
                           logits_at=lens - 1)
    assert_close(got, want, "bfloat16")


def test_generate_refuses_a_prompt_not_longer_than_the_patches():
    """The reference's concat gives P positions, not S, when S < P (and
    the engine's gather then reads past them); the port refuses any
    batch whose longest prompt is not longer than the patches."""
    jc, _, _, pm, params = pair("float32")
    P = jc.frontend.n_embeds
    eng = ServeEngine(pm, params, max_len=48)
    for n in (P - 3, P):
        with pytest.raises(ValueError, match="longer than the 8 patch"):
            eng.generate([[1] * n, [2] * 3], 2,
                         extras={"patch_embeds": patches(2, jc, 0)})
    assert len(eng.generate([[1] * (P + 1)], 2, extras={
        "patch_embeds": patches(1, jc, 0)})[0]) == P + 3


@pytest.mark.parametrize("key,shape", [("audio_embeds", (1, 8, 64)),
                                       ("loss_mask", (1, 12))])
def test_forward_refuses_keys_it_does_not_read(key, shape):
    jc, _, _, pm, params = pair("float32")
    batch = {"tokens": np.zeros((1, 12), np.int64),
             "patch_embeds": patches(1, jc, 0), key: np.zeros(shape)}
    with pytest.raises(ValueError, match="batch keys"):
        pm.forward(params, batch)
    # the dense family reads neither frontend key
    dense = build_model(port_cfg(jx_get("qwen2-0.5b").reduced()))
    with pytest.raises(ValueError, match="batch keys"):
        dense.forward(params, {"tokens": batch["tokens"],
                               "patch_embeds": batch["patch_embeds"]})


def test_merge_checks_the_patch_shape():
    jc, _, _, _, params = pair("float32")
    h = torch.zeros(2, 12, jc.d_model)
    for bad in ((1, 8, jc.d_model), (2, 8, jc.d_model + 1), (2, 8)):
        with pytest.raises(ValueError, match="patch_embeds"):
            tf.merge_patches(h, torch.zeros(bad))
