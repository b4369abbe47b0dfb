"""The port's LM serving stack against the JAX package's, on the CPU.

Configs: ``qwen2-0.5b`` reduced (2 layers, d 64, 4 q heads over 2 KV
heads, head dim 16, vocab 256), a variant with 14 q heads over 2 (GQA
group 7), and an untied-head variant (with tied embeddings a randomly
initialised model echoes its last token, so greedy decoding alone says
little there); each at float32 and at the config's bfloat16.  Weights
are the reference's ``init_params(0)`` carried over by
``params.lm_from_params``; inputs come from seeded numpy.  The
reference's attention runs its CPU path (``_chunked_jnp`` and
``_jnp_fallback``), the port's its plain versions (CPU tensors).

Tolerances, on the max |difference| against the reference's output:
  * float32: 1e-4 * max(1, max|reference|) (the two sum in other
    orders), and greedy tokens equal;
  * bfloat16: 2e-2 * max(1, max|reference|).  XLA's and torch's CPU
    bf16 matmuls round differently in about 0.02% of outputs, by one
    bf16 ulp, and the layers carry that on (measured: 0.4-0.9% of
    max|logit|).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.attention as jx_attn  # noqa: E402
import repro.models.layers as jx_layers  # noqa: E402
import repro.models.transformer as jx_tf  # noqa: E402
from repro.configs import ASSIGNED_ARCHS, get_config as jx_get  # noqa: E402
from repro.models.model import build_model as jx_build  # noqa: E402
from repro.serve import ServeEngine as JxServe  # noqa: E402

import repro_torch.configs.base as pt_base  # noqa: E402
import repro_torch.models.transformer as tf  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.params import lm_from_params  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

DTYPES = ["float32", "bfloat16"]
VARIANTS = {"base": {}, "group7": dict(n_heads=14, n_kv_heads=2),
            "untied": dict(tie_embeddings=False)}


@pytest.fixture(autouse=True)
def _one_thread():
    # small eager ops are slow on many threads in a shared sandbox
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(ref):
    """The port's ModelConfig with every field of the reference's."""
    d = dataclasses.asdict(ref)
    d["moe"] = pt_base.MoEConfig(**d["moe"])
    d["ssm"] = pt_base.SSMConfig(**d["ssm"])
    d["frontend"] = pt_base.FrontendConfig(**d["frontend"])
    if d["hybrid"] is not None:
        d["hybrid"] = pt_base.HybridConfig(**d["hybrid"])
    return pt_base.ModelConfig(**d)


@functools.lru_cache(maxsize=None)
def pair(dtype: str, variant: str = "base"):
    """(reference config, reference model, its init_params(0) tree as
    numpy, port config, port model, port weights from that tree)."""
    jc = dataclasses.replace(jx_get("qwen2-0.5b").reduced(), dtype=dtype,
                             **VARIANTS[variant])
    jm = jx_build(jc)
    tree = jax.tree.map(np.asarray, jm.init_params(0))
    pc = port_cfg(jc)
    return jc, jm, tree, pc, build_model(pc), lm_from_params(pc, tree,
                                                             device="cpu")


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_close(got, want, dtype: str) -> float:
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    rel = 1e-4 if dtype == "float32" else 2e-2
    tol = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)
    return err


def jx_arr(a: np.ndarray, dtype: str):
    return jnp.asarray(a, jnp.float32).astype(dtype)


def pt_arr(a: np.ndarray, dtype: str):
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch,
                                                                  dtype))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_config_copy_counts_parameters_like_the_reference(arch):
    """The port's copy of ``_param_count`` and ``reduced()`` gives the
    reference's numbers and fields for every architecture the reference
    registers."""
    ref = jx_get(arch)
    cfg = port_cfg(ref)
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    assert dataclasses.asdict(cfg.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert cfg.reduced().param_count() == ref.reduced().param_count()
    assert (cfg.q_dim, cfg.kv_dim, cfg.sub_quadratic) == \
        (ref.q_dim, ref.kv_dim, ref.sub_quadratic)


def test_registry_holds_qwen2_as_the_reference_does():
    """The registry holds every LM configuration the reference registers
    (all of ``ASSIGNED_ARCHS``); the reference's ``multiscope``
    placeholder (family "pipeline", no LM) is not copied."""
    cfg = pt_base.get_config("qwen2-0.5b")
    assert dataclasses.asdict(cfg) == \
        dataclasses.asdict(jx_get("qwen2-0.5b"))
    assert pt_base.list_archs() == [
        "deepseek-67b", "deepseek-coder-33b", "deepseek-moe-16b",
        "grok-1-314b", "mamba2-370m", "pixtral-12b", "qwen2-0.5b",
        "stablelm-1.6b", "whisper-small", "zamba2-7b"]
    assert pt_base.list_archs() == sorted(ASSIGNED_ARCHS)
    with pytest.raises(KeyError):
        pt_base.get_config("multiscope")
    with pytest.raises(ValueError):
        dataclasses.replace(cfg, n_kv_heads=3)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_param_specs_are_the_reference_tree(reduced):
    """Paths and shapes of the port's specs are the reference's
    parameter tree (shape mode: nothing is allocated at full width), and
    ``Model.param_count`` is the analytic count."""
    ref = jx_get("qwen2-0.5b")
    ref = ref.reduced() if reduced else ref
    shapes = jx_build(ref).param_shapes()
    flat = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    model = build_model(port_cfg(ref))
    assert {s.path: s.shape for s in model.param_specs()} == flat
    assert model.param_count() == ref.param_count() \
        == jx_build(ref).param_count()


@pytest.mark.parametrize("arch,family", [
    ("deepseek-moe-16b", "moe"), ("pixtral-12b", "vlm"),
    ("whisper-small", "encdec")])
def test_other_families_raise_naming_the_roadmap(arch, family):
    """Every family is ported now, so none raises naming a ROADMAP.md
    item: the moe, vlm and encdec families build
    (``tests/test_torch_moe.py``, ``test_torch_vlm.py``,
    ``test_torch_encdec.py``), and only a family with no LM (the
    pipeline's) raises.  Their specs hold ``cfg.param_count()``
    parameters; for encdec, plus the LayerNorm and GELU-MLP biases the
    analytic count leaves out (``test_torch_encdec``)."""
    cfg = port_cfg(jx_get(arch).reduced())
    assert cfg.family == family and family in tf.PORTED
    with pytest.raises(ValueError, match="has no LM"):
        tf.check_family(dataclasses.replace(cfg, family="pipeline"))
    extra = 0
    if family == "encdec":
        d = cfg.d_model
        extra = (2 * cfg.n_encoder_layers + 3 * cfg.n_layers + 2) * d \
            + (cfg.n_encoder_layers + cfg.n_layers) * (cfg.d_ff + d)
    assert build_model(cfg).param_count() == cfg.param_count() + extra
    assert build_model(cfg).param_count() == \
        jx_build(jx_get(arch).reduced()).param_count()


# ---------------------------------------------------------------------------
# stablelm-1.6b: MHA (32 of 32 heads), QKV bias, an untied head
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def stablelm_pair():
    """``pair`` for ``stablelm-1.6b`` reduced at float32: (reference
    model, its init_params(0) tree as numpy, port model, weights)."""
    jc = dataclasses.replace(jx_get("stablelm-1.6b").reduced(),
                             dtype="float32")
    jm = jx_build(jc)
    tree = jax.tree.map(np.asarray, jm.init_params(0))
    pc = port_cfg(jc)
    return jm, tree, build_model(pc), lm_from_params(pc, tree, device="cpu")


def test_registry_holds_stablelm_as_the_reference_does():
    cfg = pt_base.get_config("stablelm-1.6b")
    assert dataclasses.asdict(cfg) == \
        dataclasses.asdict(jx_get("stablelm-1.6b"))
    assert cfg.param_count() == 1_644_414_976
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.qkv_bias,
            cfg.tie_embeddings) == (32, 32, 64, True, False)
    model = build_model(cfg)
    assert model.param_count() == 1_644_414_976


def test_stablelm_lm_forward_logits_and_cache_float32():
    jm, tree, pm, params = stablelm_pair()
    assert params.lm_head is not None
    toks = np.random.default_rng(40).integers(0, 256, (2, 37))
    wl, _, wc = jm.forward(tree, {"tokens": jnp.asarray(toks, jnp.int32)},
                           return_cache=True)
    gl, _, gc = pm.forward(params, {"tokens": toks}, return_cache=True)
    assert_close(gl, wl, "float32")
    for got, want in zip(gc["layers"], wc["layers"]):
        assert_close(got, want, "float32")


def test_stablelm_generate_greedy_matches_reference_float32():
    jm, tree, pm, params = stablelm_pair()
    ps = _prompts("long", 256)
    want = JxServe(jm, tree, max_len=48).generate(ps, max_new_tokens=8)
    got = ServeEngine(pm, params, max_len=48).generate(ps, max_new_tokens=8)
    assert got == want


# ---------------------------------------------------------------------------
# deepseek-67b and deepseek-coder-33b: head dim 128, GQA groups of 8 and 7
# ---------------------------------------------------------------------------

DEEPSEEK_DENSE = ("deepseek-67b", "deepseek-coder-33b")


@functools.lru_cache(maxsize=None)
def dense_pair(arch: str):
    """``stablelm_pair`` for a dense config reduced at float32."""
    jc = dataclasses.replace(jx_get(arch).reduced(), dtype="float32")
    jm = jx_build(jc)
    tree = jax.tree.map(np.asarray, jm.init_params(0))
    pc = port_cfg(jc)
    return jm, tree, build_model(pc), lm_from_params(pc, tree, device="cpu")


@pytest.mark.parametrize("arch,count,heads", [
    ("deepseek-67b", 67_425_001_472, (64, 8)),
    ("deepseek-coder-33b", 33_342_991_360, (56, 8))])
def test_registry_holds_the_deepseek_dense_configs(arch, count, heads):
    cfg = pt_base.get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jx_get(arch))
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == heads + (128,)
    assert cfg.param_count() == build_model(cfg).param_count() == count


@pytest.mark.parametrize("arch", DEEPSEEK_DENSE)
def test_deepseek_dense_lm_forward_logits_and_cache_float32(arch):
    jm, tree, pm, params = dense_pair(arch)
    toks = np.random.default_rng(41).integers(0, 256, (2, 37))
    wl, _, wc = jm.forward(tree, {"tokens": jnp.asarray(toks, jnp.int32)},
                           return_cache=True)
    gl, _, gc = pm.forward(params, {"tokens": toks}, return_cache=True)
    assert_close(gl, wl, "float32")
    for got, want in zip(gc["layers"], wc["layers"]):
        assert_close(got, want, "float32")


@pytest.mark.parametrize("arch", DEEPSEEK_DENSE)
def test_deepseek_dense_generate_greedy_matches_reference_float32(arch):
    jm, tree, pm, params = dense_pair(arch)
    ps = _prompts("long", 256)
    want = JxServe(jm, tree, max_len=48).generate(ps, max_new_tokens=8)
    got = ServeEngine(pm, params, max_len=48).generate(ps, max_new_tokens=8)
    assert got == want


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-370m"])
def test_param_dtype_bfloat16_forward_matches_the_reference(arch, dtype):
    """Weights held in bf16 (``param_dtype``, the reference's knob) in the
    dense and ssm families (the hybrid's: ``test_torch_hybrid``): every
    parameter is held in bf16, and the logits at either activation dtype
    are the reference's (norm scales, the SSM's dt_bias, A_log and D and
    the head upcast where it upcasts them)."""
    jc = dataclasses.replace(jx_get(arch).reduced(), dtype=dtype,
                             param_dtype="bfloat16")
    jm = jx_build(jc)
    jtree = jm.init_params(0)
    pc = port_cfg(jc)
    params = lm_from_params(pc, jax.tree.map(np.asarray, jtree),
                            device="cpu")
    assert {p.dtype for p in params.parameters()} == {torch.bfloat16}
    toks = np.random.default_rng(42).integers(0, 256, (2, 29))
    wl, _, _ = jm.forward(jtree, {"tokens": jnp.asarray(toks, jnp.int32)})
    gl, _, _ = build_model(pc).forward(params, {"tokens": toks})
    assert_close(gl, wl, dtype)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_matches(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)) * 3
    scale = rng.standard_normal(64)
    want = jx_layers.rmsnorm({"scale": jnp.asarray(scale, jnp.float32)},
                             jx_arr(x, dtype), 1e-6)
    norm = layers.RMSNorm(64, 1e-6, "cpu")
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
    got = norm(pt_arr(x, dtype))
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rope_matches(dtype):
    """Tables at positions 0..S-1 and at per-row decode positions, and
    the half-split rotation in the activation dtype."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 7, 4, 16))
    for pos in (np.arange(7), np.array([[5], [0], [900]])):
        jc, js = jx_layers.rope_tables(jnp.asarray(pos), 16, 1e6)
        pc, ps = layers.rope_tables(torch.from_numpy(pos), 16, 1e6)
        assert_close(pc, jc, "float32")
        assert_close(ps, js, "float32")
        xx = x[:, :1] if pos.ndim == 2 else x
        want = jx_layers.apply_rope(jx_arr(xx, dtype), jc, js)
        got = layers.apply_rope(pt_arr(xx, dtype), pc, ps)
        assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_swiglu_and_linear_match(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64))
    p = {k: rng.standard_normal(s) / 8 for k, s in (
        ("w_gate", (64, 128)), ("w_up", (64, 128)), ("w_down", (128, 64)))}
    want = jx_layers.mlp_swiglu(
        {k: jnp.asarray(v, jnp.float32) for k, v in p.items()},
        jx_arr(x, dtype))
    mlp = layers.SwiGLU(64, 128, "cpu")
    lin = layers.Linear(64, 128, True, "cpu")
    b = rng.standard_normal(128)
    with torch.no_grad():
        for k, v in p.items():
            getattr(mlp, k).copy_(torch.from_numpy(v))
        lin.w.copy_(torch.from_numpy(p["w_up"]))
        lin.b.copy_(torch.from_numpy(b))
    assert_close(mlp(pt_arr(x, dtype)), want, dtype)
    want = jx_layers.linear({"w": jnp.asarray(p["w_up"], jnp.float32),
                             "b": jnp.asarray(b, jnp.float32)},
                            jx_arr(x, dtype))
    assert_close(lin(pt_arr(x, dtype)), want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_weight_casts_are_kept_once_at_load(dtype):
    """A layer weight's copy in the activation dtype is made when it is
    loaded, equals a cast, follows a later load, moves with ``.to()``
    and stays out of ``state_dict``; in f32 there is no copy.  Uses read
    the kept copy with grad mode off (serving); with it on, a weight is
    cast at use (in the graph), to the same bits."""
    *_, params = pair(dtype)
    act = getattr(torch, dtype)
    mlp, wq = params.layers[1].mlp, params.layers[1].attn.wq
    kept = [k for k, _ in params.named_buffers() if k.endswith("_cast")]
    assert not any("_cast" in k for k in params.state_dict())
    if dtype == "float32":
        assert kept == [] and mlp.weight("w_up", act) is mlp.w_up
        return
    # wq, wk, wv (weights and biases), wo and the three SwiGLU weights
    # of every layer; nothing of the embedding or the head
    assert len(kept) == len(params.layers) * 10
    for m, name in ((mlp, "w_up"), (wq, "w"), (wq, "b")):
        with torch.no_grad():
            assert m.weight(name, act) is getattr(m, f"{name}_cast")
        assert m.weight(name, act) is not getattr(m, f"{name}_cast")
        assert torch.equal(m.weight(name, act), getattr(m, name).to(act))
        assert torch.equal(getattr(m, f"{name}_cast"),
                           getattr(m, name).to(act))
    fresh = tf.TransformerLM(params.cfg, "cpu")
    fresh.load_state_dict(params.state_dict())
    assert not [k for k, _ in fresh.named_buffers()]     # not loaded:
    x = torch.randn(3, params.cfg.d_model).to(act)      # cast at use
    assert torch.equal(fresh.layers[1].mlp(x), mlp(x))
    stacked = torch.randn((len(params.layers),) + tuple(mlp.w_up.shape))
    saved = torch.stack([layer.mlp.w_up.clone() for layer in params.layers])
    try:
        params.load_("layers/mlp/w_up", stacked)
        assert torch.equal(mlp.w_up_cast, stacked[1].to(act))
    finally:
        params.load_("layers/mlp/w_up", saved)
    assert torch.equal(mlp.w_up_cast, saved[1].to(act))
    assert params.to(torch.device("cpu")).layers[1].mlp.w_up_cast.dtype \
        == act


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _layer0(tree):
    return jax.tree.map(lambda a: jnp.asarray(a[0]), tree["layers"])


@pytest.mark.parametrize("variant", ["base", "group7"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_full_matches(dtype, variant):
    jc, _, tree, _, _, params = pair(dtype, variant)
    x = np.random.default_rng(4).standard_normal((2, 37, jc.d_model))
    want = jx_attn.attention_full(_layer0(tree)["attn"], jx_arr(x, dtype),
                                  jc)
    with torch.inference_mode():
        got, (k, v) = params.layers[0].attn(pt_arr(x, dtype))
    assert got.dtype == getattr(torch, dtype)
    assert k.shape == (2, 37, jc.n_kv_heads, jc.head_dim)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("variant", ["base", "group7"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_decode_matches(dtype, variant):
    """One decode step over a random cache at per-row positions (one of
    them 0, one at the last slot): the output, and the cache written in
    place at (row, pos) only."""
    jc, _, tree, _, _, params = pair(dtype, variant)
    rng = np.random.default_rng(5)
    S = 24
    x = rng.standard_normal((3, 1, jc.d_model))
    ck, cv = (rng.standard_normal((3, S, jc.n_kv_heads, jc.head_dim))
              for _ in range(2))
    pos = np.array([0, 11, S - 1], np.int32)
    want, wk, wv = jx_attn.attention_decode(
        _layer0(tree)["attn"], jx_arr(x, dtype), jx_arr(ck, dtype),
        jx_arr(cv, dtype), jnp.asarray(pos), jc)
    tk, tv = pt_arr(ck, dtype), pt_arr(cv, dtype)
    before = tk.clone()
    with torch.inference_mode():
        got = params.layers[0].attn.decode(pt_arr(x, dtype), tk, tv,
                                           torch.from_numpy(pos))
    assert_close(got, want, dtype)
    assert_close(tk, wk, dtype)
    assert_close(tv, wv, dtype)
    untouched = np.ones((3, S), bool)
    untouched[np.arange(3), pos] = False
    assert torch.equal(tk[torch.from_numpy(untouched)],
                       before[torch.from_numpy(untouched)])


# ---------------------------------------------------------------------------
# the LM: forward with cache capture, decode, prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_lm_forward_logits_and_cache(dtype, variant):
    jc, jm, tree, _, pm, params = pair(dtype, variant)
    toks = np.random.default_rng(6).integers(0, jc.vocab_size, (2, 37))
    wl, _, wc = jm.forward(tree, {"tokens": jnp.asarray(toks, jnp.int32)},
                           return_cache=True)
    gl, aux, gc = pm.forward(params, {"tokens": toks}, return_cache=True)
    assert gl.dtype == torch.float32 and float(aux) == 0.0
    assert_close(gl, wl, dtype)
    for got, want in zip(gc["layers"], wc["layers"]):
        assert got.dtype == getattr(torch, dtype)
        assert_close(got, want, dtype)
    # logits at one position per row: the same numbers up to the head
    # matmul's summation order at another shape
    at = np.array([36, 4])
    one, _, _ = pm.forward(params, {"tokens": toks}, logits_at=at)
    assert_close(one, gl[torch.arange(2), torch.from_numpy(at)], "float32")


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_lm_decode_match(dtype, variant):
    """``prefill`` to a longer cache, then two decode steps at ragged
    positions: logits and every cache row."""
    jc, jm, tree, _, pm, params = pair(dtype, variant)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jc.vocab_size, (2, 19))
    wl, wcache = jm.prefill(tree, {"tokens": jnp.asarray(toks, jnp.int32)},
                            max_len=32)
    gl, gcache = pm.prefill(params, {"tokens": toks}, max_len=32)
    assert_close(gl, wl, dtype)
    assert gcache["layers"][0].shape == wcache["layers"][0].shape
    pos = np.array([19, 7], np.int32)
    for step in range(2):
        tok = rng.integers(0, jc.vocab_size, (2, 1)).astype(np.int32)
        wl, wcache = jm.decode_step(tree, jnp.asarray(tok),
                                    jnp.asarray(pos + step), wcache)
        gl, gcache = pm.decode_step(params, torch.from_numpy(tok),
                                    torch.from_numpy(pos + step), gcache)
        assert gl.shape == (2, jc.vocab_size)
        assert_close(gl, wl, dtype)
    for got, want in zip(gcache["layers"], wcache["layers"]):
        assert_close(got, want, dtype)


def test_make_cache_and_pad_cache_match():
    jc, _, _, pc, pm, _ = pair("bfloat16")
    want, _ = jx_tf.make_cache(jc, 3, 20, mode="init")
    got = pm.make_cache(3, 20, device="cpu")
    for g, w in zip(got["layers"], want["layers"]):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        assert not g.any()
    k = np.random.default_rng(8).standard_normal(
        (2, 3, 5, jc.n_kv_heads, jc.head_dim))
    wp = jx_tf.pad_cache(jc, {"layers": (jx_arr(k, "float32"),) * 2}, 9)
    gp = tf.pad_cache(pc, {"layers": (pt_arr(k, "float32"),) * 2}, 9)
    for g, w in zip(gp["layers"], wp["layers"]):
        assert np.array_equal(f32(g), f32(w))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _prompts(kind: str, vocab: int):
    if kind == "short":
        return [[1, 2, 3], [7, 8]]
    rng = np.random.default_rng(9)
    return [[int(t) for t in rng.integers(0, vocab, n)]
            for n in (20, 5, 33, 1)]


@pytest.mark.parametrize("prompts", ["short", "long"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_generate_greedy_matches_reference_float32(variant, prompts):
    """Greedy serving, token for token, at float32."""
    _, jm, tree, _, pm, params = pair("float32", variant)
    ps = _prompts(prompts, 256)
    want = JxServe(jm, tree, max_len=48).generate(ps, max_new_tokens=8)
    got = ServeEngine(pm, params, max_len=48).generate(ps, max_new_tokens=8)
    assert got == want
    assert [len(g) for g in got] == [len(p) + 8 for p in ps]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_generate_first_token_logits_bfloat16(variant):
    """At the config's bf16 the first sampled token's logits (each row's
    last real position after a ragged prefill) stay within the bf16
    tolerance of the reference's; greedy tokens agree wherever the
    reference's top-2 margin exceeds twice that tolerance."""
    _, jm, tree, _, pm, params = pair("bfloat16", variant)
    ps = _prompts("long", 256)
    lens = np.array([len(p) for p in ps])
    toks = np.zeros((len(ps), lens.max()), np.int32)
    for i, p in enumerate(ps):
        toks[i, :len(p)] = p
    wl, _, _ = jm.forward(tree, {"tokens": jnp.asarray(toks)})
    want = f32(wl)[np.arange(len(ps)), lens - 1]
    got, _, _ = pm.forward(params, {"tokens": toks}, logits_at=lens - 1)
    err = assert_close(got, want, "bfloat16")
    top2 = np.sort(want, axis=-1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > 2 * 2e-2 * max(1.0, np.abs(want).max())
    first = [g[len(p)] for g, p in zip(
        ServeEngine(pm, params, max_len=48).generate(ps, 1), ps)]
    assert np.array_equal(np.array(first)[sure], want.argmax(-1)[sure]), err


def test_generate_is_deterministic_and_ragged_rows_are_independent():
    """A repeat gives the same tokens; each prompt served alone gives the
    tokens it gets in the batch (padding never leaks)."""
    _, _, _, _, pm, params = pair("float32", "untied")
    eng = ServeEngine(pm, params, max_len=48)
    ps = _prompts("long", 256)
    a = eng.generate(ps, 6)
    assert a == eng.generate(ps, 6)
    assert [eng.generate([p], 6)[0] for p in ps] == a


def test_sampling_is_deterministic_given_the_seed():
    _, _, _, _, pm, params = pair("float32", "untied")
    ps = _prompts("short", 256)
    a = ServeEngine(pm, params, 32, temperature=1.0, seed=3).generate(ps, 6)
    assert a == ServeEngine(pm, params, 32, temperature=1.0,
                            seed=3).generate(ps, 6)
    assert all(0 <= t < 256 for row in a for t in row)
    greedy = ServeEngine(pm, params, 32).generate(ps, 6)
    assert a != greedy       # this seed's draws leave the argmax path


def test_generate_raises_when_the_cache_has_no_room():
    """The reference silently drops the writes past max_len; the port
    refuses the request."""
    _, _, _, _, pm, params = pair("float32")
    eng = ServeEngine(pm, params, max_len=10)
    assert len(eng.generate([[1, 2, 3, 4]], 6)[0]) == 10
    with pytest.raises(ValueError, match="max_len"):
        eng.generate([[1, 2, 3, 4, 5]], 6)


@pytest.mark.parametrize("prompts", [[], [[1, 2], []], [[1, 256]],
                                     [[-1, 3]]],
                         ids=["no-prompt", "empty", "past-vocab",
                              "negative"])
def test_generate_rejects_malformed_prompts(prompts):
    _, _, _, _, pm, params = pair("float32")
    with pytest.raises(ValueError, match="token ids"):
        ServeEngine(pm, params, max_len=16).generate(prompts, 2)


def test_lm_from_params_checks_every_shape():
    jc, _, tree, pc, _, _ = pair("float32")
    bad = jax.tree.map(lambda a: a, tree)
    bad["layers"]["attn"]["wk"]["w"] = np.zeros((2, 64, 16), np.float32)
    with pytest.raises(ValueError, match="layers/attn/wk/w"):
        lm_from_params(pc, bad, device="cpu")
    extra = jax.tree.map(lambda a: a, tree)
    extra["lm_head"] = {"w": np.zeros((64, 256), np.float32)}
    with pytest.raises(ValueError, match="lm_head/w"):
        lm_from_params(pc, extra, device="cpu")
    missing = {k: v for k, v in tree.items() if k != "ln_final"}
    with pytest.raises(ValueError, match="ln_final"):
        lm_from_params(pc, missing, device="cpu")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults would run")
    jc, _, tree, pc, pm, _ = pair("float32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pm.init_params(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_from_params(pc, tree)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pm.make_cache(1, 8)


def test_port_init_is_seeded_by_name():
    """The port's own init: the reference's shapes and scales, the same
    numbers for the same seed, other numbers for another seed (and not
    the reference's numbers: another generator)."""
    _, _, tree, pc, pm, _ = pair("float32")
    a, b = pm.init_params(0, device="cpu"), pm.init_params(0, device="cpu")
    c = pm.init_params(1, device="cpu")
    for (name, pa), pb, pc_ in zip(a.named_parameters(), b.parameters(),
                                   c.parameters()):
        assert torch.equal(pa, pb), name
    wq = a.layers[1].attn.wq.w
    assert not torch.equal(wq, c.layers[1].attn.wq.w)
    assert abs(float(wq.std()) - 1 / 8) < 0.02          # 1/sqrt(64)
    assert abs(float(a.embed.table.std()) - 1.0) < 0.05
    assert torch.equal(a.layers[0].attn.wq.b, torch.zeros(64))
    assert torch.equal(a.layers[0].ln_mlp.scale, torch.ones(64))
    assert not np.allclose(wq.numpy(), tree["layers"]["attn"]["wq"]["w"][1])
