"""The port's ``TrainStep`` against the JAX package's, on the CPU: one
step of each family, with ``accum`` 1 and 2, ``cast_bf16`` and a
``grad_transform``; the port of ``tests/test_models.py``'s smoke
forward-and-train-step for every arch; and a ``generate`` after a step.

Configs are each family's reduced config with f32 activations, weights
drawn by the port's init and carried into both packages through
``params.lm_to_params`` / ``lm_from_params`` (as
``test_torch_train_lm``); the reference's step runs under ``jax.jit``.

Tolerances (f32; the two sum in other orders):
  * metrics (``loss``, ``ce``, ``aux``, ``tokens``, ``grad_norm``):
    relative 1e-5;
  * parameters after the step: 1e-5, except that AdamW's first step
    moves every element by lr * g / (|g| + eps), about +-lr whatever |g|
    is, and by an amount that moves with g's rounding where |g| is near
    eps: an element whose gradient is at rounding level (|g| at most
    1e-5 of its leaf's max |g| plus 1e-6 of the whole gradient's max:
    there the two packages' sums round apart, possibly to either sign)
    may land up to 2 lr away.  Such elements stay under 1% of the
    weights; they are mostly the key biases of whisper's rope-free
    attention, whose true gradient is 0 (its leaves read about 1e-8 of
    the whole gradient's max).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ASSIGNED_ARCHS  # noqa: E402
from repro.optim import adamw as jx_adamw  # noqa: E402
from repro.train import build_train_step as jx_build_step  # noqa: E402

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.params import lm_from_params, lm_to_params  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train import build_train_step  # noqa: E402

from test_torch_train_lm import _jbatch, _leaves, family_setup  # noqa: E402

LR = 1e-3
METRIC_RTOL = 1e-5
PARAM_ATOL = 1e-5
NOISE_REL, NOISE_FLOOR = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _zero_first_layer_wq(tree, xp):
    """A ``grad_transform`` that reads the stacked layout: layer 0's wq
    gradient set to zero (numpy-style ``xp`` update for either
    package)."""
    out = dict(tree)
    layers = dict(out["layers"])
    attn = dict(layers["attn"])
    attn["wq"] = dict(attn["wq"], w=xp(attn["wq"]["w"]))
    layers["attn"] = attn
    out["layers"] = layers
    return out


def _jx_zero0(x):
    return x.at[0].set(0.0)


def _pt_zero0(x):
    x = x.clone()
    x[0] = 0.0
    return x


# (arch, accum, cast_bf16, transform): one step of each family; accum 1
# and 2 and cast_bf16 each three times, the transform once
STEP_CASES = (("qwen2-0.5b", 1, False, True),
              ("deepseek-moe-16b", 2, False, False),
              ("pixtral-12b", 1, True, False),
              ("whisper-small", 2, True, False),
              ("mamba2-370m", 2, False, False),
              ("zamba2-7b", 1, True, False))


@pytest.mark.parametrize("arch,accum,cast,transform", STEP_CASES,
                         ids=[f"{c[0]}-accum{c[1]}{'-bf16' if c[2] else ''}"
                              f"{'-transform' if c[3] else ''}"
                              for c in STEP_CASES])
def test_train_step_matches_reference(arch, accum, cast, transform):
    jc, jm, pc, pm, tree, batch, mask = family_setup(arch, seed=1)
    batch = dict(batch, loss_mask=mask)
    # reference: one jitted step from the same weights
    jopt = jx_adamw(lr=LR)
    jts = jx_build_step(jm, jopt, accum=accum, cast_bf16=cast,
                        grad_transform=(lambda g: _zero_first_layer_wq(
                            g, _jx_zero0)) if transform else None)
    jparams = jax.tree.map(jnp.asarray, tree)
    want_p, _, want_m = jax.jit(jts)(jparams, jopt.init(jparams),
                                     _jbatch(batch))
    want_p = {p: np.asarray(v, np.float32) for p, v in _leaves(
        jax.tree.map(np.asarray, want_p))}
    # the port: the same step in place
    weights = lm_from_params(pc, tree, device="cpu")
    ts = build_train_step(pm, adamw(weights.parameters(), lr=LR),
                          accum=accum, cast_bf16=cast,
                          grad_transform=(lambda g: _zero_first_layer_wq(
                              g, _pt_zero0)) if transform else None)
    g, _ = ts.grads(weights, batch)
    with torch.no_grad():
        for p, x in zip(ts._params(), g):
            p.grad = x
    grads = dict(_leaves(lm_to_params(weights, grads=True)))
    for p in ts._params():
        p.grad = None
    got_m = ts(weights, batch)
    want_keys = {"loss", "grad_norm"} | (
        {"ce", "aux", "tokens"} if accum == 1 else set())
    assert set(got_m) == set(want_m) == want_keys
    for k in want_keys:
        w = float(want_m[k])
        assert abs(float(got_m[k]) - w) <= METRIC_RTOL * max(1.0, abs(w)), \
            (k, float(got_m[k]), w)
    got_p = dict(_leaves(lm_to_params(weights)))
    top = max(float(np.abs(x).max()) for x in grads.values())
    noisy = 0
    for path, w in want_p.items():
        diff = np.abs(got_p[path] - w)
        g_leaf = np.abs(grads[path])
        at_noise = g_leaf <= NOISE_REL * g_leaf.max() + NOISE_FLOOR * top
        assert float(diff[~at_noise].max(initial=0.0)) <= PARAM_ATOL, \
            (path, float(diff[~at_noise].max()))
        assert float(diff.max()) <= 2 * LR * (1 + 1e-3), path
        noisy += int((diff[at_noise] > PARAM_ATOL).sum())
    if transform:
        # the transform zeroed layer 0's wq gradient: AdamW moved it by
        # the decay only
        w0 = tree["layers"]["attn"]["wq"]["w"][0]
        np.testing.assert_allclose(got_p["layers/attn/wq/w"][0],
                                   w0 - LR * 0.1 * w0, rtol=0, atol=1e-7)
    assert noisy <= 1e-2 * sum(x.size for x in want_p.values()), noisy


def test_cast_bf16_casts_the_reference_leaves_and_keeps_f32_masters():
    """``cast_bf16`` casts a master where the reference's stacked leaf has
    two or more axes (a layer's norm scale: (L, d) there), the final
    norm's scale stays f32, and the masters stay f32 with f32
    gradients."""
    _, _, pc, pm, tree, batch, _ = family_setup("qwen2-0.5b")
    weights = lm_from_params(pc, tree, device="cpu")
    ts = build_train_step(pm, adamw(weights.parameters(), lr=LR),
                          cast_bf16=True)
    g, _ = ts.grads(weights, batch)
    assert all(x.dtype == torch.float32 for x in g)
    casts = ts._casts(weights)
    assert "w.layers.0.ln_attn.scale" in casts
    assert "w.ln_final.scale" not in casts
    assert "w.embed.table" in casts
    assert all(t.dtype == torch.bfloat16 and t.grad_fn is not None
               for t in casts.values())
    assert all(p.dtype == torch.float32 for p in weights.parameters())


def _smoke_batch(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
    key = {"vlm": "patch_embeds", "encdec": "audio_embeds"}.get(cfg.family)
    if key:
        batch[key] = rng.standard_normal(
            (B, cfg.frontend.n_embeds, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", list(ASSIGNED_ARCHS))
def test_smoke_forward_and_train_step(arch):
    """The port of ``tests/test_models.py::test_smoke_forward_and_train_step``:
    reduced config at its own dtypes, forward shape and no NaN, a finite
    loss, one real optimizer step that changes the weights."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init_params(0, device="cpu")
    batch = _smoke_batch(cfg)
    logits, aux, _ = model.forward(params, batch)
    B, S = batch["tokens"].shape
    assert logits.shape == (B, S, cfg.vocab_size)
    assert not bool(torch.isnan(logits).any())
    loss, metrics = model.loss(params, batch)
    assert np.isfinite(float(loss))
    before = [p.detach().clone() for p in params.parameters()]
    ts = build_train_step(model, adamw(params.parameters(), lr=1e-3))
    mets = ts(params, batch)
    assert np.isfinite(float(mets["loss"]))
    assert any(float((a - b.detach()).abs().max()) > 0
               for a, b in zip(before, params.parameters()))


def test_generate_after_a_step_reads_the_new_weights():
    """The kept activation-dtype copies are made again after the update:
    a ``generate`` after a train step equals one from a fresh model
    loaded with the stepped weights (bf16 activations over f32 masters,
    so every layer weight has a kept copy), and differs from the one
    before the step."""
    cfg = get_config("qwen2-0.5b").reduced()
    model = build_model(cfg)
    params = model.init_params(0, device="cpu")
    rng = np.random.default_rng(5)
    prompts = [list(rng.integers(0, cfg.vocab_size, n)) for n in (5, 9, 12)]
    before = ServeEngine(model, params, max_len=32).generate(prompts, 8)
    kept = params.layers[0].attn.wq.w_cast.clone()
    ts = build_train_step(model, adamw(params.parameters(), lr=5e-2))
    ts(params, _smoke_batch(cfg, B=4, S=24, seed=6))
    assert not torch.equal(kept, params.layers[0].attn.wq.w_cast)
    assert torch.equal(params.layers[0].attn.wq.w_cast,
                       params.layers[0].attn.wq.w.detach().to(
                           torch.bfloat16))
    after = ServeEngine(model, params, max_len=32).generate(prompts, 8)
    fresh = lm_from_params(cfg, lm_to_params(params), device="cpu")
    again = ServeEngine(model, fresh, max_len=32).generate(prompts, 8)
    assert after == again
    assert after != before
