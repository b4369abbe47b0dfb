"""The port's LM loss and its gradients against the JAX package's, on the
CPU, for all six families; the token pipeline and the shape cells; the
plain attention backward against ``jax.grad`` of ``_chunked_jnp``.

Configs: each family's reduced config (``qwen2-0.5b``, ``deepseek-moe-16b``,
``pixtral-12b``, ``whisper-small``, ``mamba2-370m``, ``zamba2-7b``) with
f32 activations.  Weights are drawn by the port's init, turned into the
reference's stacked tree by ``params.lm_to_params`` and carried back into
the port by ``params.lm_from_params`` (the reference's own
``init_params`` compiles one draw per shape and costs seconds a family);
inputs come from seeded numpy.  The reference runs its CPU paths
(``_chunked_jnp`` attention, ``_chunked_jnp`` scan), the port its plain
versions (CPU tensors) under autograd.

Tolerances, f32 throughout (the two sum in other orders):
  * the loss and its metrics: relative 1e-5;
  * each gradient leaf: max |d| <= 1e-4 * max|reference leaf| + 1e-6 *
    the largest max|leaf| of the whole gradient (the floor holds the
    leaves whose true gradient is 0, where both give rounding noise:
    the key biases of whisper's attention, which has no rope, so a bias
    shifts a row's scores together and the softmax ignores it);
  * the plain attention backward: max |d| <= 1e-5 * max(1,
    max|reference|);
  * ``TokenPipeline`` and ``configs.shapes``: equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs.shapes as jx_shapes  # noqa: E402
from repro.configs import ASSIGNED_ARCHS, get_config as jx_get  # noqa: E402
from repro.data.tokens import TokenPipeline as JxTokenPipeline  # noqa: E402
from repro.kernels.flash_attention.ops import _chunked_jnp  # noqa: E402
from repro.models.model import build_model as jx_build  # noqa: E402

import repro_torch.configs.shapes as pt_shapes  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd, flash_attention_bwd_ref,
    flash_attention_ref)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.params import lm_from_params, lm_to_params  # noqa: E402

from test_torch_lm import port_cfg  # noqa: E402

FAMILY_ARCHS = {"dense": "qwen2-0.5b", "moe": "deepseek-moe-16b",
                "vlm": "pixtral-12b", "encdec": "whisper-small",
                "ssm": "mamba2-370m", "hybrid": "zamba2-7b"}
B, S = 2, 16
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    # small eager ops are slow on many threads in a shared sandbox
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def family_setup(arch: str, seed: int = 0):
    """(reference config and model, port config and model, the weights
    tree (numpy, the reference's layout), a numpy batch with a
    ``loss_mask`` of zeros and ones)."""
    jc = dataclasses.replace(jx_get(arch).reduced(), dtype="float32")
    pc = port_cfg(jc)
    pm = build_model(pc)
    tree = lm_to_params(pm.init_params(seed, device="cpu"))
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, pc.vocab_size, (B, S)).astype(
        np.int32)}
    key = {"vlm": "patch_embeds", "encdec": "audio_embeds"}.get(pc.family)
    if key:
        batch[key] = rng.standard_normal(
            (B, pc.frontend.n_embeds, pc.d_model)).astype(np.float32)
    mask = (rng.random((B, S)) < 0.7).astype(np.int8)
    mask[:, 1] = 1
    return jc, jx_build(jc), pc, pm, tree, batch, mask


@pytest.fixture(scope="module", params=list(FAMILY_ARCHS.values()))
def family(request):
    jc, jm, pc, pm, tree, batch, mask = family_setup(request.param)
    jparams = jax.tree.map(jnp.asarray, tree)
    jloss = jax.jit(jm.loss)
    jgrad = jax.jit(jax.grad(lambda p, b: jm.loss(p, b)[0]))
    return dict(arch=request.param, pc=pc, pm=pm, tree=tree, batch=batch,
                mask=mask, jparams=jparams, jloss=jloss, jgrad=jgrad)


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _leaves(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", val


@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_metrics_match_reference(family, masked):
    batch = dict(family["batch"])
    if masked:
        batch["loss_mask"] = family["mask"]
    want, wm = family["jloss"](family["jparams"], _jbatch(batch))
    weights = lm_from_params(family["pc"], family["tree"], device="cpu")
    got, gm = family["pm"].loss(weights, batch)
    assert set(gm) == {"ce", "aux", "tokens"}
    for name, g, w in (("loss", got, want), *((k, gm[k], wm[k])
                                              for k in gm)):
        assert g.dtype == torch.float32 and g.ndim == 0, name
        w = float(w)
        assert abs(float(g) - w) <= LOSS_RTOL * max(1.0, abs(w)), \
            (name, float(g), w)
    if masked:
        assert float(gm["tokens"]) == float(family["mask"][:, 1:].sum())
    else:
        assert float(gm["tokens"]) == B * (S - 1)
    if family["pc"].family == "moe":
        assert float(gm["aux"]) > 0


def assert_grads_close(got: dict, want: dict, label: str) -> None:
    want = {p: np.asarray(v, np.float32) for p, v in _leaves(want)}
    got = dict(_leaves(got))
    assert set(got) == set(want), label
    top = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, (label, path)
        tol = GRAD_RTOL * float(np.abs(w).max()) + GRAD_FLOOR * top
        err = float(np.abs(g - w).max())
        assert err <= tol, (label, path, err, tol)


def test_gradients_match_jax_grad(family):
    """``loss.backward()`` through the port's plain versions against
    ``jax.grad`` of the reference's loss, leaf by leaf through
    ``lm_to_params(grads=True)``, with the loss mask."""
    batch = dict(family["batch"], loss_mask=family["mask"])
    want = family["jgrad"](family["jparams"], _jbatch(batch))
    weights = lm_from_params(family["pc"], family["tree"], device="cpu")
    weights.requires_grad_(True)
    loss, _ = family["pm"].loss(weights, batch)
    loss.backward()
    got = lm_to_params(weights, grads=True)
    assert_grads_close(got, jax.tree.map(np.asarray, want), family["arch"])
    assert any(float(np.abs(g).max()) > 0 for _, g in _leaves(got))


def test_loss_rejects_keys_the_family_does_not_read():
    _, _, pc, pm, tree, batch, mask = family_setup("qwen2-0.5b")
    weights = lm_from_params(pc, tree, device="cpu")
    with pytest.raises(ValueError, match="loss_mask"):
        pm.loss(weights, dict(batch, loss_mask=mask, extra=mask))
    # serving reads no loss_mask
    with pytest.raises(ValueError, match="tokens"):
        pm.forward(weights, dict(batch, loss_mask=mask))


def test_lm_to_params_inverts_lm_from_params():
    for arch in ("qwen2-0.5b", "zamba2-7b", "whisper-small"):
        _, _, pc, pm, tree, _, _ = family_setup(arch, seed=3)
        back = lm_to_params(lm_from_params(pc, tree, device="cpu"))
        for path, v in _leaves(tree):
            np.testing.assert_array_equal(dict(_leaves(back))[path], v)
        grads = lm_to_params(lm_from_params(pc, tree, device="cpu"),
                             grads=True)
        assert all(not g.any() for _, g in _leaves(grads))


# ---------------------------------------------------------------------------
# the plain attention backward
# ---------------------------------------------------------------------------

# (name, Sq, Skv, Hq, Hkv, causal, kv_valid), two key blocks of 32 each:
# rows that see a key only
# (the reference's _chunked_jnp averages V over a row with none)
ATTN_CASES = (("causal GQA 4/2", 64, 64, 4, 2, True, 0),
              ("Sq 16 < Skv 64 causal", 16, 64, 4, 2, True, 0),
              ("kv_valid 50 non-causal", 64, 64, 4, 4, False, 50),
              ("GQA 7 causal", 64, 64, 14, 2, True, 0))


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: c[0])
def test_plain_attention_backward_matches_jax_grad(case):
    _, Sq, Skv, Hq, Hkv, causal, kv_valid = case
    D, block = 16, 32
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, Sq, Hq, D), (2, Skv, Hkv, D), (2, Skv, Hkv, D)))
    dout = rng.standard_normal((2, Sq, Hq, D)).astype(np.float32)
    scale = 1.0 / np.sqrt(D)

    def ref(q, k, v):
        return _chunked_jnp(q, k, v, causal=causal, sm_scale=scale,
                            block_k=block, kv_valid=kv_valid)
    out, vjp = jax.vjp(ref, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    got_out = flash_attention_ref(tq, tk, tv, causal, scale, kv_valid,
                                  block_k=block)
    got = torch.autograd.grad(got_out, (tq, tk, tv), torch.from_numpy(dout))
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out),
                               rtol=0, atol=1e-5)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        tol = 1e-5 * max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g.numpy() - w).max()) <= tol, name
    # the wrapper's CPU route: autograd through the plain version, and
    # the plain backward, give the same gradients
    wq, wk, wv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    wout = flash_attention(wq, wk, wv, causal=causal, kv_valid=kv_valid)
    wout.backward(torch.from_numpy(dout))
    plain = flash_attention_bwd_ref(tq, tk, tv, wout.detach(),
                                    torch.from_numpy(dout), causal,
                                    kv_valid=kv_valid)
    cpu = flash_attention_bwd(tq.detach(), tk.detach(), tv.detach(),
                              wout.detach(), torch.from_numpy(dout), causal,
                              kv_valid=kv_valid)
    for g, p, c in zip((wq.grad, wk.grad, wv.grad), plain, cpu):
        torch.testing.assert_close(g, p, rtol=1e-6, atol=1e-6)
        assert torch.equal(p, c)


def test_backward_of_a_row_with_no_key_is_zero():
    """Sq 32 > Skv 16 causal: the first 16 rows see no key; their output
    and every gradient through them is 0 (the stated difference from
    ``_chunked_jnp``)."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .requires_grad_(True)
               for s in ((1, 32, 2, 16), (1, 16, 1, 16), (1, 16, 1, 16)))
    out = flash_attention(q, k, v, causal=True)
    assert not out[:, :16].any()
    dout = torch.zeros_like(out)
    dout[:, :16] = 1.0
    out.backward(dout)
    assert not q.grad.any() and not k.grad.any() and not v.grad.any()


def test_bwd_model_and_planted_faults_on_the_cpu():
    """``check.flash_attention_bwd_model`` (the kernel's algorithm in
    plain PyTorch) agrees with the plain backward within the card's
    tolerance at a small GQA case in both dtypes, and each planted fault
    reads outside it."""
    from repro_torch.kernels.flash_attention import check
    case = ("S64 causal", None, 64, 64, True, 0, (4, 2, 16))
    old = check.B
    check.B = 1
    try:
        for dt in (torch.float32, torch.bfloat16):
            reads = check.check_bwd_faults(
                (case[0], dt) + case[2:], "cpu", 0)
            assert set(reads) == set(check.BWD_FAULTS)
            assert min(reads.values()) > 0.1
    finally:
        check.B = old


# ---------------------------------------------------------------------------
# the token pipeline and the shape cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,batch,seq,seed", [(128, 8, 16, 3),
                                                  (1000, 4, 33, 0),
                                                  (151_936, 4, 64, 0)])
def test_token_pipeline_is_the_reference_bit_for_bit(vocab, batch, seq,
                                                     seed):
    ours = TokenPipeline(vocab_size=vocab, batch=batch, seq_len=seq,
                         seed=seed)
    ref = JxTokenPipeline(vocab_size=vocab, batch=batch, seq_len=seq,
                          seed=seed)
    assert ours.bigram_entropy() == ref.bigram_entropy()
    for step in (0, 1, 7, 1000):
        for n_shards in (1, 2, 4):
            for shard in range(n_shards):
                a = ours.batch_at(step, shard, n_shards)
                b = ref.batch_at(step, shard, n_shards)
                assert set(a) == set(b) == {"tokens", "loss_mask"}
                for key in a:
                    assert a[key].dtype == b[key].dtype
                    np.testing.assert_array_equal(a[key], b[key])
        # shards are disjoint rows of a deterministic global batch
        rows = [ours.batch_at(step, s, 2)["tokens"] for s in range(2)]
        assert all(r.shape == (batch // 2, seq) for r in rows)


def test_shapes_are_the_reference_cells():
    assert [dataclasses.asdict(s) for s in pt_shapes.ALL_SHAPES] == \
        [dataclasses.asdict(s) for s in jx_shapes.ALL_SHAPES]
    assert sorted(pt_shapes.SHAPES) == sorted(jx_shapes.SHAPES)
    for name in pt_shapes.SHAPES:
        assert pt_shapes.get_shape(name).tokens == \
            jx_shapes.get_shape(name).tokens
    with pytest.raises(KeyError, match="unknown shape"):
        pt_shapes.get_shape("train_8k")
    for arch in ASSIGNED_ARCHS:
        jc = jx_get(arch)
        pc = port_cfg(jc)
        got = [(dataclasses.asdict(s), r) for s, r in pt_shapes.cells_for(pc)]
        want = [(dataclasses.asdict(s), r)
                for s, r in jx_shapes.cells_for(jc)]
        assert got == want, arch
        assert (pt_shapes.shape_skip_reason(pc, pt_shapes.LONG_500K)
                is None) == pc.sub_quadratic
