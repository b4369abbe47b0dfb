"""The port's mixture-of-experts block (``moe`` family) against the JAX
package's, on the CPU: the configs, the parameter specs and dtypes,
``moe_capacity`` and ``MoEBlock``; ``test_torch_moe_serve.py`` holds
the LM built from it (forward, caches, decode, serving, planted faults)
with the helpers of this module.

Configs: ``deepseek-moe-16b`` reduced (1 dense layer + 1 MoE layer of 4
experts, top-2, 1 shared expert; d_model 64, 4 q heads over 2 KV heads
of 16, vocab 256); ``grok-1-314b`` reduced (2 MoE layers, no shared
expert, no dense layer); and a wide variant of the first with the full
model's routing and attention shapes at that depth (64 experts, top-6,
2 shared, 16 of 16 heads of 128; d_model 64, expert_d_ff 32).  Each runs
at float32 and at the config's bfloat16 activations; the forward also
with ``param_dtype`` bfloat16 (weights held in bf16, the router in f32).
Weights are the reference's ``init_params(0)`` carried over by
``params.lm_from_params``; inputs come from seeded numpy.  The
reference's attention runs its CPU path, the port's its plain versions
(CPU tensors).  The reference's routing is read out of its own
``moe_block`` calls (``_RoutingSpy``).

Tolerances are ``test_torch_lm``'s: float32 1e-4 * max(1, max|ref|) on
outputs, logits and K/V, and greedy tokens equal; bfloat16 2e-2 * max(1,
max|ref|).  The f32 routing (top-k indices, kept pairs, slots) must equal
the reference's bit for bit, in a case where the reference itself drops
pairs too, and the f32 aux loss within 1e-6 (bf16: by the bf16 rule).
In bf16 a near tie of two router probabilities may rank differently
(the router's input differs by bf16 rounding): a token whose experts or
kept pairs then differ from the reference's (``touched``; a flip moves
the later pairs of two experts' segments, so it can change which of
them are dropped) is counted, held to at most 1% of the tokens for one
block and 10% for the LM, and left out of the comparison.
"""
import contextlib
import dataclasses
import functools
import math

from typing import Tuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.moe as jx_moe  # noqa: E402
from repro.configs import get_config as jx_get  # noqa: E402
from repro.models.model import build_model as jx_build  # noqa: E402

import repro_torch.models.moe as moe  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.params import lm_from_params  # noqa: E402
from test_torch_lm import (DTYPES, assert_close, f32, jx_arr,  # noqa: E402
                           port_cfg, pt_arr)

CONFIGS = ("reduced", "grok", "wide")


def _reference_cfg(config: str, dtype: str, param_dtype: str = "float32"):
    arch = "grok-1-314b" if config == "grok" else "deepseek-moe-16b"
    jc = dataclasses.replace(jx_get(arch).reduced(), dtype=dtype,
                             param_dtype=param_dtype)
    if config == "wide":
        jc = dataclasses.replace(
            jc, n_heads=16, n_kv_heads=16, head_dim=128,
            moe=dataclasses.replace(jc.moe, n_experts=64, top_k=6,
                                    n_shared=2, expert_d_ff=32))
    return jc


@pytest.fixture(autouse=True)
def _one_thread():
    # small eager ops run faster on one thread at these sizes
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def pair(dtype: str, config: str = "reduced", param_dtype: str = "float32"):
    """(reference config, model, its init_params(0) tree as numpy, port
    config, port model, weights carried over)."""
    jc = _reference_cfg(config, dtype, param_dtype)
    jm = jx_build(jc)
    tree = jax.tree.map(np.asarray, jm.init_params(0))
    pc = port_cfg(jc)
    return jc, jm, tree, pc, build_model(pc), lm_from_params(pc, tree,
                                                             device="cpu")


def _tokens(jc, shape, seed):
    return np.random.default_rng(seed).integers(0, jc.vocab_size, shape)


def _moe_layer(tree, i=0):
    """The reference's i-th MoE layer's ``moe`` parameters, as jnp."""
    return jax.tree.map(lambda a: jnp.asarray(a[i]), tree["layers"]["moe"])


class _RoutingSpy:
    """Stands in for ``jax`` inside the reference's ``models/moe.py`` and
    keeps, in call order, what each ``moe_block`` call computes: its
    top-k indices (``jax.lax.top_k``) and the slots handed to the first
    of its two ``jax.vmap`` calls (the buffer's scatter).  Values come
    back through ``jax.debug.callback``, so the reference's layer scan
    runs compiled as it always does."""

    def __init__(self):
        self.gate_idx, self.slot = [], []
        self._vmaps = 0
        spy = self

        class _Lax:
            def __getattr__(self, name):
                return getattr(jax.lax, name)

            def top_k(self, x, k):
                vals, idx = jax.lax.top_k(x, k)
                jax.debug.callback(spy._keep(spy.gate_idx), idx,
                                   ordered=True)
                return vals, idx
        self.lax = _Lax()

    @staticmethod
    def _keep(store):
        return lambda a: store.append(np.asarray(a))

    def __getattr__(self, name):
        return getattr(jax, name)

    def vmap(self, fn):
        mapped = jax.vmap(fn)
        scatter = self._vmaps % 2 == 0
        self._vmaps += 1

        def run(*args):
            if scatter:
                jax.debug.callback(self._keep(self.slot), args[1],
                                   ordered=True)
            return mapped(*args)
        return run

    def routings(self):
        """[(gate_idx, slot)] of every ``moe_block`` call so far."""
        return list(zip(self.gate_idx, self.slot))


@contextlib.contextmanager
def spying():
    spy = _RoutingSpy()
    saved, jx_moe.jax = jx_moe.jax, spy
    try:
        yield spy
    finally:
        jx_moe.jax = saved


def _kept_experts(gate_idx: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """(B, S, k): each token's experts in increasing id, a dropped pair's
    as -1; ``keep`` (B, S * k) over the pairs sorted stably by expert
    id."""
    B, S, k = gate_idx.shape
    perm = np.argsort(gate_idx.reshape(B, S * k), axis=-1, kind="stable")
    flat = np.empty_like(keep)
    np.put_along_axis(flat, perm, keep, axis=-1)
    up = np.argsort(gate_idx, axis=-1)
    return np.where(np.take_along_axis(flat.reshape(B, S, k), up, -1),
                    np.take_along_axis(gate_idx, up, -1), -1)


def touched(port, ref, n_experts: int) -> np.ndarray:
    """(B, S) tokens whose experts or kept pairs differ between the port's
    ``Routing``s and the reference's (gate_idx, slot), at any layer."""
    out = False
    for r, (widx, wslot) in zip(port, ref, strict=True):
        gidx = r.gate_idx.numpy()
        C = r.src.shape[-1]
        out = out | (np.sort(gidx, -1) != np.sort(widx, -1)).any(-1) | (
            _kept_experts(gidx, r.keep.numpy())
            != _kept_experts(widx, wslot < n_experts * C)).any(-1)
    return out


def _routings(params):
    return [layer.moe.routing for layer in params.layers]


# ---------------------------------------------------------------------------
# configs and specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,count", [
    ("deepseek-moe-16b", 16_375_728_128), ("grok-1-314b", 316_489_340_928),
    ("deepseek-67b", None), ("deepseek-coder-33b", None)])
def test_registry_holds_the_new_configs_as_the_reference_does(arch, count):
    cfg = get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jx_get(arch))
    assert cfg.param_count() == jx_get(arch).param_count()
    assert cfg.head_dim == 128
    if count is not None:
        assert cfg.family == "moe"
        assert build_model(cfg).param_count() == count


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("config", ("deepseek-moe-16b", "grok-1-314b")
                         + CONFIGS)
def test_moe_param_specs_are_the_reference_tree(config, param_dtype):
    """Paths, shapes and dtypes of the port's specs are the reference's
    tree in shape mode (the router f32 under a bf16 ``param_dtype``), and
    ``param_count`` is the analytic count (the shapes summed in Python:
    the reference's own ``Model.param_count`` takes each leaf's size in
    int32, which a full-width expert stack overflows)."""
    ref = (dataclasses.replace(jx_get(config), param_dtype=param_dtype)
           if "-" in config else
           _reference_cfg(config, "bfloat16", param_dtype))
    shapes = jx_build(ref).param_shapes()
    flat = {"/".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    model = build_model(port_cfg(ref))
    specs = model.param_specs()
    assert {s.path: s.shape for s in specs} == \
        {p: tuple(leaf.shape) for p, leaf in flat.items()}
    for s in specs:
        want = str(flat[s.path].dtype)
        assert str(s.torch_dtype(ref.param_dtype)).split(".")[-1] == want
    assert model.param_count() == ref.param_count() \
        == sum(math.prod(leaf.shape) for leaf in flat.values())
    assert str(flat["layers/moe/router"].dtype) == "float32"


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_moe_weights_are_held_in_param_dtype(param_dtype):
    """``lm_from_params`` and ``init_params`` hold every weight in the
    config's ``param_dtype`` but the router (f32); a weight held in the
    activation dtype keeps no second copy."""
    jc, _, _, pc, pm, params = pair("bfloat16", "reduced", param_dtype)
    own = pm.init_params(0, device="cpu")
    for model in (params, own):
        for name, p in model.named_parameters():
            want = (torch.float32 if name.endswith("moe.router")
                    else getattr(torch, param_dtype))
            assert p.dtype == want, name
        kept = [k for k, _ in model.named_buffers() if k.endswith("_cast")]
        assert (kept == []) == (param_dtype == "bfloat16")


@pytest.mark.parametrize("cf", [0.1, 1.0, 1.25, 1.5, 2.0])
@pytest.mark.parametrize("E,k", [(4, 2), (8, 2), (64, 6), (3, 1)])
def test_moe_capacity_matches(cf, E, k):
    m = get_config("deepseek-moe-16b").moe
    for S in (1, 2, 7, 37, 61, 500, 512, 531, 4096):
        mm = dataclasses.replace(m, capacity_factor=cf, n_experts=E,
                                 top_k=k)
        jm = jx_get("deepseek-moe-16b").moe
        jm = dataclasses.replace(jm, capacity_factor=cf, n_experts=E,
                                 top_k=k)
        assert moe.moe_capacity(mm, S) == jx_moe.moe_capacity(jm, S)
    m = get_config("deepseek-moe-16b").moe
    assert [moe.moe_capacity(m, S) for S in (1, 500, 531)] == [1, 59, 63]


# ---------------------------------------------------------------------------
# the MoE block
# ---------------------------------------------------------------------------

def _block_case(config, dtype, seed, S=37, shared=0.0):
    """Seeded inputs (2, S, d) of the i.i.d. normal, plus ``shared`` times
    one normal vector common to every token (a crowded expert)."""
    jc, _, tree, _, _, params = pair(dtype, config)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, S, jc.d_model)) \
        + shared * rng.standard_normal(jc.d_model)
    return jc, _moe_layer(tree), params.layers[0].moe, x


def _check_block(jc, p, block, x, dtype) -> Tuple[int, int]:
    """The port's ``MoEBlock`` against ``moe_block`` on x: f32 routing bit
    for bit, the output and the aux loss; in bf16 the tokens whose
    routing differs are counted (at most 1%) and left out.  -> (pairs the
    reference dropped, tokens whose routing differs)."""
    with spying() as spy:
        want, waux = jx_moe.moe_block(p, jx_arr(x, dtype), jc)
    (widx, wslot), = spy.routings()
    with torch.inference_mode():
        got, aux = block(pt_arr(x, dtype))
    r = block.routing
    assert got.dtype == getattr(torch, dtype) and aux.dtype == torch.float32
    E, C = jc.moe.n_experts, r.src.shape[-1]
    assert C == jx_moe.moe_capacity(jc.moe, x.shape[1])
    dropped = int((wslot >= E * C).sum())
    moved = touched([r], [(widx, wslot)], E)
    if dtype == "float32":
        assert np.array_equal(r.gate_idx.numpy(), widx)
        assert np.array_equal(r.keep.numpy(), wslot < E * C)
        assert np.array_equal(r.slot.numpy(), wslot)
        assert int(r.dropped.sum()) == dropped
        assert_close(got, want, dtype)
        assert abs(float(aux) - float(waux)) <= 1e-6
        return dropped, 0
    assert moved.sum() <= 0.01 * moved.size, moved.sum()
    assert_close(f32(got)[~moved], f32(want)[~moved], dtype)
    assert_close(aux, waux, dtype)
    return dropped, int(moved.sum())


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_block_matches(dtype, config):
    """Routing, dispatch, the experts, the combine and the shared experts
    against ``moe_block``; f32 routing bit for bit."""
    _check_block(*_block_case(config, dtype, 50), dtype)


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_block_drops_pairs_as_the_reference_does(dtype, config):
    """Tokens that share a large common part crowd the same experts: the
    reference drops pairs past an expert's capacity, and the port drops
    the same ones (f32: bit for bit) and matches its output."""
    dropped, _ = _check_block(*_block_case(config, dtype, 51, S=48,
                                           shared=3.0), dtype)
    assert dropped > 0


def test_moe_combine_gives_equal_bits_twice():
    """No scatter-add: two calls on the same input give the same bits."""
    _, _, block, x = _block_case("wide", "bfloat16", 52, S=64)
    with torch.inference_mode():
        a, aux_a = block(pt_arr(x, "bfloat16"))
        b, aux_b = block(pt_arr(x, "bfloat16"))
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


@pytest.mark.parametrize("config", CONFIGS)
def test_routing_kept_experts_and_differs(config):
    """``Routing.kept_experts`` and ``Routing.differs`` (what the card's
    serve checks count) against the numpy reading of the same arrays."""
    jc, _, block, x = _block_case(config, "float32", 58, S=48, shared=3.0)
    with torch.inference_mode():
        block(pt_arr(x, "float32"))
        a = block.routing
        block(pt_arr(x + 0.01 * np.random.default_rng(59).standard_normal(
            x.shape), "float32"))
        b = block.routing
    assert np.array_equal(a.kept_experts().numpy(),
                          _kept_experts(a.gate_idx.numpy(), a.keep.numpy()))
    assert not a.differs(a).any()
    want = touched([a], [(b.gate_idx.numpy(), b.slot.numpy())],
                   jc.moe.n_experts)
    assert np.array_equal(a.differs(b).numpy(), want)
