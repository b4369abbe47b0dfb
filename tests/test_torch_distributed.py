"""The port's checkpointing, supervisor and launcher
(``repro_torch.distributed``, ``repro_torch.launch.train``) on the CPU:
the reference's checkpoint, corruption, supervisor and heartbeat tests
(``tests/test_distributed.py``) over the port; a checkpoint of a train
state written by either package restored by the other (same manifest,
leaf files and leaf order), with and without the 8-bit second moment;
a crashed and resumed run of a reduced ``qwen2`` equal to an
uninterrupted one bit for bit; and the launcher's resume and its
refusal of a mesh.
"""
import dataclasses
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.distributed.checkpoint import Checkpointer as JxCheckpointer  # noqa: E402,E501
from repro.optim import adamw as jx_adamw  # noqa: E402

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.distributed import (Checkpointer,  # noqa: E402
                                     HeartbeatMonitor, Supervisor,
                                     TrainState)
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import adamw, cosine_schedule  # noqa: E402
from repro_torch.params import lm_to_params  # noqa: E402
from repro_torch.train import build_train_step  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The reference's tests over the port
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_gc():
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((2,), dtype=torch.int32)}}
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, keep=2)
        for step in (1, 2, 3):
            ck.save(step, tree, meta={"step": step})
        assert ck.all_steps() == [2, 3]          # gc keeps 2
        restored, man = ck.restore(tree)
        for key in ("a",):
            assert torch.equal(restored[key], tree[key])
        assert torch.equal(restored["b"]["c"], tree["b"]["c"])
        assert restored["b"]["c"].dtype == torch.int32
        assert man["step"] == 3


def test_checkpoint_detects_corruption():
    tree = {"w": torch.ones((4, 4))}
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        path = ck.save(1, tree)
        victim = [f for f in os.listdir(path) if f.endswith(".npy")][0]
        with open(os.path.join(path, victim), "r+b") as f:
            f.seek(200)
            f.write(b"\xde\xad")
        with pytest.raises(IOError):
            ck.restore(tree)


def test_supervisor_recovers_from_crash():
    calls = {"n": 0}

    def step_fn(state, step):
        calls["n"] += 1
        if calls["n"] == 4:
            raise RuntimeError("injected")
        return {"x": state["x"] + 1}

    with tempfile.TemporaryDirectory() as d:
        sup = Supervisor(Checkpointer(d), checkpoint_every=2,
                         max_restarts=2)
        out = sup.run({"x": torch.zeros(())}, step_fn, 0, 6)
        assert sup.restarts == 1
        assert float(out["x"]) == 6.0        # replay exactly, no skips


def test_heartbeat_straggler_detection():
    m = HeartbeatMonitor(window=8, straggler_factor=2.0)
    for i in range(8):
        m.record(0, 1.0)
        m.record(1, 1.1)
        m.record(2, 5.0)
    assert m.stragglers() == [2]


# ---------------------------------------------------------------------------
# A train state across the two packages
# ---------------------------------------------------------------------------

def _cfg():
    return dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                               dtype="float32")


def _trained_state(quantize: bool, steps: int = 1):
    """A reduced qwen2 (seed 0) after ``steps`` steps on the CPU."""
    cfg = _cfg()
    model = build_model(cfg)
    weights = model.init_params(0, device="cpu")
    opt = adamw(weights.parameters(), lr=1e-3, quantize_v=quantize)
    ts = build_train_step(model, opt)
    pipe = TokenPipeline(cfg.vocab_size, 2, 16, seed=0)
    for s in range(steps):
        ts(weights, pipe.batch_at(s))
    return TrainState(weights, opt)


def _jx_template(state: TrainState, quantize: bool):
    params = jax.tree.map(jnp.asarray, lm_to_params(state.weights))
    return params, jx_adamw(quantize_v=quantize).init(params)


def _flat(tree, prefix=""):
    """{reference leaf path: numpy} of a reference (params, state)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = np.asarray(leaf)
    return out


@pytest.mark.parametrize("quantize", [False, True], ids=["f32-v", "int8-v"])
def test_port_checkpoint_restores_in_the_reference(quantize):
    state = _trained_state(quantize)
    want = state.leaves()
    with tempfile.TemporaryDirectory() as d:
        Checkpointer(d).save(1, state)
        got, man = JxCheckpointer(d).restore(_jx_template(state, quantize))
    got = _flat(got)
    assert man["step"] == 1 and sorted(got) == sorted(want)
    for key, arr in want.items():
        assert got[key].dtype == arr.dtype, key
        assert np.array_equal(got[key], arr), key


@pytest.mark.parametrize("quantize", [False, True], ids=["f32-v", "int8-v"])
def test_reference_checkpoint_restores_in_the_port(quantize):
    src = _trained_state(quantize)
    params, jstate = _jx_template(src, quantize)
    # one reference AdamW update from seeded gradients: moments and step
    # that no port state holds
    rng = np.random.default_rng(0)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32)), params)
    params, jstate = jx_adamw(quantize_v=quantize).update(grads, jstate,
                                                          params)
    with tempfile.TemporaryDirectory() as d:
        JxCheckpointer(d).save(7, (params, jstate))
        dst = _trained_state(quantize, steps=0)
        out, man = Checkpointer(d).restore(dst)
    assert out is dst and man["step"] == 7
    want = _flat((params, jstate))
    got = dst.leaves()
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        assert np.array_equal(got[key], arr), key
    assert dst.optimizer.n_steps == 1


def _supervised(root: str, crash_at, steps: int = 6, every: int = 2):
    cfg = _cfg()
    model = build_model(cfg)
    weights = model.init_params(0, device="cpu")
    opt = adamw(weights.parameters(), lr=cosine_schedule(3e-3, 2, steps))
    ts = build_train_step(model, opt)
    pipe = TokenPipeline(cfg.vocab_size, 2, 16, seed=0)
    losses, crashed = {}, []

    def step_fn(state, step):
        if step == crash_at and not crashed:
            crashed.append(step)
            raise RuntimeError("injected")
        losses[step] = float(ts(state.weights, pipe.batch_at(step))["loss"])
        return state
    sup = Supervisor(Checkpointer(root, keep=2), checkpoint_every=every)
    state = sup.run(TrainState(weights, opt), step_fn, 0, steps)
    return losses, state.leaves(), sup.restarts


def test_crashed_run_resumes_bit_for_bit():
    with tempfile.TemporaryDirectory() as d:
        losses, leaves, restarts = _supervised(f"{d}/a", crash_at=3)
        want_losses, want_leaves, none = _supervised(f"{d}/b", None)
    assert (restarts, none) == (1, 0)
    assert losses == want_losses
    assert sorted(leaves) == sorted(want_leaves)
    for key in want_leaves:
        assert np.array_equal(leaves[key], want_leaves[key]), key


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def test_launcher_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="12g.3.*14b"):
        launch_train.main(["--arch", "qwen2-0.5b", "--reduced", "--device",
                           "cpu", "--mesh", "2,1"])


def test_launcher_resumes_from_its_checkpoint():
    with tempfile.TemporaryDirectory() as d:
        args = ["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu",
                "--batch", "2", "--seq", "16", "--ckpt", f"{d}/ck",
                "--ckpt-every", "2", "--steps"]
        first = launch_train.main(args + ["4"])
        again = launch_train.main(args + ["6"])
    assert (first["start"], len(first["losses"])) == (0, 4)
    assert (again["start"], len(again["losses"])) == (4, 2)
    assert all(np.isfinite(first["losses"] + again["losses"]))
