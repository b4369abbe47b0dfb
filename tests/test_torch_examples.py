"""The examples over the port on the CPU.  The two MultiScope examples,
``examples/torch_quickstart.py`` and ``examples/torch_limit_query.py``,
run to their end at
the reduced configuration with cut training steps and clip counts (the
examples' own arguments; nothing else changes), and print their
invariant lines: the quickstart's standing query agrees with the ad-hoc
query (exact store arithmetic) and ``/healthz`` grades ok, warn or fail;
the limit query reports ``correct=`` for both systems.  The quickstart's
two "tracks bit-identical" lines must be printed, but their values are
not held: the brokered feeds ride batches whose detector scores move by
up to 5.96e-8 on the CPU, and the device tracker's assignment solver
works in f32.  The LM example, ``examples/torch_train_lm.py``, runs 2
of its 300 steps.  Asked for the card without one, each example
raises.
"""
import importlib.util
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.obs import TRACER  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# enough detector steps that the proxy sees positives and the brokered
# feeds detect windows; one clip a split
CUT = ["--detector-steps", "80", "--tracker-steps", "20",
       "--train-clips", "1", "--val-clips", "1"]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def run_example(capsys):
    """-> a runner: example name and arguments -> its standard output.
    One torch thread (small eager ops are slow on many here); the tracer
    the quickstart enables is cleared after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)

    def run(name, args):
        capsys.readouterr()
        _example(name).main(args)
        return capsys.readouterr().out

    try:
        yield run
    finally:
        torch.set_num_threads(n)
        TRACER.disable()
        TRACER.clear()


def test_quickstart_runs_on_cpu(run_example):
    out = run_example("torch_quickstart",
                      ["--device", "cpu", *CUT, "--test-clips", "1"])
    assert "ad-hoc agrees: True" in out
    assert re.search(r"GET /healthz: (ok|warn|fail) \(", out)
    assert re.search(r"GET /metrics: \d+ exposition lines", out)
    identical = re.findall(r"tracks bit-identical: (True|False)", out)
    assert len(identical) == 2, out
    assert "consolidated detector dispatches" in out
    assert re.search(r"\d+ spans: .*stage\.detect x\d+", out)


def test_limit_query_runs_on_cpu(run_example):
    out = run_example("torch_limit_query",
                      ["--device", "cpu", *CUT, "--query-clips", "2"])
    for system in ("blazeit", "multiscope"):
        assert re.search(rf"^{system}\s*: pre=.* correct=\d+/8$", out,
                         re.M), out
    assert "far-corner count query" in out
    assert re.search(r"after a \d+ B budget", out)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", ["torch_quickstart", "torch_limit_query",
                                  "torch_train_lm"])
def test_example_asked_for_the_card_raises_without_one(name):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main(["--device", "cuda"])


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_limit_query"])
def test_example_defaults_are_the_reference_workload(name):
    args = _example(name).parse_args([])
    assert args.device == "cuda"
    assert (args.detector_steps, args.tracker_steps) == (250, 800)
    assert (args.train_clips, args.val_clips) == (4, 3)
    last = args.test_clips if name == "torch_quickstart" \
        else args.query_clips
    assert last == (3 if name == "torch_quickstart" else 8)


def test_train_lm_runs_on_cpu(run_example, tmp_path):
    # the LM example at 2 of its 300 steps, its checkpoints in tmp_path
    out = run_example("torch_train_lm", ["--device", "cpu", "--steps", "2",
                                         "--ckpt", str(tmp_path / "ck")])
    assert re.search(r"^model qwen2-100m: 22\.3M params on cpu$", out,
                     re.M), out
    assert "bigram entropy floor: 1.816 nats/token" in out
    assert re.search(r"^step    0 loss +[\d.]+ ", out, re.M), out
    assert re.search(r"^final loss [\d.]+ \(floor 1\.816, start ~", out,
                     re.M), out


def test_train_lm_defaults_are_the_reference_workload():
    ex = _example("torch_train_lm")
    args = ex.parse_args([])
    assert (args.device, args.steps, args.batch, args.seq) == (
        "cuda", 300, 8, 128)
    cfg = ex.make_100m_config()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == (
        6, 512, 8, 2, 64, 1536, 8192)
