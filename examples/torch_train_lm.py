"""Train a small qwen2-family LM for a few hundred steps on the synthetic
bigram corpus, over the PyTorch/CUDA port: the whole training stack end
to end (AdamW, grad clip, checkpointing, the crash-safe supervisor, the
skippable data pipeline).

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 3

The port's copy of ``examples/train_lm.py``: the same configuration,
schedule and data, trained in f32 (attention through ``flash_attention``
and its backward kernel on the card).  The loss should descend from its
initial value (about 256 at this init, as the reference's) toward the
bigram entropy floor printed at startup.
"""
import argparse
import dataclasses
import os
import sys
import time
from typing import List, Optional

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.distributed import (Checkpointer, Supervisor,  # noqa: E402
                                     TrainState)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import adamw, cosine_schedule  # noqa: E402
from repro_torch.train import build_train_step  # noqa: E402


def make_100m_config():
    """The qwen2-family config of the reference's example."""
    base = get_config("qwen2-0.5b")
    return dataclasses.replace(
        base, name="qwen2-100m", n_layers=6, d_model=512, n_heads=8,
        n_kv_heads=2, head_dim=64, d_ff=1536, vocab_size=8192,
        remat="none")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default="artifacts/train_lm_ckpt")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    """-> {"losses": each step's loss, "floor": the bigram entropy,
    "tokens_per_s": over the whole run}."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = make_100m_config()
    model = build_model(cfg)
    weights = model.init_params(0, device=dev)
    n = model.param_count()
    print(f"model {cfg.name}: {n / 1e6:.1f}M params on {dev}")

    pipe = TokenPipeline(cfg.vocab_size, args.batch, args.seq, seed=0)
    floor = pipe.bigram_entropy()
    print(f"bigram entropy floor: {floor:.3f} nats/token")

    opt = adamw(weights.parameters(),
                lr=cosine_schedule(3e-3, 30, args.steps))
    ts = build_train_step(model, opt, max_grad_norm=1.0)

    sup = Supervisor(Checkpointer(args.ckpt, keep=2), checkpoint_every=100)
    t0 = time.time()
    losses: List[float] = []

    def step_fn(state, step):
        mets = ts(state.weights, pipe.batch_at(step))
        losses.append(float(mets["loss"]))
        if step % 25 == 0:
            avg = sum(losses[-25:]) / len(losses[-25:])
            tok_s = args.batch * args.seq * (step + 1) / (time.time() - t0)
            print(f"step {step:4d} loss {avg:7.4f} "
                  f"({tok_s:,.0f} tok/s)")
        return state

    sup.run(TrainState(weights, opt), step_fn, 0, args.steps)
    wall = time.time() - t0
    tail = losses[-20:]
    final = sum(tail) / len(tail)
    print(f"\nfinal loss {final:.4f} (floor {floor:.3f}, "
          f"start ~{losses[0]:.2f})")
    return dict(losses=losses, floor=floor,
                tokens_per_s=args.batch * args.seq * args.steps / wall)


if __name__ == "__main__":
    main()
