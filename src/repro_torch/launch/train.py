"""Training launcher: the port of the JAX package's
``repro.launch.train``, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --steps 200 --batch 8 --seq 128 [--reduced] [--device cuda] \\
        [--ckpt artifacts/train_ckpt] [--bf16-wire] [--quantize-v] \\
        [--accum 2]

Wires the substrate: config -> model -> weights on the device -> AdamW
(cosine schedule, optional 8-bit v) -> the train step (in place) ->
skippable token pipeline -> crash-safe ``Supervisor`` with async
checkpointing, resuming from the latest checkpoint under ``--ckpt`` if
there is one.  ``--bf16-wire`` is the step's ``cast_bf16``.  The
reference's ``--mesh`` shards over a host mesh; the port runs on one
device, and any mesh but ``1,1`` raises (sharding rules are ROADMAP
item 12g.3, more than one card item 14b).
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs.base import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.distributed.checkpoint import Checkpointer, TrainState
from repro_torch.distributed.fault import Supervisor
from repro_torch.models.model import build_model
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.train import build_train_step


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--mesh", default="1,1",
                    help="data,model axis sizes (only 1,1: one device)")
    ap.add_argument("--ckpt", default="artifacts/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--bf16-wire", action="store_true")
    ap.add_argument("--quantize-v", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    """Train as the arguments say -> {"losses": each step's loss,
    "start": the step it began or resumed at, "restarts": the
    supervisor's}."""
    args = parse_args(argv)
    dm, mm = (int(x) for x in args.mesh.split(","))
    if (dm, mm) != (1, 1):
        raise NotImplementedError(
            f"--mesh {args.mesh}: the port trains on one device; sharding "
            "rules are ROADMAP item 12g.3 and more than one card item 14b")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    weights = model.init_params(args.seed, device=dev)
    opt = adamw(weights.parameters(),
                lr=cosine_schedule(args.lr, args.steps // 10, args.steps),
                quantize_v=args.quantize_v)
    ts = build_train_step(model, opt, accum=args.accum,
                          cast_bf16=args.bf16_wire)
    state = TrainState(weights, opt)
    pipe = TokenPipeline(cfg.vocab_size, args.batch, args.seq,
                         seed=args.seed)
    print(f"[train] {cfg.name}: {model.param_count() / 1e6:.1f}M params "
          f"on {dev}")

    sup = Supervisor(Checkpointer(args.ckpt, keep=2),
                     checkpoint_every=args.ckpt_every)
    t0 = time.time()
    losses: List[float] = []

    def step_fn(st: TrainState, step: int) -> TrainState:
        m = ts(st.weights, pipe.batch_at(step))
        losses.append(float(m["loss"]))
        if step % 20 == 0:
            tok_s = (args.batch * args.seq * (step + 1)
                     / max(time.time() - t0, 1e-9))
            print(f"[train] step {step:5d} "
                  f"loss {np.mean(losses[-20:]):.4f} "
                  f"({tok_s:,.0f} tok/s)", flush=True)
        return st

    start = 0
    latest = sup.checkpointer.latest_step()
    if latest is not None:
        print(f"[train] resuming from checkpoint step {latest}")
        sup.checkpointer.restore(state)
        start = latest
    sup.run(state, step_fn, start, args.steps - start)
    print(f"[train] done: final loss "
          f"{np.mean(losses[-20:]) if losses else float('nan'):.4f}")
    return dict(losses=losses, start=start, restarts=sup.restarts)


if __name__ == "__main__":
    main()
