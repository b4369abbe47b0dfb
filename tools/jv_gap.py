"""How far the recurrent tracker's host assignment is from the optimum.

``repro_torch.core.hungarian.hungarian_device_np`` solves each frame's
track/detection assignment with an f32 Jonker-Volgenant over a square
padded with ``FORBIDDEN_DEVICE`` (2^13).  Its potentials then carry
sentinel-scale values, where f32 resolves costs only to 2^-10, so its
answer can be dearer than the exact optimum.  This script measures by
how much, with ``optimality_gap`` (scipy's exact solver on the same
square, in float64), on seeded cost matrices shaped like the tracker's
(1 - match probability, gated below ``match_threshold``; up to
``max_tracks`` tracks against up to twice as many detections):

- ``sparse``: one strong match a track, weak gated ones around it;
- ``ties``: the same, with four crowds of 2-5 tracks and detections
  whose match probabilities lie within about 1e-4 of one another;
- ``dense``: uniform probabilities.

It prints, per padded side and family, the matrices solved, how many
came back off the optimum, and the largest gap; then the largest gap
over all of them against ``DEVICE_JV_GAP``, and exits 1 when a
gap exceeds it.  It runs on the host and needs numpy and scipy:

    PYTHONPATH=src python3 tools/jv_gap.py [--matrices 1500] [--seed 0]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.configs.multiscope import TrackerConfig
from repro_torch.core.hungarian import (BIG, DEVICE_JV_GAP,
                                        assoc_side, hungarian_device_np,
                                        optimality_gap)

FAMILIES = ("sparse", "ties", "dense")


def cost_matrix(rng, family: str, thr: float, max_tracks: int):
    """One seeded (tracks, detections) cost matrix of ``family``."""
    n_t = int(rng.integers(1, max_tracks + 1))
    n_d = int(rng.integers(1, 2 * max_tracks + 1))
    if family == "dense":
        p = rng.uniform(0.0, 1.0, (n_t, n_d))
    else:
        p = rng.uniform(0.0, 0.3, (n_t, n_d))
        k = min(n_t, n_d)
        p[rng.permutation(n_t)[:k], rng.permutation(n_d)[:k]] = \
            rng.uniform(0.5, 0.999, k)
        if family == "ties":
            for _ in range(4):
                c = int(rng.integers(2, 6))
                ts = rng.choice(n_t, min(c, n_t), replace=False)
                ds = rng.choice(n_d, min(c, n_d), replace=False)
                p[np.ix_(ts, ds)] = rng.uniform(0.3, 0.99) + \
                    rng.normal(0.0, 1e-4, (len(ts), len(ds)))
    p = np.clip(p, 0.0, 1.0).astype(np.float32)
    return np.where(p >= np.float32(thr), np.float32(1.0) - p,
                    np.float32(BIG)).astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--matrices", type=int, default=1500,
                    help="matrices in all, the families taken in turn")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cfg = TrackerConfig()
    rng = np.random.default_rng(args.seed)
    gaps = {}
    for i in range(args.matrices):
        family = FAMILIES[i % len(FAMILIES)]
        cost = cost_matrix(rng, family, cfg.match_threshold, cfg.max_tracks)
        gap = optimality_gap(cost, hungarian_device_np(cost))
        gaps.setdefault((assoc_side(*cost.shape), family), []).append(gap)
    for (side, family), v in sorted(gaps.items()):
        v = np.asarray(v)
        print(f"side {side:4d} {family:7s}: {len(v):5d} matrices, "
              f"{int((v > 0).sum()):4d} off the optimum, largest gap "
              f"{float(v.max())!r}")
    worst = max(max(v) for v in gaps.values())
    print(f"largest gap over {args.matrices} matrices (seed {args.seed}): "
          f"{worst!r}; DEVICE_JV_GAP {DEVICE_JV_GAP!r}")
    return 0 if worst <= DEVICE_JV_GAP else 1


if __name__ == "__main__":
    sys.exit(main())
