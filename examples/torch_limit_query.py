"""Table 2 scenario over the PyTorch/CUDA port: a cardinality-limited
query answered two ways — BlazeIt's query-driven search vs MultiScope's
extract-once-serve-many track store.

    PYTHONPATH=src python examples/torch_limit_query.py            # card
    PYTHONPATH=src python examples/torch_limit_query.py --device cpu

The port's copy of ``examples/limit_query.py``: the same workload at its
defaults, over ``repro_torch``.  Find N frames with >= K cars in the
bottom half of the jackson dataset.  MultiScope pre-processes once —
``TrackStore.ingest`` streams the query set through the executor (decode
prefetch on by default) and materializes the tracks on disk — after
which THIS query and every follow-up query run in milliseconds over the
packed track arrays (``QueryService``), while BlazeIt must touch the
detector per query.  ``--detector-steps``, ``--tracker-steps`` and the
three clip counts cut the run down (the tests and ``chip_smoke.py`` do).
"""
import argparse
import os
import sys
import tempfile
from typing import List, Optional

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs.multiscope import MULTISCOPE_PIPELINE  # noqa: E402
from repro_torch.core import tuner as tuner_mod  # noqa: E402
from repro_torch.core.baselines import BlazeItBaseline  # noqa: E402
from repro_torch.core.experiment import limit_query_experiment  # noqa: E402
from repro_torch.data.video_synth import make_split  # noqa: E402
from repro_torch.query import (Query, QueryService,  # noqa: E402
                               StoreBudget, TimeRange, TrackStore)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--detector-steps", type=int, default=250)
    ap.add_argument("--tracker-steps", type=int, default=800)
    ap.add_argument("--train-clips", type=int, default=4)
    ap.add_argument("--val-clips", type=int, default=3)
    ap.add_argument("--query-clips", type=int, default=8)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = MULTISCOPE_PIPELINE.reduced()
    train = make_split("jackson", "train", args.train_clips)
    val = make_split("jackson", "val", args.val_clips)
    query_clips = make_split("jackson", "test", args.query_clips)

    system = tuner_mod.setup(cfg, train, val,
                             detector_steps=args.detector_steps,
                             tracker_steps=args.tracker_steps,
                             device=device)
    tuner_mod.tune(system, val)

    blaze = BlazeItBaseline(system.bank)
    det = system.bank.detectors[system.theta_best.det_arch]
    train_dets = []
    for clip in train:
        for f in range(0, clip.n_frames, system.theta_best.gap):
            frame = clip.render(f, *system.theta_best.det_res)
            d = det.detect_batch(frame[None],
                                 system.theta_best.det_conf)[0]
            train_dets.append((clip, f, d))
    blaze.train(train_dets)

    # -- Table 2: the same limit query, both systems ------------------------
    res = limit_query_experiment(system, blaze, query_clips,
                                 want=8, min_count=2)
    print("\n== Table 2 analogue ==")
    for m in ("blazeit", "multiscope"):
        d = res[m]
        total = d["pre_seconds"] + d["query_seconds"]
        print(f"{m:11s}: pre={d['pre_seconds']:.1f}s "
              f"query={d['query_seconds']:.3f}s total={total:.1f}s "
              f"correct={d['correct']}/{res['want']}")
    print(f"{'':11s}  warm repeat of the same query: "
          f"{res['multiscope']['warm_query_seconds'] * 1e3:.2f}ms")

    # -- exploratory follow-ups: the store answers NEW queries for free -----
    with tempfile.TemporaryDirectory(prefix="trackstore_") as root:
        store = TrackStore(root, system.bank, system.theta_best)
        service = QueryService(store)
        service.warm(query_clips)         # pre-process once...
        followups = [
            ("frames with >=2 cars in the bottom half",
             Query.count_frames(region=(0.0, 0.5, 1.0, 1.0),
                                min_count=2)),
            ("seconds with any car in the left half",
             Query.duration(region=(0.0, 0.0, 0.5, 1.0))),
            ("distinct tracks in the first 3 seconds",
             Query.count_tracks(time_range=TimeRange(
                 0, 3 * query_clips[0].profile.fps))),
        ]
        print("\n== exploratory follow-ups (warm store, no detector) ==")
        for desc, q in followups:         # ...query many
            r = service.query(q, query_clips)
            val_str = ", ".join(f"{k}={v:.2f}" if isinstance(v, float)
                                else f"{k}={v}"
                                for k, v in r.aggregates.items())
            print(f"  {desc}: {val_str}  "
                  f"({r.stats.scan_seconds * 1e3:.2f}ms, "
                  f"ingested {r.stats.ingested_clips} clips)")

        # -- the index at work: a selective region is answered without
        # scanning (or even loading) the clips it provably misses
        sel = Query.count_frames(region=(0.0, 0.0, 0.02, 0.02))
        r = service.query(sel, query_clips)
        print(f"\n== secondary indexes ==\n"
              f"  far-corner count query: skipped "
              f"{r.skipped_clips}/{r.n_clips} clips via summaries, "
              f"scanned {r.scanned_clips} "
              f"({r.stats.scan_seconds * 1e3:.2f}ms)")
        r = service.query(Query.count_frames(min_count=2), query_clips)
        print(f"  unregioned count query: {r.indexed_clips} clips "
              f"answered straight from histograms")

        # -- and a size budget: evict LRU clips, re-query transparently
        budget = int(store.disk_bytes() * 0.5)
        evicted = store.set_budget(StoreBudget(max_bytes=budget))
        r = service.query(Query.count_frames(min_count=2), query_clips)
        print(f"  after a {budget} B budget: {evicted} clips evicted, "
              f"re-query re-ingested {r.stats.ingested_clips} and "
              f"matches: {r.aggregates}")


if __name__ == "__main__":
    main()
