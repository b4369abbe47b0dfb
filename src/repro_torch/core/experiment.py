"""Paper-evaluation driver: everything needed for Table 1, Figures 6-8 and
Table 2 on the 7 synthetic datasets.

For each dataset: train/val/test splits -> MultiScope setup + greedy tune
-> baselines (Chameleon / BlazeIt / Miris) parameter selection on val ->
apply every selected configuration on the UNSEEN test split -> record
(accuracy, runtime) test curves + Table-1-style "fastest within 5% of
best" runtimes.  Results are dumped as JSON artifacts consumed by
the caller.

The port of the JAX package's ``repro.core.experiment``: everything
trains and runs on one device (``device=``, the card by default).  Run
it as ``python -m repro_torch.core.experiment [--quick] [--device cpu]``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch import Device, resolve_device
from repro_torch.configs.multiscope import MULTISCOPE_PIPELINE
from repro_torch.core import pipeline as pl
from repro_torch.core import tuner as tuner_mod
from repro_torch.core.baselines import (BlazeItBaseline,
                                        ChameleonBaseline, MirisBaseline)
from repro_torch.core.baselines.chameleon import pareto
from repro_torch.core.executor import run_clips
from repro_torch.core.metrics import clip_count_accuracy, mota
from repro_torch.core.tracker import build_examples
from repro_torch.core.tuner import TunerPoint
from repro_torch.data.video_synth import Clip, make_split


def _streamed_split(bank):
    """Split-level runner over the streaming executor, shared by every
    MultiScope-engine test curve (cross-clip decode prefetch + per-clip
    device round-robin)."""
    def run(pt, clips):
        return run_clips(bank, pt.params, clips)[0]
    return run


def _test_curve(run_fn, points: List[TunerPoint],
                test_clips: Sequence[Clip],
                run_split_fn=None) -> List[Dict[str, Any]]:
    """Apply each selected configuration on the test split.

    ``run_split_fn(pt, clips) -> [RunResult]`` runs a whole split at
    once — the MultiScope curves use ``executor.run_clips`` so clip
    i+1's decode prefetches while clip i computes and clips round-robin
    devices; per-clip ``run_fn`` remains for baselines with their own
    execution loops."""
    out = []
    for pt in points:
        if run_split_fn is not None:
            results = run_split_fn(pt, test_clips)
            accs = [clip_count_accuracy(r.tracks, clip)
                    for r, clip in zip(results, test_clips)]
            secs = sum(r.seconds for r in results)
        else:
            accs, secs, results = [], 0.0, []
            for clip in test_clips:
                r = run_fn(pt, clip)
                accs.append(clip_count_accuracy(r.tracks, clip))
                secs += r.seconds
                results.append(r)
        out.append({
            "params": pt.params.describe(), "module": pt.module,
            "val_accuracy": pt.val_accuracy,
            "val_seconds": pt.val_seconds,
            "test_accuracy": float(np.mean(accs)),
            "test_seconds": secs,
        })
    return out


def table1_runtime(curve: List[Dict[str, Any]], best_acc: float,
                   slack: float = 0.05) -> Optional[float]:
    """Fastest test runtime among configs within ``slack`` of best_acc."""
    ok = [c["test_seconds"] for c in curve
          if c["test_accuracy"] >= best_acc - slack]
    return min(ok) if ok else None


def run_dataset(dataset: str, *, n_train: int = 5, n_val: int = 4,
                n_test: int = 6, n_frames: int = 48,
                detector_steps: int = 400, tracker_steps: int = 1500,
                with_mota: bool = False, with_ablation: bool = False,
                with_limit_query: bool = False,
                log=print, device: Device = "cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    t_start = time.time()
    train = make_split(dataset, "train", n_train, n_frames)
    val = make_split(dataset, "val", n_val, n_frames)
    test = make_split(dataset, "test", n_test, n_frames)
    cfg = MULTISCOPE_PIPELINE.reduced()

    # ---- MultiScope -----------------------------------------------------------
    sys = tuner_mod.setup(cfg, train, val, detector_steps=detector_steps,
                          tracker_steps=tracker_steps, log=log, device=dev)
    ms_curve_val = tuner_mod.tune(sys, val, log=log)
    ms_points = pareto(ms_curve_val)
    ms_curve = _test_curve(None, ms_points, test,
                           run_split_fn=_streamed_split(sys.bank))

    # θ_best labels reused by the baselines (shared substrate, like the
    # paper giving all methods the same pretrained detector)
    det = sys.bank.detectors[sys.theta_best.det_arch]
    train_dets = []
    for clip in train:
        for f in range(0, clip.n_frames, sys.theta_best.gap):
            frame = clip.render(f, *sys.theta_best.det_res)
            dets = det.detect_batch(frame[None],
                                    sys.theta_best.det_conf)[0]
            train_dets.append((clip, f, dets))

    # ---- Chameleon --------------------------------------------------------------
    cham = ChameleonBaseline(sys.bank)
    cham_points = cham.select(val)
    cham_curve = _test_curve(None, cham_points, test,
                             run_split_fn=_streamed_split(sys.bank))

    # ---- BlazeIt ----------------------------------------------------------------
    blaze = BlazeItBaseline(sys.bank)
    blaze.train(train_dets)
    blaze_points = blaze.select(val)
    blaze_curve = _test_curve(
        lambda pt, clip: blaze.run_clip(
            pt.params, clip, float(pt.module.split("=")[1])),
        blaze_points, test)

    # ---- Miris -------------------------------------------------------------------
    miris = MirisBaseline(sys.bank)

    def getter(clip):
        # the bounded LRU render cache (pipeline.render_frame) replaces
        # the old per-run dict, which grew without bound across
        # configurations; decode cost is irrelevant here, only pixels
        def g(f):
            return pl.render_frame(clip, f, *sys.theta_best.det_res)[0]
        return g

    examples = []
    for clip in train:
        r = pl.run_clip(sys.bank, sys.theta_best, clip)
        examples.extend(build_examples(r.tracks, getter(clip),
                                       cfg.tracker.crop,
                                       clip_key=clip.clip_id))
    miris.train(examples, steps=tracker_steps)
    miris_points = miris.select(val)
    miris_curve = _test_curve(
        lambda pt, clip: miris.run_clip(
            pt.params, clip, float(pt.module.split("=")[1])),
        miris_points, test)

    curves = {"multiscope": ms_curve, "chameleon": cham_curve,
              "blazeit": blaze_curve, "miris": miris_curve}
    best_acc = max(c["test_accuracy"] for cv in curves.values()
                   for c in cv)
    table1 = {name: table1_runtime(cv, best_acc)
              for name, cv in curves.items()}

    result: Dict[str, Any] = {
        "dataset": dataset,
        "n_clips": {"train": n_train, "val": n_val, "test": n_test},
        "theta_best": sys.theta_best.describe(),
        "setup_seconds": sys.setup_seconds,
        "curves": curves,
        "best_accuracy": best_acc,
        "table1_runtime_at_5pct": table1,
        "wall_seconds": time.time() - t_start,
    }

    if with_mota:
        result["mota"] = mota_crosscheck(sys, ms_points, test[:3], log=log)
    if with_ablation:
        result["ablation"] = ablation(sys, val, test, log=log)
    if with_limit_query:
        lq_clips = make_split(dataset, "test", n_test + 6, n_frames)
        result["limit_query"] = limit_query_experiment(
            sys, blaze, lq_clips, log=log)
    return result


def mota_crosscheck(sys, points: List[TunerPoint],
                    clips: Sequence[Clip], log=print) -> List[Dict]:
    """Fig 8: count accuracy vs MOTA over candidate configurations."""
    out = []
    for pt in points:
        accs, motas = [], []
        for clip in clips:
            r = pl.run_clip(sys.bank, pt.params, clip)
            accs.append(clip_count_accuracy(r.tracks, clip))
            motas.append(mota(r.tracks, clip,
                              frames=range(0, clip.n_frames,
                                           pt.params.gap),
                              device=sys.bank.device))
        out.append({"params": pt.params.describe(),
                    "count_accuracy": float(np.mean(accs)),
                    "mota": float(np.mean(motas))})
        log(f"[fig8] {pt.params.describe()} count={np.mean(accs):.3f} "
            f"mota={np.mean(motas):.3f}")
    return out


def ablation(sys, val_clips: Sequence[Clip], test_clips: Sequence[Clip],
             log=print) -> Dict[str, List[Dict]]:
    """Fig 7: detector-only -> +SORT -> +recurrent -> +proxy (full)."""
    cfg = sys.bank.cfg
    variants: Dict[str, List[TunerPoint]] = {}

    # 1. detection module only (tuner over arch x res, SORT implicit for
    #    track formation, native rate)
    pts = []
    for arch in cfg.detector.archs:
        for res in cfg.detector.resolutions:
            p = pl.PipelineParams(arch, res, cfg.detector.confidences[1],
                                  gap=1, tracker="sort", refine=False)
            a, t = tuner_mod._evaluate(sys.bank, p, val_clips)
            pts.append(TunerPoint(p, a, t))
    variants["detector-only"] = pareto(pts)

    # 2. + SORT over gaps
    pts = []
    for arch in cfg.detector.archs:
        for res in cfg.detector.resolutions:
            for gap in cfg.tracker.gaps:
                p = pl.PipelineParams(arch, res,
                                      cfg.detector.confidences[1],
                                      gap=gap, tracker="sort",
                                      refine=False)
                a, t = tuner_mod._evaluate(sys.bank, p, val_clips)
                pts.append(TunerPoint(p, a, t))
    variants["+sort"] = pareto(pts)

    # 3. + recurrent tracker (with refinement)
    pts = []
    for res in cfg.detector.resolutions:
        for gap in cfg.tracker.gaps:
            p = pl.PipelineParams(cfg.detector.archs[-1], res,
                                  cfg.detector.confidences[1], gap=gap,
                                  tracker="recurrent", refine=True)
            a, t = tuner_mod._evaluate(sys.bank, p, val_clips)
            pts.append(TunerPoint(p, a, t))
    variants["+recurrent"] = pareto(pts)

    # 4. full (tuner output incl. proxy) — reuse sys.curve
    variants["+proxy(full)"] = pareto(sys.curve) if sys.curve else []

    out = {}
    for name, points in variants.items():
        out[name] = _test_curve(None, points, test_clips,
                                run_split_fn=_streamed_split(sys.bank))
        log(f"[fig7] {name}: {len(points)} pareto points")
    return out


def limit_query_experiment(sys, blaze: BlazeItBaseline,
                           clips: Sequence[Clip], *, want: int = 10,
                           min_count: int = 3,
                           region=(0.0, 0.5, 1.0, 1.0),
                           store_root: Optional[str] = None,
                           log=print) -> Dict[str, Any]:
    """Table 2: BlazeIt limit query vs MultiScope extract-once-serve-many.

    Find ``want`` frames with >= min_count objects in the bottom half,
    >= 2s apart.  The BlazeIt side searches per query (proxy ranking +
    detector probes).  The MultiScope side goes through the track store
    subsystem: the FIRST query materializes tracks for the whole query
    set (``TrackStore.ingest`` through the streaming executor), every
    later query scans the packed arrays in milliseconds — the reported
    ``query_seconds`` is the plan scan, ``pre_seconds`` the one-time
    ingest, and ``warm_query_seconds`` a repeat of the same query
    against the warm store (zero detector calls)."""
    import tempfile

    from repro_torch.query import Query, QueryService, TrackStore

    fps = clips[0].profile.fps
    spacing = 2 * fps
    params = sys.theta_best

    # BlazeIt (unchanged: per-query search is the point of comparison)
    bz = blaze.limit_query(clips, params, want=want, min_count=min_count,
                           region=region, min_spacing=spacing)
    # verify against ground truth
    bz_correct = sum(
        1 for ci, f in bz["found"]
        if _gt_count_region(clips[ci], f, region) >= min_count)

    # MultiScope: materialize tracks once, serve the query from the store
    fastest = None
    for pt in (sys.curve or []):
        if fastest is None or pt.val_seconds < fastest.val_seconds:
            if pt.val_accuracy >= max(
                    p.val_accuracy for p in sys.curve) - 0.05:
                fastest = pt
    ms_params = (fastest or TunerPoint(params, 0, 0)).params
    root = store_root or tempfile.mkdtemp(prefix="trackstore_")
    try:
        store = TrackStore(root, sys.bank, ms_params)
        service = QueryService(store)
        q = Query.limit_frames(region=region, min_count=min_count,
                               want=want, min_spacing=spacing)
        cold = service.query(q, clips)      # ingest + first scan
        warm = service.query(q, clips)      # served entirely from store
        if warm.stats.ingested_clips != 0 or warm.frames != cold.frames:
            raise RuntimeError(
                "warm store disagreed with the cold scan: "
                f"re-ingested {warm.stats.ingested_clips} clips, "
                f"frames {warm.frames} vs {cold.frames}")
        found = cold.frames
    finally:
        if store_root is None:              # we made the dir; remove it
            import shutil
            shutil.rmtree(root, ignore_errors=True)
    ms_correct = sum(
        1 for ci, f in found
        if _gt_count_region(clips[ci], f, region) >= min_count)

    return {
        "want": want, "min_count": min_count,
        "blazeit": {"pre_seconds": bz["pre_seconds"],
                    "query_seconds": bz["query_seconds"],
                    "detector_frames": bz["detector_frames"],
                    "found": len(bz["found"]), "correct": bz_correct},
        "multiscope": {"pre_seconds": cold.stats.ingest_seconds,
                       "query_seconds": cold.stats.scan_seconds,
                       "warm_query_seconds": warm.stats.total_seconds,
                       "store_fingerprint": store.fingerprint,
                       "found": len(found), "correct": ms_correct},
    }


def _gt_count_region(clip: Clip, frame: int, region) -> int:
    boxes = clip.boxes_at(frame)
    if len(boxes) == 0:
        return 0
    m = ((boxes[:, 0] >= region[0]) & (boxes[:, 0] <= region[2])
         & (boxes[:, 1] >= region[1]) & (boxes[:, 1] <= region[3]))
    return int(m.sum())


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--datasets", default="all")
    ap.add_argument("--out", default="artifacts/paper")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--mota", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args()
    from repro_torch.data.video_synth import DATASETS
    names = list(DATASETS) if args.datasets == "all" \
        else args.datasets.split(",")
    os.makedirs(args.out, exist_ok=True)
    kw = dict(n_train=3, n_val=3, n_test=3, detector_steps=150,
              tracker_steps=600) if args.quick else {}
    for name in names:
        path = os.path.join(args.out, f"{name}.json")
        if os.path.exists(path):
            print(f"[paper] cached {name}")
            continue
        print(f"[paper] ==== {name} ====", flush=True)
        res = run_dataset(
            name, with_mota=args.mota or name == "caldot1",
            with_ablation=name == "caldot1",
            with_limit_query=name == "jackson", device=args.device, **kw)
        with open(path, "w") as f:
            json.dump(res, f, indent=1, default=float)
        print(f"[paper] {name}: table1={res['table1_runtime_at_5pct']} "
              f"wall={res['wall_seconds']:.0f}s", flush=True)


if __name__ == "__main__":
    main()
