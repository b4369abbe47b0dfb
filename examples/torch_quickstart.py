"""Quickstart over the PyTorch/CUDA port: the full MultiScope workflow
on one synthetic dataset.

    PYTHONPATH=src python examples/torch_quickstart.py            # card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The port's copy of ``examples/quickstart.py``: the same workload at its
defaults, over ``repro_torch``.  Trains the detector/proxy/tracker
stack, selects θ_best, runs the greedy tuner, and prints the
speed-accuracy curve — Figure 1's workflow end to end.  The last section
is the serving story: pre-process the test split ONCE into a
``TrackStore``, then answer an open-ended stream of queries from the
materialized tracks in milliseconds (``repro_torch.query``), live
segment appends with standing queries (``repro_torch.stream``), two
cameras ingesting concurrently through one shared
``executor.BatchBroker`` — their per-frame detector windows coalesce
into consolidated device batches — and the device-resident TRACK stage
(``ExecutorOptions(device_tracker=True)``): the ``track_step`` kernel
scanning whole chunks in one dispatch.  Both "tracks bit-identical"
lines compare against a solo host run: the detector's scores move by
about an ulp with its batch size, and the card's assignment solver works
in f32, so either line can print False where a decision sits on a tie.
``--detector-steps``, ``--tracker-steps`` and the three clip counts cut
the run down (the tests and ``chip_smoke.py`` do).
"""
import argparse
import dataclasses
import os
import sys
import tempfile
import threading
from typing import List, Optional

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

import numpy as np  # noqa: E402

from repro_torch import obs, resolve_device  # noqa: E402
from repro_torch.configs.multiscope import MULTISCOPE_PIPELINE  # noqa: E402
from repro_torch.core import tuner as tuner_mod  # noqa: E402
from repro_torch.core.executor import (BatchBroker,  # noqa: E402
                                       ExecutorOptions, run_clips)
from repro_torch.core.metrics import clip_count_accuracy  # noqa: E402
from repro_torch.data.video_synth import make_clip, make_split  # noqa: E402
from repro_torch.query import Query, QueryService, TrackStore  # noqa: E402
from repro_torch.stream import SegmentIngestor, StandingQuery  # noqa: E402


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--detector-steps", type=int, default=250)
    ap.add_argument("--tracker-steps", type=int, default=800)
    ap.add_argument("--train-clips", type=int, default=4)
    ap.add_argument("--val-clips", type=int, default=3)
    ap.add_argument("--test-clips", type=int, default=3)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = MULTISCOPE_PIPELINE.reduced()
    train = make_split("caldot1", "train", args.train_clips)
    val = make_split("caldot1", "val", args.val_clips)
    test = make_split("caldot1", "test", args.test_clips)

    print("== setup (detector / θ_best / proxies / windows / tracker) ==")
    system = tuner_mod.setup(cfg, train, val,
                             detector_steps=args.detector_steps,
                             tracker_steps=args.tracker_steps,
                             device=device)

    print("\n== greedy joint tuning (§3.5) ==")
    curve = tuner_mod.tune(system, val)

    print("\n== the speed-accuracy curve, applied to the TEST split ==")
    # the streaming executor runs the whole split: decode prefetch is on
    # by default, and clip i+1's decode overlaps clip i's compute
    for pt in curve:
        results, secs = run_clips(system.bank, pt.params, test)
        accs = [clip_count_accuracy(r.tracks, clip)
                for r, clip in zip(results, test)]
        acc = sum(accs) / len(accs)
        print(f"  [{pt.module:10s}] test_acc={acc:.3f} "
              f"test_t={secs:6.2f}s  {pt.params.describe()}")

    print("\n== pre-process once, query many (repro_torch.query) ==")
    # materialize the split once: TrackStore streams cold clips through
    # the executor and persists the tracks keyed by θ's fingerprint —
    # point the root at a persistent directory and a re-run skips
    # straight to the queries
    with tempfile.TemporaryDirectory(prefix="trackstore_") as root:
        store = TrackStore(root, system.bank, system.theta_best)
        service = QueryService(store)
        report = service.warm(test)
        print(f"  ingest: {report.ingested} clips, {report.frames} "
              f"frames ({report.fps:.0f} fps wall)")
        # ...then every query is a millisecond scan, detector untouched
        for desc, q in [
            ("frames with >=2 objects",
             Query.count_frames(min_count=2)),
            ("busy frames in the top half",
             Query.count_frames(region=(0.0, 0.0, 1.0, 0.5),
                                min_count=2)),
            ("first 5 such frames",
             Query.limit_frames(min_count=2, want=5,
                                min_spacing=test[0].profile.fps)),
        ]:
            r = service.query(q, test)
            answer = r.frames if q.aggregate == "frames" \
                else int(r.aggregates["count"])
            # skipped = clips the per-clip index summaries proved
            # irrelevant; indexed = clips answered from precomputed
            # count histograms without touching a row
            print(f"  {desc}: {answer} "
                  f"({r.stats.scan_seconds * 1e3:.2f}ms, "
                  f"{r.skipped_clips} skipped / {r.indexed_clips} "
                  f"indexed of {r.n_clips})")

        print("\n== live ingestion (repro_torch.stream) ==")
        # an always-on camera appends SEGMENTS to an open clip; queries
        # stay answerable at every watermark in between, and a standing
        # query receives exact per-watermark deltas instead of being
        # re-run from scratch
        live = make_clip("caldot1", "live", 0, n_frames=48)
        ingestor = SegmentIngestor(store, service=service)
        watching = service.register_standing(StandingQuery(
            Query.count_frames(min_count=2), [live],
            name="busy-frames"))
        ingestor.open(live)
        while True:
            rep = ingestor.append(live, 12)     # one camera segment
            delta = watching.deltas[-1]
            print(f"  watermark {rep.watermark:2d}: "
                  f"+{delta.count_delta} busy frames "
                  f"(append {rep.wall_seconds * 1e3:.0f}ms, "
                  f"delta {rep.standing_seconds * 1e3:.2f}ms, "
                  f"{delta.rows_scanned} new rows scanned)")
            if rep.sealed:
                break
        # the accumulated standing answer == re-running ad-hoc
        total = int(watching.result().aggregates["count"])
        adhoc = int(service.query(Query.count_frames(min_count=2),
                                  [live]).aggregates["count"])
        print(f"  sealed: {total} busy frames accumulated "
              f"(ad-hoc agrees: {adhoc == total})")

        print("\n== two cameras, one shared detector batch "
              "(BatchBroker) ==")
        # two live feeds decode, plan and track independently on their
        # own threads, but their per-frame detector windows coalesce
        # into shared device batches through one executor.BatchBroker:
        # fewer, fuller dispatches, while each feed's tracks stay its
        # solo run's up to the detector's batch drift (about an ulp of
        # a score: a decision on a tie can flip).
        # A proxy-on θ is the broker's regime — the proxy gates DETECT
        # down to a couple of small windows per frame, exactly the
        # tiny per-stream dispatches worth merging (θ_best may run
        # proxy-off, where every call is already a full frame). The
        # lowest sweep threshold keeps skipping conservative for the
        # demo; a production θ would calibrate it for target recall.
        res = sorted(system.bank.proxies)[-1]
        per_frame = dataclasses.replace(
            system.theta_best, chunk_size=1, refine=False,
            proxy_res=res, proxy_threshold=min(cfg.proxy.thresholds))
        feeds = [make_clip("caldot1", "live", i + 1, n_frames=24)
                 for i in range(2)]
        detector = system.bank.detectors[per_frame.det_arch]

        def ingest_feed(feed, tag, broker):
            s = TrackStore(os.path.join(root, f"{tag}_{feed.clip_id}"),
                           system.bank, per_frame)
            ing = SegmentIngestor(s, options=ExecutorOptions(
                prefetch=False, batch_broker=broker))
            ing.open(feed)
            while not ing.append(feed, 12).sealed:
                pass
            return s.get(feed).rows

        detector.dispatches = 0
        solo = [ingest_feed(f, "solo", None) for f in feeds]
        solo_dispatches = detector.dispatches
        # trace the rest of the demo: spans cost nothing until here
        # (every site guards on TRACER.enabled) and recording them
        # never changes tracks or dispatch counts (repro_torch.obs contract)
        obs.enable()
        broker = BatchBroker()
        shared = [None, None]
        threads = [threading.Thread(
            target=lambda i=i: shared.__setitem__(
                i, ingest_feed(feeds[i], "brk", broker)))
            for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        broker.close()
        identical = all(np.array_equal(a, b)
                        for a, b in zip(solo, shared))
        print(f"  {broker.dispatches} consolidated detector dispatches "
              f"vs {solo_dispatches} solo "
              f"(mean bucket fill "
              f"{sum(broker.batch_fill) / len(broker.batch_fill):.2f}); "
              f"tracks bit-identical: {identical}")

        print("\n== device-resident TRACK (fused track-step kernel) ==")
        # with a recurrent θ, TRACK itself can live on the device: the
        # fused track_step kernel advances GRU + match + assignment in
        # one dispatch. ExecutorOptions(device_assign=True) calls it
        # per frame; device_tracker=True scans a WHOLE chunk in one
        # dispatch; a TrackBroker (same shape as BatchBroker above)
        # coalesces concurrent streams' steps. All are scheduling
        # knobs — tracks stay the host tracker's (up to ties within the
        # card's f32 assignment solver's gap), so none of them is part
        # of θ.
        from repro_torch.core.executor import run_clip_streamed
        recur = dataclasses.replace(per_frame, tracker="recurrent",
                                    chunk_size=8)
        host = run_clip_streamed(system.bank, recur, feeds[0])
        dev = run_clip_streamed(system.bank, recur, feeds[0],
                                ExecutorOptions(device_tracker=True))
        identical = len(host.tracks) == len(dev.tracks) and all(
            np.array_equal(a, b)
            for a, b in zip(host.tracks, dev.tracks))
        print(f"  host {host.dispatches['track']} track dispatches -> "
              f"device {dev.dispatches['track']} (chunk-scan); "
              f"tracks bit-identical: {identical}")
        t = dev.stage_seconds["track"]
        print(f"  track stage: {t['wall'] * 1e3:.0f}ms wall / "
              f"{t['process'] * 1e3:.0f}ms cpu "
              f"(RunResult.stage_seconds)")

        print("\n== one timeline for it all (repro_torch.obs) ==")
        # everything since obs.enable() — the two-camera broker run,
        # both feeds' appends, and the device-track comparison — landed
        # in one span ring buffer.  Inspect it in-process...
        spans = obs.TRACER.snapshot()
        by_name = {}
        for s in spans:
            by_name[s.name] = by_name.get(s.name, 0) + 1
        print(f"  {len(spans)} spans: "
              + ", ".join(f"{n} x{c}"
                          for n, c in sorted(by_name.items())))
        flushes = [s for s in spans if s.name == "broker.detect.flush"]
        if flushes:
            f0 = max(flushes, key=lambda s: s.args["windows"])
            print(f"  busiest flush: {f0.args['windows']} windows from "
                  f"{f0.args['streams']} streams after "
                  f"{f0.args['wait_ms']:.1f}ms linger")
        # ...read the always-on metrics registry the same way...
        fill = obs.REGISTRY.snapshot("broker.detect.fill")
        if fill.get("broker.detect.fill", {}).get("count"):
            f = fill["broker.detect.fill"]
            print(f"  broker fill: mean {f['mean']:.2f} over "
                  f"{f['count']} dispatches (REGISTRY)")
        # ...and export the timeline: the Chrome trace renders each
        # camera as its own lane with the shared broker lane between
        # them (open in chrome://tracing or https://ui.perfetto.dev)
        trace = os.path.join(tempfile.gettempdir(),
                             "multiscope_trace.json")
        jsonl = os.path.join(tempfile.gettempdir(),
                             "multiscope_spans.jsonl")
        obs.export_chrome(trace)
        obs.export_jsonl(jsonl)
        obs.disable()
        print(f"  wrote {trace} (Chrome trace) and {jsonl} "
              f"(JSON-lines)")

        print("\n== the same telemetry over HTTP (obs.serve) ==")
        # the serving plane: a background stdlib exporter mounting
        # Prometheus /metrics, component-health /healthz (with the SLO
        # engine's rolling-window verdicts) and a full JSON /snapshot.
        # It costs nothing until start()ed, and a concurrent scraper
        # never perturbs tracks — the same no-perturbation contract as
        # tracing, asserted in tests/test_torch_obs_serve.py
        import json
        import urllib.request

        from repro_torch.obs.serve import ObsServer
        from repro_torch.obs.slo import SloEngine

        with ObsServer(port=0, slo=SloEngine()) as server:
            text = urllib.request.urlopen(
                server.url + "/metrics", timeout=5).read().decode()
            hz = json.loads(urllib.request.urlopen(
                server.url + "/healthz", timeout=5).read().decode())
        sample = next((ln for ln in text.splitlines()
                       if ln.startswith("stream_appends")),
                      text.splitlines()[-1])
        print(f"  GET /metrics: {len(text.splitlines())} exposition "
              f"lines, e.g. `{sample}`")
        comps = ", ".join(f"{n}={c['status']}"
                          for n, c in hz["components"].items())
        print(f"  GET /healthz: {hz['status']} ({comps})")


if __name__ == "__main__":
    main()
