"""Read the per-frame engine's two kernels of several source trees in
turns on one card, with one yardstick for all of them.

    python3 tools/kernel_turns.py TREE [TREE ...]

Each TREE is the root of a checkout (this one, or an older commit
unpacked with ``git archive``).  The trees run one after another, each
in a process of its own that imports that tree's ``chip_smoke`` and
``repro_torch`` from the tree and builds its kernels there; list a tree
twice to read it twice (parent, change, change, parent).  Every reading
goes through the wrappers' public signatures and ``chip_smoke``'s
timers (``event_ms``, ``device_ms``, ``host_us``), which every tree
since the port's first kernels shares, so only the kernels and their
wrappers differ between the trees:

- the single-frame ``window_gather`` on the set-up chunk's first frame
  (960 x 544), 8 rows of (15, 9) and of (30, 17) cells (6 seeded, the
  far edge, one zero row), with the table on the host (as the per-frame
  engine passes it) and on the card: ms a call between CUDA events,
  device ms at a cold L2, the host's enqueue in us;
- ``proxy_score`` on the set-up chunk's features at (1, 8, 13, 64) and
  (16, 8, 13, 64): the same three readings;
- ``ProxyModel.scores`` on one proxy frame (encoder, kernel and the copy
  back; it returns host arrays, so its host clock includes the wait);
- the per-frame engine on cached clip 0, ``FRAME_RUNS`` times (fps; the
  first pays the per-frame path's warm-up), then once more with host
  clocks around the proxy, the detector and the tracker
  (``chip_smoke.frame_breakdown``'s phases; "other" is the rest:
  planning, the frame upload, ``window_gather`` and NMS).

Each tree prints its readings as one JSON line, and the parent process
prints the card's name and power limit beside them.  Needs one CUDA
card.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

TAG = "kernel_turns: "
FRAME_RUNS = 5


def read_tree() -> dict:
    """The readings of the tree in the working directory."""
    sys.path[:0] = [os.path.join(os.getcwd(), "src"), os.getcwd()]
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.core import pipeline as pl
    from repro_torch.core.detector import Detector
    from repro_torch.core.proxy import ProxyModel
    from repro_torch.core.tracker import RecurrentTracker
    from repro_torch.data.video_synth import make_clip
    from repro_torch.kernels.proxy_score import proxy_score
    from repro_torch.kernels.window_gather import window_gather

    cs.build_kernels()
    bank = cs.make_bank(cs.DEVICE)
    clip = make_clip("caldot1", "test", cs.SEED, n_frames=cs.N_FRAMES)
    params, frames, feat, _ = cs.set_up(bank, clip)
    out = {}

    def timed(label, fn, kernel):
        with torch.inference_mode():
            dev_ms = cs.device_ms(fn, kernel)
            out[label] = dict(ms=cs.event_ms(fn), device_ms=dev_ms,
                              host_us=cs.host_us(fn))

    frame = torch.from_numpy(np.ascontiguousarray(frames[0])).to(cs.DEVICE)
    H, W, _ = frame.shape
    rng = np.random.default_rng(cs.SEED)
    cell = pl.CELL_PX
    for wc, hc in cs.SIZES_CELLS[1:]:
        tbl = np.zeros((8, 2), np.int32)
        tbl[:6] = np.stack([rng.integers(0, H // cell - hc + 1, 6),
                            rng.integers(0, W // cell - wc + 1, 6)], 1)
        tbl[6] = (H // cell - hc, W // cell - wc)
        for where, t in (("host", tbl),
                         ("device", torch.from_numpy(tbl).to(cs.DEVICE))):
            timed(f"window_gather ({wc}, {hc}) {where} table",
                  lambda t=t, wc=wc, hc=hc: window_gather(
                      frame, t, win_h=hc * cell, win_w=wc * cell,
                      cell=cell), "window_gather")
    enc = bank.proxies[params.proxy_res].encoder
    thr = params.proxy_threshold
    for B in (1, feat.shape[0]):
        f = feat[:B].contiguous()
        timed(f"proxy_score {tuple(f.shape)}",
              lambda f=f: proxy_score(f, enc.head_w, enc.head_b, thr),
              "proxy_score")
    proxy = bank.proxies[params.proxy_res]
    pframe = pl.downsample_chunk(frames[:1], params.proxy_res)[0]
    proxy.scores(pframe, thr)
    reps = 200
    t0 = time.perf_counter()
    for _ in range(reps):
        proxy.scores(pframe, thr)
    out["ProxyModel.scores, us a call"] = (time.perf_counter() - t0) \
        / reps * 1e6

    walls = []
    for _ in range(FRAME_RUNS):
        proxy_score.launches = window_gather.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pl.run_clip(bank, params, clip, engine="frame")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out["per-frame fps"] = [cs.N_FRAMES / w for w in walls]
    out["per-frame run"] = dict(
        windows=res.detector_windows, tracks=len(res.tracks),
        proxy_score_launches=proxy_score.launches,
        window_gather_launches=window_gather.launches)
    spent = {"decode": 0.0, "proxy": 0.0, "detect": 0.0, "track": 0.0}

    def clocked(phase):
        def wrap(fn):
            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    spent[phase] += time.perf_counter() - t0
            return wrapper
        return wrap
    with contextlib.ExitStack() as hooks:
        for owner, name, phase in ((pl, "render_frame", "decode"),
                                   (ProxyModel, "scores", "proxy"),
                                   (Detector, "detect_batch", "detect"),
                                   (RecurrentTracker, "step", "track")):
            hooks.enter_context(cs.wrapped(owner, name, clocked(phase)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pl.run_clip(bank, params, clip, engine="frame")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["per-frame run by phase, s"] = dict(
        wall=wall, **spent, other=wall - sum(spent.values()))
    return out


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(TAG + json.dumps(read_tree()), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    me = os.path.abspath(__file__)
    rows = []
    for k, tree in enumerate(argv):
        proc = subprocess.run([sys.executable, me, "--one"],
                              cwd=os.path.abspath(tree), text=True,
                              capture_output=True, timeout=900)
        if proc.returncode:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
            print(f"tree {tree}: exit {proc.returncode}", file=sys.stderr)
            return 1
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith(TAG)][-1]
        rows.append(dict(turn=k + 1, tree=tree,
                         **json.loads(line[len(TAG):])))
        print(json.dumps(rows[-1]), flush=True)
    print(f"card: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
