"""Deterministic synthetic video with exact ground-truth tracks.

The port keeps its own copy of the clip simulator; it renders frames
bit-identical to the JAX package's ``repro.data.video_synth``.

The container has no ffmpeg or real video, so the evaluation reproduces the
paper's WORKLOAD STRUCTURE instead of its pixels: each of the 7 dataset
profiles (caldot1, caldot2, tokyo, uav, warsaw, amsterdam, jackson) defines
a camera scene with spatial paths (lanes / turning movements), object
density, object size, and speed matching the qualitative description in
§4 (busy junctions vs sparse scenes vs aerial).  Objects are rendered as
filled rectangles with per-object color over a textured background, so a
small CNN detector is learnable but not trivial (background clutter +
additive noise).

Determinism: everything derives from counter-based Philox keyed on
(profile, split, clip, frame) — any frame can be rendered independently at
any resolution (the paper's "decode at detector resolution": rendering
cost genuinely scales with pixel count, preserving the decode-cost
structure that Chameleon/MultiScope exploit).

Ground truth per clip: full tracks (frame, cx, cy, w, h, track_id,
pattern_id), pattern counts (the paper's hand-label format), and per-frame
boxes (for MOTA).
"""
from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# world units: the native frame is 1.0 x 1.0; pixels scale at render time
Point = Tuple[float, float]


@dataclass(frozen=True)
class PathSpec:
    """One spatial pattern: a polyline from entry to exit."""
    name: str
    waypoints: Tuple[Point, ...]
    weight: float = 1.0          # relative spawn probability


@dataclass(frozen=True)
class Profile:
    name: str
    paths: Tuple[PathSpec, ...]
    spawn_rate: float            # expected objects entering per frame
    speed: Tuple[float, float]   # world units / frame (min, max)
    size: Tuple[float, float]    # object size fraction of frame (min, max)
    fps: int = 8
    n_patterns: int = 0          # 0 -> len(paths); counting granularity
    clutter: int = 6             # static background distractor rects

    def patterns(self) -> int:
        return self.n_patterns or len(self.paths)


def _line(*pts: Point) -> Tuple[Point, ...]:
    return tuple(pts)


def _interp(waypoints: Sequence[Point], t: float) -> Point:
    """t in [0, 1] along the polyline (arc-length parametrized)."""
    pts = np.asarray(waypoints, np.float64)
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    total = seg.sum()
    if total <= 0:
        return tuple(pts[0])
    d = t * total
    acc = 0.0
    for i, s in enumerate(seg):
        if d <= acc + s or i == len(seg) - 1:
            u = 0.0 if s == 0 else (d - acc) / s
            p = pts[i] * (1 - u) + pts[i + 1] * u
            return float(p[0]), float(p[1])
        acc += s
    return tuple(pts[-1])


# ---------------------------------------------------------------------------
# The 7 dataset profiles
# ---------------------------------------------------------------------------

def _junction(name: str, spawn: float, speed=(0.010, 0.020),
              size=(0.055, 0.095), fps=8, turns: int = 8) -> Profile:
    """4-way junction with through + turn movements (tokyo/warsaw/jackson
    style).  Patterns = turning movements."""
    c = 0.5
    arms = {"n": (c, -0.1), "s": (c, 1.1), "w": (-0.1, c), "e": (1.1, c)}
    moves = [("n", "s"), ("s", "n"), ("w", "e"), ("e", "w"),
             ("n", "e"), ("s", "w"), ("w", "n"), ("e", "s")][:turns]
    paths = []
    for a, b in moves:
        paths.append(PathSpec(f"{a}->{b}",
                              _line(arms[a], (c, c), arms[b])))
    return Profile(name, tuple(paths), spawn, speed, size, fps)


def _highway(name: str, spawn: float, size=(0.05, 0.09),
             fps=8) -> Profile:
    paths = (
        PathSpec("nb", _line((0.35, 1.1), (0.42, -0.1))),
        PathSpec("sb", _line((0.58, -0.1), (0.65, 1.1))),
    )
    return Profile(name, paths, spawn, (0.022, 0.034), size, fps)


PROFILES: Dict[str, Profile] = {
    # highways: 2 patterns, medium density, fast small objects
    "caldot1": _highway("caldot1", spawn=0.22),
    "caldot2": _highway("caldot2", spawn=0.15, size=(0.045, 0.075)),
    # busy city junctions: objects in (almost) every frame
    "tokyo": _junction("tokyo", spawn=0.30, turns=4),
    "warsaw": _junction("warsaw", spawn=0.36, turns=8),
    # aerial drone: many small slow objects, 8 turning movements
    "uav": _junction("uav", spawn=0.25, speed=(0.006, 0.012),
                     size=(0.030, 0.050), fps=5, turns=8),
    # sparse scenes: long empty stretches (proxy models shine here)
    "amsterdam": Profile(
        "amsterdam",
        (PathSpec("quay-we", _line((-0.1, 0.62), (1.1, 0.58))),
         PathSpec("quay-ew", _line((1.1, 0.72), (-0.1, 0.76))),),
        spawn_rate=0.02, speed=(0.008, 0.014), size=(0.060, 0.100)),
    "jackson": _junction("jackson", spawn=0.03, turns=4),
}

DATASETS = tuple(PROFILES)     # the 7 evaluation datasets


# ---------------------------------------------------------------------------
# Clip generation
# ---------------------------------------------------------------------------

@dataclass
class TrackGT:
    track_id: int
    pattern_id: int
    frames: np.ndarray           # (n,) int32 frame indices
    boxes: np.ndarray            # (n, 4) fp32 (cx, cy, w, h) world units


# static background layers, one per (clip, resolution) — tiny and reused
# by every frame of a clip (the tuner re-renders the same clips at many
# resolutions, hence the cap).  The executor's decode workers render
# concurrently (one thread per in-flight clip), so mutations are locked;
# values are deterministic per key, so racing lookups at worst recompute.
_BG_CACHE: Dict[Tuple, np.ndarray] = {}
_BG_CACHE_MAX = 256
_COLOR_CACHE: Dict[Tuple, np.ndarray] = {}
_COLOR_CACHE_MAX = 8192
_CACHE_LOCK = threading.Lock()


@dataclass
class Clip:
    profile: Profile
    split: str
    clip_id: int
    n_frames: int
    tracks: List[TrackGT] = field(default_factory=list)
    _boxes_index: Optional[Dict[int, np.ndarray]] = \
        field(default=None, repr=False, compare=False)

    # -- labels ----------------------------------------------------------------
    def pattern_counts(self) -> np.ndarray:
        """The paper's hand-label format: unique objects per pattern."""
        counts = np.zeros(self.profile.patterns(), np.int64)
        for t in self.tracks:
            counts[t.pattern_id] += 1
        return counts

    def boxes_at(self, frame: int) -> np.ndarray:
        """(n, 5) [cx, cy, w, h, track_id] world units, objects visible
        in ``frame``.  Indexed once per clip (render calls this for
        every frame; scanning all tracks each time dominated it)."""
        if self._boxes_index is None:
            idx: Dict[int, List[np.ndarray]] = {}
            for t in self.tracks:
                for i, f in enumerate(t.frames):
                    idx.setdefault(int(f), []).append(np.concatenate(
                        [t.boxes[i], [float(t.track_id)]]))
            object.__setattr__(self, "_boxes_index", {
                f: np.stack(rows).astype(np.float32)
                for f, rows in idx.items()})
        return self._boxes_index.get(
            frame, np.zeros((0, 5), np.float32))

    # -- rendering ---------------------------------------------------------------
    def _background(self, width: int, height: int) -> np.ndarray:
        """Static scene layer (gradient + clutter): identical for every
        frame of a clip, so it is built once per (clip, resolution) and
        copied per frame.  Decode cost still scales with W*H (copy,
        object draws and per-frame noise are all full-frame)."""
        key = (self.profile.name, self.split, self.clip_id, width,
               height)
        with _CACHE_LOCK:
            bg = _BG_CACHE.get(key)
        if bg is not None:
            return bg
        brng = _rng(self.profile.name, self.split, self.clip_id, 3, 0)
        gx = brng.uniform(0.25, 0.45)
        gy = brng.uniform(0.25, 0.45)
        yy = np.linspace(0, 1, height, dtype=np.float32)[:, None]
        xx = np.linspace(0, 1, width, dtype=np.float32)[None, :]
        bg = (0.35 + gx * xx + gy * yy)[..., None] * np.ones(
            3, np.float32)
        # static clutter rectangles (buildings/markings)
        for _ in range(self.profile.clutter):
            cx, cy = brng.uniform(0.05, 0.95, 2)
            w, h = brng.uniform(0.04, 0.16, 2)
            col = brng.uniform(0.2, 0.8, 3).astype(np.float32)
            _draw_rect(bg, cx, cy, w, h, col, fill=0.6)
        with _CACHE_LOCK:
            _BG_CACHE[key] = bg
            if len(_BG_CACHE) > _BG_CACHE_MAX:
                _BG_CACHE.pop(next(iter(_BG_CACHE)))
        return bg

    def _track_color(self, tid: int) -> np.ndarray:
        key = (self.profile.name, self.split, self.clip_id, tid)
        with _CACHE_LOCK:
            col = _COLOR_CACHE.get(key)
        if col is None:
            crng = _rng(self.profile.name, self.split, self.clip_id, 11,
                        tid)
            col = crng.uniform(0.0, 1.0, 3).astype(np.float32)
            col[tid % 3] = 1.0               # saturated channel
            with _CACHE_LOCK:
                _COLOR_CACHE[key] = col
                if len(_COLOR_CACHE) > _COLOR_CACHE_MAX:
                    _COLOR_CACHE.pop(next(iter(_COLOR_CACHE)))
        return col

    def render(self, frame: int, width: int, height: int) -> np.ndarray:
        """(H, W, 3) float32 in [0, 1].  Cost scales with W*H (the decode
        cost model).  Deterministic per (profile, split, clip, frame);
        noise is drawn from the float32 Gaussian stream (a different —
        still deterministic — stream than the original float64 path, so
        pixels differ from pre-engine renders)."""
        rng = _rng(self.profile.name, self.split, self.clip_id, 7, frame)
        img = self._background(width, height).copy()
        # objects (per-track colors are constants — cached)
        for box in self.boxes_at(frame):
            cx, cy, w, h, tid = box
            _draw_rect(img, cx, cy, w, h,
                       self._track_color(int(tid)), fill=1.0)
        img += rng.standard_normal(img.shape, dtype=np.float32) \
            * np.float32(0.02)
        return np.clip(img, 0.0, 1.0)


def _draw_rect(img: np.ndarray, cx: float, cy: float, w: float, h: float,
               col: np.ndarray, fill: float) -> None:
    H, W = img.shape[:2]
    x0 = max(int((cx - w / 2) * W), 0)
    x1 = min(int(math.ceil((cx + w / 2) * W)), W)
    y0 = max(int((cy - h / 2) * H), 0)
    y1 = min(int(math.ceil((cy + h / 2) * H)), H)
    if x1 <= x0 or y1 <= y0:
        return
    img[y0:y1, x0:x1] = (1 - fill) * img[y0:y1, x0:x1] + fill * col


def _rng(*key_parts) -> np.random.Generator:
    # stable across processes (python str hash is randomized per process)
    import hashlib
    digest = hashlib.sha256(repr(key_parts).encode()).digest()
    h = int.from_bytes(digest[:8], "little")
    return np.random.Generator(np.random.Philox(key=h))


def make_clip(profile_name: str, split: str, clip_id: int,
              n_frames: int = 48) -> Clip:
    """Simulate object motion for one clip; exact GT tracks attached."""
    prof = PROFILES[profile_name]
    clip = Clip(prof, split, clip_id, n_frames)
    rng = _rng(profile_name, split, clip_id, 1, 0)
    weights = np.array([p.weight for p in prof.paths], np.float64)
    weights /= weights.sum()
    tid = 0
    # spawn objects over an extended window so mid-clip state is realistic
    for f0 in range(-int(1.2 / prof.speed[0]), n_frames):
        n_spawn = rng.poisson(prof.spawn_rate)
        for _ in range(n_spawn):
            pattern = int(rng.choice(len(prof.paths), p=weights))
            path = prof.paths[pattern]
            speed = rng.uniform(*prof.speed)
            size = rng.uniform(*prof.size)
            aspect = rng.uniform(0.8, 1.4)
            pts = np.asarray(path.waypoints, np.float64)
            total_len = np.linalg.norm(np.diff(pts, axis=0),
                                       axis=1).sum()
            n_steps = max(int(total_len / speed), 2)
            frames, boxes = [], []
            for s in range(n_steps + 1):
                f = f0 + s
                if f < 0 or f >= n_frames:
                    continue
                cx, cy = _interp(path.waypoints, s / n_steps)
                # visible only while inside the frame
                if not (0.0 <= cx <= 1.0 and 0.0 <= cy <= 1.0):
                    continue
                frames.append(f)
                boxes.append([cx, cy, size, size * aspect])
            if len(frames) >= 2:
                clip.tracks.append(TrackGT(
                    tid, pattern,
                    np.asarray(frames, np.int32),
                    np.asarray(boxes, np.float32)))
                tid += 1
    return clip


def make_split(profile_name: str, split: str, n_clips: int,
               n_frames: int = 48) -> List[Clip]:
    return [make_clip(profile_name, split, i, n_frames)
            for i in range(n_clips)]
