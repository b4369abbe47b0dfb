"""Per-run stage timings and dispatch counters.

A minimal copy of the JAX package's ``repro.obs.metrics.RunProfile``:
enough for ``RunResult.stage_seconds`` and ``RunResult.dispatches``.
The port has no global metrics registry yet, so nothing is published.
"""
from __future__ import annotations

import threading
from typing import Dict, Sequence


class RunProfile:
    """Per-run stage wall/CPU seconds + dispatch counters.  Thread-safe:
    decode runs on a worker thread while the other stages run on the
    draining thread."""

    __slots__ = ("_lock", "wall", "proc", "disp")

    def __init__(self, stages: Sequence[str]):
        self._lock = threading.Lock()
        self.wall = {s: 0.0 for s in stages}    # guarded-by: _lock
        self.proc = {s: 0.0 for s in stages}    # guarded-by: _lock
        self.disp: Dict[str, int] = {}          # guarded-by: _lock

    def note_stage(self, name: str, wall: float, proc: float) -> None:
        with self._lock:
            self.wall[name] += wall
            self.proc[name] += proc

    def dispatch(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.disp[name] = self.disp.get(name, 0) + n

    def dispatches(self, name: str) -> int:
        with self._lock:
            return self.disp.get(name, 0)

    def stage_seconds(self) -> Dict[str, Dict[str, float]]:
        """stage -> {"wall": s, "process": s}."""
        with self._lock:
            return {s: {"wall": float(self.wall[s]),
                        "process": float(self.proc.get(s, 0.0))}
                    for s in self.wall}
