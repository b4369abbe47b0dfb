"""Fault tolerance and straggler detection for the training loop: the
port of the JAX package's ``repro.distributed.fault``.

``Supervisor`` wraps the step loop with:
  * periodic checkpointing (async) through
    ``repro_torch.distributed.checkpoint``;
  * crash recovery: any exception from the step function triggers a
    restore from the latest checkpoint and a replay (bounded retries);
  * straggler detection: per host, the mean of its last ``window`` step
    times; hosts above ``straggler_factor`` x the median are reported
    through ``on_straggler``.

The data pipeline must be SKIPPABLE (``batch_at(step)``) so a replay
after a restore does not train twice on a batch; the port's
``data.tokens`` provides that.  The step function may update its state
in place (a ``checkpoint.TrainState``, as the port's ``TrainStep``
does): a restore then copies the checkpoint into that same state.  As
in the reference, a crash before the first checkpoint replays from
``start_step`` with the state as it stands.
"""
from __future__ import annotations

import statistics
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from repro_torch.distributed.checkpoint import Checkpointer


@dataclass
class HeartbeatMonitor:
    window: int = 20
    straggler_factor: float = 2.0
    _times: Dict[int, deque] = field(default_factory=lambda: defaultdict(
        lambda: deque(maxlen=64)))

    def record(self, host: int, seconds: float) -> None:
        self._times[host].append(seconds)

    def stragglers(self):
        means = {h: statistics.fmean(list(ts)[-self.window:])
                 for h, ts in self._times.items() if ts}
        if len(means) < 2:
            return []
        med = statistics.median(means.values())
        return [h for h, m in means.items()
                if m > self.straggler_factor * med]


@dataclass
class Supervisor:
    checkpointer: Checkpointer
    checkpoint_every: int = 50
    max_restarts: int = 3
    on_straggler: Optional[Callable[[list], None]] = None
    monitor: HeartbeatMonitor = field(default_factory=HeartbeatMonitor)
    restarts: int = 0

    def run(self, state: Any, step_fn: Callable[[Any, int], Any],
            start_step: int, num_steps: int, template: Any = None) -> Any:
        """Run ``num_steps`` of ``step_fn(state, step) -> state`` with
        checkpoint and restart.  ``template`` defaults to ``state`` (the
        structure a restore rebuilds, or the ``TrainState`` it copies
        into)."""
        template = state if template is None else template
        step = start_step
        end = start_step + num_steps
        while step < end:
            try:
                t0 = time.monotonic()
                state = step_fn(state, step)
                self.monitor.record(0, time.monotonic() - t0)
                step += 1
                if step % self.checkpoint_every == 0:
                    self.checkpointer.save(step, state, async_=True)
                bad = self.monitor.stragglers()
                if bad and self.on_straggler:
                    self.on_straggler(bad)
            except KeyboardInterrupt:
                raise
            except Exception:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                self.checkpointer.wait()
                latest = self.checkpointer.latest_step()
                if latest is None:
                    # nothing durable yet: restart from the initial step
                    step = start_step
                    continue
                state, manifest = self.checkpointer.restore(template,
                                                            step=latest)
                step = manifest["step"]
        self.checkpointer.wait()
        return state
