"""Checkpointing and the crash-safe supervisor of the port's training
loop (``checkpoint``, ``fault``)."""
from repro_torch.distributed.checkpoint import (  # noqa: F401
    Checkpointer, TrainState)
from repro_torch.distributed.fault import (  # noqa: F401
    HeartbeatMonitor, Supervisor)
