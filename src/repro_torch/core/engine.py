"""The chunked engine's entry point: ``run_clip_chunked``, the stage
graph of ``repro_torch.core.executor`` on its SEQUENTIAL scheduler (no
decode prefetch, no double buffering): every stage of chunk k completes
before chunk k+1 starts.  Tracks equal the streaming scheduler's; only
the scheduling differs.  New code should use the executor directly
(``ClipExecutor``, ``run_clip_streamed``, ``run_clips``).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.executor import ClipExecutor, ExecutorOptions
from repro_torch.core.pipeline import ModelBank, PipelineParams, RunResult
from repro_torch.data.video_synth import Clip


def run_clip_chunked(bank: ModelBank, params: PipelineParams, clip: Clip,
                     chunk_size: Optional[int] = None) -> RunResult:
    """One clip through the sequential stage graph on the bank's device.
    ``chunk_size`` overrides θ's ``PipelineParams.chunk_size`` (default
    B = 16)."""
    opts = ExecutorOptions(prefetch=False, double_buffer=False,
                           chunk_size=chunk_size)
    return ClipExecutor(bank, params, opts).run(clip)
