"""Live ingestion: segment-append pipelines over open clips.

The port of the JAX package's ``repro.stream`` (``src/repro/stream/``):
the same modules, public names and checkpoint layout; each segment
runs through the port's executor on the bank's device.  The
bit-identity claims below hold where a segment leaves the conv nets'
batches as they were (``ingest``'s docstring): the detector and the
crop CNN move by up to an f32 ulp with their batch.

The batch subsystems (``repro_torch.core.executor`` → ``repro_torch.query``)
assume a FINISHED clip; always-on feeds (traffic cameras) never
finish.  This package makes the store/index/service stack live —
cameras append frame segments to open clips and every query stays
answerable at each watermark in between:

  * ``checkpoint`` — ``TrackerCheckpoint``: the TRACK stage's
    cross-chunk state (active tracks, GRU hidden state, next-id
    counter, frame cursor) made serializable, so segment-append ingest
    is BIT-IDENTICAL to one-shot ingest and a new process resumes a
    stream exactly;
  * ``state``      — ``StreamIndexState``: per-watermark incremental
    merge of the clip's secondary index (count histograms, track
    bboxes, occupancy grids, ``ClipSummary``) in O(changed rows), with
    the per-track ``TrackDelta`` stream driving standing queries;
  * ``ingest``     — ``SegmentIngestor``: drives the executor's stage
    graph over each appended segment (decode prefetch, chunked
    dispatch, shared decode pool all apply) and lands monotone
    watermarks in the ``TrackStore``'s open-clip NPZ layout;
  * ``standing``   — ``StandingQuery``: a registered query re-evaluated
    incrementally per watermark — only never-seen rows scanned,
    summary-skippable deltas dropped — whose accumulated deltas
    reconstruct the ad-hoc answer bit-for-bit at every watermark.

Differential guarantees (tests/test_stream.py,
benchmarks/stream_bench.py): for every tested segment split, the
sealed clip's rows/hist/bboxes/summary equal a one-shot batch ingest
exactly; at every intermediate watermark the incrementally merged
index equals a full rebuild; standing-query accumulations equal the
ad-hoc plan and the naive ``ref.reference_query`` oracle.
"""
from repro_torch.stream.checkpoint import TrackerCheckpoint  # noqa: F401
from repro_torch.stream.ingest import (  # noqa: F401
    AppendReport, SegmentIngestor)
from repro_torch.stream.standing import (  # noqa: F401
    StandingDelta, StandingQuery)
from repro_torch.stream.state import (  # noqa: F401
    StreamIndexState, TrackDelta, WatermarkDelta)
