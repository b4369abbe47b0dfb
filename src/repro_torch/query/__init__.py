"""Exploratory query subsystem: pre-process once, query many.

The port of the JAX package's ``repro.query`` (``src/repro/query/``):
the same modules, public names and on-disk layout; extraction runs
through the port's executor on the bank's device.

MultiScope's serving story (§1, §4.2): the pipeline extracts tracks from
a dataset ONCE, and an open-ended stream of analyst queries is answered
from the materialized tracks in milliseconds — the detector is never
touched again for a warm clip.

  * ``store``   — ``TrackStore``: persistent, versioned materialization
    of ``executor.run_clips`` outputs, keyed by
    (dataset, clip, θ-fingerprint), with incremental ingest, an
    optional ``StoreBudget`` (LRU/TTL eviction of clip NPZs; evicted
    clips keep their index summaries and re-ingest on next touch), and
    an OPEN-clip layout for live ingestion (monotone ``watermark``
    marking how much of a still-arriving clip is queryable);
  * ``index``   — secondary indexes built at materialize time:
    per-frame count histograms (min_len buckets), per-track bounding
    boxes, coarse 4x4 occupancy grids, and per-clip ``ClipSummary``
    digests persisted in the version's ``index.json`` (they survive
    eviction);
  * ``ops``     — composable query operators (spatial regions, temporal
    ranges, per-frame count predicates, track filters, limit-N,
    aggregations, an optional dataset scope);
  * ``plan``    — compiles a ``Query`` into a two-phase plan: consult
    the index to skip whole clips (bbox/grid/span/count bounds) or
    answer count/limit queries from histograms, fall back to the
    vectorized row scan otherwise — bit-identical either way
    (tests/test_query_index.py);
  * ``service`` — ``QueryService``: thread-safe concurrent queries over
    one store or a ``{dataset: store}`` mapping, with transparent
    ingest of cold clips, summary-aware ``prefetch`` ordering
    (unskippable clips first, biggest predicted scan first), per-query
    latency accounting (ingest vs scan, median + p95), and standing-
    query subscriptions for live streams.

Live ingestion (``repro_torch.stream``) makes this subsystem continuous —
cameras append frame segments to open clips and queries stay
answerable at every watermark:

    ingestor = SegmentIngestor(store, service=service)
    sq = service.register_standing(
        StandingQuery(Query.count_frames(min_count=2), clips))
    ingestor.open(clip)
    ingestor.append(clip, 12)     # 12 new frames: tracker state
                                  # resumes, index merges, sq gets an
                                  # exact delta for the new watermark

"""
from repro_torch.query.index import (  # noqa: F401
    MIN_LEN_BUCKETS, ClipSummary, build_index, summarize)
from repro_torch.query.ops import (  # noqa: F401
    CountAtLeast, Limit, Query, Region, TimeRange, TrackFilter)
from repro_torch.query.plan import (  # noqa: F401
    CompiledPlan, QueryResult, compile_query)
from repro_torch.query.service import QueryService, QueryStats  # noqa: F401
from repro_torch.query.store import (  # noqa: F401
    IngestReport, PackedTracks, StoreBudget, TrackStore, theta_fingerprint)
