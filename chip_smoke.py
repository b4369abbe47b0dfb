#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with one card:

    python3 chip_smoke.py

It builds every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc``
per source, started together), holds each kernel against its plain
PyTorch version on the card at the main path's shapes and times both
(``assign`` and ``track_step`` bit for bit over their ``check`` modules'
cases, with the JV's steps counted on the host and ns a step;
``proxy_plan`` and ``proxy_score`` within the 8-ulp threshold band and
``window_gather_batch`` and the single-frame ``window_gather`` bit for
bit over theirs, beside two yardsticks: the card's launch floor,
``zero_()`` on a one-element tensor, and a ``copy_`` of each batch
gather's bytes), then runs the main path —
one 64-frame clip through the streaming ``ClipExecutor`` at the
full-width MultiScope configuration (detector ssd-deep at 960x544, proxy
416x256, recurrent tracker, chunks of 16) with untrained weights drawn
from a seed — three times with the host tracker and twice with TRACK on
the device (``ExecutorOptions(device_tracker=True)`` and
``device_assign=True``), whose tracks must equal the host tracker's.
Then the per-frame engine (``run_clip(engine="frame")``: ``proxy_score``
at batch 1 and the single-frame ``window_gather``) twice, the unfused
proxy path (``ExecutorOptions(fused_plan=False)``), whose plans must be
the fused path's wherever no proxy cell lies in the flip band, both
engines again with a track refiner (refined tracks must contain the
unrefined ones), and the quality readout (MOTA with the host Hungarian
and with every frame in one ``assign`` launch, count accuracy).  It
checks that every kernel of each path was launched and that the output
is right, and profiles four more runs for the device's busy share.
Then the LM serving path (``run_lm``): ``flash_attention`` (bf16 and
f32 on tensor cores, f32 as 3xTF32) and ``decode_attention`` (the keys
split over a cluster of 16 blocks) against their plain versions on
their ``check`` modules' cases (f32 within 1e-5, bf16 one bf16 ulp
apart), their refusals, and timed at the serving shapes beside
``scaled_dot_product_attention``, then ``ServeEngine.generate`` at full
qwen2-0.5b width (24 layers, bf16 activations, weights from the seed) on
4 prompts of 61, 200, 384 and 500 tokens with 32 new tokens each: twice
(the same tokens, 24 ``flash_attention`` and 768 ``decode_attention``
launches each), timed, and once profiled.  The serve checks then hold
the logits, in bf16 and again with f32 activations, to a share of their
RMS: both attention wrappers swapped for their plain versions, each
prompt alone, the first and last decode step against a fresh prefill;
and four planted faults (decode attending kv_len = pos, decode one
position late, decode without rope, a prefill that is not causal) must
each break the check it targets.  Then Mamba2 serving (``run_ssm``):
``ssd_scan`` (bf16 and f32 on tensor cores, f32 as 3xTF32) against its
plain version (f32 within 1e-4 of max |plain|, bf16 within 2 bf16 ulps
of the f32 plain result) at the prefill's call (B 4, S 500, H 32, P 64,
N 128), B 1 at S 61, 512 and 2048, Q 100 and B 2 at S 130, timed, and
its refusals; then ``ServeEngine.generate`` at
full mamba2-370m width (48 layers, bf16 activations, weights from the
seed) on the same 4 prompts: twice (the same tokens, 48 ``ssd_scan``
launches each, all in the prefill), timed, profiled, and the same
serve checks in bf16 and f32 (the scan swapped for its plain version;
only the longest row alone and against a fresh prefill, since shorter
rows absorb the right padding into their state by the reference's
design), with three planted faults (decode without the state's decay,
decode with a zeroed conv tail, a prefill scan that drops the state
between chunks).  Then Zamba2 serving (``run_hybrid``): the attention
kernels at head dim 112 (flash at S 500 and 512; decode at B 4, S 1024,
32 of 32 heads) and ``ssd_scan`` at (P, N) = (64, 64) (H 112, S 500 and
a ragged Q 100) against their plain versions, timed, then
``ServeEngine.generate`` at full zamba2-7b width and 5 of its 13 groups
(33 of 81 layers: 5 groups of 5 Mamba2 layers and one of 2 shared
attention blocks, 3 tail layers; d_model 3584, f32 masters and their
bf16 copies) on the same 4 prompts: twice (5 ``flash_attention``, 160
``decode_attention`` and 28 ``ssd_scan`` launches each), timed,
profiled, and the serve
checks on the longest row in bf16 and f32 with three planted faults
(every site using shared block 0, zeros for the embedding the shared
blocks read, decode attending kv_len = pos).  Then MoE serving
(``run_moe``): the attention kernels at head dim 128 (flash at S 500
and 512 at deepseek-moe-16b's 16 of 16 heads, and at S 512 at
grok-1-314b's, deepseek-67b's and deepseek-coder-33b's head layouts;
decode at B 4, S 1024 at all four) against their plain versions, its own
timed, then ``ServeEngine.generate`` at full deepseek-moe-16b width (28
layers: 1 dense and 27 MoE layers of 64 routed experts, top-6, and 2
shared experts; d_model 2048; 16,375,728,128 parameters held in bf16,
the router in f32) on the same 4 prompts: twice (28
``flash_attention`` and 896 ``decode_attention`` launches each), timed
(the decode step beside the bound its weights set), profiled, and the
serve checks in bf16 and on an f32 copy of 14 of the 28 layers, with
the prompt tokens whose routing differs between the kernel and plain
runs and the pairs each layer dropped logged, the decode check held on
the rows where no run dropped a pair of the row's own tokens, and three
planted faults (the routed gates renormalised over the top-k, the
shared experts skipped, decode attending kv_len = pos).  Then vision-
language serving (``run_vlm``): the attention kernels at pixtral-12b's
32 of 8 heads of 128 (flash at S 1524, its longest prompt, and S 512,
causal; decode at B 4, S 2048 with kv_len (1, 1085, 1524, 2048)) against
their plain versions, timed beside SDPA, then ``ServeEngine.generate``
at full pixtral-12b width (40 layers, d_model 5120, d_ff 14336, vocab
131,072; 12,247,782,400 parameters held in bf16) on the same 4 prompts,
each after 1024 image positions whose patch embeddings (drawn from the
seed on the card) the prefill merges in, ``max_len`` 2048: twice (40
``flash_attention`` and 1280 ``decode_attention`` launches each), timed,
profiled, and the serve checks in bf16 and on an f32 copy of 8 of the 40
layers, with three planted faults (the patch embeddings not merged,
merged one position late, decode attending kv_len = pos).  Then
encoder-decoder serving (``run_encdec``): the attention kernels at
whisper-small's 12 of 12 heads of 64 (flash over the encoder's 1500
frames non-causal, 500 queries against 1500 keys non-causal, S 500
causal; decode at B 4, S 1024 and over 1500 frames on every row, that
call also replayed for 8 steps in a CUDA graph) against their plain
versions, timed, then ``ServeEngine.generate`` at full whisper-small
width (12 encoder and 12 decoder layers, d_model 768, f32 masters) on
the same 4 prompts, each with 1500 audio frames drawn from the seed:
twice (36 ``flash_attention`` and 768 ``decode_attention`` launches
each), timed, profiled, and the serve checks in bf16 and f32 with four
planted faults (the cross decode masked by pos instead of the frames,
the encoder without its sinusoidal positions, erf GELU for the tanh
approximation, decode attending kv_len = pos).  Then LM training
(``run_train``): ``flash_attention_bwd`` against its plain backward
(``torch.autograd.grad`` of the plain forward) over
``flash_check.BWD_CASES`` in both dtypes (f32 within 1e-5 of max
|plain|, bf16 one ulp at max; two bf16 calls give the same bits), three
planted faults on the kernel's plain model and Di dropped in the kernel
itself, the kernels each dtype launches by profiler name (bf16: dQ, dK/dV
and, with Hq > Hkv, the partials' sum, on tensor cores), timed by kernel
at S 500 and at the train step's call beside SDPA's forward and backward
and its backward alone; full-width,
full-depth ``qwen2-0.5b`` (f32 masters, ``cast_bf16``, ``TokenPipeline``
batches from the seed) 3 steps at B 4, S 1024 through the kernels held
to the same 3 steps with attention through its plain version under
autograd (losses, first-step gradients leaf by leaf through
``lm_to_params``; a backward that drops dK must fail), then 3 timed
steps at S 4096 with B 4 as ``accum`` 4 (step s, tokens/s, peak GiB,
96 forward and 96 backward launches a step); one step each of
``deepseek-moe-16b``, ``pixtral-12b`` and ``whisper-small`` at full
width and 2 layers, held the same way; full-width, full-depth
``mamba2-370m`` 3 steps at B 4, S 1024 through ``ssd_scan`` and its
backward kernel (``SSDScanFn``), held to the plain route (losses; bf16
gradients within 0.3 a leaf, where the forwards' rounding alone reads
0.20; the backward kernel against the plain backward on the kernel
forward within 0.05; f32 activations within 1e-3; a backward that
drops dx must fail), and ``zamba2-7b`` at full width cut to 1 group of
1 SSM layer, the shared block and 1 tail layer, one step at B 2, S 1024
held the same way (the scan at (64, 64), H 112; flash's backward at D
112); then ``ssd_scan_bwd`` against its plain backward over
``ssd_check.CASES`` in both dtypes (within 1e-4 of max |plain|, bf16
outputs two ulps; a final state's gradient in one case; two bf16 calls
bit-equal), its planted faults (the carried dS dropped, dB summed over
one head), its three kernels by profiler name, timed at both train
calls beside autograd of the plain scan.  Then the LM example
(``run_train_lm``: ``examples/torch_train_lm.py`` at its 300 steps in
f32, the loss heading for the bigram floor, 1800 launches of each
attention kernel's f32 instance) and a supervised run of its model
crashed once at step 17 and resumed from its step-10 checkpoint,
against one not crashed (bit for bit or not, logged).  Last the fleet
(``run_fleet``, after every phase that
reads the profiler, at the video cell's θ): caldot1 test clips 0-2 at 16
frames, round-robin over concurrent streams, each stream's tracks held
to its solo run: through one ``BatchBroker`` at 1, 4 and 16 streams on one
chunk clock (``on_clock``; fewer detector dispatches than the solo runs
at 4 and 16), the detector's batch drift read at every bucket the broker
formed (bit for bit where it is 0.0 everywhere and at 1 stream; else
every detector score within twice the drift of its solo value, a window
whose kept cells differ counted as a decision flip, and the tracks of
each stream without one held to the same decisions and boxes within
1e-4 / 2e-5), through one ``TrackBroker`` with ``device_assign`` at 4 and 16
streams (bit for bit; ``track_step`` launches equal the broker's
dispatches), and ``run_clips`` over the three clips on fresh frames with
the shared ``DecodePool`` at ``decode_workers`` 1 and 3 (bit for bit).
Then the executor's instrumentation (``run_traced``): cached clip 0 at 64
frames with the tracer off, on and off, host and device TRACK (tracks,
dispatches and launches bit for bit; one ``run`` span and its
``stage.*`` children; the registry's dispatch counters), an induced
drain failure's ``executor.drain`` crash dump, and 4 traced streams
through one ``BatchBroker`` on one chunk clock (an exact flush and
dispatch window ledger, a Chrome export with one lane a stream, each
stream held to its solo run as the fleet holds them).  After live
ingest (``run_live``), the SLO engine's stock rules, the health report
and the Prometheus text over the registry it filled (``read_obs``: the
append rule's p95 equals the appends' own, every queue depth reads 0,
every sample line parses), then training and tuning (``run_tuning``):
the three trainers' steps on the card against the CPU
(``core.train_check``), ``tuner.setup`` at full width (both detector
archs, all 8 detector and 5 proxy resolutions, the full tracker) on
caldot1 clips, the trained ssd-deep's F1 against the untrained one's,
``tuner.tune`` with 3 iterations (``proxy_score`` launched), a proxy
proposal's evaluation (or, where the cache proposes none, the sparsest
proxy θ's: ``proxy_plan`` and ``window_gather_batch`` launched), and the
tuned θ twice on the main path (equal tracks).
Then the registry over HTTP (``run_served``): 4 streams on one
``BatchBroker`` and one chunk clock, unscraped and then with an
``ObsServer`` scraped through ``/metrics`` and ``/healthz`` from a
thread the whole run (each stream held to its solo run as the traced
fleet; the same launches; every scrape well formed;
``broker.detect.units_in`` grown by every window), and ``python -m
repro_torch.obs`` in process (``serve-smoke``, ``scrape`` and
``snapshot`` against a live server, ``dump`` and ``tail``).  Last the
two examples over the port (``run_examples``:
``examples/torch_quickstart.py`` and ``examples/torch_limit_query.py``
at the reduced configuration with cut steps and clips; their invariant
lines held, ``proxy_plan`` and ``track_step`` launched, and
``window_gather_batch`` once for each sub-frame size class they
planned).  Every phase runs uncaught: any failure exits non-zero before
the result line.

The line before the last three gives the whole script's wall.  The
last three lines of standard output are the kernels' JSON record,
the card's name and power limit as ``nvidia-smi`` reports them, and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the rest of the checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import io
import json
import math
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the port (fails here, before any result, outside a checkout)
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.multiscope import MULTISCOPE_PIPELINE  # noqa: E402
from repro_torch.core import pipeline as pl  # noqa: E402
from repro_torch.core.detector import (Detector, batch_drift,  # noqa: E402
                                       next_bucket)
from repro_torch.core.proxy import ProxyModel  # noqa: E402
from repro_torch.core import executor as executor_mod  # noqa: E402
from repro_torch.core.executor import (BatchBroker,  # noqa: E402
                                       ClipExecutor, ExecutorOptions,
                                       TrackBroker, run_clips,
                                       stage_proxy)
from repro_torch.core.metrics import clip_count_accuracy, mota  # noqa: E402
from repro_torch.core.refine import TrackRefiner  # noqa: E402
from repro_torch.core import train_check  # noqa: E402
from repro_torch.core import tuner as tuner_mod  # noqa: E402
from repro_torch.core.train_models import detector_f1  # noqa: E402
from repro_torch.core import tracker as trk_mod  # noqa: E402
from repro_torch.core.hungarian import (  # noqa: E402
    BIG, DEVICE_JV_GAP, optimality_gap)
from repro_torch.core.tracker import (RecurrentTracker,  # noqa: E402
                                      init_tracker)
from repro_torch.core.windows import plan_chunk, plan_from_mapped  # noqa: E402
from repro_torch.data.video_synth import make_clip, make_split  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.assign import (assign_batch,  # noqa: E402
                                        assign_batch_ref)
from repro_torch.kernels.assign import check as assign_check  # noqa: E402
from repro_torch.kernels.track_step import (  # noqa: E402
    LOG1P_TABLE_2D, track_step, track_step_ref)
from repro_torch.kernels.track_step import (  # noqa: E402
    check as track_check)
from repro_torch.kernels.proxy_plan import (  # noqa: E402
    proxy_plan, proxy_plan_ref)
from repro_torch.kernels.proxy_plan.ops import (FLIP_ULPS,  # noqa: E402
                                                _spans_on, check_plan)
from repro_torch.kernels import views_to_host  # noqa: E402
from repro_torch.kernels.proxy_score import (  # noqa: E402
    check_scores, proxy_score, proxy_score_ref)
from repro_torch.kernels.proxy_score import (  # noqa: E402
    check as score_check)
from repro_torch.kernels.proxy_plan import check as plan_check  # noqa: E402
from repro_torch.kernels.window_gather import (  # noqa: E402
    window_gather, window_gather_batch, window_gather_batch_ref,
    window_gather_ref)
from repro_torch.kernels.window_gather import (  # noqa: E402
    check as gather_check)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_ref)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    check as decode_check)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd, flash_attention_bwd_ref,
    flash_attention_ref)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    check as flash_check)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    ops as flash_attention_ops)
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    SSDScanFn, ssd_scan, ssd_scan_bwd, ssd_scan_ref)
from repro_torch import obs  # noqa: E402
from repro_torch.obs import REGISTRY, TRACER, interp_quantile  # noqa: E402
from repro_torch.obs import recorder as obs_recorder  # noqa: E402
from repro_torch.obs.__main__ import main as obs_main  # noqa: E402
from repro_torch.obs.__main__ import (validate_exposition,  # noqa: E402
                                      validate_health)
from repro_torch.obs.serve import (ObsServer,  # noqa: E402
                                   default_components, health_report,
                                   render_prometheus)
from repro_torch.obs.slo import SloEngine, default_rules  # noqa: E402
from repro_torch.query import (PackedTracks, Query,  # noqa: E402
                               QueryService, TimeRange, TrackStore,
                               compile_query)
from repro_torch.query.ref import reference_query  # noqa: E402
from repro_torch.stream import SegmentIngestor, StandingQuery  # noqa: E402
from repro_torch.kernels.ssd_scan import check as ssd_check  # noqa: E402
from repro_torch.models import attention as lm_attention  # noqa: E402
from repro_torch.models import encdec as lm_encdec  # noqa: E402
from repro_torch.models import layers as lm_layers  # noqa: E402
from repro_torch.models import moe as lm_moe  # noqa: E402
from repro_torch.models import ssm as lm_ssm  # noqa: E402
from repro_torch.models import transformer as lm_transformer  # noqa: E402
from repro_torch.models.model import Model, build_model  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.distributed import (Checkpointer,  # noqa: E402
                                     Supervisor, TrainState)
from repro_torch.configs.shapes import TRAIN_4K  # noqa: E402
from repro_torch.optim import adamw, cosine_schedule  # noqa: E402
from repro_torch.params import lm_to_params  # noqa: E402
from repro_torch.train import build_train_step  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

DEVICE = "cuda"
CFG = MULTISCOPE_PIPELINE       # full width
SEED = 0
N_FRAMES = 64
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
F32_OPS_PER_S = 67e12           # H100 SXM float32 outside tensor cores
L2_FLUSH_BYTES = 128 << 20      # more than the H100's 50 MB L2
SIZES_CELLS = [(60, 34), (15, 9), (30, 17)]   # full frame + two windows
PROXY_QUANTILE = 0.85
DET_QUANTILE = 0.995
CONV_ATOL = 1e-4                # card vs CPU conv nets (TF32 off)
# the fleet phase: caldot1 test clips 0-2 at 16 frames (one chunk; cut
# from 32 so that the call, the tuning phase included, fits) a
# stream, round-robin over the streams; tracks of a brokered stream
# against its solo run: bit for bit, or (where the detector moved with
# the batch and no decision flipped) the same frames and ids and boxes
# within the slice's tolerances
FLEET_FRAMES = 16
FLEET_CLIPS = 3
FLEET_STREAMS = (1, 4, 16)
FLEET_TRACK_STREAMS = (4, 16)
FLEET_POOLS = (1, 3)
FLEET_JOIN_S = 300.0
# profiler traces that held none of their kernels: traced again after a
# pause, this many times in all
TRACE_TRIES = 8
TRACE_PAUSE_S = 1.0
# the calls a check of which kernel a wrapper launched traces: this many
# seconds of them (20 scan calls, about 2 ms of the card's time, held
# none in eight traces late in one run)
TRACE_SECONDS = 0.25
# how far a brokered stream's host-tracker costs may move from its solo
# run's before their first differing assignment: the detector's drift
# carried through the GRU (1.2e-7 read on the card); a fault moves
# them by tenths
FLEET_COST_ATOL = 1e-5
# the live phase: caldot1 test clips 0-2 at 64 frames, in segments of
# one chunk (aligned: every chunk as in a batch ingest, so bit for bit)
# and of LIVE_ODD_SEG frames (other batches: held as the fleet holds a
# brokered stream)
LIVE_FRAMES = 64
LIVE_CLIPS = 3
LIVE_SEG = 16
LIVE_ODD_SEG = 5
LIVE_JOIN_S = 300.0
BOX_RTOL, BOX_ATOL = 1e-4, 2e-5
BF16_OPS_PER_S = 989e12         # H100 SXM bf16 tensor cores, dense
# f32 on tensor cores as 3xTF32: three tf32 products (495 TFLOP/s dense)
TF32X3_OPS_PER_S = 495e12 / 3
LM_CFG = get_config("qwen2-0.5b")   # full width
LM_PROMPT_LENS = (61, 200, 384, 500)
LM_MAX_LEN = 1024
LM_NEW_TOKENS = 32
# logits of two runs that differ in rounding only (the attention kernels
# against their plain versions, batch 1 against 4, a decode step against
# a fresh prefill), max |d| held to this share of the logits' RMS, by
# activation dtype; set between the rounding-only gaps and the planted
# faults' gaps that the serve checks print (PERF.md)
LM_LOGIT_TOL = {"bfloat16": 0.2, "float32": 1e-3}
# the device kernels each attention wrapper may launch, by name (both
# flash attention kernels run on tensor cores, f32 as 3xTF32)
FLASH_KERNEL_NAMES = flash_check.KERNEL_NAMES
DECODE_KERNEL_NAMES = ("decode_attention_kernel",)
# the JV kernels of assign_batch (by the matrix size)
ASSIGN_KERNEL_NAMES = ("assign_kernel", "assign_large_kernel")
SSM_CFG = get_config("mamba2-370m")  # full width
# the Mamba2 cell's serve checks, by the same rule: its 48 layers carry
# bf16 rounding further (rounding-only gaps up to 0.23 of the RMS, the
# smallest planted fault 0.79, PERF.md)
SSM_LOGIT_TOL = {"bfloat16": 0.4, "float32": 1e-3}
# full width at 5 of its 13 groups (33 of 81 layers: 5 groups of 5 Mamba2
# layers and a shared block, the 3 tail layers), to keep the script
# within its time with the MoE phase (PERF.md section 4): the kernels'
# shapes do not change with depth, and both shared blocks still alternate
HYBRID_GROUPS = 5
HYBRID_CFG = get_config("zamba2-7b")
HYBRID_CFG = dataclasses.replace(
    HYBRID_CFG, hybrid=dataclasses.replace(HYBRID_CFG.hybrid,
                                           n_groups=HYBRID_GROUPS),
    n_layers=HYBRID_GROUPS * (HYBRID_CFG.hybrid.ssm_per_group + 1)
    + HYBRID_CFG.hybrid.tail_ssm)
# the Zamba2 cell's serve checks, by the same rule: f32 as the other
# cells; bf16 about twice the rounding-only gaps its first full-width
# run read (0.301-0.309 of the RMS over 81 layers), the smallest fault
# held in bf16 3.02 (PERF.md)
HYBRID_LOGIT_TOL = {"bfloat16": 0.6, "float32": 1e-3}
# full width, all 28 layers, its weights held in bf16 (f32 masters and
# their bf16 copies, 91.5 GiB, do not fit the card); the f32 check copy
# at MOE_F32_LAYERS of 28 (1 dense + 13 MoE layers): f32 masters of all
# 28 (61.0 GiB) and the f32 draw of the largest expert stack (18.6 GiB)
# do not fit
MOE_CFG = dataclasses.replace(get_config("deepseek-moe-16b"),
                              param_dtype="bfloat16")
MOE_F32_LAYERS = 14
# the MoE cell's serve checks, by the same rule (PERF.md)
MOE_LOGIT_TOL = {"bfloat16": 0.6, "float32": 1e-3}
# full width, all 40 layers, its weights held in bf16 (22.81 GiB; f32
# masters and their bf16 copies, 68.4 GiB, leave no room to serve); the
# f32 check copy at VLM_F32_LAYERS of 40 (its f32 weights 45.63 GiB at
# full depth, and an f32 prefill of 4 x 1524 tokens through 40 layers
# seconds long, run some 20 times): the bf16 model is freed first
VLM_CFG = dataclasses.replace(get_config("pixtral-12b"),
                              param_dtype="bfloat16")
VLM_F32_LAYERS = 8
# the vlm cell's serve checks, by the same rule: its first card run read
# rounding-only gaps of 0.107-0.110 of the RMS in bf16, 1.1e-5-1.7e-5 in
# f32, the smallest fault held in bf16 3.46 (PERF.md)
VLM_LOGIT_TOL = {"bfloat16": 0.3, "float32": 1e-3}
# full width (12 encoder and 12 decoder layers), bf16 over f32 masters
ENCDEC_CFG = get_config("whisper-small")
# by the same rule: rounding-only gaps 0.036-0.039 in bf16, the smallest
# fault held there 0.736; f32 below the other cells' 1e-3, since erf
# GELU for tanh moves the logits only 7.1e-4 of their RMS there, against
# rounding-only gaps of 3.3e-6-9.9e-6 (PERF.md)
ENCDEC_LOGIT_TOL = {"bfloat16": 0.2, "float32": 1e-4}


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def event_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Per-call time of ``fn`` between CUDA events over ``reps`` calls
    (host enqueue included, as the main path pays it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled_cold(fn, reps: int):
    """A profiler's record of ``reps`` calls of ``fn`` (after one
    untimed call), the L2 cache overwritten before each so that the
    inputs come from device memory, as the bound assumes."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=DEVICE)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    return prof


def device_us(ev) -> float:
    """An averaged profiler event's total device time in us (the name
    of the field depends on the torch version)."""
    total = getattr(ev, "device_time_total", None)
    return getattr(ev, "cuda_time_total", 0.0) if total is None else total


def device_ms_by_kernel(fn, kernel_names, reps: int = 50):
    """Device time per call of ``fn`` of each CUDA kernel whose name
    contains one of ``kernel_names``, from the profiler's trace, with the
    L2 cache overwritten before each call so that the inputs come from
    device memory, as the bound assumes: the mean time of the launches
    the trace recorded, times the launches one call makes (the recorded
    launches over ``reps``, rounded).  The trace may drop launches, so
    its total over ``reps`` would read short.  {name: ms, or None if the
    profiler recorded no device time for it}."""
    prof = profiled_cold(fn, reps)
    out = {name: None for name in kernel_names}
    for ev in prof.key_averages():
        for name in kernel_names:
            if name in ev.key and ev.count and out[name] is None:
                total = device_us(ev)
                if total:
                    calls = max(1, round(ev.count / reps))
                    out[name] = total / ev.count * calls / 1e3  # us -> ms
    return out


def device_ms(fn, kernel_names, reps: int = 50):
    """Device time per call of ``fn`` of the CUDA kernels whose names
    contain ``kernel_names`` (a name or a tuple of names, every kernel the
    wrapper may launch), summed over those the trace holds
    (``device_ms_by_kernel``); None if it holds none."""
    if isinstance(kernel_names, str):
        kernel_names = (kernel_names,)
    found = [t for t in device_ms_by_kernel(fn, kernel_names, reps).values()
             if t is not None]
    return sum(found) if found else None


def grid_blocks(trace: dict, kernel_names) -> list:
    """Thread blocks (grid x * y * z) of each launch, in a profiler's
    Chrome trace, of a kernel whose name contains one of
    ``kernel_names``."""
    return [math.prod(ev["args"]["grid"])
            for ev in trace.get("traceEvents", [])
            if ev.get("cat") == "kernel" and "grid" in ev.get("args", {})
            and any(n in ev.get("name", "") for n in kernel_names)]


def launch_blocks(fn, kernel_names, seconds: float = 0.05) -> list:
    """The distinct ``grid_blocks`` of those kernels' launches over
    ``seconds`` of profiled calls of ``fn``, as the card recorded them.
    The trace can miss the launches of its first milliseconds (a
    one-call trace late in a long process held none), so it holds many
    calls.  [] if it holds none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
        torch.cuda.synchronize()
    path = _build.BUILD_DIR / "launch_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    path.unlink()
    return sorted(set(grid_blocks(trace, kernel_names)))


def bound(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S):
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / ops_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def build_kernels() -> None:
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"build: {len(secs)} kernels in {time.perf_counter() - t0:.2f} s "
        f"(parallel nvcc; per source {json.dumps(secs)})")
    for name in secs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}]: {line.strip()}")


def make_bank(dev: str):
    cfg = CFG
    pres = cfg.proxy.resolutions[0]                       # (416, 256)
    return pl.ModelBank(
        cfg, {"ssd-deep": Detector("ssd-deep", seed=SEED, device=dev)},
        {pres: ProxyModel(cfg.proxy.cell, cfg.proxy.base_channels, pres,
                          seed=SEED, device=dev)},
        tracker_params=init_tracker(cfg.tracker, seed=SEED, device=dev),
        sizes_cells=list(SIZES_CELLS), ref_grid=SIZES_CELLS[0],
        device=dev)


def set_up(bank, clip):
    """θ for the main path.  The proxy threshold and the detector
    confidence are quantiles of the untrained heads' scores on the first
    chunk; window times are measured, and seeded proportional to window
    area if the measured ones leave no sub-frame window (set-up, not
    the main path)."""
    cfg = bank.cfg
    det_res = cfg.detector.resolutions[0]                 # (960, 544)
    pres = cfg.proxy.resolutions[0]
    proxy = bank.proxies[pres]
    frames = np.stack([pl.render_frame(clip, f, *det_res)[0]
                       for f in range(16)])
    pframes = pl.downsample_chunk(frames, pres)
    feat = proxy.features(pframes)
    enc = proxy.encoder
    with torch.inference_mode():
        sig = torch.sigmoid(feat @ enc.head_w + enc.head_b)
        thr = float(torch.quantile(sig.flatten(), PROXY_QUANTILE))
        scores = torch.sigmoid(bank.detectors["ssd-deep"].net(
            torch.from_numpy(frames).to(DEVICE))[..., 0])
        conf = float(torch.quantile(scores.flatten(), DET_QUANTILE))
    params = pl.PipelineParams("ssd-deep", det_res, conf, gap=1,
                               proxy_res=pres, proxy_threshold=thr,
                               tracker="recurrent", refine=False,
                               chunk_size=16)
    sizeset = pl.make_sizeset(bank, params)
    log(f"set-up: proxy threshold {thr!r} (q{PROXY_QUANTILE}), det_conf "
        f"{conf!r} (q{DET_QUANTILE}), measured window times (s) "
        f"{ {str(s): t for s, t in sizeset.times.items()} }")
    grids, stats = proxy.plan_batch(pframes, thr, pl.det_grid(det_res))

    def plan():
        return plan_from_mapped(grids, stats, pl.make_sizeset(bank, params),
                                cfg.windows.max_windows, chunk_size=16)

    full = sizeset.full
    if all(s == full for s in plan().by_size):
        t_full = sizeset.times[full]
        for s in sizeset.sizes:
            bank.win_times[("ssd-deep", s)] = \
                t_full * s[0] * s[1] / (full[0] * full[1])
        log("set-up: the measured window times leave no sub-frame window "
            "in the first chunk; seeded them proportional to window area "
            f"from the full frame's {t_full!r} s")
    first = plan()
    if all(s == full for s in first.by_size):
        raise RuntimeError("no sub-frame window planned: window_gather "
                           "would not run")
    log(f"set-up: first chunk plans {sum(map(len, first.windows))} windows"
        f" in size classes { {str(s): len(e) for s, e in first.by_size.items()} }")
    return params, frames, feat, first


def traced(trace, label: str, tries: int = TRACE_TRIES):
    """``trace()`` (one profiler trace, read down to a value: None or
    empty where the trace held none of its kernels) again, after a
    pause, up to ``tries`` times: a trace late in a long process may
    drop every launch, and did so three times in a row for one call.
    Logs any empty trace; raises if every trace was empty."""
    for k in range(tries):
        got = trace()
        if got is not None and got != set():
            if k:
                log(f"{label}: {k} empty profiler trace(s) before this one")
            return got
        torch.cuda.synchronize()
        time.sleep(TRACE_PAUSE_S)
    raise AssertionError(f"{label}: the profiler recorded none of the "
                         f"kernels in {tries} traces")


def traced_ms(fn, kernel_names, label: str) -> float:
    """``device_ms`` of ``fn``, from the first trace that holds its
    kernels (``traced``)."""
    return traced(lambda: device_ms(fn, kernel_names), label)


def traced_kernels(launched, label: str) -> set:
    """``launched()`` (a check module's ``kernels_launched``: the kernel
    names one profiler trace holds), from the first trace that holds
    any (``traced``)."""
    return traced(launched, label)


def check_kernel_of_each_dtype(label: str, check, launched) -> None:
    """Each dtype launches only its own kernel: ``launched(dtype)`` (a
    check module's ``kernels_launched``) holds ``check.F32_KERNEL`` alone
    for f32 and the rest of ``check.KERNEL_NAMES`` for bf16."""
    for dt in (torch.bfloat16, torch.float32):
        got = traced_kernels(lambda: launched(dt), f"{label} {dt}")
        want = ({check.F32_KERNEL} if dt == torch.float32 else
                set(check.KERNEL_NAMES) - {check.F32_KERNEL})
        if got != want:
            raise AssertionError(f"{label} {dt}: the trace holds "
                                 f"{sorted(got)}, expected {sorted(want)}")
        log(f"{label} {dt}: launches {sorted(got)} only")


def launch_floor_ms() -> float:
    """The card's launch floor: the device time of ``zero_()`` on a
    one-element CUDA tensor, read as ``device_ms`` reads a kernel (the
    flush fills f32, this fills int32, so the names differ)."""
    one = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    t = traced_ms(lambda: one.zero_(), "FillFunctor<int>", "launch floor")
    log(f"launch floor: zero_() on a one-element CUDA tensor, device (cold "
        f"L2) {t!r} ms")
    return t


def copy_device_ms(n_bytes: int) -> float:
    """The device time of ``out.copy_(src)`` over ``n_bytes`` of f32 (a
    device-to-device memcpy), read as ``device_ms`` reads a kernel."""
    src = torch.ones(n_bytes // 4, device=DEVICE)
    out = torch.empty_like(src)
    return traced_ms(lambda: out.copy_(src), "Memcpy DtoD", "copy_")


def check_window_gather(frames, plan):
    """The batch gather against its plain version over the cases of
    ``repro_torch.kernels.window_gather.check`` (the card-only tests'
    own), bit for bit: the first chunk's plan for each size class it
    holds (the set-up chunk's own frames and tables), seeded tables
    padded with zero rows (one out of range), 8 windows of (30, 17) and
    the scalar branch.  Each timed with its bound and the device time of
    a ``copy_`` of the same bytes.  -> (the main-path record: the first
    chunk's plan, the class with the most windows; every record)."""
    dev_frames = torch.from_numpy(frames).to(DEVICE)
    cases = list(gather_check.CASES)
    for size in SIZES_CELLS[1:]:
        if plan.by_size.get(size) and size != cases[0][2]:
            cases.insert(1, (f"first chunk's plan {size}", cases[0][1], size,
                             "plan"))
    rows = []
    for case in cases:
        name, shape, size, kind = case
        table = None
        entries = plan.by_size.get(size) if kind == "plan" else None
        if entries:
            table = np.zeros((next_bucket(len(entries)), 3), np.int32)
            for k, (slot, x, y, _) in enumerate(entries):
                table[k] = (slot, y, x)
        fr = dev_frames if shape == tuple(frames.shape) else None
        rec = gather_check.check_case(case, DEVICE, frames=fr, table=table)
        src, tbl, win_h, win_w = rec["operands"]

        def kern():
            return window_gather_batch(src, tbl, win_h=win_h, win_w=win_w,
                                       cell=pl.CELL_PX)

        def plain():
            return window_gather_batch_ref(src, tbl, win_h=win_h,
                                           win_w=win_w, cell=pl.CELL_PX)
        b_ms, b_by = bound(2 * rec["out_bytes"] + tbl.numel() * 4, 0)
        dev_ms = traced_ms(kern, gather_check.KERNEL_NAMES,
                           f"window_gather_batch {name}")
        row = dict(case=name, size=size, n=rec["n"],
                   src="first chunk's plan" if table is not None
                   else "seeded", max_abs_err=rec["max_abs_err"],
                   ms=event_ms(kern), plain_ms=event_ms(plain),
                   device_ms=dev_ms, copy_device_ms=copy_device_ms(
                       rec["out_bytes"]), bound_ms=b_ms, bound_by=b_by)
        log(f"window_gather_batch {name}: {rec['n']} rows of {size} cells "
            f"({row['src']} table), exact; kernel {row['ms']:.4f} ms/call "
            f"(device, cold L2 {dev_ms!r}), plain {row['plain_ms']:.4f} ms, "
            f"bound {b_ms:.5f} ms ({b_by}); copy_ of the same "
            f"{rec['out_bytes']} bytes, device {row['copy_device_ms']!r}")
        rows.append(row)
    # the main-path entry: the planned class with the most windows
    return max((r for r in rows if r["src"] == "first chunk's plan"),
               key=lambda r: r["n"]), rows


def check_proxy_plan(feat, w, b, thr, grid_hw):
    """The fused plan against its plain version over the cases of
    ``repro_torch.kernels.proxy_plan.check`` (the card-only tests'
    own: the main path's shapes at a threshold between cells and on a
    cell, an all-empty frame, B 1, the reduced config, an odd C), then
    on the set-up chunk's own features at the main path's threshold,
    timed there (device ms over ``KERNEL_NAMES``; the host's enqueue
    time of the wrapper).  -> the record."""
    hc, wc = grid_hw
    B, hp, wp, C = feat.shape
    flips = 0
    for case in plan_check.CASES:
        rec = plan_check.check_case(case, DEVICE)
        flips += rec["flips"]
        log(f"proxy_plan {case[0]} {rec['shape']}: {rec['flips']} flipped "
            f"grid cells, all within {FLIP_ULPS} ulp of the threshold "
            f"({rec['reach']} cells in the band's reach); stats equal "
            "wherever no flip touched")
    rec = plan_check.check_call(feat, w, b, thr, grid_hw,
                                "main path features")
    flips += rec["flips"]
    log(f"proxy_plan (main path features): {rec['flips']} flipped grid "
        f"cells, all within {FLIP_ULPS} ulp of threshold {thr!r} "
        f"({rec['reach']} cells in the band's reach)")
    sy, sx = _spans_on(feat.device, hc, hp, wc, wp)

    def kern():
        return proxy_plan(feat, w, b, thr, grid_hw=grid_hw)

    def plain():
        return proxy_plan_ref(feat, w, b, thr, sy, sx)
    n_bytes = (feat.numel() + w.numel() + 1 + sy.numel() + sx.numel()) * 4 \
        + B * hc * wc + B * 8 * 4
    n_ops = B * hp * wp * (2 * C + 4) + B * (hc * wp * hp + hc * wc * wp) * 2
    b_ms, b_by = bound(n_bytes, n_ops)
    with torch.inference_mode():
        dev_ms = traced_ms(kern, plan_check.KERNEL_NAMES, "proxy_plan")
        row = dict(max_abs_err=float(flips > 0), flips=flips,
                   ms=event_ms(kern), plain_ms=event_ms(plain),
                   host_us=host_us(kern), device_ms=dev_ms, bound_ms=b_ms,
                   bound_by=b_by)
        # the plan's way back to the host, as ProxyModel.plan_batch takes
        # it: one copy of the buffer that grid and stats share, against
        # a copy of each
        grid, stats = kern()
        row.update(copy_back_us=host_us(lambda: views_to_host(grid, stats)),
                   copy_back_two_us=host_us(lambda: (grid.cpu().numpy(),
                                                     stats.cpu().numpy())))
    log(f"proxy_plan {tuple(feat.shape)} -> {(B, hc, wc)}: kernel "
        f"{row['ms']:.4f} ms/call (device, cold L2 {dev_ms!r}; host "
        f"enqueue {row['host_us']:.2f} us a call), plain "
        f"{row['plain_ms']:.4f} ms, bound {b_ms:.6f} ms ({b_by}); the plan "
        f"to the host in one copy {row['copy_back_us']:.2f} us, in two "
        f"{row['copy_back_two_us']:.2f} us")
    return row


def host_us(fn, reps: int = 200) -> float:
    """Host time of one call of ``fn`` (its enqueue: no synchronise
    inside the loop), in us."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def check_window_gather_single(frame):
    """The single-frame gather against its plain version over
    ``window_gather.check.SINGLE_CASES`` (the card-only tests' own), bit
    for bit, every zero row cropping cell (0, 0): 8 rows of each
    sub-frame size on the set-up chunk's first frame (6 seeded, the far
    edge, one zero row) with the table on the host, as the per-frame
    engine passes it (the launch carries its rows), and on the card; a
    host table of 20 rows (a device table); unaligned rows with either
    table (the scalar kernel).  The 8-row cases are timed: ms a call,
    device ms at a cold L2 over ``SINGLE_KERNEL_NAMES``, the host's
    enqueue, the plain version, and the bound over the distinct frame
    pixels the table touches plus the bytes written (beside the
    earlier bound, twice the bytes written).  -> {case: record}."""
    dev_frame = torch.from_numpy(np.ascontiguousarray(frame)).to(DEVICE)
    rows = {}
    for case in gather_check.SINGLE_CASES:
        name, shape, size, kind, where = case
        fr = dev_frame if shape == tuple(frame.shape) else None
        rec = gather_check.check_single_case(case, DEVICE, frame=fr)
        src, tbl, win_h, win_w = rec["operands"]
        row = dict(case=name, size=size, n=rec["n"], table=where,
                   max_abs_err=rec["max_abs_err"])
        rows[name] = row
        if kind != "padded":
            log(f"window_gather {name}: {rec['n']} rows of {size} cells, "
                "exact")
            continue

        def kern():
            return window_gather(src, tbl, win_h=win_h, win_w=win_w,
                                 cell=pl.CELL_PX)

        def plain():
            return window_gather_ref(src, torch.as_tensor(tbl).to(DEVICE),
                                     win_h=win_h, win_w=win_w,
                                     cell=pl.CELL_PX)
        b_ms, b_by = bound(rec["bound_bytes"], 0)
        row.update(ms=event_ms(kern), plain_ms=event_ms(plain),
                   host_us=host_us(kern),
                   device_ms=traced_ms(kern, gather_check.SINGLE_KERNEL_NAMES,
                                       f"window_gather {name}"),
                   bound_ms=b_ms, bound_by=b_by,
                   bound_ms_written_twice=bound(2 * rec["out_bytes"], 0)[0])
        log(f"window_gather {name}: {rec['n']} rows of {size} cells (6 "
            f"seeded, far edge, padding) from one {shape[0]}x{shape[1]} "
            f"frame: exact; kernel {row['ms']:.4f} ms/call (device, cold L2 "
            f"{row['device_ms']!r}; host enqueue {row['host_us']:.2f} us a "
            f"call), plain {row['plain_ms']:.4f} ms, bound {b_ms:.6f} ms "
            f"({b_by}: {rec['bound_bytes']} bytes, each touched pixel once; "
            f"twice the output {row['bound_ms_written_twice']:.6f} ms)")
    return rows


def check_proxy_score(feat, w, b, thr):
    """The score-map head against its plain version over
    ``proxy_score.check.CASES`` (the card-only tests' own): the
    per-frame path's (1, 8, 13, 64) and a chunk's (16, 8, 13, 64) on the
    encoder's real features of the set-up chunk at the main path's
    threshold, the chunk again at a threshold ON a cell's score, and
    seeded C 40 and odd C; scores to 1e-6, both held to float64 by
    ``check_scores`` (flips only in the 8-ulp band).  The first two are
    timed (device ms over ``KERNEL_NAMES``, the host's enqueue), with
    the outputs' way back to the host as ``ProxyModel.scores`` takes it,
    one copy of the buffer both share, against a copy of each.
    -> {B: record}."""
    rows = {}
    for case in score_check.CASES:
        name, shape, kind = case
        ops = None
        if shape[1:] == tuple(feat.shape[1:]) and shape[0] <= feat.shape[0]:
            f = feat[:shape[0]].contiguous()
            t = thr
            if kind == "on_a_cell":
                with torch.inference_mode():
                    t = float(torch.sigmoid(
                        f[shape[0] // 2, shape[1] // 2, shape[2] // 2] @ w
                        + b))
            ops = (f, w, b, t)
        rec = score_check.check_case(case, DEVICE, operands=ops)
        log(f"proxy_score {name} {shape}: max |d score| "
            f"{rec['max_abs_err']!r}, {rec['flips']} flipped cells, all "
            f"within {FLIP_ULPS} ulp ({rec['band']} cells in the band, "
            f"threshold {rec['operands'][3]!r})")
        if kind != "quantile" or ops is None:
            continue
        f = ops[0]

        def kern():
            return proxy_score(f, w, b, thr)

        def plain():
            return proxy_score_ref(f, w, b, thr)
        n_rows = f.numel() // f.shape[-1]
        C = f.shape[-1]
        n_bytes = (f.numel() + w.numel() + 1) * 4 + n_rows * (4 + 1)
        b_ms, b_by = bound(n_bytes, n_rows * (2 * C + 4))
        with torch.inference_mode():
            row = dict(shape=tuple(f.shape), max_abs_err=rec["max_abs_err"],
                       flips=rec["flips"], band=rec["band"],
                       ms=event_ms(kern), plain_ms=event_ms(plain),
                       host_us=host_us(kern),
                       device_ms=traced_ms(kern, score_check.KERNEL_NAMES,
                                           f"proxy_score {name}"),
                       bound_ms=b_ms, bound_by=b_by)
            s, p = kern()
            row.update(copy_back_us=host_us(lambda: views_to_host(s, p)),
                       copy_back_two_us=host_us(lambda: (s.cpu().numpy(),
                                                         p.cpu().numpy())))
        log(f"proxy_score {tuple(f.shape)}: kernel {row['ms']:.4f} ms/call "
            f"(device, cold L2 {row['device_ms']!r}; host enqueue "
            f"{row['host_us']:.2f} us a call), plain {row['plain_ms']:.4f} "
            f"ms, bound {b_ms:.7f} ms ({b_by}); scores and positives to the "
            f"host in one copy {row['copy_back_us']:.2f} us, in two "
            f"{row['copy_back_two_us']:.2f} us")
        rows[shape[0]] = row
    return rows


def host_ms(fn, reps: int = 2) -> float:
    """Per-call host time of ``fn`` (a plain version on a CPU copy)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def check_assign():
    """The JV kernel against its plain version over the cases of
    ``repro_torch.kernels.assign.check`` (the card-only tests' own), bit
    for bit: K = 4 at N = 8, 64, 128 and 128 restricted to eff_n 40 on
    costs quantised to 1/64, all-equal rows, minima 32 columns apart,
    zeros of either sign, N = 256 (rows past shared memory) and N = 2048
    (the large-matrix instance); then
    the batches that must raise (NaN costs, a row of +inf: a step with no
    finite free column).  Each case timed, with the JV's steps (counted
    on the host) and ns a step.  -> {case: record}."""
    rows = {}
    for case in assign_check.CASES:
        name, K, N, eff, _ = case
        row = assign_check.check_case(case, DEVICE)
        host = assign_check.case_costs(case)
        dev = host.to(DEVICE)
        big = N > 1024

        def kern():
            return assign_batch(dev, eff)
        # (K, N) int32 out, (K, N, N) f32 in: the solve is sequential, so
        # the bound is bytes only and far below what a solve can reach
        b_ms, b_by = bound(host.numel() * 4 + K * N * 4, 0)
        dev_ms = device_ms(kern, ASSIGN_KERNEL_NAMES, reps=2 if big else 50)
        steps = max(row["steps"])
        row.update(ms=event_ms(kern, reps=2 if big else 50,
                               warmup=1 if big else 5),
                   device_ms=dev_ms,
                   plain_ms=host_ms(lambda: assign_batch_ref(host, eff),
                                    reps=1),
                   bound_ms=b_ms, bound_by=b_by,
                   ns_per_step=None if dev_ms is None
                   else dev_ms * 1e6 / steps)
        log(f"assign_batch {name} ({K}, {N}, {N}) eff_n={eff}: exact "
            f"against the plain version on a CPU copy; kernel "
            f"{row['ms']:.4f} ms/call (device, cold L2 {dev_ms}), plain "
            f"(CPU) {row['plain_ms']:.2f} ms, bound {b_ms:.6f} ms ({b_by}: "
            f"matrices read once, columns written once); JV steps "
            f"{row['steps']} (hops {row['hops']}), {row['ns_per_step']} ns "
            "a step of the longest solve")
        rows[name] = row
    for case in assign_check.RAISE_CASES:
        msg = assign_check.check_raises(case, DEVICE)
        log(f"assign_batch on {case[0]} costs raises, as the plain version "
            f"does ({msg}), and with err= sets the flag instead")
    return rows


def check_track_step():
    """The fused step against its plain version over the cases of
    ``repro_torch.kernels.track_step.check`` (the card-only tests' own),
    bit for bit on all three outputs, the plain version on the card equal
    to the plain version on the CPU: at the main path's widths (Q = 128
    slots) one stream with 40 live tracks and 30 detections at the
    tracker's threshold, 16 streams at threshold 0.5, one live row, one
    valid column, Q = 256 on squares of 64 and 256, and Q = 512 (the
    large-matrix JV instance).  Each case
    timed by kernel part, with the JV's steps and ns a step.
    -> {case: record}."""
    heads_cpu = track_check.heads("cpu")
    heads = [p.to(DEVICE) for p in heads_cpu]
    table_cpu = torch.from_numpy(LOG1P_TABLE_2D)
    table = table_cpu.to(DEVICE)
    rows = {}
    for case in track_check.CASES:
        name, K, Q, _, _ = case
        row = track_check.check_case(case, DEVICE, heads_cpu)
        ops_cpu, thr_cpu = track_check.case_operands(case, heads_cpu)
        ops = [a.to(DEVICE) for a in ops_cpu]
        thr_dev = thr_cpu.to(DEVICE)

        def kern():
            return track_step(*ops, thr_dev, heads, table)

        def plain():
            return track_step_ref(*ops, thr_dev, heads, table)
        alive, dvalid = ops_cpu[2], ops_cpu[7]
        n = (dvalid > 0).sum(1)
        H = ops_cpu[0].shape[2]
        e = ops_cpu[5].shape[2]
        M = heads_cpu[8].shape[1]
        # operations this data needs: the match MLP and logit over the
        # live pairs, the match-time features of the valid columns, and
        # both GRU batches with their features over all 2Q rows; the JV
        # solve is sequential and outside the bound
        feat = (e + 6) * e * 2
        gru = 3 * (e + H) * H * 2
        pairs = row["live_pairs"]
        n_ops = (pairs * ((H + e + 6) * M * 2 + M * 2) + int(n.sum()) * feat
                 + 2 * Q * K * (feat + gru))
        n_bytes = (sum(a.numel() for a in ops_cpu) + 1
                   + sum(p.numel() for p in heads_cpu)
                   + table_cpu.numel()) * 4 + K * Q * (1 + 2 * H) * 4
        b_ms, b_by = bound(n_bytes, n_ops)
        q2_ms = K * (Q * Q * (H + e + 6) * M * 2 + Q * Q * M * 2) \
            / F32_OPS_PER_S * 1e3
        parts = {k: t for k, t in device_ms_by_kernel(
            kern, track_check.KERNEL_NAMES).items() if t is not None}
        jv_ms = parts.get("track_assign_kernel",
                          parts.get("track_assign_large_kernel"))
        main = name == track_check.CASES[0][0]
        row.update(ms=event_ms(kern, reps=20),
                   device_ms=sum(parts.values()) if parts else None,
                   device_ms_parts=parts,
                   plain_ms=event_ms(plain, reps=1, warmup=0) if main
                   else None,
                   bound_ms=b_ms, bound_by=b_by, bound_q2_ms=q2_ms,
                   ns_per_step=None if jv_ms is None
                   else jv_ms * 1e6 / max(max(row["steps"]), 1))
        log(f"track_step {name}: K={K} Q={Q} H={H} e={e} M={M}: {pairs} "
            f"live pairs, {row['matched']} rows matched, squares "
            f"{row['sides']}; kernel == plain on the card == plain on the "
            f"CPU, bit for bit on matched/h_upd/h_new; kernel "
            f"{row['ms']:.4f} ms/call (device, cold L2 {row['device_ms']}: "
            f"{json.dumps(parts)}), plain (card) {row['plain_ms']} ms, "
            f"bound {b_ms:.6f} ms ({b_by}: live-pair MLP + features + both "
            f"GRU batches at 67 TFLOP/s; JV sequential, outside it; all "
            f"Q^2 pairs would be {q2_ms:.6f} ms); JV steps {row['steps']} "
            f"(hops {row['hops']}), {row['ns_per_step']} ns a step of the "
            "longest solve")
        rows[name] = row
    return rows


def check_against_cpu(bank, frames, feat_cuda, pres):
    """Small-input agreement: the card's conv nets against the same
    weights on the CPU (TF32 off, so float32 on both), and the port's
    own cross-bucket drift on the card (reported, not asserted)."""
    import copy
    det = bank.detectors["ssd-deep"]
    enc = bank.proxies[pres].encoder
    x = torch.from_numpy(frames[:2])
    with torch.inference_mode():
        card = det.net(x.to(DEVICE)).cpu()
        cpu = copy.deepcopy(det.net).cpu()(x)
        d_det = float((card - cpu).abs().max())
        px = torch.from_numpy(np.ascontiguousarray(
            pl.downsample_chunk(frames[:2], pres)))
        d_proxy = float((feat_cuda[:2].cpu()
                         - copy.deepcopy(enc).cpu()(px)).abs().max())
        one = det.net(x[:1].to(DEVICE))
        sixteen = det.net(torch.from_numpy(frames).to(DEVICE))[:1]
        d_bucket = float((one - sixteen).abs().max())
        # the crop CNN embeds per frame (padded to 8 crops) on the
        # per-frame path and per chunk (padded to a bucket) on the
        # streaming one
        cnn = bank.tracker_params["crop_cnn"]
        crop = bank.cfg.tracker.crop
        crops = torch.from_numpy(np.random.default_rng(SEED).random(
            (64, crop, crop, 3), np.float32)).to(DEVICE)
        full = cnn(crops)
        d_embed = max(float((cnn(crops[:n]) - full[:n]).abs().max())
                      for n in (8, 16, 24, 40))
        # sub-frame windows: per frame at a bucket of that frame's
        # windows, per chunk at a bucket of the chunk's
        CELL_PX = pl.CELL_PX
        ph, pw = SIZES_CELLS[1][1] * CELL_PX, SIZES_CELLS[1][0] * CELL_PX
        wins = torch.from_numpy(np.ascontiguousarray(
            frames[:, :ph, :pw])).to(DEVICE)
        w16 = det.net(wins)
        d_window = max(float((det.net(wins[:n]) - w16[:n]).abs().max())
                       for n in (1, 2, 4, 8))
    log(f"card vs CPU, same weights, 2 frames of {frames.shape[1:3]}: "
        f"detector head "
        f"max |d| {d_det!r}, proxy features max |d| {d_proxy!r} "
        f"(tolerance {CONV_ATOL})")
    log(f"port's detector across buckets on the card (batch 1 vs 16): "
        f"max |d| {d_bucket!r}; detector on {pw}x{ph} windows (batch 1, 2,"
        f" 4, 8 vs 16): max |d| {d_window!r}; crop CNN (batch 8, 16, 24, 40"
        f" vs 64): max |d| {d_embed!r} (reported, not asserted)")
    if not (d_det < CONV_ATOL and d_proxy < CONV_ATOL):
        raise AssertionError("conv nets on the card disagree with the CPU")


def device_busy(bank, params, clip, options=None,
                label: str = "host tracker", engine: str = "streaming"
                ) -> None:
    """One more run of the main path (or, with ``engine="frame"``, of
    the per-frame engine) under the profiler, recording the device only:
    the card's busy time summed over every kernel and copy it ran,
    against the run's wall time, and the time of the track_step kernels.
    The profiler adds some host time, so the idle share is an upper
    bound."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if engine == "frame":
            res = pl.run_clip(bank, params, clip, engine="frame")
        else:
            res = ClipExecutor(bank, params, options).run(clip)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    per_name = {}
    for ev in prof.events():          # the device's own events only
        if ev.device_type == DeviceType.CUDA:
            per_name[ev.name] = per_name.get(ev.name, 0.0) \
                + ev.time_range.elapsed_us()
    busy_us = sum(per_name.values())
    track_us = sum(us for k, us in per_name.items() if "track_" in k
                   and "_kernel" in k)
    top = sorted(((us, k) for k, us in per_name.items()), reverse=True)
    stage = "" if res.stage_seconds is None else (
        f"TRACK stage {res.stage_seconds['track']['wall'] * 1e3:.1f} ms "
        "wall, ")
    log(f"device busy ({label}, profiled run, clip {clip.clip_id}): "
        f"{busy_us / 1e3:.1f} ms of {wall * 1e3:.1f} ms wall = "
        f"{100 * busy_us / 1e6 / wall:.1f}% busy, "
        f"{100 - 100 * busy_us / 1e6 / wall:.1f}% idle; {stage}"
        f"track_step kernels {track_us / 1e3:.1f} ms; top device time: "
        + "; ".join(f"{k[:60]} {us / 1e3:.1f} ms" for us, k in top[:6]))


@contextlib.contextmanager
def wrapped(owner, name: str, wrap):
    """Replace ``owner.name`` by ``wrap(original)`` inside the block (an
    instrumented run), and restore the original after it."""
    fn = getattr(owner, name)
    setattr(owner, name, wrap(fn))
    try:
        yield
    finally:
        setattr(owner, name, fn)


def frame_breakdown(bank, params, clip) -> dict:
    """Where one per-frame run's wall time goes: host clocks around the
    decode (``render_frame``), the proxy (``ProxyModel.scores``: encoder,
    ``proxy_score`` and the copy back), the detector
    (``Detector.detect_batch``, which synchronises on its outputs) and
    the tracker step (its crop CNN synchronises too), wrapped in place
    for this one measured run and restored after it.  The rest is host
    planning, the frame upload, ``window_gather`` and NMS.  -> seconds
    by phase, "other" and "wall" included."""
    spent = {"decode": 0.0, "proxy": 0.0, "detect": 0.0, "track": 0.0}

    def timed(phase):
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
            hooks.enter_context(wrapped(owner, name, timed(phase)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pl.run_clip(bank, params, clip, engine="frame")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rest = wall - sum(spent.values())
    log(f"per-frame run by phase (clip {clip.clip_id}, host clocks): "
        f"{wall:.3f} s wall = "
        + ", ".join(f"{k} {v:.3f} s" for k, v in spent.items())
        + f", other (planning, frame upload, window_gather, NMS) "
        f"{rest:.3f} s")
    return dict(spent, other=rest, wall=wall)


def engine_drift(bank, params, clip) -> None:
    """Where the per-frame engine parts from the streaming engine on the
    same clip (reported, not asserted: the two run their conv nets at
    other batch sizes): the detections each feeds the host tracker,
    frame by frame, recorded around ``RecurrentTracker.step`` for these
    two runs only."""
    seen = {"streaming": {}, "frame": {}}

    def recording(store):
        def wrap(step):
            def wrapper(self, frame_idx, dets, frame, det_embeds=None):
                store[frame_idx] = np.array(dets, copy=True)
                return step(self, frame_idx, dets, frame, det_embeds)
            return wrapper
        return wrap
    with wrapped(RecurrentTracker, "step", recording(seen["streaming"])):
        a = pl.run_clip(bank, params, clip)
    with wrapped(RecurrentTracker, "step", recording(seen["frame"])):
        b = pl.run_clip(bank, params, clip, engine="frame")
    differ = []
    for f, d in sorted(seen["frame"].items()):
        o = seen["streaming"][f]
        if d.shape != o.shape or not np.array_equal(d, o):
            gap = float(np.abs(d - o).max()) if d.shape == o.shape else None
            differ.append((f, d.shape[0], o.shape[0], gap))
    log(f"engine drift (clip {clip.clip_id}): streaming {len(a.tracks)} "
        f"tracks, per-frame {len(b.tracks)}; detections fed to the tracker"
        f" differ on {len(differ)} of {len(seen['frame'])} frames"
        + ("" if not differ else
           f", first (frame, per-frame count, streaming count, max |d|): "
           f"{differ[:4]}"))


def compare_plans(bank, params, clip):
    """Both PROXY paths' plans for every chunk of ``clip``: fused
    (``plan_batch`` -> ``plan_from_mapped``) and unfused
    (``scores_batch`` -> ``map_proxy_grid`` -> ``plan_chunk``).  They
    must plan the same windows on every frame where ``check_scores``
    finds no proxy cell in the flip band.  Returns (frames compared,
    frames with a cell in the band)."""
    proxy = bank.proxies[params.proxy_res]
    enc = proxy.encoder
    sizeset = pl.make_sizeset(bank, params)
    grid = pl.det_grid(params.det_res)
    mw = bank.cfg.windows.max_windows
    thr = params.proxy_threshold
    ids = list(range(0, clip.n_frames, params.gap))
    compared = in_band = 0
    for c0 in range(0, len(ids), 16):
        frames = np.stack([pl.render_frame(clip, f, *params.det_res)[0]
                           for f in ids[c0:c0 + 16]])
        pframes = pl.downsample_chunk(frames, params.proxy_res)
        grids, stats = proxy.plan_batch(pframes, thr, grid)
        fused = plan_from_mapped(grids, stats, sizeset, mw, chunk_size=16)
        _, pos = proxy.scores_batch(pframes, thr)
        unfused = plan_chunk([pl.map_proxy_grid(p, grid) for p in pos],
                             sizeset, mw, chunk_size=16)
        feat = proxy.features(pframes)
        with torch.inference_mode():
            sc, ps = proxy_score(feat, enc.head_w, enc.head_b, thr)
        for k in range(len(frames)):
            if check_scores(feat[k:k + 1], enc.head_w, enc.head_b, thr,
                            sc[k:k + 1], ps[k:k + 1]):
                in_band += 1
                continue
            compared += 1
            if fused.windows[k] != unfused.windows[k]:
                raise AssertionError(f"frame {ids[c0 + k]}: fused and "
                                     "unfused plans differ with no cell "
                                     "in the flip band")
    return compared, in_band


def check_refined(refined, plain, label: str) -> int:
    """Every refined track contains its unrefined track's rows
    unchanged: refinement only prepends a start row and appends an end
    row.  Returns how many tracks it extended."""
    if len(refined.tracks) != len(plain.tracks):
        raise AssertionError(f"refined {label} run has another track count")
    extended = 0
    for r, u in zip(refined.tracks, plain.tracks):
        if not np.isfinite(r).all():
            raise AssertionError(f"refined {label} track not finite")
        if np.array_equal(r, u):
            continue
        if len(r) != len(u) + 2 or not np.array_equal(r[1:-1], u) \
                or r[0, 0] != u[0, 0] or r[-1, 0] != u[-1, 0]:
            raise AssertionError(f"refined {label} track does not contain "
                                 "its unrefined rows")
        extended += 1
    return extended


def same_tracks(a, b) -> bool:
    return len(a.tracks) == len(b.tracks) and all(
        np.array_equal(x, y) for x, y in zip(a.tracks, b.tracks))


def check_result(res, n_frames):
    if res.frames_processed != n_frames:
        raise AssertionError(f"{res.frames_processed} frames processed")
    if not (res.detector_windows >= res.full_frames
            and res.full_frames + res.skipped_frames <= n_frames):
        raise AssertionError("inconsistent RunResult counters")
    if not res.tracks:
        raise AssertionError("no tracks")
    for t in res.tracks:
        if t.ndim != 2 or t.shape[1] != 6 or not np.isfinite(t).all():
            raise AssertionError(f"bad track array {t.shape}")
        f = t[:, 0]
        if (np.diff(f) <= 0).any() or f.min() < 0 or f.max() >= n_frames \
                or len(np.unique(t[:, 5])) != 1:
            raise AssertionError("track frames not increasing in range")


# ---------------------------------------------------------------------------
# The fleet: many streams through the cross-stream brokers, and run_clips
# ---------------------------------------------------------------------------

def run_threads(fns, timeout: float = FLEET_JOIN_S) -> list:
    """Run each callable on its own thread; -> their results.  A thread
    still alive after its join's timeout, or any error, fails."""
    out = [None] * len(fns)
    errors = []

    def one(i):
        try:
            out[i] = fns[i]()
        except BaseException as exc:     # raised below, on this thread
            errors.append(exc)

    threads = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"a stream did not finish in {timeout} s")
    if errors:
        raise errors[0]
    return out


def counters_agree(got, want, label: str) -> None:
    """A stream's run against its solo run: the same counters."""
    for k in ("frames_processed", "detector_windows", "full_frames",
              "skipped_frames"):
        if getattr(got, k) != getattr(want, k):
            raise AssertionError(f"{label}: RunResult.{k} "
                                 f"{getattr(got, k)} against "
                                 f"{getattr(want, k)}")


def tracks_agree(got, want, exact: bool, label: str) -> None:
    """A stream's run against its solo run: the same counters, and the
    same tracks bit for bit (``exact``) or with the same frames and ids
    and boxes within ``BOX_RTOL`` / ``BOX_ATOL``."""
    counters_agree(got, want, label)
    if len(got.tracks) != len(want.tracks):
        raise AssertionError(f"{label}: {len(got.tracks)} tracks against "
                             f"{len(want.tracks)}")
    for t, (x, y) in enumerate(zip(got.tracks, want.tracks)):
        if exact:
            if not np.array_equal(x, y):
                raise AssertionError(f"{label}: track {t} differs in its "
                                     "bits")
        elif x.shape != y.shape or not np.array_equal(x[:, [0, 5]],
                                                      y[:, [0, 5]]):
            raise AssertionError(f"{label}: track {t} has other frames "
                                 f"or ids ({x.shape} against {y.shape})")
        elif not np.allclose(x, y, rtol=BOX_RTOL, atol=BOX_ATOL):
            raise AssertionError(f"{label}: track {t}'s boxes differ by "
                                 f"{float(np.abs(x - y).max())!r}")


class ScoreLog:
    """The decisions of each stream's run, by stream, in the order the
    stream made them: every detector row's objectness scores (a solo
    run's ``detect_batch`` calls, or a brokered stream's requests: the
    flushing thread splits each consolidated batch back to its requests
    before any is marked done), and every host-tracker assignment (its
    cost matrix and pairs).  A stream thread names itself in
    ``tl.stream``."""

    def __init__(self):
        self.tl = threading.local()
        self.rows: Dict[int, list] = {}
        self.of_request: Dict[int, np.ndarray] = {}
        self.assigns: Dict[int, list] = {}

    def scores(self, fn):                      # detector.detect_scores
        def wrapper(net, frames):
            s, b = fn(net, frames)
            self.tl.last = s
            return s, b
        return wrapper

    def detect_batch(self, fn):                # Detector.detect_batch
        def wrapper(det, *args, **kwargs):
            out = fn(det, *args, **kwargs)
            rows = self.tl.last[:len(out)].cpu().numpy()
            reqs = getattr(self.tl, "reqs", None)
            if reqs is None:
                self.rows.setdefault(self.tl.stream, []).append(rows)
            else:
                ofs = 0
                for r in reqs:
                    self.of_request[id(r)] = rows[ofs:ofs + r.n]
                    ofs += r.n
            return out
        return wrapper

    def dispatch(self, fn):                    # BatchBroker._dispatch
        def wrapper(broker, reqs):
            self.tl.reqs = reqs
            try:
                return fn(broker, reqs)
            finally:
                self.tl.reqs = None
        return wrapper

    def submit(self, fn):                      # BatchBroker._submit
        def wrapper(broker, req):
            out = fn(broker, req)
            self.rows.setdefault(self.tl.stream, []).append(
                self.of_request.pop(id(req)))
            return out
        return wrapper

    def assign(self, fn):                      # tracker.hungarian_device_np
        def wrapper(cost):
            pairs = fn(cost)
            self.assigns.setdefault(self.tl.stream, []).append(
                (np.array(cost, np.float32), {(int(t), int(d))
                                              for t, d in pairs}))
            return pairs
        return wrapper

    @contextlib.contextmanager
    def recording(self):
        from repro_torch.core import detector as det_mod
        with wrapped(det_mod, "detect_scores", self.scores), \
                wrapped(Detector, "detect_batch", self.detect_batch), \
                wrapped(BatchBroker, "_dispatch", self.dispatch), \
                wrapped(BatchBroker, "_submit", self.submit), \
                wrapped(trk_mod, "hungarian_device_np", self.assign):
            yield self


def decision(row: np.ndarray, conf: float) -> tuple:
    """The cells ``decode_detections`` keeps from one window's scores,
    in the order it takes them (score above ``conf``, by falling
    score)."""
    s = row.ravel()
    idx = np.flatnonzero(s > conf)
    return tuple(idx[np.argsort(-s[idx])][:256].tolist())


def score_flips(got: list, want: list, conf: float, label: str):
    """One stream's detector rows against its solo run's, row by row ->
    (max |Δ| of the scores, the rows whose decision differs: (call, row,
    the cells that crossed ``conf`` as (solo, brokered) scores, or the
    cells whose order changed))."""
    if len(got) != len(want) or any(g.shape != w.shape
                                    for g, w in zip(got, want)):
        raise AssertionError(f"{label}: detector rows "
                             f"{[g.shape for g in got]} against the solo "
                             f"run's {[w.shape for w in want]}")
    worst, flips = 0.0, []
    for k, (g, w) in enumerate(zip(got, want)):
        if g.size:
            worst = max(worst, float(np.abs(g - w).max()))
        for b in range(len(g)):
            dg, dw = decision(g[b], conf), decision(w[b], conf)
            if dg == dw:
                continue
            crossed = np.flatnonzero((g[b].ravel() > conf)
                                     != (w[b].ravel() > conf))
            flips.append((k, b, [(float(w[b].ravel()[c]),
                                  float(g[b].ravel()[c]))
                                 for c in crossed] or "order"))
    return worst, flips


def assignment_flip(got: list, want: list, thr: float, label: str):
    """One stream's host-tracker assignments against its solo run's ->
    None where every one has the same pairs, else the first that
    differs: ("tie", call, A(q) - A(p), its limit), where A is the solo
    run's costs, p its pairs and q the stream's, and the limit is the
    sum of |A - B| over the pairs of both (an exact solver of B cannot
    pick q unless the two assignments are tied within it); ("solver",
    call, A(q) - A(p), the limit, p's gap, q's gap) where they are not,
    but p and q each lie within ``DEVICE_JV_GAP`` of the exact
    optimum of its own costs (``optimality_gap``: the host's f32 JV is
    not exact, so a drift within ``FLEET_COST_ATOL`` can move it to
    another answer about as near the optimum); or ("gate", call, offsets)
    where an entry is gated on one side only, with each such entry's
    match probability off the threshold.  Raises where the costs before
    it moved by more than ``FLEET_COST_ATOL``, or where the flip is none
    of these."""
    for k, ((B, q), (A, p)) in enumerate(zip(got, want)):
        if A.shape != B.shape:
            raise AssertionError(f"{label}: assignment {k} over "
                                 f"{B.shape} against the solo run's "
                                 f"{A.shape}, with no window flip")
        both = (A < BIG / 2) & (B < BIG / 2)
        drift = float(np.abs(A - B)[both].max()) if both.any() else 0.0
        if drift > FLEET_COST_ATOL:
            raise AssertionError(f"{label}: assignment {k}'s costs moved "
                                 f"by {drift!r}")
        if p == q:
            continue
        gate = (A < BIG / 2) != (B < BIG / 2)
        if gate.any():
            off = np.abs(1.0 - np.where(A < BIG / 2, A, B)[gate] - thr)
            if off.max() > FLEET_COST_ATOL:
                raise AssertionError(f"{label}: assignment {k} gated "
                                     f"entries {off.max()!r} from the "
                                     "threshold")
            return ("gate", k, off.tolist())
        gap = sum(float(A[t, d]) for t, d in q) - \
            sum(float(A[t, d]) for t, d in p)
        limit = sum(abs(float(A[t, d]) - float(B[t, d])) for t, d in p | q)
        if gap <= limit:
            return ("tie", k, gap, limit)
        gp, gq = optimality_gap(A, p), optimality_gap(B, q)
        if max(gp, gq) > DEVICE_JV_GAP:
            raise AssertionError(f"{label}: assignment {k} took other "
                                 f"pairs {sorted(q - p)} for "
                                 f"{sorted(p - q)}, {gap!r} dearer at the "
                                 f"solo costs (limit {limit!r}); from the "
                                 f"exact optimum: the solo run's {gp!r}, "
                                 f"the stream's {gq!r} (limit "
                                 f"{DEVICE_JV_GAP!r})")
        return ("solver", k, gap, limit, gp, gq)
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} assignments against "
                             f"{len(want)}")
    return None


def largest_gap(*logs) -> Tuple[float, int]:
    """The host JV's largest ``optimality_gap`` over every assignment the
    logs hold -> (that gap, the assignments)."""
    gaps = [optimality_gap(cost, pairs) for lg in logs
            for per in lg.assigns.values() for cost, pairs in per]
    return max(gaps, default=0.0), len(gaps)


def stage_sums(results) -> dict:
    """Stage wall and thread-CPU seconds summed over the runs."""
    out = {}
    for r in results:
        for k, v in r.stage_seconds.items():
            w, p = out.get(k, (0.0, 0.0))
            out[k] = (round(w + v["wall"], 3), round(p + v["process"], 3))
    return out


def detector_buckets(bank, params, frames, shapes) -> dict:
    """``batch_drift`` of the detector at every pow2 bucket up to each
    crop shape's largest: (h, w) -> {bucket: max |Δ|}.  Rows are crops
    of the fleet's frames (full frames repeated to fill a bucket)."""
    net = bank.detectors[params.det_arch].net
    out = {}
    for (h, w), top in sorted(shapes.items()):
        rows = [frames[i % len(frames), (i * 16) % (frames.shape[1] - h + 1):
                       (i * 16) % (frames.shape[1] - h + 1) + h,
                       (i * 32) % (frames.shape[2] - w + 1):
                       (i * 32) % (frames.shape[2] - w + 1) + w]
                for i in range(top)]
        x = torch.from_numpy(np.ascontiguousarray(np.stack(rows))
                             ).to(DEVICE)
        buckets = [1 << k for k in range(top.bit_length())
                   if 1 << k <= top]
        out[(h, w)] = batch_drift(net, x, buckets)
        del x
    return out


def on_clock(meet: threading.Barrier) -> dict:
    """Stages that put a fleet's streams on one chunk clock, as cameras
    that hand over each chunk together: after each chunk's PROXY a stream
    registers with its ``BatchBroker`` and waits for every other stream,
    so their DETECT requests meet in the broker.  Free-running streams
    drift apart by whole TRACK stages (a 64-track clip's host tracker
    takes seconds, a sparse one's tenths), far beyond the broker's
    10 ms linger, and a stream that reaches DETECT first flushes alone
    while its peers have not registered; so their requests rarely meet.
    The wait counts in the PROXY stage's wall."""
    def proxy_then_meet(ctx, task):
        task = stage_proxy(ctx, task)
        ctx.broker()
        meet.wait(FLEET_JOIN_S)
        return task
    return {"proxy": proxy_then_meet}


def run_fleet(bank, params) -> dict:
    """The executor's multi-stream half at full width, at the video
    cell's θ: solo runs of the fleet's clips (the oracle), ``BatchBroker``
    at 1, 4 and 16 streams on one chunk clock (host tracker), the
    detector's batch drift at every bucket the broker formed,
    ``TrackBroker`` with ``device_assign`` at 4 and 16, and ``run_clips``
    over the clips on fresh frames with the shared ``DecodePool`` at each
    ``FLEET_POOLS`` size.

    A brokered window rides another batch than in its solo run, so its
    scores may move by the detector's batch drift.  Every stream's
    detector rows are logged beside its solo run's (``ScoreLog``): each
    must lie within twice the largest drift read against batch 1 (both
    runs' batches are within it of batch 1), and a window whose kept
    cells differ (a score crossing det_conf, or two scores trading
    places) is counted as a decision flip.  A stream with no flip holds
    its tracks to the solo run's, bit for bit where the drift read 0.0
    everywhere and at 1 stream, else within the tolerances; unless its
    host tracker's first assignment that differs from the solo run's is
    tied with it within the drift (``assignment_flip``), a decision flip
    too.  A stream with a flip holds its counters only (``held_to``).
    Launch counts
    are set to 0 just before each run and read just after every thread
    joined.
    -> (the launches of each path, the oracle ``run_traced`` holds its
    brokered streams to: the clips, the solo runs and their ``ScoreLog``,
    the drift bound and whether it read 0.0)."""
    t_phase = time.perf_counter()
    smi = nvidia_smi()
    conf = params.det_conf
    pl.clear_render_cache()
    clips = [make_clip("caldot1", "test", SEED + i, n_frames=FLEET_FRAMES)
             for i in range(FLEET_CLIPS)]

    # the solo runs: once on fresh frames (decode paid), then the oracle
    # on cached frames with its detector rows logged
    fresh_wall = 0.0
    fresh = []
    for c in clips:
        r, _, wall = counted(lambda: ClipExecutor(bank, params).run(c))
        fresh.append(r)
        fresh_wall += wall
    solo_log = ScoreLog()
    solo, solo_wall = [], []
    with solo_log.recording():
        for i, c in enumerate(clips):
            solo_log.tl.stream = i
            r, _, wall = counted(lambda: ClipExecutor(bank, params).run(c))
            solo.append(r)
            solo_wall.append(wall)
    for i, r in enumerate(solo):
        check_result(r, FLEET_FRAMES)
        tracks_agree(r, fresh[i], True, f"solo run of clip {i}, cached "
                     "against fresh frames")

    def sequential_fps(n):
        """fps of the same n streams' runs one after another (solo walls,
        frames cached)."""
        return n * FLEET_FRAMES / sum(solo_wall[i % len(clips)]
                                      for i in range(n))

    log(f"fleet: caldot1 test clips 0-{len(clips) - 1}, {FLEET_FRAMES} "
        f"frames each, the video cell's det_conf {conf!r}; solo runs: "
        f"tracks {[len(r.tracks) for r in solo]}, detector dispatches "
        f"{[r.dispatches['detect'] for r in solo]}, walls {solo_wall} s "
        f"(frames cached; fresh: {fresh_wall:.3f} s for the three); "
        f"stage (wall, thread CPU) s summed {stage_sums(solo)}")

    def fleet_run(n, opts, score_log=None, clock=False):
        """n concurrent streams, clips round-robin, one executor each;
        with ``clock``, the streams on one chunk clock (``on_clock``);
        -> (results, launches, wall)."""
        meet = threading.Barrier(n)
        stages = on_clock(meet) if clock else None

        def stream(i):
            if score_log is not None:
                score_log.tl.stream = i
            try:
                return ClipExecutor(bank, params, opts, stages=stages).run(
                    clips[i % len(clips)])
            except BaseException:
                meet.abort()             # no peer waits out the clock
                raise
        return counted(lambda: run_threads([
            lambda i=i: stream(i) for i in range(n)]))

    # BatchBroker: record each detector batch's rows per crop shape
    formed = {}

    def recording(fn):
        def wrapper(self, frames, *args, **kwargs):
            shape = tuple(frames.shape[1:3])
            formed[shape] = max(formed.get(shape, 1), int(frames.shape[0]))
            return fn(self, frames, *args, **kwargs)
        return wrapper

    brokered, fleet_launches = {}, {}
    for n in FLEET_STREAMS:
        broker = BatchBroker()
        score_log = ScoreLog()
        with score_log.recording(), \
                wrapped(Detector, "detect_batch", recording):
            res, launches, wall = fleet_run(
                n, ExecutorOptions(batch_broker=broker), score_log,
                clock=True)
        broker.close()
        for name in ("proxy_plan", "window_gather_batch"):
            if launches[name] <= 0:
                raise AssertionError(f"{name} was not launched by "
                                     f"{n} brokered streams")
        solo_disp = sum(solo[i % len(clips)].dispatches["detect"]
                        for i in range(n))
        if n > 1 and broker.dispatches >= solo_disp:
            raise AssertionError(
                f"BatchBroker at {n} streams: {broker.dispatches} "
                f"dispatches, the solo runs {solo_disp}")
        if broker.windows_in != sum(r.detector_windows for r in res):
            raise AssertionError("BatchBroker lost windows")
        brokered[n] = (res, score_log)
        fleet_launches[f"batch_broker_{n}"] = launches
        log(f"fleet BatchBroker, {n} streams x {FLEET_FRAMES} frames "
            f"(host tracker, one chunk clock; its waits count in proxy): "
            f"{n * FLEET_FRAMES} frames in {wall:.3f} s"
            f" wall = {n * FLEET_FRAMES / wall:.2f} fps aggregate (the "
            f"same runs one after another: {sequential_fps(n):.2f}); "
            f"detector dispatches {broker.dispatches} (solo runs "
            f"{solo_disp}), windows {broker.windows_in}, mean "
            f"batch_fill {float(np.mean(broker.batch_fill)):.4f}; "
            f"stage (wall, thread CPU) s summed over streams "
            f"{stage_sums(res)}; launches {launches}; card {smi}")

    frames = np.stack([pl.render_frame(c, f, *params.det_res)[0]
                       for c in clips for f in range(FLEET_FRAMES)])
    full = (params.det_res[1], params.det_res[0])
    shapes = {shape: max(64, next_bucket(rows))
              for shape, rows in formed.items()}
    shapes.setdefault(full, 64)
    drift = detector_buckets(bank, params, frames, shapes)
    del frames
    worst = max(d for per in drift.values() for d in per.values())
    exact = worst == 0.0
    bound = 2 * worst
    log("fleet: detector batch drift (max |d| of detect_scores against "
        "batch 1) at each bucket of each crop shape: "
        + "; ".join(f"{w}x{h}: " + ", ".join(f"{b} {d!r}"
                                              for b, d in per.items())
                    for (h, w), per in drift.items())
        + f"; largest batch formed per shape {formed}")
    thr = bank.cfg.tracker.match_threshold

    def described(i, kind, flip):
        """One stream's first decision flip, for the log."""
        head = f"; stream {i} (clip {i % len(clips)}): "
        if kind == "assignment":
            how, k = flip[:2]
            if how == "gate":
                return head + (f"assignment {k} gated entries {flip[2]} "
                               "off the match threshold")
            return head + (f"assignment {k} swapped pairs "
                           + ("tied within the drift" if how == "tie" else
                              f"each {flip[4]!r} / {flip[5]!r} from its "
                              "exact optimum (limit "
                              f"{DEVICE_JV_GAP!r})")
                           + f" (dearer by {flip[2]!r} at the solo costs, "
                           f"limit {flip[3]!r})")
        return head + ", ".join(
            f"window call {k} row {b} "
            + ("cells reordered" if cells == "order" else
               "crossed " + " ".join(
                   f"{w!r}->{g!r} ({w - conf:+.3e} from det_conf)"
                   for w, g in cells))
            for k, b, cells in flip)

    for n, (res, score_log) in brokered.items():
        # one stream's lone requests run what its solo run does
        rule = exact or n == 1
        limit = 0.0 if rule else bound
        moved, flipped = 0.0, {}
        for i, r in enumerate(res):
            c = i % len(clips)
            d, flip = held_to(r, solo[c], score_log, solo_log, (i, c), rule,
                              bound, conf, thr,
                              f"BatchBroker, {n} streams, stream {i}")
            moved = max(moved, d)
            if flip is not None:
                flipped[i] = flip
        kinds = [kind for kind, _ in flipped.values()]
        log(f"fleet BatchBroker, {n} streams: detector scores within "
            f"{moved!r} of the solo runs' (limit {limit!r}"
            + (")" if rule else ", twice the largest drift)")
            + f"; streams whose decisions flipped: {len(flipped)} of {n} "
            f"({kinds.count('window')} in a detector window, "
            f"{kinds.count('assignment')} in a host-tracker assignment)"
            + "".join(described(i, kind, fl)
                      for i, (kind, fl) in flipped.items())
            + "; every stream without a flip has its solo run's tracks "
            + ("bit for bit" if rule else
               f"within rtol {BOX_RTOL} / atol {BOX_ATOL} (same frames, "
               "ids and counters)"))

    gap, n_assigns = largest_gap(solo_log,
                                 *(lg for _, lg in brokered.values()))
    log(f"fleet: the host JV's largest gap from the exact optimum over the "
        f"{n_assigns} assignments of the solo and brokered runs {gap!r} "
        f"(limit {DEVICE_JV_GAP!r})")

    # TrackBroker: every stream's device steps ride shared launches
    for n in FLEET_TRACK_STREAMS:
        broker = TrackBroker()
        res, launches, wall = fleet_run(n, ExecutorOptions(
            device_assign=True, track_broker=broker))
        broker.close()
        for i, r in enumerate(res):
            tracks_agree(r, solo[i % len(clips)], True,
                         f"TrackBroker, {n} streams, stream {i}")
        if launches["track_step"] != broker.dispatches:
            raise AssertionError(
                f"TrackBroker at {n} streams: {launches['track_step']} "
                f"track_step launches, {broker.dispatches} dispatches")
        if broker.dispatches <= 0 or \
                sum(broker.stream_fill) != broker.steps_in:
            raise AssertionError("TrackBroker's ledger does not add up")
        fleet_launches[f"track_broker_{n}"] = launches
        log(f"fleet TrackBroker (device_assign), {n} streams x "
            f"{FLEET_FRAMES} frames: {n * FLEET_FRAMES} frames in "
            f"{wall:.3f} s wall = {n * FLEET_FRAMES / wall:.2f} fps "
            f"aggregate (the host tracker's solo runs one after another: "
            f"{sequential_fps(n):.2f}); track_step launches "
            f"{launches['track_step']} = dispatches, steps "
            f"{broker.steps_in}, K mean "
            f"{float(np.mean(broker.stream_fill)):.3f} max "
            f"{max(broker.stream_fill)}; stage (wall, thread CPU) s summed "
            f"over streams {stage_sums(res)}; tracks equal the solo host "
            f"runs' bit for bit; card {smi}")

    # run_clips on fresh frames with the shared decode pool
    for w in FLEET_POOLS:
        pl.clear_render_cache()
        (res, _), launches, wall = counted(lambda: run_clips(
            bank, params, clips, ExecutorOptions(decode_workers=w)))
        for i, (r, want) in enumerate(zip(res, solo)):
            tracks_agree(r, want, True, f"run_clips, clip {i}")
        fleet_launches[f"run_clips_{w}"] = launches
        log(f"fleet run_clips, decode_workers {w} (pool of {max(2, w)}), "
            f"{len(clips)} fresh clips x {FLEET_FRAMES} frames: "
            f"{len(clips) * FLEET_FRAMES} frames in {wall:.3f} s wall = "
            f"{len(clips) * FLEET_FRAMES / wall:.2f} fps (the solo runs "
            f"on fresh frames one after another: "
            f"{len(clips) * FLEET_FRAMES / fresh_wall:.2f}); decode "
            f"{stage_sums(res)['decode']} s (wall, thread CPU) summed over "
            f"the clips; stage sums {stage_sums(res)}; tracks equal the "
            f"per-clip runs' bit for bit; launches {launches}; card {smi}")
    log(f"fleet phase: {time.perf_counter() - t_phase:.1f} s wall")
    return fleet_launches, dict(clips=clips, solo=solo, solo_log=solo_log,
                                bound=bound, exact=exact)


# ---------------------------------------------------------------------------
# Observability: the executor's spans, mirrors and crash dump on the card
# ---------------------------------------------------------------------------

TRACED_FRAMES = 64              # main-path clip of the traced runs
TRACED_STREAMS = 4              # BatchBroker streams of the traced fleet
TRACED_FAIL_CHUNK = 2           # the induced drain failure's chunk
# one Prometheus sample: name, optional labels, a value float() reads
PROM_SAMPLE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*\})? (\S+)$')


def traced_runs(run, label: str) -> list:
    """``run`` tracer off, on, off, each counted; -> [(result, launches,
    wall, spans)] in that order.  The tracer is off again after, and
    the three runs must give the same tracks bit for bit, dispatches
    and launches."""
    out = []
    for traced in (False, True, False):
        TRACER.clear()
        if traced:
            obs.enable()
        try:
            res, launches, wall = counted(run)
            spans = TRACER.snapshot()
        finally:
            obs.disable()
            TRACER.clear()
        out.append((res, launches, wall, spans))
    ref = out[0]
    for res, launches, _, spans in out:
        if not same_tracks(res, ref[0]):
            raise AssertionError(f"{label}: tracks with the tracer on "
                                 "differ from tracer off")
        if res.dispatches != ref[0].dispatches or launches != ref[1]:
            raise AssertionError(f"{label}: dispatches {res.dispatches} / "
                                 f"launches {launches} against "
                                 f"{ref[0].dispatches} / {ref[1]}")
    if out[0][3] or out[2][3] or not out[1][3]:
        raise AssertionError(f"{label}: spans recorded with the tracer "
                             "off, or none with it on")
    return out


def run_spans(spans, stream: str, label: str) -> tuple:
    """One traced run's spans: exactly one ``run`` span of ``stream`` and
    ``stage.*`` children parented to it with its stream and durations
    >= 0; -> (the run span, the stage spans)."""
    roots = [sp for sp in spans if sp.name == "run"]
    if len(roots) != 1 or roots[0].stream != stream or roots[0].dur < 0:
        raise AssertionError(f"{label}: run spans "
                             f"{[(sp.stream, sp.dur) for sp in roots]}")
    stages = [sp for sp in spans if sp.name.startswith("stage.")]
    if not stages or any(sp.parent != roots[0].sid or sp.stream != stream
                         or sp.dur < 0 or sp.proc < 0 for sp in stages):
        raise AssertionError(f"{label}: stage spans not under the run")
    return roots[0], stages


def clocked_broker_run(bank, params, clips, n: int) -> tuple:
    """``n`` streams of ``clips`` (round-robin), each its own
    ``ClipExecutor`` on its own thread, through one ``BatchBroker`` on
    one chunk clock (``on_clock``), their detector rows logged; the
    launch counts set to 0 just before and read after every thread
    joined, and the broker closed; -> (results, launches, wall, the
    broker, the ``ScoreLog``)."""
    broker = BatchBroker()
    meet = threading.Barrier(n)
    score_log = ScoreLog()

    def one(i):
        score_log.tl.stream = i
        try:
            return ClipExecutor(bank, params, ExecutorOptions(
                batch_broker=broker), stages=on_clock(meet)).run(
                    clips[i % len(clips)])
        except BaseException:
            meet.abort()
            raise

    with score_log.recording():
        res, launches, wall = counted(lambda: run_threads(
            [lambda i=i: one(i) for i in range(n)]))
    broker.close()
    return res, launches, wall, broker, score_log


def hold_broker_run(bank, params, oracle, res, score_log,
                    label: str) -> dict:
    """Each stream of a ``clocked_broker_run`` held to its clip's solo
    run as the fleet holds them (``held_to``); -> {stream: the kind of
    decision that flipped} for the streams held to their counters."""
    clips, solo, solo_log = oracle["clips"], oracle["solo"], \
        oracle["solo_log"]
    conf, thr = params.det_conf, bank.cfg.tracker.match_threshold
    flips = {}
    for i, r in enumerate(res):
        c = i % len(clips)
        _, flip = held_to(r, solo[c], score_log, solo_log, (i, c),
                          oracle["exact"], oracle["bound"], conf, thr,
                          f"{label}, stream {i}")
        if flip is not None:
            flips[i] = flip[0]
    return flips


def run_traced(bank, params, oracle) -> dict:
    """The executor's instrumentation at full width, at the video cell's
    θ, after the fleet (its threads end every profiler trace worth
    reading) and before live ingest:

    1. caldot1 test clip 0 at ``TRACED_FRAMES`` frames (frames cached),
       host tracker, tracer off / on / off: the same tracks bit for bit,
       dispatches and launches; one ``run`` span and its ``stage.*``
       children with the run's stream; the registry's
       ``executor.dispatch.{proxy,detect}`` grow by the run's dispatches
       and ``detector.dispatches`` by at least the detect count;
    2. the same with ``device_tracker`` (``track_step`` launches equal);
    3. a drain that fails (a ``stages=`` proxy raising on chunk
       ``TRACED_FAIL_CHUNK``) with a ``FlightRecorder`` installed: the
       run raises, and the dump's reasons hold ``executor.drain`` and
       its extra the run's stream;
    4. ``TRACED_STREAMS`` streams of the fleet's 16-frame clips on one
       ``BatchBroker`` and one chunk clock, tracer on: the Chrome export
       loads with ``json.load``, one lane a stream plus ``(shared)``,
       sorted non-negative timestamps; each flush's dispatch windows sum
       to its windows and over the run to every window submitted; the
       registry's ``broker.detect.dispatches`` grows by the broker's
       dispatches; every stream held to its solo run as the fleet holds
       them (``held_to``, flips counted).

    fps with the tracer on and off and the span counts are printed, not
    held.  -> the launches of each path."""
    t_phase = time.perf_counter()
    smi = nvidia_smi()
    clip = make_clip("caldot1", "test", SEED, n_frames=TRACED_FRAMES)
    stream = f"caldot1/test{SEED}"
    launches = {}
    counted(lambda: ClipExecutor(bank, params).run(clip))   # cache frames

    # 1-2: the main path, host and device TRACK
    for label, opts in (("host", ExecutorOptions()),
                        ("device_tracker",
                         ExecutorOptions(device_tracker=True))):
        before = REGISTRY.snapshot()
        runs = traced_runs(lambda: ClipExecutor(bank, params, opts).run(
            clip), f"traced {label}")
        after = REGISTRY.snapshot()
        res, n, _, spans = runs[1]
        check_result(res, TRACED_FRAMES)
        root, stages = run_spans(spans, stream, f"traced {label}")
        for k in ("proxy", "detect"):
            grew = after[f"executor.dispatch.{k}"] - before.get(
                f"executor.dispatch.{k}", 0)
            if grew != 3 * res.dispatches[k]:
                raise AssertionError(f"traced {label}: "
                                     f"executor.dispatch.{k} grew {grew} "
                                     f"over three runs of "
                                     f"{res.dispatches[k]}")
        det_grew = after["detector.dispatches"] - before.get(
            "detector.dispatches", 0)
        if det_grew < 3 * res.dispatches["detect"]:
            raise AssertionError(f"traced {label}: detector.dispatches "
                                 f"grew {det_grew}")
        on_path = ["proxy_plan", "window_gather_batch"] + (
            ["track_step"] if opts.device_tracker else [])
        for name in on_path:
            if n[name] <= 0:
                raise AssertionError(f"{name} was not launched by the "
                                     f"traced {label} run")
        launches[f"traced_{label}"] = n
        fps = [TRACED_FRAMES / r[2] for r in runs]
        log(f"traced {label} (clip {clip.clip_id}, {TRACED_FRAMES} frames "
            f"cached): fps tracer off {fps[0]:.2f}, on {fps[1]:.2f}, off "
            f"{fps[2]:.2f}; tracks ({len(res.tracks)}), dispatches "
            f"{res.dispatches} and launches {n} equal in all three; "
            f"{len(spans)} spans (run {root.args}, "
            f"{len(stages)} stage spans, stage span ms summed "
            f"{ {st: round(sum(sp.dur for sp in stages if sp.name == st) / 1e6, 3) for st in sorted({sp.name for sp in stages})} }); "
            f"registry: executor.dispatch.* and detector.dispatches "
            f"grew by the runs' dispatches ({det_grew} detector calls); "
            f"card {smi}")

    # 3: a drain that fails, with the black box installed
    def failing_proxy(ctx, task):
        if task.index == TRACED_FAIL_CHUNK:
            raise RuntimeError(f"induced failure on chunk {task.index}")
        return stage_proxy(ctx, task)

    with tempfile.TemporaryDirectory() as box:
        rec = obs_recorder.install(obs_recorder.FlightRecorder(box))
        TRACER.clear()
        obs.enable()
        try:
            try:
                ClipExecutor(bank, params,
                             stages={"proxy": failing_proxy}).run(clip)
            except RuntimeError as exc:
                if "induced failure" not in str(exc):
                    raise
            else:
                raise AssertionError("the induced drain failure did not "
                                     "raise")
            dumps = rec.dumps()
        finally:
            obs_recorder.uninstall()
            obs.disable()
            TRACER.clear()
        if len(dumps) != 1:
            raise AssertionError(f"{len(dumps)} crash dumps")
        with open(dumps[0]) as f:
            doc = json.load(f)
    reasons = doc.get("reasons", [doc["reason"]])
    if "executor.drain" not in reasons or doc["extra"]["stream"] != stream:
        raise AssertionError(f"crash dump: reasons {reasons}, extra "
                             f"{doc['extra']}")
    log(f"traced drain failure (proxy raising on chunk "
        f"{TRACED_FAIL_CHUNK}): the run raised; one crash dump, reasons "
        f"{reasons}, extra {doc['extra']}, error {doc['error']['type']}: "
        f"{doc['error']['message']!r}, lineage "
        f"{[(sp['name'], sp.get('chunk')) for sp in doc['lineage']]}")

    # 4: a traced BatchBroker fleet on one chunk clock
    clips = oracle["clips"]
    n = TRACED_STREAMS
    disp0 = REGISTRY.counter("broker.detect.dispatches").value
    TRACER.clear()
    obs.enable()
    try:
        res, n_fleet, wall, broker, score_log = clocked_broker_run(
            bank, params, clips, n)
        spans = TRACER.snapshot()
        with tempfile.TemporaryDirectory() as out:
            path = Path(out) / "trace.json"
            n_events = TRACER.export_chrome(str(path))
            with open(path) as f:
                events = json.load(f)
    finally:
        obs.disable()
        TRACER.clear()
    xs = [e for e in events if e["ph"] == "X"]
    lanes = {e["args"]["name"] for e in events if e["ph"] == "M"}
    streams = {f"caldot1/test{clips[i % len(clips)].clip_id}"
               for i in range(n)}
    if len(xs) != n_events or lanes != streams | {"(shared)"}:
        raise AssertionError(f"chrome export: {len(xs)} events of "
                             f"{n_events}, lanes {sorted(lanes)}")
    ts = [e["ts"] for e in xs]
    if ts != sorted(ts) or min(ts) < 0 or min(e["dur"] for e in xs) < 0:
        raise AssertionError("chrome export: timestamps not sorted and "
                             "non-negative")
    flushes = {sp.sid: sp for sp in spans
               if sp.name == "broker.detect.flush"}
    disp = [sp for sp in spans if sp.name == "broker.detect.dispatch"]
    per: Dict[int, int] = {}
    for sp in disp:
        if sp.parent not in flushes:
            raise AssertionError("a dispatch span outside every flush")
        per[sp.parent] = per.get(sp.parent, 0) + sp.args["windows"]
    if per != {sid: f.args["windows"] for sid, f in flushes.items()}:
        raise AssertionError("a flush's dispatch windows do not sum to "
                             "its windows")
    submitted = sum(r.detector_windows for r in res)
    if not (len(disp) == broker.dispatches
            and sum(per.values()) == broker.windows_in == submitted):
        raise AssertionError(f"flush ledger: {len(disp)} dispatch spans, "
                             f"{broker.dispatches} dispatches, windows "
                             f"{sum(per.values())} / {broker.windows_in} "
                             f"/ {submitted}")
    grew = REGISTRY.counter("broker.detect.dispatches").value - disp0
    if grew != broker.dispatches:
        raise AssertionError(f"broker.detect.dispatches grew {grew}, the "
                             f"broker made {broker.dispatches}")
    for name in ("proxy_plan", "window_gather_batch"):
        if n_fleet[name] <= 0:
            raise AssertionError(f"{name} was not launched by the traced "
                                 "fleet")
    launches["traced_batch_broker"] = n_fleet
    flips = hold_broker_run(bank, params, oracle, res, score_log,
                            f"traced BatchBroker, {n} streams")
    rule = oracle["exact"]
    run_roots = [sp for sp in spans if sp.name == "run"]
    if len(run_roots) != n:
        raise AssertionError(f"{len(run_roots)} run spans for {n} streams")
    log(f"traced BatchBroker, {n} streams x {FLEET_FRAMES} frames (one "
        f"chunk clock, cached frames): {n * FLEET_FRAMES / wall:.2f} fps "
        f"aggregate; {len(spans)} spans, Chrome export {n_events} events "
        f"in lanes {sorted(lanes)}; {len(flushes)} flushes, "
        f"{len(disp)} dispatch spans = dispatches, windows per flush "
        f"{sorted(per.values())} sum {sum(per.values())} = windows "
        f"submitted {submitted}; broker.detect.dispatches grew {grew}; "
        f"streams whose decisions flipped {len(flips)} of {n} {flips}, the "
        f"rest hold their solo tracks "
        + ("bit for bit" if rule else f"within rtol {BOX_RTOL} / atol "
           f"{BOX_ATOL}") + f"; launches {n_fleet}; card {smi}")
    log(f"traced phase: {time.perf_counter() - t_phase:.1f} s wall; card "
        f"{smi}")
    return launches


def read_obs(append_walls: list) -> None:
    """After the live phase: one tick of the stock SLO rules over the
    registry it filled (the append rule's quantile must equal
    ``interp_quantile`` of the appends' wall seconds), one health report
    (the shared decode pool's and both brokers' queue depths read 0 once
    every run has finished) and one Prometheus rendering (every sample
    line parses)."""
    t0 = time.perf_counter()
    hist = REGISTRY.get("stream.append.wall_seconds")
    if hist is None or hist.count != len(append_walls):
        raise AssertionError(f"stream.append.wall_seconds holds "
                             f"{None if hist is None else hist.count} "
                             f"appends, the live phase made "
                             f"{len(append_walls)}")
    engine = SloEngine(default_rules())
    fired = engine.tick()
    verdicts = engine.report()["rules"]
    want = interp_quantile(sorted(append_walls), 0.95)
    got = verdicts["append_latency"].get("value")
    if got != want:
        raise AssertionError(f"append_latency p95 {got!r}, the appends' "
                             f"{want!r}")
    snap = REGISTRY.snapshot()
    health = health_report(snap, default_components())
    for comp in ("decode_pool", "broker_detect", "broker_track"):
        v = health["components"][comp]["value"]
        if v != 0.0:
            raise AssertionError(f"{comp} reads {v!r} with every run "
                                 "finished")
    text = render_prometheus(snap)
    samples = [ln for ln in text.splitlines() if not ln.startswith("#")]
    for ln in samples:
        m = PROM_SAMPLE.match(ln)
        if m is None:
            raise AssertionError(f"malformed exposition line {ln!r}")
        float(m.group(3))
    log(f"obs after live ingest: SLO verdicts "
        f"{ {k: (v['state'], v['samples'], v.get('value')) for k, v in verdicts.items()} }"
        f" (append_latency p95 {got!r} = interp_quantile of the "
        f"{len(append_walls)} appends' wall seconds); edges fired "
        f"{[(e.rule, e.severity) for e in fired]}; health "
        f"{health['status']}: "
        f"{ {k: (c['status'], c['value']) for k, c in health['components'].items()} }"
        f"; Prometheus text {len(text)} bytes, {len(samples)} samples, "
        f"every one parsed; {time.perf_counter() - t0:.3f} s; card "
        f"{nvidia_smi()}")


# ---------------------------------------------------------------------------
# The serving plane over HTTP, its command line, and the two examples
# ---------------------------------------------------------------------------

SCRAPE_TIMEOUT_S = 5.0          # every urlopen of the served phase
SCRAPED_ROUTES = ("/metrics", "/healthz")


def scrape(url: str) -> tuple:
    """One GET with a timeout; -> (status, body).  An HTTP error status
    (``/healthz`` answers 503 on ``fail``) is an answer, not a failure."""
    try:
        with urllib.request.urlopen(url, timeout=SCRAPE_TIMEOUT_S) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def check_scrapes(bodies: dict) -> None:
    """Every ``/metrics`` body a 200 that ``validate_exposition`` passes,
    every ``/healthz`` a 200 or 503 whose document ``validate_health``
    passes; at least one scrape of each route."""
    for path, got in bodies.items():
        if not got:
            raise AssertionError(f"no scrape of {path} completed")
        for status, body in got:
            if path == "/metrics":
                if status != 200:
                    raise AssertionError(f"/metrics answered {status}")
                validate_exposition(body)
            else:
                doc = json.loads(body)
                validate_health(doc)
                if status != (503 if doc["status"] == "fail" else 200):
                    raise AssertionError(f"/healthz {doc['status']} "
                                         f"answered {status}")


def obs_cli(argv: list) -> str:
    """``python -m repro_torch.obs`` in this process; -> its standard
    output (a non-zero exit fails)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = obs_main(argv)
    if rc != 0:
        raise AssertionError(f"repro_torch.obs {argv[0]} exited {rc}")
    return out.getvalue()


def run_served(bank, params, oracle) -> dict:
    """The serving plane under load, after ``run_tuning`` (which keeps
    its place right after ``read_obs``): ``TRACED_STREAMS``
    streams of the fleet's clips on one ``BatchBroker`` and one chunk
    clock, unscraped, then again with an ``ObsServer`` (port 0, an
    ``SloEngine`` over the registry, a ``FlightRecorder``) scraped from
    a thread through ``/metrics`` and ``/healthz`` the whole run.  Each
    run's streams are held to the fleet's solo runs as ``run_traced``
    holds its own (``held_to``, flips counted); the scraped run launches
    what the unscraped one did (``FLEET_KERNELS``, ``proxy_plan`` and
    ``window_gather_batch`` at least once); ``broker.detect.units_in``
    grows by every window submitted; every scrape is well formed
    (``check_scrapes``).  Scrapes a second, the handler threads' CPU
    seconds and fps scraped against unscraped are printed, not held.
    Then the command line: ``serve-smoke`` (its three artifacts and a
    ``ValueError`` dump), ``scrape`` and ``snapshot`` against a live
    server over the registry, ``dump`` and ``tail`` on the smoke's
    flight directory.  -> the launches of both runs."""
    t_phase = time.perf_counter()
    smi = nvidia_smi()
    clips, n = oracle["clips"], TRACED_STREAMS
    label = f"served BatchBroker, {n} streams"
    units = REGISTRY.counter("broker.detect.units_in")

    res0, n0, wall0, _, log0 = clocked_broker_run(bank, params, clips, n)
    flips0 = hold_broker_run(bank, params, oracle, res0, log0,
                             f"{label}, unscraped")

    bodies: Dict[str, list] = {path: [] for path in SCRAPED_ROUTES}
    stop = threading.Event()
    errors: list = []
    with tempfile.TemporaryDirectory() as tmp:
        server = ObsServer(port=0, slo=SloEngine(registry=REGISTRY),
                           recorder=obs_recorder.FlightRecorder(
                               str(Path(tmp) / "ring")))

        def hammer():
            while not stop.is_set():
                for path in SCRAPED_ROUTES:
                    try:
                        bodies[path].append(scrape(server.url + path))
                    except OSError as exc:
                        errors.append(exc)

        server.start()
        scraper = threading.Thread(target=hammer, daemon=True,
                                   name="chip-smoke-scraper")
        try:
            u0 = units.value
            t0 = time.perf_counter()
            scraper.start()
            res, n1, wall, broker, log1 = clocked_broker_run(
                bank, params, clips, n)
            grew = units.value - u0
        finally:
            stop.set()
            scraper.join(4 * SCRAPE_TIMEOUT_S)
            scraped_s = time.perf_counter() - t0
            server.stop()
        if scraper.is_alive():
            raise AssertionError("the scraper did not stop")
        stats = server.stats()
    if errors:
        raise AssertionError(f"{len(errors)} scrapes failed: {errors[0]!r}")
    check_scrapes(bodies)
    flips = hold_broker_run(bank, params, oracle, res, log1,
                            f"{label}, scraped")
    submitted = sum(r.detector_windows for r in res)
    if not grew == broker.windows_in == submitted:
        raise AssertionError(f"broker.detect.units_in grew {grew}, the "
                             f"broker took {broker.windows_in} windows, "
                             f"{submitted} were submitted")
    for name in FLEET_KERNELS:
        if n1[name] != n0[name]:
            raise AssertionError(f"{name}: {n1[name]} launches scraped, "
                                 f"{n0[name]} unscraped")
    for name in ("proxy_plan", "window_gather_batch"):
        if n1[name] <= 0:
            raise AssertionError(f"{name} was not launched by the scraped "
                                 "fleet")
    n_scrapes = {p: len(b) for p, b in bodies.items()}
    frames = n * FLEET_FRAMES
    log(f"{label} x {FLEET_FRAMES} frames (one chunk clock): fps "
        f"unscraped {frames / wall0:.2f}, scraped "
        f"{frames / wall:.2f}; scrapes {n_scrapes} in {scraped_s:.3f} s = "
        f"{sum(n_scrapes.values()) / scraped_s:.1f} a second, every "
        f"/metrics body and /healthz document valid (health "
        f"{sorted({json.loads(b)['status'] for _, b in bodies['/healthz']})}"
        f"); server stats {stats} (handler CPU seconds "
        f"{stats['handler_cpu_seconds']!r}); broker.detect.units_in grew "
        f"{grew} = windows submitted; streams whose decisions flipped: "
        f"unscraped {flips0}, scraped {flips} of {n}; launches unscraped "
        f"{n0}, scraped {n1}; card {smi}")

    # the operator command line
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "smoke"
        said = obs_cli(["serve-smoke", "--out", str(out)]).strip()
        for name in ("metrics.txt", "healthz.json", "snapshot.json"):
            if not (out / name).is_file():
                raise AssertionError(f"serve-smoke wrote no {name}")
        with ObsServer(port=0) as server:
            text = obs_cli(["scrape", "--url", server.url])
            n_samples = validate_exposition(text)
            snap = json.loads(obs_cli(["snapshot", "--url", server.url]))
        if snap["metrics"].get("broker.detect.units_in") != units.value:
            raise AssertionError("/snapshot's broker.detect.units_in "
                                 f"{snap['metrics'].get('broker.detect.units_in')}"
                                 f" against the registry's {units.value}")
        validate_health(snap["health"])
        flight = str(out / "flight")
        dump = json.loads(obs_cli(["dump", "--dir", flight]))
        if dump["error"]["type"] != "ValueError" \
                or dump["checkpoint"] != "camA/ckpt.npz":
            raise AssertionError(f"serve-smoke's dump: {dump['error']}, "
                                 f"checkpoint {dump['checkpoint']}")
        tail = [json.loads(ln) for ln in
                obs_cli(["tail", "--dir", flight, "-n", "5"]).splitlines()]
        if not 0 < len(tail) <= 5:
            raise AssertionError(f"tail -n 5 printed {len(tail)} records")
    log(f"repro_torch.obs: {said}; scrape of the registry {len(text)} "
        f"bytes, {n_samples} samples; snapshot health "
        f"{snap['health']['status']}, {len(snap['metrics'])} metrics; "
        f"dump {dump['reason']} ({dump['error']['type']}); tail "
        f"{[r['kind'] for r in tail]}")
    log(f"served phase: {time.perf_counter() - t_phase:.1f} s wall; card "
        f"{smi}")
    return {"unscraped": n0, "scraped": n1}


# the examples' own arguments: the reference's 250 detector and 800
# tracker steps and its clip counts (4 train, 3 val, 3 test or 8 query)
# cut so that both examples together take about a minute on the card
EXAMPLE_ARGS = {
    "torch_quickstart": ["--detector-steps", "250", "--tracker-steps",
                         "400", "--train-clips", "3", "--val-clips", "2",
                         "--test-clips", "2"],
    "torch_limit_query": ["--detector-steps", "250", "--tracker-steps",
                          "400", "--train-clips", "3", "--val-clips", "2",
                          "--query-clips", "4"],
}


@contextlib.contextmanager
def counting_gathers(tally: list):
    """The executor's DETECT stage wrapped to add to ``tally[0]`` the
    sub-frame size classes of each chunk's plan: each is one
    ``window_gather_batch`` launch."""
    detect = executor_mod.DEFAULT_STAGES["detect"]
    lock = threading.Lock()             # streams detect on their threads

    def counted_detect(ctx, task):
        n = sum((w * pl.CELL_PX, h * pl.CELL_PX) != (ctx.W, ctx.H)
                for w, h in task.plan.by_size)
        with lock:
            tally[0] += n
        return detect(ctx, task)

    executor_mod.DEFAULT_STAGES["detect"] = counted_detect
    try:
        yield
    finally:
        executor_mod.DEFAULT_STAGES["detect"] = detect


def example(name: str):
    """``examples/<name>.py`` imported by its path."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_examples() -> dict:
    """The two examples over the port, last: each ``main(["--device",
    "cuda", ...])`` at ``EXAMPLE_ARGS``, its launch counts set to 0 just
    before and read just after, its standard output captured.  Held: the
    quickstart's "ad-hoc agrees: True" (exact store arithmetic) and a
    ``/healthz`` status of ok, warn or fail; a ``correct=`` line for both
    systems of the limit query; ``proxy_plan`` and ``track_step``
    launched by the two together, and ``window_gather_batch`` once for
    each sub-frame size class their plans held (``counting_gathers``:
    on the card the tuner's measured window times can leave no
    sub-frame window at the reduced configuration).  The quickstart's
    two "tracks bit-identical" values are printed, not held (the broker
    line rides the detector's batch drift, the device line the f32 host
    JV's gap; the fleet, traced and live phases hold those paths to
    their bounds).  -> {example: launches}."""
    t_phase = time.perf_counter()
    smi = nvidia_smi()
    launches = {}
    outs = {}
    classes = {}
    for name, args in EXAMPLE_ARGS.items():
        main_fn = example(name).main
        buf = io.StringIO()
        tally = [0]
        with contextlib.redirect_stdout(buf), counting_gathers(tally):
            _, n, wall = counted(
                lambda: main_fn(["--device", DEVICE, *args]))
        outs[name] = out = buf.getvalue()
        launches[name], classes[name] = n, tally[0]
        if n["window_gather_batch"] != tally[0]:
            raise AssertionError(f"{name}: {n['window_gather_batch']} "
                                 "window_gather_batch launches for "
                                 f"{tally[0]} sub-frame size classes")
        shown = [ln for ln in out.splitlines()
                 if ln.strip() and not ln.startswith(("[tune]", "[setup]"))]
        log(f"example {name} {' '.join(args)}: {wall:.1f} s wall; launches "
            f"{n}; sub-frame size classes planned {tally[0]}; its output "
            "but the tuner's log:\n  " + "\n  ".join(shown))
    quick, limit = outs["torch_quickstart"], outs["torch_limit_query"]
    if "ad-hoc agrees: True" not in quick:
        raise AssertionError("the quickstart's standing query disagrees "
                             "with the ad-hoc one")
    health = re.search(r"GET /healthz: (ok|warn|fail) \(", quick)
    if health is None:
        raise AssertionError("the quickstart printed no /healthz status")
    identical = re.findall(r"^  (.*) tracks bit-identical: (True|False)$",
                           quick, re.M)
    if len(identical) != 2:
        raise AssertionError(f"{len(identical)} 'tracks bit-identical' "
                             "lines in the quickstart")
    for system in ("blazeit", "multiscope"):
        if not re.search(rf"^{system}\s*: pre=.* correct=\d+/\d+$", limit,
                         re.M):
            raise AssertionError(f"the limit query printed no correct= "
                                 f"line for {system}")
    for name in ("proxy_plan", "track_step"):
        if not sum(n[name] for n in launches.values()):
            raise AssertionError(f"{name} was not launched by the examples")
    log(f"examples: ad-hoc agrees True; /healthz {health.group(1)}; tracks "
        f"bit-identical (printed, not held): broker line "
        f"{identical[0][1]}, device_tracker line {identical[1][1]}; "
        f"window_gather_batch launches = sub-frame size classes planned "
        f"{classes}; {time.perf_counter() - t_phase:.1f} s wall; card {smi}")
    return launches


# ---------------------------------------------------------------------------
# Live ingest: the track store, segment appends and standing queries
# ---------------------------------------------------------------------------

def packed_equal(got, want, label: str) -> None:
    """Two packed clips bit for bit but for the timing field: rows,
    offsets, index arrays (all numpy), summary, counters, frame span."""
    for k in ("rows", "offsets", "hist", "track_bbox"):
        x, y = getattr(got, k), getattr(want, k)
        if type(x) is not np.ndarray or type(y) is not np.ndarray:
            raise AssertionError(f"{label}: {k} is {type(x).__name__}, "
                                 "not a numpy array")
        if x.dtype != y.dtype or not np.array_equal(x, y):
            raise AssertionError(f"{label}: {k} differs")
    for k in ("summary", "counters", "n_frames", "fps", "watermark"):
        if getattr(got, k) != getattr(want, k):
            raise AssertionError(f"{label}: {k} {getattr(got, k)} against "
                                 f"{getattr(want, k)}")


def as_run(packed) -> Any:
    """A packed clip read as a ``RunResult`` (its tracks and counters),
    for the fleet's comparisons."""
    f, w, full, skip = packed.counters
    return pl.RunResult(packed.tracks(), packed.seconds, f, w, full, skip)


def rows_by_shape(rows: list) -> list:
    """One stream's logged detector rows, concatenated per crop shape in
    the order they came.  Within a size class windows come frame by
    frame whatever the chunks, so a clip appended in segments and the
    same clip in one run list each shape's rows in the same order."""
    out: Dict[tuple, list] = {}
    for r in rows:
        out.setdefault(r.shape[1:], []).append(r)
    return [np.concatenate(out[k]) for k in sorted(out)]


def held_to(got, want, got_log, want_log, streams, exact, bound, conf,
            thr, label, by_shape=False):
    """A brokered stream's run against its solo run, or a live clip
    against the batch-ingested one (both as ``RunResult``s), from their
    ``ScoreLog``s (``streams``: the stream's key there, the solo run's;
    ``by_shape``: detector rows grouped by crop shape, as segments move
    windows between calls).  Every detector score lies within ``bound``
    of its solo value, or equals it where ``exact`` (no drift read, or
    one stream's lone requests).  A window whose kept cells differ, each
    crossing score within ``bound`` of det_conf, or a first differing
    host-tracker assignment that ``assignment_flip`` explains, is a
    decision flip, and none may flip where ``exact``.  A run with a flip
    holds its counters only; the rest hold the solo run's tracks, bit
    for bit where ``exact``, else within the tolerances.  -> (the
    largest score difference, the flip or None)."""
    group = rows_by_shape if by_shape else list
    g, w = streams
    d, flips = score_flips(group(got_log.rows.get(g, [])),
                           group(want_log.rows.get(w, [])), conf, label)
    limit = 0.0 if exact else bound
    if d > limit:
        raise AssertionError(f"{label}: detector scores {d!r} from the "
                             f"solo run's, beyond {limit!r}")
    for k, b, cells in flips:
        if cells != "order" and any(abs(v - conf) > bound
                                    for v, _ in cells):
            raise AssertionError(f"{label}: call {k} row {b} flipped at "
                                 f"{cells}")
    flip = ("window", flips) if flips else None
    if flip is None:
        af = assignment_flip(got_log.assigns.get(g, []),
                             want_log.assigns.get(w, []), thr, label)
        flip = None if af is None else ("assignment", af)
    if flip is not None and exact:
        raise AssertionError(f"{label}: a decision flipped with no drift")
    if flip is None:
        tracks_agree(got, want, exact, label)
    else:
        counters_agree(got, want, label)
        check_result(got, want.frames_processed)
    return d, flip


def summed_dispatches(results) -> dict:
    """Device dispatches per stage, summed over runs or appends."""
    out: Dict[str, int] = {}
    for r in results:
        for k, n in r.dispatches.items():
            out[k] = out.get(k, 0) + n
    return out


def ms_quantiles(seconds: list) -> str:
    v = sorted(s * 1e3 for s in seconds)
    return (f"p50 {interp_quantile(v, 0.5):.3f} p95 "
            f"{interp_quantile(v, 0.95):.3f} ms (n {len(v)})")


def run_live(bank, params) -> dict:
    """Live ingest at full width, at the video cell's θ (``refine`` off,
    as live ingest requires): caldot1 test clips 0-2 at ``LIVE_FRAMES``
    frames, each store in its own temporary directory.

    1. batch: ``TrackStore.ingest`` through ``run_clips``; each stored
       clip is ``PackedTracks.pack`` of its own ``ClipExecutor`` run bit
       for bit (timing aside), and a second ingest calls no detector;
    2. live, aligned: a ``SegmentIngestor`` appends each clip in
       segments of one chunk (round robin over the clips), with two
       standing queries registered on the store's ``QueryService``; each
       sealed clip equals the batch one bit for bit;
    3. live, unaligned: clip 0 in segments of ``LIVE_ODD_SEG`` frames,
       held to the batch clip as the fleet holds a brokered stream
       (flips counted);
    4. resume: clip 1 checkpointed half way, the ingestor dropped, a
       new one resumes and seals, bit for bit; and a rollback to a stale
       checkpoint (``checkpoint_every=2``);
    5. TRACK on the device: clip 0 appended with ``device_assign`` equals
       its batch ingest under the same options bit for bit, and a host
       checkpoint resumes under ``device_tracker``;
    6. a live fleet: three feeds, an ingestor each on one store, one
       shared ``BatchBroker``, appending from their own threads in
       rounds of one segment a feed with a barrier between rounds; held
       as in step 3;
    7. queries: after sealing, each standing answer equals the ad-hoc
       ``QueryService.query`` on the store and ``reference_query``,
       exactly; the ad-hoc queries timed cold and warm.

    Launch counts are set to 0 just before each step and read just
    after.  -> the launches of each step."""
    t_phase = time.perf_counter()
    smi = nvidia_smi()
    conf, thr = params.det_conf, bank.cfg.tracker.match_threshold
    clips = [make_clip("caldot1", "test", SEED + i, n_frames=LIVE_FRAMES)
             for i in range(LIVE_CLIPS)]
    n_all = LIVE_FRAMES * LIVE_CLIPS
    launches, walls = {}, {}
    formed: Dict[tuple, int] = {}

    def forming(fn):
        def wrapper(self, frames, *args, **kwargs):
            shape = tuple(frames.shape[1:3])
            formed[shape] = max(formed.get(shape, 1), int(frames.shape[0]))
            return fn(self, frames, *args, **kwargs)
        return wrapper

    def step(name, run):
        out, launches[name], walls[name] = counted(run)
        return out

    tmp = []

    def new_root() -> str:
        """A store's own temporary directory (removed at the end)."""
        tmp.append(tempfile.TemporaryDirectory())
        return tmp[-1].name

    try:
        # 1. batch ingest on fresh frames, then the per-clip oracle
        pl.clear_render_cache()
        A = TrackStore(new_root(), bank, params)
        rep = step("batch", lambda: A.ingest(clips))
        if rep.ingested != LIVE_CLIPS or rep.frames != n_all:
            raise AssertionError(f"batch ingest: {rep}")
        for name in ("proxy_plan", "window_gather_batch"):
            if launches["batch"][name] <= 0:
                raise AssertionError(f"{name} was not launched by the "
                                     "batch ingest")
        solo_log, solo = ScoreLog(), []
        with solo_log.recording():
            for i, c in enumerate(clips):
                solo_log.tl.stream = i
                solo.append(ClipExecutor(bank, params).run(c))
        for i, (c, r) in enumerate(zip(clips, solo)):
            check_result(r, LIVE_FRAMES)
            packed_equal(A.get(c), PackedTracks.pack(r.tracks, c, r),
                         f"batch ingest, clip {i}")
        calls = []

        def counting(fn):
            def wrapper(*args, **kwargs):
                calls.append(1)
                return fn(*args, **kwargs)
            return wrapper
        with wrapped(Detector, "detect_batch", counting):
            again = A.ingest(clips)
        if calls or again.ingested or again.cached != LIVE_CLIPS:
            raise AssertionError(f"re-ingest: {len(calls)} detector "
                                 f"calls, {again}")
        batch_fps = n_all / rep.wall_seconds
        log(f"live 1, batch: TrackStore.ingest of clips 0-"
            f"{LIVE_CLIPS - 1} x {LIVE_FRAMES} frames on fresh frames "
            f"(run_clips): {rep.wall_seconds:.3f} s = {batch_fps:.2f} fps; "
            f"store {rep.store_bytes} bytes; each clip equals its own "
            f"ClipExecutor run bit for bit (timing aside); tracks "
            f"{[len(r.tracks) for r in solo]}; a second ingest: 0 detector "
            f"calls, {again.cached} cached; launches {launches['batch']}")

        # 2. live, aligned, with standing queries on the store's service
        B = TrackStore(new_root(), bank, params)
        svc = QueryService(B)
        queries = {
            "region_count": Query.count_frames(
                region=(0.0, 0.4, 1.0, 1.0), min_count=2),
            "time_tracks": Query.count_tracks(
                min_track_len=3, time_range=TimeRange(8, LIVE_FRAMES - 8)),
        }
        standing = {k: svc.register_standing(StandingQuery(q, clips, k))
                    for k, q in queries.items()}
        ing = SegmentIngestor(B, service=svc)
        reports, rescan_rows = [], 0
        visible = [0] * LIVE_CLIPS

        def aligned():
            nonlocal rescan_rows
            for c in clips:
                ing.open(c)
            for _ in range(0, LIVE_FRAMES, LIVE_SEG):
                for i, c in enumerate(clips):
                    r = ing.append(c, LIVE_SEG)
                    reports.append(r)
                    visible[i] = r.rows_total
                    rescan_rows += sum(visible)
        pl.clear_render_cache()
        step("live_aligned", aligned)
        for i, c in enumerate(clips):
            packed_equal(B.get(c), A.get(c), f"live, {LIVE_SEG}-frame "
                         f"segments, clip {i}")
        if not all(r.sealed for r in reports[-LIVE_CLIPS:]):
            raise AssertionError("a live clip did not seal")
        live_fps = n_all / walls["live_aligned"]
        lag = [REGISTRY.gauge(f"stream.watermark_lag_seconds[caldot1/"
                              f"test{SEED + i}]").value
               for i in range(LIVE_CLIPS)]
        log(f"live 2, aligned: {len(reports)} appends of {LIVE_SEG} frames "
            f"(round robin) on fresh frames in {walls['live_aligned']:.3f} "
            f"s = {live_fps:.2f} fps (batch {batch_fps:.2f}); append wall "
            f"{ms_quantiles([r.wall_seconds for r in reports])}; store "
            f"{ms_quantiles([r.store_seconds for r in reports])}; standing "
            f"{ms_quantiles([r.standing_seconds for r in reports])}; "
            f"watermark lag of the last appends {lag} s; dispatches summed "
            f"over the appends {summed_dispatches(reports)} (the batch "
            f"runs' {summed_dispatches(solo)}); each sealed clip "
            f"equals the batch one bit for bit; launches "
            f"{launches['live_aligned']}; card {smi}")

        # 3. live, unaligned: other chunks, so other detector batches
        B3 = TrackStore(new_root(), bank, params)
        ing3 = SegmentIngestor(B3)
        odd_log, odd = ScoreLog(), []

        def unaligned():
            odd_log.tl.stream = 0
            ing3.open(clips[0])
            while not odd or not odd[-1].sealed:
                odd.append(ing3.append(clips[0], LIVE_ODD_SEG))
        with odd_log.recording(), wrapped(Detector, "detect_batch",
                                          forming):
            step("live_unaligned", unaligned)

        # 4. resume from a checkpoint, and roll back to a stale one
        mid = LIVE_FRAMES // 2

        def resume():
            root = new_root()
            first = SegmentIngestor(TrackStore(root, bank, params))
            first.open(clips[1])
            first.append(clips[1], mid)
            del first
            st = TrackStore(root, bank, params)
            second = SegmentIngestor(st)
            if second.open(clips[1]) != mid:
                raise AssertionError("resume: wrong watermark")
            second.seal(clips[1])
            packed_equal(st.get(clips[1]), A.get(clips[1]),
                         "resumed clip 1")
            # the checkpoint taken at open, then an append that writes
            # none: the store runs a segment ahead of its sidecar
            root = new_root()
            first = SegmentIngestor(TrackStore(root, bank, params),
                                    checkpoint_every=2)
            first.open(clips[1])
            first.checkpoint(clips[1])
            first.append(clips[1], LIVE_SEG)
            del first
            st = TrackStore(root, bank, params)
            if st.get(clips[1]).watermark != LIVE_SEG:
                raise AssertionError("rollback: the store is not ahead")
            second = SegmentIngestor(st)
            if second.open(clips[1]) != 0 or st.watermark(clips[1]) != 0:
                raise AssertionError("rollback: wrong watermark")
            second.seal(clips[1])
            packed_equal(st.get(clips[1]), A.get(clips[1]),
                         "clip 1 rolled back to a stale checkpoint")
        step("resume", resume)
        log(f"live 4, resume: clip 1 checkpointed at {mid} frames, resumed "
            f"by a new ingestor and sealed; and rolled back from "
            f"{LIVE_SEG} frames to the checkpoint taken at open "
            f"(checkpoint_every=2): both equal the batch clip bit for bit; "
            f"{walls['resume']:.3f} s; launches {launches['resume']}")

        # 5. TRACK on the device
        def device_track():
            dopts = ExecutorOptions(device_assign=True)
            D = TrackStore(new_root(), bank, params, dopts)
            D.ingest(clips[:1])
            L = TrackStore(new_root(), bank, params)
            di = SegmentIngestor(L, options=dopts)
            di.open(clips[0])
            while not di.append(clips[0], LIVE_SEG).sealed:
                pass
            packed_equal(L.get(clips[0]), D.get(clips[0]),
                         "device_assign live clip 0 against its batch")
            packed_equal(L.get(clips[0]), A.get(clips[0]),
                         "device_assign live clip 0 against the host's")
            root = new_root()
            hi = SegmentIngestor(TrackStore(root, bank, params))
            hi.open(clips[0])
            hi.append(clips[0], mid)
            del hi
            st = TrackStore(root, bank, params)
            dt = SegmentIngestor(st, options=ExecutorOptions(
                device_tracker=True))
            dt.open(clips[0])
            dt.seal(clips[0])
            packed_equal(st.get(clips[0]), A.get(clips[0]),
                         "host checkpoint resumed under device_tracker")
        step("device_track", device_track)
        if launches["device_track"]["track_step"] <= 0:
            raise AssertionError("track_step was not launched by the "
                                 "device-TRACK appends")
        log(f"live 5, TRACK on the device: clip 0 appended with "
            f"device_assign equals its device_assign batch ingest and the "
            f"host one bit for bit; a host checkpoint at {mid} "
            f"frames resumed under device_tracker equals the batch clip; "
            f"{walls['device_track']:.3f} s; launches "
            f"{launches['device_track']}")

        # 6. a live fleet through one BatchBroker
        F = TrackStore(new_root(), bank, params)
        broker = BatchBroker()
        opts = ExecutorOptions(batch_broker=broker)
        meet = threading.Barrier(LIVE_CLIPS)
        fleet_log = ScoreLog()

        def feed(i):
            fleet_log.tl.stream = i
            fi = SegmentIngestor(F, options=opts)
            fi.open(clips[i])
            reps = []
            try:
                while not reps or not reps[-1].sealed:
                    meet.wait(LIVE_JOIN_S)
                    reps.append(fi.append(clips[i], LIVE_SEG))
            except BaseException:
                meet.abort()             # no peer waits out the round
                raise
            return reps
        with fleet_log.recording(), wrapped(Detector, "detect_batch",
                                            forming):
            feeds = step("live_fleet", lambda: run_threads(
                [lambda i=i: feed(i) for i in range(LIVE_CLIPS)],
                LIVE_JOIN_S))
        broker.close()

        # one drift reading bounds steps 3 and 6
        frames = np.stack([pl.render_frame(c, f, *params.det_res)[0]
                           for c in clips for f in range(0, LIVE_FRAMES,
                                                         4)])
        full = (params.det_res[1], params.det_res[0])
        shapes = {shape: max(64, next_bucket(rows))
                  for shape, rows in formed.items()}
        shapes.setdefault(full, 64)
        drift = detector_buckets(bank, params, frames, shapes)
        del frames
        bound = 2 * max(d for per in drift.values() for d in per.values())
        d3, flip3 = held_to(as_run(B3.get(clips[0])), as_run(A.get(clips[0])),
                            odd_log, solo_log, (0, 0), bound == 0.0, bound,
                            conf, thr, f"live, {LIVE_ODD_SEG}-frame segments, "
                            "clip 0", by_shape=True)
        gap, n_assigns = largest_gap(solo_log, odd_log)
        log(f"live 3, unaligned: clip 0 in {len(odd)} appends of "
            f"{LIVE_ODD_SEG} frames (cached frames) in "
            f"{walls['live_unaligned']:.3f} s = "
            f"{LIVE_FRAMES / walls['live_unaligned']:.2f} fps; append wall "
            f"{ms_quantiles([r.wall_seconds for r in odd])}; detector "
            f"scores within {d3!r} of the batch run's (limit {bound!r}, "
            f"twice the largest drift at the buckets formed {formed}); "
            f"decision flips: {0 if flip3 is None else 1} "
            f"({'none' if flip3 is None else flip3}); the host JV's largest "
            f"gap from the exact optimum over the {n_assigns} assignments "
            f"of the batch and these runs {gap!r} (limit "
            f"{DEVICE_JV_GAP!r}); launches "
            f"{launches['live_unaligned']}")

        # 6's readout, held as step 3's
        flips, moved = {}, 0.0
        for i, c in enumerate(clips):
            d, fl = held_to(as_run(F.get(c)), as_run(A.get(c)), fleet_log,
                            solo_log, (i, i), bound == 0.0, bound, conf, thr,
                            f"live fleet, feed {i}", by_shape=True)
            moved = max(moved, d)
            if fl is not None:
                flips[i] = fl
        solo_disp = sum(r.dispatches["detect"] for r in solo)
        if broker.windows_in != sum(F.get(c).counters[1] for c in clips):
            raise AssertionError("the live fleet's BatchBroker lost "
                                 "windows")
        log(f"live 6, fleet: {LIVE_CLIPS} feeds x {LIVE_FRAMES // LIVE_SEG} "
            f"rounds of {LIVE_SEG} frames through one BatchBroker (cached "
            f"frames) in {walls['live_fleet']:.3f} s = "
            f"{n_all / walls['live_fleet']:.2f} fps aggregate; detector "
            f"dispatches {broker.dispatches} (the feeds' solo runs "
            f"{solo_disp}), windows {broker.windows_in}, mean batch_fill "
            f"{float(np.mean(broker.batch_fill)):.4f}; append wall "
            f"{ms_quantiles([r.wall_seconds for f in feeds for r in f])}; "
            f"scores within {moved!r} of the batch runs' (limit {bound!r});"
            f" feeds whose decisions flipped: {len(flips)} of {LIVE_CLIPS} "
            f"{flips}; the rest hold the batch tracks within rtol "
            f"{BOX_RTOL} / atol {BOX_ATOL}; launches "
            f"{launches['live_fleet']}")

        # 7. queries: standing answers against ad-hoc and the oracle
        t0 = time.perf_counter()
        tracks = [B.tracks(c) for c in clips]
        for k, q in queries.items():
            plan = compile_query(q)
            kw = {"time_range": (plan.time_range.start, plan.time_range.end)
                  } if plan.time_range is not None else {}
            if plan.region is not None:
                kw["region"] = (plan.region.x0, plan.region.y0,
                                plan.region.x1, plan.region.y1)
            oracle = reference_query(
                tracks, [c.profile.fps for c in clips], min_len=plan.min_len,
                min_count=plan.min_count, aggregate=q.aggregate, **kw)
            got, adhoc = standing[k].result(), svc.query(q, clips)
            if not (got.aggregates == adhoc.aggregates
                    == oracle["aggregates"]
                    and sorted(got.frames) == adhoc.frames
                    == oracle["frames"]):
                raise AssertionError(
                    f"standing query {k}: {got.aggregates} against ad-hoc "
                    f"{adhoc.aggregates} and the oracle "
                    f"{oracle['aggregates']}")
        cold_svc = QueryService(TrackStore(B.root, None, params))
        timed = {}
        for k, q in queries.items():
            t1 = time.perf_counter()
            cold = cold_svc.query(q, clips)
            t2 = time.perf_counter()
            warm = cold_svc.query(q, clips)
            t3 = time.perf_counter()
            if cold.aggregates != warm.aggregates or \
                    cold.stats.ingested_clips or warm.stats.ingested_clips:
                raise AssertionError(f"query {k}: cold and warm differ")
            timed[k] = ((t2 - t1) * 1e3, (t3 - t2) * 1e3,
                        cold.aggregates)
        walls["queries"] = time.perf_counter() - t0
        rows = sum(len(B.get(c).rows) for c in clips)
        log(f"live 7, queries: standing answers equal ad-hoc and "
            f"reference_query exactly ({ {k: timed[k][2] for k in timed} });"
            f" rows scanned by the standing queries "
            f"{ {k: sq.rows_scanned for k, sq in standing.items()} } "
            f"(skipped {({k: sq.rows_skipped for k, sq in standing.items()})}"
            f") against {rows} rows in the store and {rescan_rows} that an "
            f"ad-hoc re-scan at every watermark reads; ad-hoc query ms "
            f"cold (NPZs from disk), warm: "
            f"{ {k: (round(v[0], 3), round(v[1], 3)) for k, v in timed.items()} }")
    finally:
        for t in tmp:
            t.cleanup()
    wall = time.perf_counter() - t_phase
    log(f"live phase: {wall:.1f} s wall; steps (s) "
        f"{ {k: round(v, 3) for k, v in walls.items()} }; card {smi}")
    return launches


VIDEO_COUNTERS = (proxy_plan, window_gather_batch, track_step,
                  assign_batch, proxy_score, window_gather)
# the kernels the fleet's paths launch
FLEET_KERNELS = ("proxy_plan", "window_gather_batch", "track_step")


def counted(run):
    """Run ``run`` with every video kernel's launch count set to 0 just
    before it; -> (result, launches, wall seconds)."""
    for k in VIDEO_COUNTERS:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, {k.__name__: k.launches for k in VIDEO_COUNTERS}, \
        time.perf_counter() - t0


def run_video() -> tuple:
    """The video paths: every check and run above but the fleet; -> (their
    six kernels' records, the bank, θ)."""
    bank = make_bank(DEVICE)
    clip = make_clip("caldot1", "test", SEED, n_frames=N_FRAMES)
    params, frames, feat, first_plan = set_up(bank, clip)
    pres = params.proxy_res
    grid_hw = pl.det_grid(params.det_res)[::-1]
    enc = bank.proxies[pres].encoder

    floor_ms = launch_floor_ms()
    wg, wg_rows = check_window_gather(frames, first_plan)
    wg1 = check_window_gather_single(frames[0])
    wg1_main = wg1[gather_check.SINGLE_CASES[0][0]]  # (15, 9), host table
    with torch.inference_mode():
        pp = check_proxy_plan(feat, enc.head_w, enc.head_b,
                              params.proxy_threshold, grid_hw)
    ps = check_proxy_score(feat, enc.head_w, enc.head_b,
                           params.proxy_threshold)
    check_against_cpu(bank, frames, feat, pres)

    asg = check_assign()
    ts = check_track_step()

    # the main path through its entry point, the launch counts set to 0
    # just before each run and read just after.  Run 1 is cold (cuDNN
    # and allocator warm-up at every shape); run 2, on another clip of
    # the same profile, is warm with decode paid in full (fps); run 3
    # repeats run 1's clip, which must give the same tracks.  Then TRACK
    # on the device, both flavours, on run 1's clip: the tracks must be
    # the host tracker's, array for array.
    clip2 = make_clip("caldot1", "test", SEED + 1, n_frames=N_FRAMES)
    runs = {}
    for label, c, opts in (
            ("cold", clip, None), ("warm", clip2, None),
            ("repeat", clip, None),
            ("device_tracker", clip, ExecutorOptions(device_tracker=True)),
            ("device_assign", clip, ExecutorOptions(device_assign=True))):
        res, launches, wall = counted(
            lambda: pl.run_clip(bank, params, c) if opts is None
            else ClipExecutor(bank, params, opts).run(c))
        check_result(res, N_FRAMES)
        on_path = ["proxy_plan", "window_gather_batch"]
        if launches["proxy_score"] or launches["window_gather"]:
            raise AssertionError("the fused streaming path launched a "
                                 "per-frame or unfused kernel")
        if opts is None:
            if launches["track_step"]:
                raise AssertionError("the host tracker launched track_step")
        else:
            on_path.append("track_step")
        for name in on_path:
            if launches[name] <= 0:
                raise AssertionError(f"{name} was not launched on the "
                                     f"main path ({label} run)")
        runs[label] = (res, launches)
        log(f"main path ({label}, clip {c.clip_id}): {N_FRAMES} frames in "
            f"{wall:.3f} s wall = {N_FRAMES / wall:.2f} fps; windows "
            f"{res.detector_windows}, full frames {res.full_frames}, "
            f"skipped {res.skipped_frames}, tracks {len(res.tracks)}; "
            f"dispatches {res.dispatches}; launches {launches}")
        log(f"  stage_seconds {json.dumps(res.stage_seconds)}")
    res, launches = runs["cold"]
    res3, launches3 = runs["repeat"]
    if launches != launches3 or not same_tracks(res, res3):
        raise AssertionError("two runs of the main path differ")
    for label in ("device_tracker", "device_assign"):
        dres = runs[label][0]
        if not same_tracks(res, dres):
            raise AssertionError(f"{label}: tracks differ from the host "
                                 "tracker's on the same clip")
        for k in ("frames_processed", "detector_windows", "full_frames",
                  "skipped_frames"):
            if getattr(dres, k) != getattr(res, k):
                raise AssertionError(f"{label}: RunResult.{k} differs")
        for k in ("proxy", "detect"):
            if dres.dispatches[k] != res.dispatches[k]:
                raise AssertionError(f"{label}: dispatches[{k!r}] differs")
        log(f"{label}: {len(dres.tracks)} tracks identical to the host "
            "tracker's, array for array; counters equal (track dispatches "
            f"{dres.dispatches['track']} against {res.dispatches['track']})")

    # the per-frame engine on clip 0 (frames cached), twice: batch-1
    # proxy through proxy_score, crops through the single-frame gather
    frame_runs = []
    for i in range(2):
        fres, flaunch, fwall = counted(
            lambda: pl.run_clip(bank, params, clip, engine="frame"))
        check_result(fres, N_FRAMES)
        for name in ("proxy_score", "window_gather"):
            if flaunch[name] <= 0:
                raise AssertionError(f"{name} was not launched on the "
                                     "per-frame path")
        for name in ("proxy_plan", "window_gather_batch", "track_step"):
            if flaunch[name]:
                raise AssertionError(f"the per-frame path launched {name}")
        frame_runs.append((fres, flaunch, N_FRAMES / fwall))
        log(f"per-frame engine (run {i + 1}, clip {clip.clip_id}, frames "
            f"cached): {N_FRAMES} frames in {fwall:.3f} s wall = "
            f"{N_FRAMES / fwall:.2f} fps; windows {fres.detector_windows}, "
            f"full frames {fres.full_frames}, skipped "
            f"{fres.skipped_frames}, tracks {len(fres.tracks)}; launches "
            f"{flaunch}; stage_seconds {fres.stage_seconds}")
    fres, flaunch, _ = frame_runs[0]
    if flaunch != frame_runs[1][1] or not same_tracks(fres, frame_runs[1][0]):
        raise AssertionError("two per-frame runs differ")
    log(f"per-frame engine: both runs give the same {len(fres.tracks)} "
        "tracks and launch counts; the streaming repeat of the same clip "
        f"planned {res3.detector_windows} windows against "
        f"{fres.detector_windows}")

    engine_drift(bank, params, clip)

    # the unfused proxy path: one proxy_score launch per chunk
    ures, ulaunch, uwall = counted(lambda: ClipExecutor(
        bank, params, ExecutorOptions(fused_plan=False)).run(clip))
    check_result(ures, N_FRAMES)
    if ulaunch["proxy_score"] <= 0 or ulaunch["proxy_plan"]:
        raise AssertionError(f"fused_plan=False launches {ulaunch}")
    compared, in_band = compare_plans(bank, params, clip)
    log(f"fused_plan=False (clip {clip.clip_id}): {N_FRAMES} frames in "
        f"{uwall:.3f} s wall = {N_FRAMES / uwall:.2f} fps; launches "
        f"{ulaunch}; plans equal the fused path's on {compared} frames, "
        f"{in_band} frames with a proxy cell in the flip band")
    if in_band == 0:
        if not same_tracks(res, ures):
            raise AssertionError("fused_plan=False: tracks differ from the "
                                 "fused run's with no cell in the band")
        log(f"fused_plan=False: {len(ures.tracks)} tracks identical to the "
            "fused run's, array for array")

    # refinement: a refiner from the streaming run's tracks on a train
    # clip, then both engines on clip 0 with θ's refine on
    train = make_clip("caldot1", "train", SEED, n_frames=N_FRAMES)
    train_tracks = pl.run_clip(bank, params, train).tracks
    refiner = TrackRefiner(bank.cfg.refine, train_tracks,
                           frame_scale=1.0 / params.det_res[0])
    bank.refiner = refiner
    params_r = dataclasses.replace(params, refine=True)
    try:
        rs = pl.run_clip(bank, params_r, clip)
        rf = pl.run_clip(bank, params_r, clip, engine="frame")
    finally:
        bank.refiner = None
    ext_s = check_refined(rs, res, "streaming")
    ext_f = check_refined(rf, fres, "per-frame")
    log(f"refinement: {len(refiner.clusters)} path clusters from "
        f"{len(train_tracks)} tracks of the streaming run on caldot1 train "
        f"clip {SEED}; streaming run "
        f"extended {ext_s} of {len(rs.tracks)} tracks, per-frame run "
        f"{ext_f} of {len(rf.tracks)}; every refined track contains its "
        "unrefined rows unchanged")

    # quality readout (untrained weights: a readout, not a gate)
    quality = {}
    for label, r in (("streaming", res), ("frame", fres)):
        m_host = mota(r.tracks, clip, assign="host")
        assign_batch.launches = 0
        m_batch = mota(r.tracks, clip, assign="batch", device=DEVICE)
        torch.cuda.synchronize()
        n_asg = assign_batch.launches
        if n_asg <= 0:
            raise AssertionError("the batch MOTA did not launch assign")
        acc = clip_count_accuracy(r.tracks, clip)
        quality[label] = dict(mota_host=m_host, mota_batch=m_batch,
                              count_accuracy=acc, assign_launches=n_asg)
        log(f"quality ({label} run, clip {clip.clip_id}, untrained "
            f"weights): MOTA host {m_host!r} | batch {m_batch!r} "
            f"({n_asg} assign launch); count accuracy {acc!r}")

    clip3 = make_clip("caldot1", "test", SEED + 2, n_frames=N_FRAMES)
    device_busy(bank, params, clip3)
    device_busy(bank, params, clip3, ExecutorOptions(device_tracker=True),
                "device tracker, frames cached")
    device_busy(bank, params, clip3, ExecutorOptions(device_assign=True),
                "device assign, frames cached")
    # the per-frame engine on clip 0, where its fps runs were taken
    device_busy(bank, params, clip, label="per-frame engine, frames cached",
                engine="frame")
    phases = frame_breakdown(bank, params, clip)
    per_frame = dict(fps=[r[2] for r in frame_runs],
                     **{k: phases[k] for k in ("wall", "proxy", "other")})
    log(f"per-frame readout (clip {clip.clip_id}, frames cached): fps "
        f"{per_frame['fps'][0]:.2f}, {per_frame['fps'][1]:.2f}; by phase "
        f"{per_frame['wall']:.3f} s wall, proxy {per_frame['proxy']:.3f} s, "
        f"other {per_frame['other']:.3f} s")

    src = "src/repro_torch/csrc/"
    dev_launches = runs["device_tracker"][1]
    a_main = asg["N128"]
    t_main = ts[track_check.CASES[0][0]]    # K = 1, the main path's shape
    kernels = [
        dict(name="proxy_plan", route="cuda", source=src + "proxy_plan.cu",
             replaces="src/repro/kernels/proxy_plan/kernel.py:67",
             design="one block of 512 per frame: the frame's features, w "
                    "and spans in one wave of bulk copies into shared "
                    "memory (ordinary loads where unaligned), head 4 "
                    "threads a cell, spans as bitmasks, grid by AND/OR, "
                    "plan stats; f32 cuda-core",
             launches=launches["proxy_plan"],
             max_abs_err=pp["max_abs_err"],
             ms=pp["ms"], plain_ms=pp["plain_ms"], bound_ms=pp["bound_ms"],
             bound_by=pp["bound_by"], library_ms=None,
             device_ms=pp["device_ms"], host_us=pp["host_us"],
             copy_back_us=pp["copy_back_us"],
             copy_back_two_us=pp["copy_back_two_us"],
             flips=pp["flips"], launch_floor_device_ms=floor_ms),
        dict(name="window_gather_batch", route="cuda",
             source=src + "window_gather.cu",
             replaces="src/repro/kernels/window_gather/kernel.py:76",
             design="one block per (window, band of rows), every 16-byte "
                    "load of the band issued before the first store; a "
                    "host table's rows carried by the launch as a kernel "
                    "parameter (scalar copies where unaligned)",
             launches=launches["window_gather_batch"],
             max_abs_err=wg["max_abs_err"], ms=wg["ms"],
             plain_ms=wg["plain_ms"], bound_ms=wg["bound_ms"],
             bound_by=wg["bound_by"], library_ms=None,
             device_ms=wg["device_ms"], copy_device_ms=wg["copy_device_ms"],
             launch_floor_device_ms=floor_ms,
             shape=f"{wg['n']} windows of {wg['size']} cells",
             cases={r["case"]: {f: r[f] for f in (
                 "n", "ms", "device_ms", "copy_device_ms", "bound_ms")}
                 for r in wg_rows}),
        dict(name="track_step", route="cuda", source=src + "track_step.cu",
             replaces="src/repro/kernels/track_step/kernel.py:160",
             design="feature, cost (a thread per pair and hidden unit), "
                    "JV (one warp per stream, state in registers) and GRU "
                    "kernels, f32 cuda-core, bit-matched (-fmad=false)",
             launches=dev_launches["track_step"],
             launches_device_assign=runs["device_assign"][1]["track_step"],
             max_abs_err=t_main["max_abs_err"], ms=t_main["ms"],
             plain_ms=t_main["plain_ms"], bound_ms=t_main["bound_ms"],
             bound_by=t_main["bound_by"], library_ms=None,
             device_ms=t_main["device_ms"],
             device_ms_parts=t_main["device_ms_parts"],
             jv_steps=t_main["steps"][0],
             jv_ns_per_step=t_main["ns_per_step"],
             shape=f"K=1 Q={t_main['Q']}, {t_main['live_pairs']} live pairs",
             cases={k: {f: r[f] for f in ("ms", "device_ms",
                                          "device_ms_parts", "steps",
                                          "ns_per_step", "bound_ms")}
                    for k, r in ts.items()}),
        dict(name="proxy_score", route="cuda", source=src + "proxy_score.cu",
             replaces="src/repro/kernels/proxy_score/kernel.py:40",
             design="one warp per cell row, every load issued first on "
                    "the read-only path (b, then float2 of feat and w), "
                    "shuffle tree, the block's scores and positives "
                    "stored as two runs into one buffer (one copy back); "
                    "f32 cuda-core",
             launches=flaunch["proxy_score"],
             launches_unfused=ulaunch["proxy_score"],
             max_abs_err=ps[1]["max_abs_err"], ms=ps[1]["ms"],
             plain_ms=ps[1]["plain_ms"], bound_ms=ps[1]["bound_ms"],
             bound_by=ps[1]["bound_by"], library_ms=None,
             device_ms=ps[1]["device_ms"], host_us=ps[1]["host_us"],
             copy_back_us=ps[1]["copy_back_us"],
             copy_back_two_us=ps[1]["copy_back_two_us"],
             flips=ps[1]["flips"], shape=str(ps[1]["shape"]),
             chunk={k: ps[16][k] for k in ("shape", "max_abs_err", "flips",
                                           "ms", "device_ms", "host_us",
                                           "plain_ms", "bound_ms")},
             per_frame=per_frame),
        dict(name="window_gather", route="cuda",
             source=src + "window_gather.cu",
             replaces="src/repro/kernels/window_gather/kernel.py:40",
             design="the batch gather's body over a (cy, cx) table: one "
                    "block per (window, band of rows), every 16-byte load "
                    "of the band before the first store; a host table's "
                    "rows carried by the launch (scalar copies where "
                    "unaligned)",
             launches=flaunch["window_gather"],
             max_abs_err=max(r["max_abs_err"] for r in wg1.values()),
             ms=wg1_main["ms"], plain_ms=wg1_main["plain_ms"],
             bound_ms=wg1_main["bound_ms"], bound_by=wg1_main["bound_by"],
             library_ms=None, device_ms=wg1_main["device_ms"],
             host_us=wg1_main["host_us"],
             shape=f"{wg1_main['n']} windows of {wg1_main['size']} cells, "
                   "host table",
             cases={k: {f: r[f] for f in ("n", "ms", "device_ms", "host_us",
                                          "plain_ms", "bound_ms",
                                          "bound_ms_written_twice")}
                    for k, r in wg1.items() if "ms" in r}),
        dict(name="assign_batch", route="cuda", source=src + "assign.cu",
             replaces="src/repro/kernels/assign/kernel.py:118",
             design="JV, one warp per matrix, state in registers (shared "
                    "memory past 287 columns), bit-matched (-fmad=false)",
             launches=quality["streaming"]["assign_launches"],
             launches_device_tracker=dev_launches["assign_batch"],
             launches_from="metrics.mota(assign='batch')",
             solve_runs_in="track_step (jv.cuh), once per launch",
             max_abs_err=a_main["max_abs_err"], ms=a_main["ms"],
             plain_ms=a_main["plain_ms"], plain_on="cpu",
             bound_ms=a_main["bound_ms"], bound_by=a_main["bound_by"],
             library_ms=None, device_ms=a_main["device_ms"],
             jv_steps=max(a_main["steps"]),
             jv_ns_per_step=a_main["ns_per_step"],
             shape=f"K=4 N={a_main['N']}",
             cases={k: {f: r[f] for f in ("ms", "device_ms", "steps",
                                          "ns_per_step")}
                    for k, r in asg.items()}),
    ]
    return kernels, bank, params, quality["streaming"]


# ---------------------------------------------------------------------------
# Training and tuning: setup and tune at full width on the card
# ---------------------------------------------------------------------------

TUNE_CLIPS = 2                  # caldot1 train and val clips each
TUNE_FRAMES = 32
# the reference's defaults are 400, 120 and 1500: the tracker is cut
TUNE_STEPS = dict(detector_steps=400, proxy_steps=120, tracker_steps=300)
TUNE_MAX_ITERS = 3              # of TunerConfig's 12
# the kernels the tuning path launches
TUNING_KERNELS = ("proxy_score", "proxy_plan", "window_gather_batch")


def synchronised_split(records: list):
    """``pipeline.run_split`` that appends (θ, seconds, synchronised wall,
    count accuracy) of each call to ``records``."""
    def wrap(fn):
        def run(bank, params, clips, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(bank, params, clips, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            records.append((params, out[1], wall, float(np.mean(
                [clip_count_accuracy(r.tracks, c)
                 for r, c in zip(out[0], clips)]))))
            return out
        return run
    return wrap


def wall_of(records: list, params) -> float:
    """The synchronised wall of the last recorded evaluation of θ."""
    return [r[2] for r in records if r[0] == params][-1]


def run_tuning(untrained: dict) -> dict:
    """Training and tuning on the card at full MultiScope width (both
    detector archs, all 8 detector and 5 proxy resolutions, the full
    tracker), on ``caldot1`` with ``TUNE_CLIPS`` train and val clips of
    ``TUNE_FRAMES`` frames:

    1. each trainer's 3 steps of ``_fit`` on the card against the CPU
       (``core.train_check``: each step's loss and the first step's
       gradients within 1e-4, the final parameters' loss on a fresh
       batch within 1e-3; the parameters' gaps reported), the card side
       twice;
    2. ``tuner.setup`` with the steps cut to ``TUNE_STEPS``; the trained
       ssd-deep's F1 at 960x544 must beat the untrained one's;
    3. ``tuner.tune`` with ``max_iters`` cut to ``TUNE_MAX_ITERS``: every
       point with its ``seconds`` beside the synchronised wall of its
       ``run_split``; ``proxy_score`` must be launched over setup and
       tune; then ``ProxyCache.propose(θ_best, S)`` through
       ``_evaluate`` (where it proposes nothing, or no sub-frame window,
       the sparsest proxy θ with recall), which must launch
       ``proxy_plan`` and ``window_gather_batch``;
    4. the curve's most accurate θ twice through ``ClipExecutor`` on test
       clip 0 (equal tracks), its count accuracy and MOTA beside the
       untrained main path's (``untrained``).

    -> the launches of setup + tune and of the proposal's evaluation."""
    t_phase = time.perf_counter()
    smi = nvidia_smi()
    walls = {}

    # 1. card against CPU training parity
    t0 = time.perf_counter()
    parity = {}
    for name in train_check.TRAINERS:
        r = train_check.check_trainer(name, DEVICE)
        parity[name] = r
        log(f"training parity ({name}, batch {r['batch']}, "
            f"{r['steps']} steps of _fit, seeded init on both devices): "
            f"losses card {r['losses_card']} CPU {r['losses_cpu']}, "
            f"largest rel {r['loss_rel']!r} (tol {train_check.LOSS_RTOL}); "
            f"first-step gradients {r['grad_rel']!r} of max |CPU| "
            f"({r['grad_worst']}, tol {train_check.GRAD_RTOL}); final "
            f"parameters' loss on a fresh batch card {r['fresh_card']!r} "
            f"CPU {r['fresh_cpu']!r}, rel {r['fresh_rel']!r} (tol "
            f"{train_check.FRESH_RTOL}); parameters: largest gap "
            f"{r['param_rel']!r} of max |CPU| ({r['param_worst']}), "
            f"{r['param_within']:.4f} of them within "
            f"{train_check.PARAM_RTOL}; card run against card run: loss "
            f"{r['card_to_card_loss']!r}, parameter "
            f"{r['card_to_card_param']!r}")
    walls["parity"] = time.perf_counter() - t0

    # 2. setup at full width
    cfg = dataclasses.replace(CFG, tuner=dataclasses.replace(
        CFG.tuner, max_iters=TUNE_MAX_ITERS))
    train = make_split("caldot1", "train", TUNE_CLIPS, TUNE_FRAMES)
    val = make_split("caldot1", "val", TUNE_CLIPS, TUNE_FRAMES)
    log(f"tuning cell: caldot1, {TUNE_CLIPS} train and {TUNE_CLIPS} val "
        f"clips of {TUNE_FRAMES} frames; cuts: detector_steps "
        f"{TUNE_STEPS['detector_steps']} (of 400), proxy_steps "
        f"{TUNE_STEPS['proxy_steps']} (of 120), tracker_steps "
        f"{TUNE_STEPS['tracker_steps']} (of 1500), max_iters "
        f"{TUNE_MAX_ITERS} (of {CFG.tuner.max_iters})")
    records: list = []
    caches: list = []
    det_timing: dict = {}

    def timed_trainer(fn):
        def train(*a, **k):
            t = {}
            out = fn(*a, timing=t, **k)
            det_timing[a[0]] = t
            return out
        return train

    def kept_caches(fn):
        def build(*a, **k):
            caches.append(fn(*a, **k))
            return caches[-1]
        return build

    for k in VIDEO_COUNTERS:
        k.launches = 0
    t0 = time.perf_counter()
    with wrapped(pl, "run_split", synchronised_split(records)), \
            wrapped(tuner_mod, "train_detector", timed_trainer), \
            wrapped(tuner_mod, "build_caches", kept_caches):
        sys_ = tuner_mod.setup(cfg, train, val, log=log, device=DEVICE,
                               **TUNE_STEPS)
        walls["setup"] = time.perf_counter() - t0
        n_setup = len(records)
        t0 = time.perf_counter()
        curve = tuner_mod.tune(sys_, val, log=log)
        torch.cuda.synchronize()
        walls["tune"] = time.perf_counter() - t0
    launches = {"setup+tune": {k.__name__: k.launches
                               for k in VIDEO_COUNTERS}}
    bank = sys_.bank
    log(f"setup: {walls['setup']:.1f} s wall; setup_seconds (stage clock: "
        f"wall closed by a synchronise) "
        f"{ {k: round(v, 3) for k, v in sys_.setup_seconds.items()} }; "
        f"θ_best {sys_.theta_best.describe()}; window sizes "
        f"{bank.sizes_cells}; {len(bank.proxies)} proxies")
    for arch, t in det_timing.items():
        log(f"  detector {arch}: {t['steps']} steps, drawing batches "
            f"(host rendering) {t['batch_s']:.3f} s, steps {t['step_s']:.3f}"
            f" s")
    log("  proxy seconds a frame (batch "
        f"{pl.TIMING_BATCH}): " + ", ".join(
            f"{r[0]}x{r[1]} {tuner_mod._time_proxy(p) * 1e3:.4f} ms"
            for r, p in bank.proxies.items()))
    log("  detector seconds a frame (batch "
        f"{pl.TIMING_BATCH}): " + ", ".join(
            f"{a}@{r[0]}x{r[1]} {v * 1e3:.4f} ms"
            for (a, r), v in bank.det_times.items()))
    log("  window seconds a window (batch "
        f"{pl.TIMING_BATCH}): " + ", ".join(
            f"{a} {s} {v * 1e3:.4f} ms" for (a, s), v in
            bank.win_times.items()))
    for params, secs, wall, acc in records[:n_setup]:
        log(f"  setup evaluation {params.describe()}: accuracy {acc:.4f}, "
            f"seconds {secs:.3f} (RunResult), synchronised wall {wall:.3f}")
    for params, secs, wall, acc in records[n_setup:]:
        log(f"  tune evaluation {params.describe()} refine={params.refine}"
            f": accuracy {acc:.4f}, seconds {secs:.3f}, synchronised wall "
            f"{wall:.3f}")
    zero = np.zeros((1,) + tuple(CFG.detector.resolutions[0][::-1]) + (3,),
                    np.float32)
    log("  detections on a zero frame at conf 0.5 (what the reference's "
        "timer decodes): " + ", ".join(
            f"{a} {len(d.detect_batch(zero, 0.5)[0])}"
            for a, d in bank.detectors.items()))
    det_res = CFG.detector.resolutions[0]
    f1 = detector_f1(bank.detectors["ssd-deep"], val, det_res)
    f1_0 = detector_f1(Detector("ssd-deep", seed=SEED, device=DEVICE), val,
                       det_res)
    log(f"detector_f1 at {det_res[0]}x{det_res[1]} (conf 0.4, 40 val "
        f"frames): trained ssd-deep {f1!r}, untrained (seed {SEED}) "
        f"{f1_0!r}")
    if not f1 > f1_0:
        raise AssertionError("the trained detector is no better than the "
                             "untrained one")

    # 3. the curve
    log(f"tune: {walls['tune']:.1f} s wall, {len(records) - n_setup} "
        f"evaluations, {len(curve)} points; launches over setup and tune "
        f"{launches['setup+tune']}")
    for pt in curve:
        log(f"  point {pt.module}: {pt.params.describe()} refine="
            f"{pt.params.refine}; val accuracy {pt.val_accuracy!r}, seconds "
            f"{pt.val_seconds!r}, synchronised wall "
            f"{wall_of(records, pt.params)!r}")
    if launches["setup+tune"]["proxy_score"] <= 0:
        raise AssertionError("proxy_score was not launched by setup and tune")
    det_cache, proxy_cache = caches[-1]
    for res in bank.proxies:
        log(f"  proxy cache {res[0]}x{res[1]} (est. s a frame, recall): "
            + ", ".join(f"{th!r}: ({e[0] * 1e3:.4f} ms, {e[1]:.3f})"
                        for (r, th), e in proxy_cache.entries.items()
                        if r == res))
    S = cfg.tuner.speedup_per_iter
    launches["proposal"] = {k.__name__: 0 for k in VIDEO_COUNTERS}

    def evaluate(cand, label: str) -> dict:
        for k in VIDEO_COUNTERS:
            k.launches = 0
        with wrapped(pl, "run_split", synchronised_split(records)):
            acc, secs = tuner_mod._evaluate(bank, cand, val)
        torch.cuda.synchronize()
        got = {k.__name__: k.launches for k in VIDEO_COUNTERS}
        for name, n in got.items():
            launches["proposal"][name] += n
        log(f"{label}: {cand.describe()} (est. "
            f"{proxy_cache.entries[(cand.proxy_res, cand.proxy_threshold)]}"
            f", full frame {proxy_cache.t_frame_full!r} s); val accuracy "
            f"{acc!r}, seconds {secs!r}, synchronised wall "
            f"{records[-1][2]!r}; launches {got}")
        return got

    cand = proxy_cache.propose(sys_.theta_best, S)
    if cand is None:
        # on the card a proxy costs most of a full frame (PERF.md), so
        # the cheapest entry, a threshold that skips every frame, meets
        # the budget by a margin of about the timers' noise, and the
        # cache may propose nothing, as the reference's tuner then does
        log(f"proxy proposal for θ_best at S {S}: none (budget "
            f"{(1.0 - S) * proxy_cache.t_frame_full!r} s a frame, the "
            f"cheapest entry "
            f"{min(t for t, _ in proxy_cache.entries.values())!r} s)")
    if cand is None or not evaluate(cand, f"proxy proposal for θ_best at "
                                    f"S {S}")["window_gather_batch"]:
        # no proposal, or its plans hold no sub-frame window (the
        # cheapest entry may skip every frame): the sparsest proxy θ that
        # still finds objects, with the measured window times, and if
        # they leave no sub-frame window either, with window times
        # proportional to area, as ``set_up`` seeds the main path's
        _, res, th = max((th, res, th) for (res, th), (_, recall)
                         in proxy_cache.entries.items()
                         if 0.0 < recall and th < 1.0)
        sparse = dataclasses.replace(sys_.theta_best, proxy_res=res,
                                     proxy_threshold=th)
        if not evaluate(sparse, "the sparsest proxy θ with recall, "
                        "measured window times")["window_gather_batch"]:
            saved = dict(bank.win_times)
            sizeset = pl.make_sizeset(bank, sparse)
            full = sizeset.full
            for size in sizeset.sizes:
                bank.win_times[(sparse.det_arch, size)] = \
                    sizeset.times[full] * size[0] * size[1] \
                    / (full[0] * full[1])
            try:
                evaluate(sparse, "the same, window times proportional to "
                         f"area from the full frame's {sizeset.times[full]!r}"
                         " s")
            finally:
                bank.win_times.clear()
                bank.win_times.update(saved)
    for name in ("proxy_plan", "window_gather_batch"):
        if launches["proposal"][name] <= 0:
            raise AssertionError(f"{name} was not launched by the proxy "
                                 "proposals' evaluations")

    # 4. the tuned bank on the main path
    best = max(curve, key=lambda p: p.val_accuracy)
    clip = make_clip("caldot1", "test", SEED, n_frames=N_FRAMES)
    r1, l1, w1 = counted(lambda: ClipExecutor(bank, best.params).run(clip))
    r2, l2, w2 = counted(lambda: ClipExecutor(bank, best.params).run(clip))
    if not same_tracks(r1, r2) or l1 != l2:
        raise AssertionError("two runs of the tuned θ differ")
    if r1.frames_processed != len(range(0, N_FRAMES, best.params.gap)) \
            or not r1.tracks or not all(
                t.ndim == 2 and t.shape[1] == 6 and np.isfinite(t).all()
                for t in r1.tracks):
        raise AssertionError("the tuned θ's run is malformed")
    m_host = mota(r1.tracks, clip, frames=range(0, N_FRAMES,
                                                best.params.gap),
                  assign="host")
    acc = clip_count_accuracy(r1.tracks, clip)
    log(f"tuned θ ({best.module}, val accuracy {best.val_accuracy!r}) "
        f"{best.params.describe()} on test clip {clip.clip_id}, twice: "
        f"{len(r1.tracks)} tracks, equal; {w1:.3f} / {w2:.3f} s wall; "
        f"launches {l1}; count accuracy {acc!r}, MOTA {m_host!r} against "
        f"the untrained main path's {untrained['count_accuracy']!r}, "
        f"{untrained['mota_host']!r}")
    log(f"tuning phase: {time.perf_counter() - t_phase:.1f} s wall; "
        f"parity {walls['parity']:.1f}, setup {walls['setup']:.1f}, tune "
        f"{walls['tune']:.1f}; card {smi}")
    return launches


# ---------------------------------------------------------------------------
# LM serving: flash_attention (prefill) and decode_attention (decode)
# ---------------------------------------------------------------------------

def attn_bound(n_bytes, n_ops, dtype):
    """(bound ms, by) at the dtype's tensor-core peak (bf16; f32 as
    3xTF32, the way flash_attention and ssd_scan compute it), and the
    f32 CUDA-core line beside it."""
    rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else TF32X3_OPS_PER_S
    b_ms, b_by = bound(n_bytes, n_ops, rate)
    return b_ms, b_by, bound(n_bytes, n_ops, F32_OPS_PER_S)[0]


def op_device_ms(fn, op_name: str, reps: int = 20):
    """Device time per call of every kernel that the host op ``op_name``
    (an ``aten::`` op, children included) launches within ``fn``, with
    the L2 overwritten before each call as in ``device_ms_by_kernel``;
    None if the profiler attributed no device time to it.  For a library
    call whose kernels' names vary with the dtype (SDPA's f32 path is
    not a flash kernel)."""
    for ev in profiled_cold(fn, reps).key_averages():
        if ev.key == op_name and ev.count:
            total = device_us(ev)
            return total / ev.count / 1e3 if total else None
    return None


def check_flash_attention(heads=(flash_check.HQ, flash_check.HKV,
                                  flash_check.D),
                          timed=("S512 causal", "S500 causal")):
    """The prefill kernel against its plain version on the card
    (``kernels.flash_attention.check``), over the cases at ``heads``.
    At qwen2-0.5b's (Hq 14, Hkv 2, D 64): the serving shape (B 4, S 512,
    causal) in bf16 and f32, the prefill's own S 500 (the ragged edge,
    masked in the kernel), Sq 128 < Skv 512 causal, non-causal, kv_valid
    500, and Sq 512 > Skv 256 causal, whose first 256 rows see no key
    (they must be 0); then that each dtype runs its own kernel and the
    wrapper's refusals.  At zamba2-7b's (32, 32, 112): S 500 and 512,
    causal; at whisper-small's (12, 12, 64) and pixtral-12b's (32, 8,
    128), ``flash_check.SERVE_CASES``.  Timed at the ``timed`` cases,
    both dtypes, beside SDPA (its device time: every kernel the call
    launches).  -> {case: record}."""
    rows = {}
    for i, case in enumerate(flash_check.CASES + flash_check.SERVE_CASES):
        name, dt, Sq, Skv, causal, kv_valid, case_heads = case
        if case_heads != tuple(heads):
            continue
        Hq, Hkv, D = case_heads
        q, k, v = flash_check.case_operands(case, DEVICE, SEED + i)
        label = f"flash_attention {name} {dt}"
        err = flash_check.check_flash(q, k, v, causal, kv_valid, label)
        row = dict(case=name, dtype=str(dt).split(".")[-1],
                   B=flash_check.B, Sq=Sq, Skv=Skv, Hq=Hq, Hkv=Hkv, D=D,
                   causal=causal, kv_valid=kv_valid, max_abs_err=err)
        if name in timed:
            n_valid = kv_valid or Skv
            qpos = np.arange(Sq) + (Skv - Sq)
            seen = np.clip(np.minimum(qpos + 1, n_valid) if causal
                           else np.full(Sq, n_valid), 0, None)
            n_ops = q.shape[0] * Hq * 4 * D * int(seen.sum())
            n_bytes = (2 * q.numel() + k.numel() + v.numel()) \
                * q.element_size()
            b_ms, b_by, f32_ms = attn_bound(n_bytes, n_ops, dt)

            def kern():
                return flash_attention(q, k, v, causal=causal,
                                       kv_valid=kv_valid)

            def plain():
                return flash_attention_ref(q, k, v, causal=causal,
                                           kv_valid=kv_valid)

            def sdpa():
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=causal, enable_gqa=True)
            with torch.inference_mode():
                row.update(ms=event_ms(kern, reps=20),
                           device_ms=device_ms(kern, FLASH_KERNEL_NAMES,
                                               reps=20),
                           plain_ms=event_ms(plain, reps=5),
                           library_ms=event_ms(sdpa, reps=20)
                           if (Sq == Skv or not causal) and not kv_valid
                           else None,
                           library_device_ms=op_device_ms(
                               sdpa, "aten::scaled_dot_product_attention"),
                           bound_ms=b_ms, bound_by=b_by,
                           bound_f32_core_ms=f32_ms, flops=n_ops,
                           bytes=n_bytes)
            log(f"{label}: max |d| {err!r}; kernel {row['ms']:.4f} ms/call "
                f"(device, cold L2 {row['device_ms']}), plain "
                f"{row['plain_ms']:.4f} ms, SDPA {row['library_ms']} ms "
                f"(device {row['library_device_ms']}), "
                f"bound {b_ms:.5f} ms ({b_by}; {n_ops / 1e9:.3f} GFLOP, "
                f"{n_bytes / 1e6:.2f} MB; f32 CUDA-core line "
                f"{f32_ms:.5f} ms)")
        else:
            log(f"{label}: max |d| {err!r} (within tolerance)")
        rows[(name, row["dtype"])] = row
    if tuple(heads) != (flash_check.HQ, flash_check.HKV, flash_check.D):
        return rows
    check_kernel_of_each_dtype(
        "flash_attention", flash_check,
        lambda dt: flash_check.kernels_launched(
            next(c for c in flash_check.CASES if c[1] == dt), DEVICE,
            seconds=TRACE_SECONDS))
    flash_check.check_refusals(DEVICE)
    log(f"flash_attention: refuses head dims "
        f"{flash_check.UNBUILT_HEAD_DIMS} in f32 and bf16")
    return rows


def check_decode_attention(cases=decode_check.LM_CASES,
                           timed=(decode_check.CASES[0][0],)):
    """The decode kernel against its plain version on the card
    (``kernels.decode_attention.check``), over ``cases``, in bf16 and
    f32.  By default: B 4, S 1024, Hq 14, Hkv 2, D 64 with kv_len (1,
    61, S/2, S) (the serving call, timed) and (0, 64, 65, S - 1), a
    16-head group and stablelm-1.6b's heads (MHA, 32 of 32 of 64); then
    the wrapper's refusals and a CUDA-graph replay.  zamba2-7b's call
    (``decode_check.HYBRID_CASE``) is the hybrid phase's.  A timed case
    also records the thread blocks of its launch as the profiler's trace
    holds them (``launch_blocks``).  -> {(case, dtype): record of a
    timed case}."""
    rows = {}
    for ci, case in enumerate(decode_check.CASES):
        if case not in cases:
            continue
        name, b, S, Hq, Hkv, D, _ = case
        for i, dt in enumerate(decode_check.DTYPES):
            q, k, v, lens = decode_check.case_operands(
                case, dt, DEVICE, SEED + 20 + 2 * ci + i)
            label = f"decode_attention {name} {dt}"
            err = decode_check.check_decode(q, k, v, lens, label)
            if name not in timed:
                log(f"{label}: max |d| {err!r} (within tolerance)")
                continue

            def kern():
                return decode_attention(q, k, v, lens)

            def plain():
                return decode_attention_ref(q, k, v, lens)
            mask = (torch.arange(S, device=DEVICE)[None, :]
                    < lens[:, None])[:, None, None, :]

            def sdpa():
                return F.scaled_dot_product_attention(
                    q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=mask, enable_gqa=True)
            keys = int(lens.sum())
            n_bytes = (2 * q.numel() + 2 * keys * Hkv * D) \
                * q.element_size() + lens.numel() * 4
            n_ops = 4 * D * Hq * keys
            b_ms, b_by, f32_ms = attn_bound(n_bytes, n_ops, dt)
            with torch.inference_mode():
                row = dict(case=name, dtype=str(dt).split(".")[-1], B=b,
                           S=S, Hq=Hq, Hkv=Hkv, D=D,
                           kv_len=lens.tolist(), max_abs_err=err,
                           ms=event_ms(kern), device_ms=device_ms(
                               kern, DECODE_KERNEL_NAMES),
                           plain_ms=event_ms(plain, reps=20),
                           library_ms=event_ms(sdpa), bound_ms=b_ms,
                           bound_by=b_by, bound_f32_core_ms=f32_ms,
                           flops=n_ops, bytes=n_bytes,
                           blocks=launch_blocks(kern, DECODE_KERNEL_NAMES))
            log(f"{label}: max |d| {err!r}; kernel {row['ms']:.4f} ms/call "
                f"(device, cold L2 {row['device_ms']}; thread blocks a "
                f"launch, from the trace: {row['blocks']}), plain "
                f"{row['plain_ms']:.4f} ms, SDPA {row['library_ms']:.4f} "
                f"ms, bound {b_ms:.6f} ms ({b_by}; {n_bytes / 1e6:.3f} MB)")
            rows[(name, row["dtype"])] = row
    if decode_check.CASES[0] not in cases:
        return rows
    decode_check.check_refusals(DEVICE)
    log("decode_attention: refuses a 17-head group and head dims 32 and "
        "96")
    err = decode_check.check_graph_replay(DEVICE, SEED + 30)
    log(f"decode_attention: captured in a CUDA graph and replayed after "
        f"kv_len changed in place, max |d| {err!r} (within tolerance)")
    return rows


def recording(store: dict, key: str):
    """A wrapper for ``Model.forward`` / ``Model.decode_step`` that keeps
    a copy of each call's logits under ``store[key]``."""
    def wrap(fn):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            store.setdefault(key, []).append(out[0].float().clone())
            return out
        return wrapper
    return wrap


@dataclasses.dataclass(frozen=True)
class ServeCell:
    """One LM serving cell: its config; the kernels a generate launches,
    by name, with their wrappers and launches a generate; the swap of
    each for its plain version; the rows held alone against the batch
    and against a fresh prefill (``None``: every row); the planted
    faults; the logit tolerance by activation dtype; and, where a fresh
    prefill is no identity for every row, the decode check itself."""
    cfg: Any
    kernels: Dict[str, Tuple[Callable, int]]
    plain: Tuple[Tuple[Any, str, Callable], ...]
    rows: Optional[Tuple[int, ...]]
    faults: Tuple[Tuple[str, Any, str, Callable, str, bool], ...]
    tol: Dict[str, float]
    # the device kernels behind ``kernels``, by the names a trace gives
    device_names: Tuple[str, ...] = ()
    # (model, params, prompts, out, logs) -> the decode check's gap;
    # None: ``decode_gap`` over ``rows``
    decode: Optional[Callable] = None
    # rows -> the batch's frontend embeddings of those rows (the vlm
    # cell's patch_embeds, the encdec cell's audio_embeds), beside the
    # tokens of every generate and fresh prefill; {} for a text-only cell
    extras: Callable[[Any], Dict[str, Any]] = lambda rows: {}

    def counts(self) -> Dict[str, int]:
        return {n: fn.launches for n, (fn, _) in self.kernels.items()}

    def reset(self) -> None:
        for fn, _ in self.kernels.values():
            fn.launches = 0

    def want(self) -> Dict[str, int]:
        return {n: w for n, (_, w) in self.kernels.items()}


def routing_recording(store: dict):
    """A wrapper for ``Model.forward`` that keeps, for a model with MoE
    layers, each call's routing a layer under ``store["routing"]``."""
    def wrap(fn):
        def wrapper(self, params, *args, **kwargs):
            out = fn(self, params, *args, **kwargs)
            if self.cfg.family == "moe":
                store.setdefault("routing", []).append(
                    [layer.moe.routing for layer in params.layers])
            return out
        return wrapper
    return wrap


def served(eng, prompts, n_new, plain=(), extras=None):
    """One generate with the prefill and decode logits recorded (and an
    MoE model's prefill routing); each ``(owner, attr, plain_fn)`` of
    ``plain`` swaps a kernel's wrapper for its plain version for this
    run; ``extras``: the prompts' frontend embeddings.  -> (tokens,
    {"prefill": [..], "decode": [..]})."""
    logs = {}
    with contextlib.ExitStack() as hooks:
        hooks.enter_context(wrapped(Model, "forward",
                                    routing_recording(logs)))
        hooks.enter_context(wrapped(Model, "forward",
                                    recording(logs, "prefill")))
        hooks.enter_context(wrapped(Model, "decode_step",
                                    recording(logs, "decode")))
        for owner, attr, fn in plain:
            hooks.enter_context(wrapped(owner, attr, lambda _, f=fn: f))
        out = eng.generate(prompts, n_new, extras)
    torch.cuda.synchronize()
    return out, logs


def logit_gap(got, want) -> float:
    """max |got - want| in units of the RMS of ``want`` (a row's logits
    spread about that much; its max |logit|, the echo of the input token
    under the tied random init, is an outlier several times larger)."""
    want = want.float()
    return float((got.float() - want).abs().max()
                 / want.pow(2).mean().sqrt())


def logits_close(got, want, label: str, tol: float) -> float:
    """``logit_gap`` held to ``tol``.  -> the gap."""
    gap = logit_gap(got, want)
    if gap > tol:
        raise AssertionError(f"{label}: logits differ by {gap!r} RMS > "
                             f"{tol!r}")
    return gap


def tokens_agree(a, b, lens, logits, tol: float) -> int:
    """Greedy tokens of two runs agree wherever the first run's top-2
    margin exceeds twice the logit tolerance (``tol`` of that row's
    RMS); after the first allowed disagreement in a row the contexts
    differ, so that row stops.  ``logits[s]`` are the logits that chose
    new token s.  -> tokens compared."""
    compared = 0
    for i, n in enumerate(lens):
        for s in range(len(a[i]) - n):
            lg = logits[s][i]
            top2 = torch.topk(lg, 2).values
            if a[i][n + s] != b[i][n + s]:
                margin = tol * float(lg.float().pow(2).mean().sqrt())
                if float(top2[0] - top2[1]) > 2 * margin:
                    raise AssertionError(f"row {i} token {s}: kernel and "
                                         "plain runs differ at a clear "
                                         "margin")
                break
            compared += 1
    return compared


def prefill_logits(model, params, seqs, extras=None):
    """Logits at the last token of each of ``seqs`` from one fresh
    forward over them, right-padded; ``extras``: their frontend
    embeddings."""
    width = max(map(len, seqs))
    logits, _, _ = model.forward(
        params, {"tokens": np.array([s + [0] * (width - len(s))
                                     for s in seqs]), **(extras or {})},
        logits_at=np.array([len(s) - 1 for s in seqs]))
    return logits.float()


def decode_gap(model, params, prompts, out, logs, rows,
               extras=lambda rows: {}) -> float:
    """The first and the last decode step's logits of ``rows`` against a
    fresh prefill over the same tokens (and ``extras(rows)``, their
    frontend embeddings): the larger ``logit_gap``."""
    gaps = []
    for s in (0, len(logs["decode"]) - 1):
        seqs = [out[i][:len(prompts[i]) + s + 1] for i in rows]
        gaps.append(logit_gap(logs["decode"][s][list(rows)],
                              prefill_logits(model, params, seqs,
                                             extras(list(rows)))))
    return max(gaps)


def _decode_kv_len_is_pos(fn):
    def wrapper(q, k, v, kv_len, *args, **kwargs):
        return fn(q, k, v, kv_len - 1, *args, **kwargs)
    return wrapper


def _decode_one_late(fn):
    def wrapper(self, params, token, pos, cache):
        return fn(self, params, token, pos + 1, cache)
    return wrapper


def _decode_without_rope(fn):
    def wrapper(x, cos, sin):
        # decode's tables are (B, 1, D/2), the prefill's (S, D/2)
        return x if cos.ndim == 3 else fn(x, cos, sin)
    return wrapper


def _prefill_not_causal(fn):
    def wrapper(q, k, v, causal=True, **kwargs):
        return fn(q, k, v, causal=False, **kwargs)
    return wrapper


def _decode_without_decay(fn):
    def wrapper(state, x_t, dt_t, A, B_t, C_t, D):
        return fn(state, x_t, dt_t, torch.zeros_like(A), B_t, C_t, D)
    return wrapper


def _decode_zero_conv_tail(fn):
    def wrapper(self, x, state):
        state["conv"].zero_()
        return fn(self, x, state)
    return wrapper


def _prefill_drops_chunk_state(fn):
    def wrapper(x, dt, A, B, C, D, chunk=128):
        # each chunk scanned from a zero state
        parts = [fn(x[:, c:c + chunk], dt[:, c:c + chunk], A,
                    B[:, c:c + chunk], C[:, c:c + chunk], D, chunk=chunk)
                 for c in range(0, x.shape[1], chunk)]
        return torch.cat([y for y, _ in parts], dim=1), parts[-1][1]
    return wrapper


def _every_site_block_0(fn):
    def wrapper(model, *args, **kwargs):
        block1 = model.shared[1]
        model.shared[1] = model.shared[0]
        try:
            return fn(model, *args, **kwargs)
        finally:
            model.shared[1] = block1
    return wrapper


def _shared_without_embedding(fn):
    def wrapper(self, h, h_embed, rope=None):
        return fn(self, h, torch.zeros_like(h_embed), rope)
    return wrapper


# Planted faults, each run through the serve checks, which must reject
# it: (name, owner, attribute, wrap, the check that must see it, whether
# the bf16 check is held to see it too: a dropped key of hundreds moves
# the logits too little above bf16's end-to-end rounding, PERF.md).
LM_FAULTS = (
    ("decode attends kv_len = pos", lm_attention, "decode_attention",
     _decode_kv_len_is_pos, "decode", False),
    ("decode writes and reads one position late", Model, "decode_step",
     _decode_one_late, "decode", True),
    ("decode without rope", lm_attention, "apply_rope",
     _decode_without_rope, "decode", True),
    ("prefill not causal", lm_attention, "flash_attention",
     _prefill_not_causal, "prefill", True),
)
SSM_FAULTS = (
    ("decode without the state's decay (a = 1)", lm_ssm, "ssd_step",
     _decode_without_decay, "decode", True),
    ("decode with a zeroed conv tail", lm_ssm.SSMBlock, "decode",
     _decode_zero_conv_tail, "decode", True),
    ("prefill drops the state carried between chunks", lm_ssm, "ssd_scan",
     _prefill_drops_chunk_state, "prefill", True),
)


HYBRID_FAULTS = (
    ("every site uses shared block 0", lm_transformer, "lm_forward",
     _every_site_block_0, "prefill", True),
    ("shared block sees zeros for h_embed", lm_transformer.SharedBlock,
     "forward", _shared_without_embedding, "prefill", True),
    ("decode attends kv_len = pos", lm_attention, "decode_attention",
     _decode_kv_len_is_pos, "decode", False),
)


def dense_cell(cfg) -> ServeCell:
    return ServeCell(
        cfg, {"flash_attention": (flash_attention, cfg.n_layers),
              "decode_attention": (decode_attention,
                                   cfg.n_layers * LM_NEW_TOKENS)},
        ((lm_attention, "flash_attention", flash_attention_ref),
         (lm_attention, "decode_attention", decode_attention_ref)),
        None, LM_FAULTS, LM_LOGIT_TOL,
        FLASH_KERNEL_NAMES + DECODE_KERNEL_NAMES)


def ssm_cell(cfg, prompts) -> ServeCell:
    """Rows shorter than the longest absorb the right padding into their
    state (the reference's design): only the longest row is held alone
    and against a fresh prefill."""
    longest = max(range(len(prompts)), key=lambda i: len(prompts[i]))
    return ServeCell(cfg, {"ssd_scan": (ssd_scan, cfg.n_layers)},
                     ((lm_ssm, "ssd_scan", ssd_scan_ref),), (longest,),
                     SSM_FAULTS, SSM_LOGIT_TOL, ssd_check.KERNEL_NAMES)


def hybrid_cell(cfg, prompts) -> ServeCell:
    """Zamba2: ``flash_attention`` at each of the 13 shared-block sites
    of the prefill, ``decode_attention`` at each of them every decode
    step, ``ssd_scan`` once a Mamba2 layer (68) in the prefill.  Its SSM
    states absorb the right padding as the ssm cell's: only the longest
    row is held alone and against a fresh prefill."""
    h = cfg.hybrid
    longest = max(range(len(prompts)), key=lambda i: len(prompts[i]))
    n_ssm = h.n_groups * h.ssm_per_group + h.tail_ssm
    return ServeCell(
        cfg, {"flash_attention": (flash_attention, h.n_groups),
              "decode_attention": (decode_attention,
                                   h.n_groups * LM_NEW_TOKENS),
              "ssd_scan": (ssd_scan, n_ssm)},
        ((lm_attention, "flash_attention", flash_attention_ref),
         (lm_attention, "decode_attention", decode_attention_ref),
         (lm_ssm, "ssd_scan", ssd_scan_ref)),
        (longest,), HYBRID_FAULTS, HYBRID_LOGIT_TOL,
        FLASH_KERNEL_NAMES + DECODE_KERNEL_NAMES + ssd_check.KERNEL_NAMES)


def _renormalised_gates(fn):
    def wrapper(x, router, m):
        r = fn(x, router, m)
        gates = r.gate_vals / r.gate_vals.sum(dim=-1, keepdim=True)
        return dataclasses.replace(
            r, gate_vals=gates,
            w_sort=gates.reshape(r.order.shape).gather(1, r.order))
    return wrapper


def _without_shared_experts(fn):
    def wrapper(self, x):
        n, self.n_shared = self.n_shared, 0
        try:
            return fn(self, x)
        finally:
            self.n_shared = n
    return wrapper


MOE_FAULTS = (
    ("routed gates renormalised over the top-k", lm_moe, "route",
     _renormalised_gates, "prefill", True),
    ("shared experts skipped", lm_moe.MoEBlock, "forward",
     _without_shared_experts, "prefill", True),
    ("decode attends kv_len = pos", lm_attention, "decode_attention",
     _decode_kv_len_is_pos, "decode", False),
)


def moe_drops(routings, lens) -> np.ndarray:
    """(MoE layers, B): pairs dropped of each row's own tokens (not its
    right padding) in each layer's routing."""
    n = torch.as_tensor(lens, device=routings[0].keep.device)[:, None]
    return torch.stack([((~r.keep) & (r.t_sort < n)).sum(dim=-1)
                        for r in routings]).cpu().numpy()


def moe_routing_readings(logs_k, logs_p, lens, dt: str) -> dict:
    """An MoE model's routing in a serve check's prefill: the tokens (of
    the prompts, not the padding) whose top-k experts or kept pairs
    differ between the kernel run and the plain-version run, a layer,
    and the pairs the kernel run dropped, a layer and row (the prompts'
    own tokens, and all pairs with the padding's)."""
    got, plain = logs_k["routing"][0], logs_p["routing"][0]
    S = got[0].gate_idx.shape[1]
    real = torch.arange(S, device=got[0].keep.device)[None, :] \
        < torch.as_tensor(lens, device=got[0].keep.device)[:, None]
    differ = [int((g.differs(p) & real).sum()) for g, p in zip(got, plain)]
    drops = moe_drops(got, lens)
    drops_all = [r.dropped.tolist() for r in got]
    log(f"moe routing ({dt} prefill, {len(got)} MoE layers): prompt "
        f"tokens whose top-k experts or kept pairs differ between the "
        f"kernel and plain-version runs, a layer {differ} (total "
        f"{sum(differ)} of {len(got) * sum(lens)}); pairs dropped of the "
        f"prompts' own tokens, a layer and row {drops.tolist()} (total "
        f"{int(drops.sum())} of "
        f"{len(got) * sum(lens) * got[0].gate_idx.shape[-1]}), with the "
        f"padding's {drops_all}")
    return dict(topk_differ=differ, dropped=drops.tolist(),
                dropped_with_padding=drops_all)


def moe_decode_gap(model, params, prompts, out, logs) -> float:
    """``decode_gap`` for an MoE model, over every row where neither the
    generate's prefill nor either fresh prefill dropped a pair of one of
    the row's own tokens: capacity follows the padded length, so where a
    run drops one, the two runs are other computations, not roundings of
    one (the newest token, which a decode step never drops, is the first
    a fresh prefill drops from a full expert).  The fresh prefills take
    every row, so their padding (and capacity) is the batch's.  Raises
    if no row is held.  -> the larger gap over the held rows."""
    lens = [len(p) for p in prompts]
    before = moe_drops(logs["routing"][0], lens).sum(axis=0)
    held = before == 0
    fresh, after = [], []
    for s in (0, len(logs["decode"]) - 1):
        seqs = [out[i][:lens[i] + s + 1] for i in range(len(prompts))]
        fresh.append((s, prefill_logits(model, params, seqs)))
        drops = moe_drops([layer.moe.routing for layer in params.layers],
                          [len(q) for q in seqs]).sum(axis=0)
        after.append(drops.tolist())
        held &= drops == 0
    rows = np.flatnonzero(held).tolist()
    if not rows:
        raise AssertionError("moe decode check: every row dropped a pair "
                             f"of its own tokens (generate {before}, "
                             f"fresh prefills {after})")
    gap = max(logit_gap(logs["decode"][s][rows], f[rows])
              for s, f in fresh)
    log(f"moe decode check: rows {rows} held (pairs of a row's own tokens "
        f"dropped: generate's prefill {before.tolist()}, fresh prefills "
        f"at the first and last step {after}); gap {gap!r} RMS")
    return gap


def moe_cell(cfg, prompts) -> ServeCell:
    """deepseek-moe-16b: ``flash_attention`` once a layer in the prefill,
    ``decode_attention`` once a layer every decode step.  Capacity
    follows the padded length, so a shorter prompt alone is another
    computation than its row in the batch: only the longest row is held
    alone; the decode check holds the rows where no run dropped a pair
    of the row's own tokens (``moe_decode_gap``)."""
    longest = max(range(len(prompts)), key=lambda i: len(prompts[i]))
    return ServeCell(
        cfg, {"flash_attention": (flash_attention, cfg.n_layers),
              "decode_attention": (decode_attention,
                                   cfg.n_layers * LM_NEW_TOKENS)},
        ((lm_attention, "flash_attention", flash_attention_ref),
         (lm_attention, "decode_attention", decode_attention_ref)),
        (longest,), MOE_FAULTS, MOE_LOGIT_TOL,
        FLASH_KERNEL_NAMES + DECODE_KERNEL_NAMES, decode=moe_decode_gap)


def moe_f32_copy(cfg):
    """The MoE cell's f32 check copy: f32 activations over f32 weights
    at ``MOE_F32_LAYERS`` layers (the full width)."""
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32",
                               n_layers=MOE_F32_LAYERS)


def _patches_not_merged(fn):
    def wrapper(h, patch_embeds):
        return h
    return wrapper


def _patches_one_late(fn):
    def wrapper(h, patch_embeds):
        P = patch_embeds.shape[1]
        merged = fn(h, patch_embeds)
        return torch.cat([h[:, :1], merged[:, :P], h[:, P + 1:]], dim=1)
    return wrapper


VLM_FAULTS = (
    ("patch embeds not merged", lm_transformer, "merge_patches",
     _patches_not_merged, "prefill", True),
    ("patch embeds merged one position late", lm_transformer,
     "merge_patches", _patches_one_late, "prefill", True),
    ("decode attends kv_len = pos", lm_attention, "decode_attention",
     _decode_kv_len_is_pos, "decode", False),
)


def vlm_cell(cfg, prompts) -> ServeCell:
    """pixtral-12b: ``flash_attention`` once a layer in the prefill,
    ``decode_attention`` once a layer every decode step; every row is
    exact (kv_len masking), so each is held alone and against a fresh
    prefill, with its own patch embeddings."""
    return ServeCell(
        cfg, {"flash_attention": (flash_attention, cfg.n_layers),
              "decode_attention": (decode_attention,
                                   cfg.n_layers * LM_NEW_TOKENS)},
        ((lm_attention, "flash_attention", flash_attention_ref),
         (lm_attention, "decode_attention", decode_attention_ref)),
        None, VLM_FAULTS, VLM_LOGIT_TOL,
        FLASH_KERNEL_NAMES + DECODE_KERNEL_NAMES,
        extras=frontend_embeds(cfg, "patch_embeds", len(prompts),
                               cfg.frontend.n_embeds))


def vlm_f32_copy(cfg):
    """The vlm cell's f32 check copy: f32 activations over f32 weights
    at ``VLM_F32_LAYERS`` layers (the full width)."""
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32",
                               n_layers=VLM_F32_LAYERS)


def _cross_decode_masked_by_pos(fn):
    def wrapper(self, h, self_k, self_v, pos, cross_k, cross_v, n_frames):
        return fn(self, h, self_k, self_v, pos, cross_k, cross_v, pos)
    return wrapper


def _encoder_without_positions(fn):
    def wrapper(n, dim, device=None):
        return torch.zeros_like(fn(n, dim, device))
    return wrapper


def _erf_gelu(fn):
    def wrapper(x, approximate="none"):
        return fn(x)
    return wrapper


ENCDEC_FAULTS = (
    ("cross decode masked by pos, not the frames", lm_encdec.DecoderLayer,
     "decode", _cross_decode_masked_by_pos, "decode", True),
    ("encoder without sinusoidal positions", lm_encdec,
     "sinusoidal_positions", _encoder_without_positions, "prefill", True),
    ("erf GELU for the tanh approximation", lm_layers.F, "gelu", _erf_gelu,
     "prefill", False),
    ("decode attends kv_len = pos", lm_attention, "decode_attention",
     _decode_kv_len_is_pos, "decode", False),
)


def encdec_cell(cfg, prompts) -> ServeCell:
    """whisper-small: ``flash_attention`` at each encoder layer
    (bidirectional, 1500 frames) and twice a decoder layer (causal
    self-attention, cross-attention to the frames) in the prefill, 36 a
    generate; ``decode_attention`` twice a decoder layer every decode
    step (self and cross), 24 a step.  Every row is exact, so each is
    held alone and against a fresh prefill, with its own audio."""
    n_attn = cfg.n_encoder_layers + 2 * cfg.n_layers
    return ServeCell(
        cfg, {"flash_attention": (flash_attention, n_attn),
              "decode_attention": (decode_attention,
                                   2 * cfg.n_layers * LM_NEW_TOKENS)},
        ((lm_attention, "flash_attention", flash_attention_ref),
         (lm_attention, "decode_attention", decode_attention_ref)),
        None, ENCDEC_FAULTS, ENCDEC_LOGIT_TOL,
        FLASH_KERNEL_NAMES + DECODE_KERNEL_NAMES,
        extras=frontend_embeds(cfg, "audio_embeds", len(prompts),
                               cfg.frontend.n_embeds))


def serve_checks(eng, prompts, cell: ServeCell) -> dict:
    """The serving path held to itself at ``eng``'s dtype: the kernels
    against their plain versions (prefill logits and greedy tokens),
    each of ``cell.rows`` alone against the batch (first-token logits),
    their first and last decode step against a fresh prefill, each
    within the cell's tolerance of the logits' RMS; then every planted
    fault through the check it targets, which must read more than the
    tolerance.  -> readings."""
    model, params = eng.model, eng.params
    n_new = LM_NEW_TOKENS
    lens = [len(p) for p in prompts]
    rows = cell.rows or tuple(range(len(prompts)))
    dt = model.cfg.dtype
    tol = cell.tol[dt]
    extras = cell.extras(list(range(len(prompts))))
    cell.reset()
    out_k, logs_k = served(eng, prompts, n_new, extras=extras)
    if cell.counts() != cell.want():
        raise AssertionError(f"serve checks ({dt}): launches "
                             f"{cell.counts()}, expected {cell.want()}")
    out_p, logs_p = served(eng, prompts, n_new, cell.plain, extras)
    r = dict(dtype=dt, tol=tol, out=out_k)
    r["plain"] = logits_close(logs_k["prefill"][0], logs_p["prefill"][0],
                              f"{dt} prefill, kernels against plain "
                              "versions", tol)
    r["tokens_compared"] = tokens_agree(
        out_k, out_p, lens, logs_k["prefill"] + logs_k["decode"], tol)
    r["tokens_equal_plain"] = out_k == out_p
    r["min_top2_margin"] = min(
        float(torch.topk(lg, 2, dim=-1).values.diff(dim=-1).abs().min())
        for lg in logs_k["prefill"] + logs_k["decode"])
    r["batch1"] = 0.0
    for i in rows:
        _, logs1 = served(eng, [prompts[i]], 1, extras=cell.extras([i]))
        r["batch1"] = max(r["batch1"], logits_close(
            logs1["prefill"][0][0], logs_k["prefill"][0][i],
            f"{dt} prompt {i} served alone against in the batch", tol))
    if "routing" in logs_k:
        r.update(moe_routing_readings(logs_k, logs_p, lens, dt))

    def decode_check(out, logs):
        if cell.decode is not None:
            return cell.decode(model, params, prompts, out, logs)
        return decode_gap(model, params, prompts, out, logs, rows,
                          cell.extras)
    r["decode_vs_prefill"] = decode_check(out_k, logs_k)
    if r["decode_vs_prefill"] > tol:
        raise AssertionError(f"{dt} decode step against a fresh prefill: "
                             f"logits differ by {r['decode_vs_prefill']!r}"
                             f" RMS > {tol!r}")
    if not all(torch.isfinite(lg).all()
               for lg in logs_k["prefill"] + logs_k["decode"]):
        raise AssertionError(f"{dt}: non-finite logits")
    name = model.cfg.name
    log(f"serve checks ({name}, {dt}, tolerance {tol} of the logits' RMS "
        f"{float(logs_k['prefill'][0].pow(2).mean().sqrt())!r}; max "
        f"|logit| {float(logs_k['prefill'][0].abs().max())!r}): kernels "
        f"against plain versions {r['plain']!r} RMS, "
        f"{r['tokens_compared']} of {len(lens) * n_new} greedy tokens "
        f"compared (all equal: {r['tokens_equal_plain']}; smallest top-2 "
        f"margin {r['min_top2_margin']!r}); rows {list(rows)} alone "
        f"{r['batch1']!r} RMS; their first and last decode step against "
        f"a fresh prefill {r['decode_vs_prefill']!r} RMS")
    r["faults"] = {}
    for fname, owner, attr, wrap, check, in_bf16 in cell.faults:
        with wrapped(owner, attr, wrap):
            out_f, logs_f = served(eng, prompts, n_new, extras=extras)
        gap = (decode_check(out_f, logs_f) if check == "decode" else
               logit_gap(logs_f["prefill"][0], logs_k["prefill"][0]))
        held = dt == "float32" or in_bf16
        r["faults"][fname] = gap
        log(f"serve checks ({name}, {dt}), planted fault '{fname}': "
            f"{check} check reads {gap!r} RMS against tolerance {tol} ("
            f"{'caught' if gap > tol else 'not caught'}; greedy tokens "
            f"{'unchanged' if out_f == out_k else 'changed'})")
        if held and not gap > tol:
            raise AssertionError(f"{dt}: the {check} check misses the "
                                 f"planted fault '{fname}'")
    return r


def trace_sums(prof):
    """From a finished profile's raw events (``kineto_results``, not
    ``events()`` / ``key_averages()``, whose Python parse of a generate's
    few hundred thousand events took most of each LM phase's wall): ({a
    device event's name: its summed device us} over every kernel, copy
    and set the card ran, the kernel launches the host made, [(self us,
    name, calls)] of each ``aten::`` op, self time being its duration
    less that of the host events nested directly in it on its thread,
    as ``FunctionEvent.self_cpu_time_total``, and an op whose one child
    is the same op counted once, as ``EventList._remove_dup_nodes``)."""
    from torch.autograd import DeviceType
    per_name, launches, spans = {}, 0, []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            per_name[name] = per_name.get(name, 0.0) \
                + ev.duration_ns() / 1e3
            continue
        if name.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            # cudaLaunchKernel, cudaLaunchKernelExC (a cluster launch),
            # cuLaunchKernel, cuLaunchKernelEx
            launches += 1
        spans.append((ev.start_thread_id(), ev.start_ns(), ev.end_ns(),
                      name))
    spans.sort(key=lambda e: (e[0], e[1], -e[2]))
    host: Dict[str, list] = {}
    # [thread, end, name, duration, children's duration, children, the
    # first child's name]
    stack: list = []

    def close():
        thread, _, name, dur, children, n_children, first = stack.pop()
        if stack and stack[-1][0] == thread:
            parent = stack[-1]
            parent[4] += dur
            parent[5] += 1
            if parent[5] == 1:
                parent[6] = name
        if name.startswith("aten::"):
            tally = host.setdefault(name, [0.0, 0])
            tally[0] += (dur - children) / 1e3
            tally[1] += 0 if n_children == 1 and first == name else 1
    for thread, start, end, name in spans:
        while stack and (stack[-1][0] != thread or stack[-1][1] <= start):
            close()
        stack.append([thread, end, name, end - start, 0, 0, None])
    while stack:
        close()
    top_host = sorted(((us, name, n) for name, (us, n) in host.items()),
                      reverse=True)
    return per_name, launches, top_host


def serve_busy(eng, prompts, activities=None, kernel_names=(),
               extras=None) -> dict:
    """One more generate under the profiler: the device's busy time
    summed over every kernel and copy it ran, against the wall time (an
    upper bound on the idle share: the profiler slows the host), the
    part of it in the kernels whose names contain ``kernel_names``, and
    the host's side: kernel launches a token step (prefill included,
    over ``LM_NEW_TOKENS + 1`` steps) and the host ops that took the
    most self time (``trace_sums``)."""
    from torch.profiler import ProfilerActivity, profile
    if activities is None:
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        eng.generate(prompts, LM_NEW_TOKENS, extras)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_name, launches, host = trace_sums(prof)
    busy = sum(per_name.values()) / 1e6
    kern = sum(us for k, us in per_name.items()
               if any(n in k for n in kernel_names)) / 1e6
    top = sorted(((us, k) for k, us in per_name.items()), reverse=True)
    steps = LM_NEW_TOKENS + 1
    log(f"device busy (profiled generate, {eng.model.cfg.name}, "
        f"{eng.model.cfg.dtype}): "
        f"{busy * 1e3:.1f} ms of {wall * 1e3:.1f} ms wall = "
        f"{100 * busy / wall:.1f}% busy; top device time: "
        + "; ".join(f"{k[:60]} {us / 1e3:.2f} ms" for us, k in top[:6]))
    log(f"device time in {', '.join(kernel_names)} (same run): "
        f"{kern * 1e3:.4f} ms = {100 * kern / max(busy, 1e-12):.2f}% of "
        "busy")
    log(f"host (same run): {launches} kernel launches = "
        f"{launches / steps:.0f} a token step; top aten ops by self CPU "
        "time: " + "; ".join(f"{k} {us / 1e3:.1f} ms over {n} calls"
                             for us, k, n in host[:6]))
    return dict(busy_s=busy, wall_s=wall, busy_share=busy / wall,
                kernels_busy_s=kern, launches_per_step=launches / steps)


def image_positions(cfg) -> int:
    """The positions a vlm config's patch embeddings take at the start of
    each prompt (0 for the other families)."""
    return cfg.frontend.n_embeds if cfg.family == "vlm" else 0


def lm_prompts(cfg):
    """The serving cells' 4 prompts (``LM_PROMPT_LENS`` tokens, after a
    vlm config's ``image_positions`` placeholder ids), seeded."""
    rng = np.random.default_rng(SEED)
    return [[int(t) for t in rng.integers(0, cfg.vocab_size,
                                           image_positions(cfg) + n)]
            for n in LM_PROMPT_LENS]


def serve_max_len(cfg) -> int:
    """``LM_MAX_LEN``, and room for a vlm config's image positions."""
    return LM_MAX_LEN + image_positions(cfg)


def frontend_embeds(cfg, key: str, batch: int, n: int):
    """``extras`` for a cell whose prompts come with ``n`` frontend
    embeddings a row under batch key ``key``: N(0, 1), drawn in f32 from
    ``SEED`` on the card, then cast to the config's activation dtype (the
    f32 check copy sees the values the bf16 cell rounds)."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    x = torch.randn((batch, n, cfg.d_model), generator=gen, device=DEVICE)
    x = x.to(getattr(torch, cfg.dtype))

    def extras(rows):
        return {key: x[torch.as_tensor(rows, device=DEVICE)]}
    return extras


def decode_step_bytes(params) -> int:
    """The weight bytes one decode step must read: every weight but the
    embedding table (a row a token); for the encdec family the decoder's
    layers, its final norm and the tied table (the head reads it whole),
    not the encoder's layers nor ``dec_pos`` (a row a token)."""
    def n_bytes(module):
        return sum(p.numel() * p.element_size()
                   for p in module.parameters())
    table = params.embed.table
    if params.cfg.family == "encdec":
        return n_bytes(params.decoder) + n_bytes(params.ln_final) \
            + table.numel() * table.element_size()
    return n_bytes(params) - table.numel() * table.element_size()


def f32_copy(cfg):
    """The f32 check copy of a serving cell's config: f32 activations."""
    return dataclasses.replace(cfg, dtype="float32")


def run_serving(cfg, cell_of, f32_of=f32_copy) -> dict:
    """``ServeEngine.generate`` of one cell at full width (bf16
    activations over weights in ``cfg.param_dtype`` from ``SEED``) on
    ``lm_prompts``: cold and repeat (the same tokens, each kernel
    launched as the cell says, the counts set to 0 just before each), a
    timed run (prefill against decode, and the decode step against its
    weights' bound), ``serve_checks``, a profiled run, then
    ``serve_checks`` again on the f32 copy ``f32_of(cfg)``.
    ``cell_of(cfg, prompts)`` gives the cell for a config, its ``extras``
    (frontend embeddings) the hook every generate takes them from.  ->
    {"launches": the cold run's counts, "perf": the timed run's
    readings}."""
    walls = {}
    t_part = time.perf_counter()

    def part(name):
        nonlocal t_part
        now = time.perf_counter()
        walls[name] = round(now - t_part, 1)
        t_part = now
    prompts = lm_prompts(cfg)
    cell = cell_of(cfg, prompts)
    extras = cell.extras(list(range(len(prompts))))
    max_len = serve_max_len(cfg)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(seed=SEED, device=DEVICE)
    torch.cuda.synchronize()
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    log(f"lm: {cfg.name} ({model.param_count()} parameters held in "
        f"{cfg.param_dtype}, {weight_bytes / 2**30:.3f} GiB, {cfg.dtype} "
        f"activations, {cfg.n_layers} layers) initialised on the card from "
        f"seed {SEED} in {time.perf_counter() - t0:.2f} s; "
        f"max_memory_allocated at init "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    lens = [len(p) for p in prompts]
    eng = ServeEngine(model, params, max_len=max_len)
    n_new = LM_NEW_TOKENS

    runs = []
    for label in ("cold", "repeat"):
        cell.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.generate(prompts, n_new, extras)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = cell.counts()
        if launches != cell.want():
            raise AssertionError(f"serve {cfg.name} ({label}): launches "
                                 f"{launches}, expected {cell.want()}")
        if [len(o) for o in out] != [n + n_new for n in lens] or any(
                not 0 <= t < cfg.vocab_size for o in out for t in o):
            raise AssertionError(f"serve {cfg.name} ({label}): malformed "
                                 "output")
        runs.append((out, launches))
        log(f"serve {cfg.name} ({label}): {len(prompts)} prompts of {lens}"
            f" tokens, {n_new} new each, max_len {max_len}: {wall:.3f} "
            f"s wall; launches {launches}")
    if runs[0] != runs[1]:
        raise AssertionError(f"{cfg.name}: two generates of the same "
                             "prompts differ")

    # timed run: prefill (the one forward) against the decode steps
    spent = {"prefill": 0.0}

    def timed(fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                spent["prefill"] += time.perf_counter() - t
        return wrapper
    torch.cuda.reset_peak_memory_stats()
    with wrapped(Model, "forward", timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate(prompts, n_new, extras)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    pre = spent["prefill"]
    dec = wall - pre
    # a decode step reads its weights once (``decode_step_bytes``): the
    # reference's dispatch runs all experts every step
    step_bytes = decode_step_bytes(params)
    perf = dict(prefill_s=pre, prefill_tok_s=sum(lens) / pre,
                prefill_padded_tok_s=len(lens) * max(lens) / pre,
                decode_ms_per_step=dec / n_new * 1e3,
                decode_tok_s=len(lens) * n_new / dec, generate_s=wall,
                peak_bytes=peak,
                decode_weight_bound_ms=step_bytes / HBM_BYTES_PER_S * 1e3)
    log(f"serve {cfg.name} (timed): prefill {pre:.4f} s = "
        f"{perf['prefill_tok_s']:.0f} prompt tokens/s "
        f"({perf['prefill_padded_tok_s']:.0f} padded); decode {n_new} "
        f"steps in {dec:.4f} s = {perf['decode_ms_per_step']:.3f} ms/step "
        f"= {perf['decode_tok_s']:.1f} tokens/s at batch {len(lens)} "
        f"(a step's weights, {step_bytes / 2**30:.3f} GiB, bound it at "
        f"{perf['decode_weight_bound_ms']:.3f} ms); max_memory_allocated "
        f"{peak / 2**30:.3f} GiB")

    # the kernels against their plain versions, batch 1, decode against
    # prefill and the planted faults: in the config's bf16, then in f32,
    # where rounding is far below what each fault moves
    part("init and timed runs")
    chk = serve_checks(eng, prompts, cell)
    if chk["out"] != runs[0][0]:
        raise AssertionError("recorded generate differs from the first")
    part("serve checks")
    busy = serve_busy(eng, prompts, kernel_names=cell.device_names,
                      extras=extras)
    part("profiled run")
    del eng, params, extras, cell
    torch.cuda.empty_cache()
    cfg32 = f32_of(cfg)
    model32 = build_model(cfg32)
    torch.cuda.reset_peak_memory_stats()
    eng32 = ServeEngine(model32, model32.init_params(seed=SEED,
                                                     device=DEVICE),
                        max_len=max_len)
    log(f"lm: {cfg32.name} f32 check copy ({cfg32.n_layers} layers, "
        f"{model32.param_count()} parameters held in "
        f"{cfg32.param_dtype}); max_memory_allocated at init "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    cell32 = cell_of(cfg32, prompts)
    chk32 = serve_checks(eng32, prompts, cell32)
    part("f32 copy: init and serve checks")
    busy32 = serve_busy(eng32, prompts, kernel_names=cell32.device_names,
                        extras=cell32.extras(list(range(len(prompts)))))
    part("f32 copy: profiled run")
    del eng32
    torch.cuda.empty_cache()
    log(f"serve {cfg.name}: wall s by part {json.dumps(walls)}")
    log(f"lm serving {cfg.name}: " + json.dumps(dict(
        perf, **busy, **{f"float32_{k}": v for k, v in busy32.items()},
        **{f"{c['dtype']}_{k}": c[k]
                         for c in (chk, chk32)
                         for k in ("plain", "batch1", "decode_vs_prefill",
                                   "faults")})))
    return dict(launches=runs[0][1], perf=perf)


def run_lm() -> list:
    """The LM serving path at full qwen2-0.5b width: both kernels against
    their plain versions, then the dense serving cell; -> the two
    kernels' records."""
    fa = check_flash_attention()
    da = check_decode_attention()
    served_run = run_serving(LM_CFG, lambda cfg, _: dense_cell(cfg))

    src = "src/repro_torch/csrc/"
    f_main = fa[("S500 causal", "bfloat16")]
    d_main = da[(decode_check.CASES[0][0], "bfloat16")]
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_f32_core_ms", "max_abs_err")
    f_keys = keys + ("library_device_ms", "bound_by")
    return [
        dict(name="flash_attention", route="cuda",
             source=src + "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:98",
             design="wgmma fed by TMA (producer warp, mbarrier ring, 128B "
                    "swizzle); bf16: m64n64k16, 2 stages, P split into "
                    "bf16 hi + lo; f32: 3xTF32 m64n64k8 (hi the raw f32 "
                    "word, lo written beside it), 1 stage and 2 blocks an "
                    "SM, S in two accumulators, V transposed with its keys "
                    "in the register operand's K order",
             launches=served_run["launches"]["flash_attention"],
             max_abs_err=max(r["max_abs_err"] for r in fa.values()),
             ms=f_main["ms"], plain_ms=f_main["plain_ms"],
             bound_ms=f_main["bound_ms"], bound_by=f_main["bound_by"],
             library_ms=f_main["library_ms"], device_ms=f_main["device_ms"],
             library_device_ms=f_main["library_device_ms"],
             bound_f32_core_ms=f_main["bound_f32_core_ms"],
             shape="B 4, S 500, Hq 14, Hkv 2, D 64, causal, bf16",
             s512={dt: {k: fa[("S512 causal", dt)][k] for k in f_keys}
                   for dt in ("bfloat16", "float32")},
             s500_float32={k: fa[("S500 causal", "float32")][k]
                           for k in f_keys}),
        dict(name="decode_attention", route="cuda",
             source=src + "decode_attention.cu",
             replaces="src/repro/kernels/decode_attention/kernel.py:76",
             design="keys split over a 16-block cluster per (KV head, "
                    "row), partial softmaxes merged through distributed "
                    "shared memory, one launch, f32 cuda-core",
             launches=served_run["launches"]["decode_attention"],
             blocks=d_main["blocks"],
             max_abs_err=max(r["max_abs_err"] for r in da.values()),
             ms=d_main["ms"], plain_ms=d_main["plain_ms"],
             bound_ms=d_main["bound_ms"], bound_by=d_main["bound_by"],
             library_ms=d_main["library_ms"], device_ms=d_main["device_ms"],
             bound_f32_core_ms=d_main["bound_f32_core_ms"],
             shape="B 4, S 1024, Hq 14, Hkv 2, D 64, kv_len "
                   "(1, 61, 512, 1024), bf16",
             float32={k: da[(decode_check.CASES[0][0], "float32")][k]
                      for k in keys}),
    ]


def check_ssd_scan(n_state=128, timed=(ssd_check.CASES[0][0],)):
    """The scan kernel against its plain version on the card
    (``kernels.ssd_scan.check``), over the cases of state width
    ``n_state``, each in bf16 and f32 (no padding copy in either).  At N
    128 (mamba2-370m): the prefill's call (B 4, S 500, H 32, P 64, Q
    128), B 1 at S 61 (Q 61), 512 and 2048, Q 100 over S 250, and B 2 at
    S 130; then that each dtype runs its own kernel (the profiler's
    trace) and the wrapper's refusals.  At N 64 (zamba2-7b): its
    prefill's call (B 4, S 500, H 112) and Q 100 over S 250.  Each case
    logs the share of the f32 bound it used (max |d| / (F32_RTOL max
    |plain|), y and state).  Timed at the ``timed`` cases, both dtypes.
    -> {(case, dtype): record}."""
    rows = {}
    for i, (name, b, S, h, p, n, chunk) in enumerate(ssd_check.CASES):
        if n != n_state:
            continue
        for dt in (torch.bfloat16, torch.float32):
            args = ssd_check.operands(b, S, h, p, n, dt, DEVICE,
                                      SEED + 40 + i)
            label = f"ssd_scan {name} {dt}"
            err, used = ssd_check.check_scan(args, chunk, label)
            row = dict(case=name, dtype=str(dt).split(".")[-1], B=b, S=S,
                       H=h, P=p, N=n, chunk=chunk, max_abs_err=err,
                       tolerance_used=used)
            log(f"{label}: share of the f32 bound used (max |d| / "
                f"(F32_RTOL max |plain|)): y {used['y']!r}, state "
                f"{used['state']!r}")
            if name in timed:
                Q = min(chunk, S)
                n_chunks = -(-S // Q)
                # only j <= t of a chunk: C B^T (head-independent with one
                # group, once a (row, chunk)) and the intra product M x;
                # C state^T and the state update are 2 Q P N each
                tri = Q * (Q + 1)
                n_ops = b * n_chunks * (tri * n + h * (tri * p
                                                       + 4 * Q * p * n))
                n_bytes = (2 * args[0].numel() + args[3].numel()
                           + args[4].numel()) * args[0].element_size() \
                    + (args[1].numel() + 2 * h + b * h * p * n) * 4

                def kern():
                    return ssd_scan(*args, chunk=chunk)

                def plain():
                    return ssd_scan_ref(*(a.float() for a in args),
                                        chunk=chunk)
                b_ms, b_by, f32_ms = attn_bound(n_bytes, n_ops, dt)
                # from the first trace that holds the kernel: one trace in
                # a whole run held none (hybrid, N 64); raises after
                # TRACE_TRIES empty traces
                with torch.inference_mode():
                    row.update(ms=event_ms(kern, reps=20),
                               device_ms=traced(lambda: device_ms(
                                   kern, ssd_check.KERNEL_NAMES, reps=20),
                                   label),
                               plain_ms=event_ms(plain, reps=5),
                               library_ms=None, bound_ms=b_ms, bound_by=b_by,
                               bound_f32_core_ms=f32_ms, flops=n_ops,
                               bytes=n_bytes)
                log(f"{label}: max |d| {err!r}; kernel {row['ms']:.4f} "
                    f"ms/call (device, cold L2 {row['device_ms']}), plain "
                    f"{row['plain_ms']:.4f} ms, no one PyTorch call, bound "
                    f"{b_ms:.5f} ms ({b_by}; {n_ops / 1e9:.4f} GFLOP, "
                    f"{n_bytes / 1e6:.2f} MB; f32 CUDA-core line "
                    f"{f32_ms:.5f} ms)")
            else:
                log(f"{label}: max |d| {err!r} (within tolerance)")
            rows[(name, row["dtype"])] = row
    if n_state != ssd_check.CASES[0][5]:
        return rows
    name, b, S, h, p, n, chunk = ssd_check.CASES[0]
    check_kernel_of_each_dtype(
        "ssd_scan", ssd_check,
        lambda dt: ssd_check.kernels_launched(
            ssd_check.operands(b, S, h, p, n, dt, DEVICE, SEED), chunk,
            seconds=TRACE_SECONDS))
    ssd_check.check_refusals(DEVICE)
    log("ssd_scan: refuses unbuilt (P, N) (32, 16) and (64, 32) and a "
        "chunk over 128")
    return rows


def run_ssm() -> list:
    """Mamba2 serving at full mamba2-370m width: the scan kernel against
    its plain version, then the ssm serving cell; -> its record."""
    sc = check_ssd_scan()
    served_run = run_serving(SSM_CFG, ssm_cell)
    main = sc[("prefill B4 S500", "bfloat16")]
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "bound_f32_core_ms", "max_abs_err")
    return [dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:85",
        design="one block per (head, row) walking the chunks, the f32 "
               "state in registers, S unpadded; bf16: wgmma (m64n64k16, "
               "m64n128k16) fed by TMA (2 stages behind mbarriers, 128B "
               "swizzle), two warpgroups, M, the state and x*w split into "
               "bf16 hi + lo, a warp-shuffle cumsum; f32: 3xTF32 wgmma "
               "(m64n64k8, m64n128k8) in 64-row steps, one TMA stage, x "
               "and (w B) transposed, the state's registers the A operand "
               "of C state^T",
        launches=served_run["launches"]["ssd_scan"],
        max_abs_err=max(r["max_abs_err"] for r in sc.values()),
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=None,
        device_ms=main["device_ms"],
        bound_f32_core_ms=main["bound_f32_core_ms"],
        shape=f"B {main['B']}, S {main['S']}, H {main['H']}, P "
              f"{main['P']}, N {main['N']}, chunk {main['chunk']}, bf16",
        float32={k: sc[("prefill B4 S500", "float32")][k] for k in keys})]


def lm_phase(name: str, run, *args):
    """``run(*args)``, its wall time logged as the phase's."""
    t0 = time.perf_counter()
    out = run(*args)
    log(f"{name} phase: {time.perf_counter() - t0:.1f} s wall")
    return out


CELL_KEYS = ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
             "bound_by", "bound_f32_core_ms", "max_abs_err")


def cell_entry(rows, case: str, shape: str) -> dict:
    """A kernels-line entry of one timed case: its record's numbers in
    both dtypes, SDPA's device time (flash) or the launch's thread blocks
    (decode, bf16) beside them."""
    entry = {dt: {k: rows[(case, dt)].get(k) for k in CELL_KEYS}
             for dt in ("bfloat16", "float32")}
    for dt in entry:
        if "library_device_ms" in rows[(case, dt)]:
            entry[dt]["library_device_ms"] = \
                rows[(case, dt)]["library_device_ms"]
    if "blocks" in rows[(case, "bfloat16")]:
        entry["bfloat16"]["blocks"] = rows[(case, "bfloat16")]["blocks"]
    return dict(shape=shape, **entry)


def add_cell(kernels: list, key: str, served_run: dict, entries) -> None:
    """Each ``(name, rows, {sub-entry: (case, shape)})`` of ``entries``
    gives kernel ``name``'s record a ``key`` entry (the first sub-entry
    at its top, the rest under their names), ``launches_<key>`` (the
    cold generate's count) and the largest error of ``rows``; the decode
    record also the cell's timed decode step beside its weights'
    bound."""
    by_name = {k["name"]: k for k in kernels}
    perf = served_run["perf"]
    for name, rows, subs in entries:
        rec = by_name[name]
        (_, (case, shape)), *rest = subs.items()
        entry = cell_entry(rows, case, shape)
        for sub, (sub_case, sub_shape) in rest:
            entry[sub] = cell_entry(rows, sub_case, sub_shape)
        if name == "decode_attention":
            entry["serve_decode_ms_per_step"] = perf["decode_ms_per_step"]
            entry["serve_decode_weight_bound_ms"] = \
                perf["decode_weight_bound_ms"]
        rec[key] = entry
        rec[f"launches_{key}"] = served_run["launches"][name]
        rec["max_abs_err"] = max(rec["max_abs_err"],
                                 max(r["max_abs_err"] for r in rows.values()))


def run_hybrid(kernels: list) -> None:
    """Zamba2 serving at full zamba2-7b width and ``HYBRID_GROUPS`` of its
    13 groups (33 of 81 layers: 5 groups of 5 Mamba2 layers and a shared
    block, 3 tail layers; d_model 3584, 32 of 32 heads of 112, d_ff
    14336, 112 SSM heads of P 64, N 64): the three
    kernels' instances at its shapes against their plain versions (head
    dim 112; (P, N) = (64, 64)), timed, then the hybrid serving cell.
    Each of ``kernels``' flash_attention, decode_attention and ssd_scan
    records gains a ``hybrid`` entry (the new instance's times, bound
    and error) and ``launches_hybrid`` (the cold generate's count)."""
    fa = check_flash_attention(flash_check.HYBRID_HEADS,
                               timed=("D112 S500 causal",
                                      "D112 S512 causal"))
    da = check_decode_attention((decode_check.HYBRID_CASE,),
                                timed=(decode_check.HYBRID_CASE[0],))
    sc = check_ssd_scan(64, timed=(ssd_check.HYBRID_CASE[0],))
    served_run = run_serving(HYBRID_CFG, hybrid_cell)
    add_cell(kernels, "hybrid", served_run, (
        ("flash_attention", fa, {"S500": (
            "D112 S500 causal",
            "B 4, S 500, Hq 32, Hkv 32, D 112, causal")}),
        ("decode_attention", da, {"S1024": (
            decode_check.HYBRID_CASE[0], "B 4, S 1024, Hq 32, Hkv 32, D "
            "112, kv_len (1, 61, 512, 1024)")}),
        ("ssd_scan", sc, {"S500": (
            ssd_check.HYBRID_CASE[0],
            "B 4, S 500, H 112, P 64, N 64, chunk 128")})))


def run_moe(kernels: list) -> None:
    """deepseek-moe-16b serving at full width (28 layers: 1 dense and 27
    MoE layers of 64 routed experts, top-6, and 2 shared; d_model 2048,
    16 of 16 heads of 128, vocab 102,400; its weights held in bf16): the
    attention kernels' head-dim-128 instances against their plain
    versions (flash at S 500 and 512 at its heads and at S 512 at the
    other configs' head layouts; decode at B 4, S 1024 at every layout),
    its own timed beside SDPA, then the MoE serving cell, whose f32 check
    copy has 14 of the 28 layers.  Each of ``kernels``' flash_attention
    and decode_attention records gains a ``moe`` entry (the D 128
    instance's times, bound and error; the decode record the timed
    decode step against its weights' bound) and ``launches_moe`` (the
    cold generate's count)."""
    torch.cuda.empty_cache()
    fa = check_flash_attention(flash_check.MOE_HEADS,
                               timed=("D128 S500 causal",
                                      "D128 S512 causal"))
    for heads in flash_check.D128_LAYOUTS.values():
        fa.update(check_flash_attention(heads, timed=()))
    da = check_decode_attention(decode_check.D128_CASES,
                                timed=(decode_check.MOE_CASE[0],))
    served_run = run_serving(MOE_CFG, moe_cell, f32_of=moe_f32_copy)
    add_cell(kernels, "moe", served_run, (
        ("flash_attention", fa, {"S500": (
            "D128 S500 causal",
            "B 4, S 500, Hq 16, Hkv 16, D 128, causal")}),
        ("decode_attention", da, {"S1024": (
            decode_check.MOE_CASE[0], "B 4, S 1024, Hq 16, Hkv 16, D 128, "
            "kv_len (1, 61, 512, 1024)")})))


def run_vlm(kernels: list) -> None:
    """pixtral-12b serving at full width (40 layers, d_model 5120, 32 of 8
    heads of 128, d_ff 14336, vocab 131,072; its weights held in bf16;
    1024 patch embeddings a prompt, drawn from ``SEED``): the attention
    kernels' instances at its shapes against their plain versions (flash
    at S 1524, its longest prompt, and S 512, causal; decode at B 4, S
    2048 with its prompts' lengths), timed beside SDPA, then the vlm
    serving cell, whose f32 check copy has ``VLM_F32_LAYERS`` layers.
    Each of ``kernels``' flash_attention and decode_attention records
    gains a ``vlm`` entry and ``launches_vlm``."""
    torch.cuda.empty_cache()
    long_case = "D128 pixtral-12b S1524 causal"
    fa = check_flash_attention(flash_check.PIXTRAL_HEADS,
                               timed=(long_case,
                                      "D128 pixtral-12b S512 causal"))
    da = check_decode_attention((decode_check.VLM_CASE,),
                                timed=(decode_check.VLM_CASE[0],))
    served_run = run_serving(VLM_CFG, vlm_cell, f32_of=vlm_f32_copy)
    add_cell(kernels, "vlm", served_run, (
        ("flash_attention", fa, {"S1524": (
            long_case, "B 4, S 1524, Hq 32, Hkv 8, D 128, causal")}),
        ("decode_attention", da, {"S2048": (
            decode_check.VLM_CASE[0], "B 4, S 2048, Hq 32, Hkv 8, D 128, "
            "kv_len (1, 1085, 1524, 2048)")})))


def run_encdec(kernels: list) -> None:
    """whisper-small serving at full width (12 encoder and 12 decoder
    layers, d_model 768, 12 of 12 heads of 64, QKV bias, tied
    embeddings; 1500 audio frames a prompt, drawn from ``SEED``): the
    attention kernels' instances at its shapes against their plain
    versions (flash: the encoder's 1500 keys non-causal, the
    cross-attention's 500 queries against 1500 keys, the decoder's S 500
    causal; decode: its self-attention at the serving lengths and its
    cross-attention over all 1500 frames, and an 8-step CUDA-graph
    replay of the latter), timed beside SDPA, then the encdec serving
    cell.  Each of ``kernels``' flash_attention and decode_attention
    records gains an ``encdec`` entry (the encoder's and the cross call
    at its top, the others under their names) and ``launches_encdec``."""
    torch.cuda.empty_cache()
    enc, cross, dec = ("D64 MHA12 S1500 non-causal",
                       "D64 MHA12 Sq500 Skv1500 non-causal",
                       "D64 MHA12 S500 causal")
    fa = check_flash_attention(flash_check.WHISPER_HEADS,
                               timed=(enc, cross, dec))
    da = check_decode_attention(
        (decode_check.ENCDEC_CASE, decode_check.CROSS_CASE),
        timed=(decode_check.ENCDEC_CASE[0], decode_check.CROSS_CASE[0]))
    err = decode_check.check_cross_graph_replay(DEVICE, SEED + 31)
    log(f"decode_attention: the cross call captured in a CUDA graph and "
        f"replayed for 8 steps with a new query each, max |d| {err!r} "
        "(within tolerance)")
    served_run = run_serving(ENCDEC_CFG, encdec_cell)
    heads = "Hq 12, Hkv 12, D 64"
    add_cell(kernels, "encdec", served_run, (
        ("flash_attention", fa, {
            "encoder": (enc, f"B 4, S 1500, {heads}, non-causal"),
            "cross": (cross, f"B 4, Sq 500, Skv 1500, {heads}, "
                             "non-causal"),
            "decoder_self": (dec, f"B 4, S 500, {heads}, causal")}),
        ("decode_attention", da, {
            "cross": (decode_check.CROSS_CASE[0],
                      f"B 4, S 1500, {heads}, kv_len 1500 every row"),
            "self": (decode_check.ENCDEC_CASE[0],
                     f"B 4, S 1024, {heads}, kv_len (1, 61, 512, 1024)")})))

# ---------------------------------------------------------------------------
# LM training: Model.loss and TrainStep through flash_attention and its
# backward kernel
# ---------------------------------------------------------------------------

# qwen2-0.5b at full width and depth (24 layers, d 896, vocab 151,936),
# f32 masters with cast_bf16, on TokenPipeline batches (seed SEED): the
# held steps at B 4, S 1024, then train_4k's sequence length with B 4 as
# accum 4 (train_4k's global batch of 256 cut to 4 for one card and the
# script's time)
TRAIN_CFG = LM_CFG
TRAIN_STEPS = 3
TRAIN_BATCH, TRAIN_SEQ = 4, 1024
TRAIN_LONG_SEQ, TRAIN_LONG_ACCUM = TRAIN_4K.seq_len, 4
TRAIN_LR = 1e-4
# the kernel route's steps against the plain route's (attention through
# flash_attention_ref under autograd) on the same weights and batches:
# each step's loss within TRAIN_LOSS_RTOL of the plain one, and each
# leaf of the first step's gradient within TRAIN_GRAD_RTOL of the plain
# leaf in relative L2 (bf16 activations: the kernels round where the
# plain version does not); a planted fault (the backward's dK dropped)
# must break the gradient check.  A leaf whose plain gradient is below
# TRAIN_GRAD_FLOOR of the whole gradient's norm is held to that instead
# of its own norm: the key biases of attention without rope (whisper's)
# have a true gradient of 0, since the softmax ignores a shift common to
# a row's scores, and both routes give rounding noise there (its
# relative gap read 7.0 on the card)
TRAIN_LOSS_RTOL = 2e-3
TRAIN_GRAD_RTOL = 5e-2
TRAIN_GRAD_FLOOR = 1e-4
# the other attention families at full width, cut to 2 layers (the
# encdec family 2 encoder and 2 decoder layers): one step each at
# (batch, sequence), held to the plain route the same way
TRAIN_FAMILIES = (
    (dataclasses.replace(get_config("deepseek-moe-16b"), n_layers=2),
     2, 1024),
    (dataclasses.replace(get_config("pixtral-12b"), n_layers=2), 2, 1536),
    (dataclasses.replace(get_config("whisper-small"), n_layers=2,
                         n_encoder_layers=2), 2, 448))
# the SSD families (ROADMAP item 12g.1b), through ssd_scan's forward and
# backward kernels: mamba2-370m at full width and depth (48 layers, d
# 1024, vocab 50,280), TRAIN_STEPS steps at (TRAIN_BATCH, TRAIN_SEQ), and
# zamba2-7b at full width cut to 1 group of 1 SSM layer and the shared
# block and 1 tail layer (the (64, 64) scan at H 112 and flash's backward
# at D 112), one step at (batch, sequence); each held to the plain route
# (the scan through ssd_scan_ref, attention through flash_attention_ref,
# under autograd) as qwen2-0.5b is
TRAIN_SSM_CFG = SSM_CFG
TRAIN_HYBRID = (dataclasses.replace(
    get_config("zamba2-7b"), n_layers=3,
    hybrid=dataclasses.replace(get_config("zamba2-7b").hybrid,
                               n_groups=1, ssm_per_group=1, tail_ssm=1)),
    2, 1024)
# mamba2-370m's 48 layers carry bf16 rounding far: the kernel forward
# with the plain backward (``_scan_bwd_plain``) reads 0.20 of a leaf's
# gradient from the plain route (the forwards' rounding alone), the
# kernel backward against the plain backward on the kernel forward 0.022,
# and f32 activations (no cast) 4.5e-5 for every leaf (NVIDIA H100 80GB
# HBM3, 700 W).  So its bf16 gradients are held to the plain route
# within TRAIN_SSM_BF16_GRAD_RTOL, to the kernel forward with the plain
# backward within TRAIN_GRAD_RTOL, and in f32 to the plain route within
# TRAIN_SSM_F32_GRAD_RTOL; the planted fault (dx dropped) reads 0.99
TRAIN_SSM_BF16_GRAD_RTOL = 0.3
TRAIN_SSM_F32_GRAD_RTOL = 1e-3
# the scan backward's calls in those steps, checked and timed beside the
# plain backward (autograd of ssd_scan_ref): (label, b, S, H, P, N, chunk)
SSD_BWD_CALLS = (("mamba2-370m train call", TRAIN_BATCH, TRAIN_SEQ, 32, 64,
                  128, 128),
                 ("zamba2-7b train call", 2, 1024, 112, 64, 64, 128))
# the example's LM (examples/torch_train_lm.py) at its 300 steps; then a
# supervised run of its model that crashes once and resumes, against one
# that does not: SUPERVISED_STEPS steps, a checkpoint every
# SUPERVISED_EVERY, the crash at step SUPERVISED_CRASH
TRAIN_LM_STEPS = 300
SUPERVISED_STEPS, SUPERVISED_EVERY, SUPERVISED_CRASH = 30, 10, 17


def bwd_bound(q, k, causal: bool, kv_valid: int):
    """(bytes, operations) of one backward call: q, k, v, o, dO, dQ, dK
    and dV each moved once; 10 D flops for each visible (query, key)
    pair of each query head (the recomputed Q K^T, dP = dO V^T, dV, dQ,
    dK: 2.5 times the forward's 4 D)."""
    Bq, Sq, Hq, D = q.shape
    Skv = k.shape[1]
    n_valid = kv_valid or Skv
    qpos = np.arange(Sq) + (Skv - Sq)
    seen = np.clip(np.minimum(qpos + 1, n_valid) if causal
                   else np.full(Sq, n_valid), 0, None)
    n_ops = Bq * Hq * 10 * D * int(seen.sum())
    n_bytes = (4 * q.numel() + 4 * k.numel()) * q.element_size()
    return n_bytes, n_ops


def sdpa_backward_device_ms(fn, reps: int = 10):
    """Device time per call of the SDPA backward op (``aten::
    _scaled_dot_product_*_backward``, children included) inside ``fn``;
    None if the profiler attributed none to it."""
    for ev in profiled_cold(fn, reps).key_averages():
        if ev.key.startswith("aten::_scaled_dot_product") \
                and ev.key.endswith("_backward") and ev.count:
            total = device_us(ev)
            return total / ev.count / 1e3 if total else None
    return None


def sdpa_backward_alone(qt, kt, vt, dt, causal: bool) -> dict:
    """SDPA's backward alone (``enable_gqa``), over one kept forward
    graph (``torch.autograd.grad(..., retain_graph=True)``): its events
    ms, and the device ms of every kernel, copy and set it runs, summed
    from the raw trace of 10 calls with the L2 overwritten before each by
    an int32 ``bitwise_not_`` (left out of the sum); None if the trace
    held nothing else (a launch the trace dropped reads short).  Every
    dtype: SDPA's f32 path has no backward op of its own to read."""
    from torch.profiler import ProfilerActivity, profile
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                             enable_gqa=True)

    def bwd():
        return torch.autograd.grad(out, (qt, kt, vt), dt, retain_graph=True)
    reps = 10
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                        device=DEVICE)
    bwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.bitwise_not_()
            bwd()
        torch.cuda.synchronize()
    per_name, _, _ = trace_sums(prof)
    total = sum(us for name, us in per_name.items()
                if "bitwise_not" not in name)
    return dict(ms=event_ms(bwd, reps=10, warmup=2),
                device_ms=total / reps / 1e3 if total else None)


def time_bwd(q, k, v, o, dout, causal: bool, kv_valid: int = 0) -> dict:
    """The backward kernel at one shape: events and device ms (by
    kernel: dQ, dK/dV and, with Hq > Hkv in bf16, the partials' sum), the
    plain backward, SDPA forward + backward under ``torch.autograd.grad``
    (``enable_gqa``; its backward op's device ms) and its backward alone
    (``sdpa_backward_alone``), and the bound."""
    n_bytes, n_ops = bwd_bound(q, k, causal, kv_valid)
    b_ms, b_by, f32_ms = attn_bound(n_bytes, n_ops, q.dtype)
    names = flash_check.bwd_kernel_names(q.dtype, q.shape[2] // k.shape[2])

    def kern():
        return flash_attention_bwd(q, k, v, o, dout, causal=causal,
                                   kv_valid=kv_valid)

    def plain():
        return flash_attention_bwd_ref(q, k, v, o, dout, causal=causal,
                                       kv_valid=kv_valid)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    dt = dout.transpose(1, 2)

    def sdpa():
        with torch.enable_grad():
            out = F.scaled_dot_product_attention(qt, kt, vt,
                                                 is_causal=causal,
                                                 enable_gqa=True)
            return torch.autograd.grad(out, (qt, kt, vt), dt)
    lib = None if kv_valid or (causal and q.shape[1] != k.shape[1]) \
        else sdpa
    # the call's kernels from one trace, or None (a trace can drop one of
    # them: a sum of the others would read short); three traces at most
    for _ in range(3):
        by_kernel = device_ms_by_kernel(kern, names, reps=10)
        if None not in by_kernel.values():
            break
        time.sleep(TRACE_PAUSE_S)
    return dict(ms=event_ms(kern, reps=10, warmup=2),
                device_ms=None if None in by_kernel.values()
                else sum(by_kernel.values()),
                device_ms_by_kernel=by_kernel,
                plain_ms=event_ms(plain, reps=3, warmup=1),
                library_ms=event_ms(lib, reps=10, warmup=2)
                if lib else None,
                library_backward_device_ms=sdpa_backward_device_ms(lib)
                if lib else None,
                library_backward_alone=sdpa_backward_alone(
                    qt, kt, vt, dt, causal) if lib else None,
                bound_ms=b_ms, bound_by=b_by, bound_f32_core_ms=f32_ms,
                flops=n_ops, bytes=n_bytes)


def check_flash_attention_bwd() -> dict:
    """The backward kernel against its plain version on the card over
    ``flash_check.BWD_CASES`` (both dtypes; head dims 64, 112, 128; two
    bf16 calls give the same bits), the planted faults on the qwen2-0.5b
    S 500 case in both dtypes, the kernels each dtype and group launches
    (by profiler name), then timed at the S 500 case and at the train
    step's call (B 1, S 4096, Hq 14, Hkv 2, D 64, causal, bf16).  ->
    {"cases": {...}, "main": record, "s500": {dtype: record}}."""
    # bf16 with a group of 7 (three kernels) and of 1 (two), and f32
    for case in flash_check.BWD_CASES:
        if case[0] != "S500 causal" and (
                case[0] != "D64 MHA12 Sq500 Skv1500 non-causal"
                or case[1] != torch.bfloat16):
            continue
        hq, hkv, _ = case[6]
        label = f"flash_attention_bwd {flash_check.case_id(case)}"
        got = traced_kernels(lambda: flash_check.bwd_kernels_launched(
            case, DEVICE, seconds=TRACE_SECONDS), label)
        want = set(flash_check.bwd_kernel_names(case[1], hq // hkv))
        if got != want:
            raise AssertionError(f"{label}: the trace holds {sorted(got)},"
                                 f" expected {sorted(want)}")
        log(f"{label}: launches {sorted(got)} only")
    cases = {}
    for i, case in enumerate(flash_check.BWD_CASES):
        err, rel = flash_check.check_bwd_case(case, DEVICE, SEED + 50 + i)
        cases[flash_check.case_id(case)] = dict(max_abs_err=err,
                                                max_rel_err=rel)
        log(f"flash_attention_bwd {flash_check.case_id(case)}: max |d| "
            f"{err!r}, max |d| / max |plain| {rel!r} (within tolerance)")
    s500 = {}
    for case in flash_check.BWD_CASES:
        if case[0] != "S500 causal":
            continue
        reads = flash_check.check_bwd_faults(case, DEVICE, SEED)
        log(f"flash_attention_bwd planted faults "
            f"{flash_check.case_id(case)} (max |d| / max |plain|, each "
            f"outside the tolerance): {json.dumps(reads)}")
        q, k, v, o, dout = flash_check.bwd_case_operands(case, DEVICE, SEED)
        row = time_bwd(q, k, v, o, dout, True)
        s500[str(case[1]).split(".")[-1]] = row
        log(f"flash_attention_bwd {flash_check.case_id(case)} timed: "
            f"{json.dumps(row)}")
    Hq, Hkv, D = flash_check.HQ, flash_check.HKV, flash_check.D
    q, k, v, dout = flash_check.operands(
        [(1, TRAIN_LONG_SEQ, Hq, D), (1, TRAIN_LONG_SEQ, Hkv, D),
         (1, TRAIN_LONG_SEQ, Hkv, D), (1, TRAIN_LONG_SEQ, Hq, D)],
        torch.bfloat16, DEVICE, SEED + 90)
    with torch.inference_mode():
        o = flash_attention(q, k, v)
    err, rel = flash_check.check_bwd(q, k, v, o.clone(), dout, True, 0,
                                     "flash_attention_bwd train call")
    main = time_bwd(q, k, v, o.clone(), dout, True)
    main.update(max_abs_err=err, max_rel_err=rel)
    log(f"flash_attention_bwd train call B 1, S {TRAIN_LONG_SEQ}, Hq {Hq}, "
        f"Hkv {Hkv}, D {D}, causal, bf16: {json.dumps(main)}")
    return {"cases": cases, "main": main, "s500": s500}


def train_batch(cfg, batch: int, seq: int, step: int, pipe=None) -> dict:
    """``TokenPipeline`` tokens (seed ``SEED``) and the frontend
    embeddings the family reads (drawn from ``SEED`` + step on the
    card)."""
    pipe = pipe or TokenPipeline(cfg.vocab_size, batch, seq, seed=SEED)
    out = pipe.batch_at(step)
    key = {"vlm": "patch_embeds", "encdec": "audio_embeds"}.get(cfg.family)
    if key:
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(SEED + step)
        out[key] = torch.randn((batch, cfg.frontend.n_embeds, cfg.d_model),
                               generator=gen, device=DEVICE)
    return out


def attention_plain():
    """The attention of every layer through the plain version under
    autograd (the script routes it; the package has no switch)."""
    return wrapped(lm_attention, "flash_attention",
                   lambda _: flash_attention_ref)


def scan_plain():
    """The scan of every SSM layer through the plain version under
    autograd."""
    return wrapped(lm_ssm, "ssd_scan", lambda _: ssd_scan_ref)


TRAIN_COUNTERS = {"flash_attention": flash_attention,
                  "flash_attention_bwd": flash_attention_bwd,
                  "ssd_scan": ssd_scan, "ssd_scan_bwd": ssd_scan_bwd}


def _bwd_drops_dk(fn):
    def wrapper(ctx, dout):
        dq, dk, dv, *rest = fn(ctx, dout)
        return (dq, torch.zeros_like(dk), dv, *rest)
    return wrapper


def train_route(cfg, batches: list, plain: bool, fault=None,
                accum: int = 1, held: Optional[str] = "params",
                cast_bf16: bool = True) -> dict:
    """Fresh weights (seed ``SEED``) trained one step a batch through the
    kernels (or the plain route: attention and the scan through their
    plain versions; ``fault`` an (owner, name, wrap) planted with
    ``wrapped``): the first batch's gradients, with
    ``held`` "params" as the reference's leaves (``lm_to_params``, on the
    host), with "device" one f32 tensor a parameter left on the card
    (no host copy of a model of billions of weights); each step's
    metrics, wall seconds and peak memory, the kernels' launches of the
    steps and the route's wall."""
    t_route = time.perf_counter()
    torch.cuda.empty_cache()
    model = build_model(cfg)
    weights = model.init_params(SEED, device=DEVICE)
    opt = adamw(weights.parameters(), lr=TRAIN_LR)
    ts = build_train_step(model, opt, accum=accum, cast_bf16=cast_bf16)
    routes = [attention_plain(), scan_plain()] if plain else []
    if fault is not None:
        routes.append(wrapped(*fault))
    with contextlib.ExitStack() as stack:
        for r in routes:
            stack.enter_context(r)
        grads = None
        if held == "device":
            g, _ = ts.grads(weights, batches[0])
            grads = {name: x for (name, _), x in
                     zip(weights.named_parameters(), g)}
        elif held == "params":
            g, _ = ts.grads(weights, batches[0])
            with torch.no_grad():
                for p, x in zip(ts._params(), g):
                    p.grad = x.to(p.dtype)
            grads = lm_to_params(weights, grads=True)
            del g
            for p in ts._params():
                p.grad = None
        steps = []
        for counter in TRAIN_COUNTERS.values():
            counter.launches = 0
        for b in batches:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            metrics = ts(weights, b)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            steps.append(dict(
                {k: float(v) for k, v in metrics.items()}, seconds=wall,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30))
        launches = {k: c.launches for k, c in TRAIN_COUNTERS.items()}
    del weights, opt, ts
    torch.cuda.empty_cache()
    return dict(grads=grads, steps=steps, launches=launches,
                seconds=time.perf_counter() - t_route)


def _leaves(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", val


def _norm(x) -> float:
    if isinstance(x, torch.Tensor):
        return float(torch.linalg.vector_norm(x))
    return float(np.linalg.norm(x))


def grads_gap(got: dict, want: dict) -> Tuple[float, str]:
    """The largest relative L2 gap of a gradient leaf (against the
    larger of its plain norm and TRAIN_GRAD_FLOOR of the whole plain
    gradient's), and its path; leaves numpy (the reference's tree) or
    tensors (one a parameter)."""
    want_leaves = dict(_leaves(want))
    whole = math.sqrt(sum(_norm(w) ** 2 for w in want_leaves.values()))
    worst, at = 0.0, ""
    for path, g in _leaves(got):
        w = want_leaves[path]
        norm = max(_norm(w), TRAIN_GRAD_FLOOR * whole)
        gap = _norm(g - w) / norm
        if gap > worst:
            worst, at = gap, path
    return worst, at


def held_to_plain(label: str, kern: dict, plain: dict,
                  grad_rtol: float = TRAIN_GRAD_RTOL) -> dict:
    """The kernel route's losses and first gradients against the plain
    route's; raises outside TRAIN_LOSS_RTOL / ``grad_rtol``."""
    gap, at = grads_gap(kern["grads"], plain["grads"])
    losses = [(s["loss"], p["loss"]) for s, p in zip(kern["steps"],
                                                     plain["steps"])]
    loss_gap = max(abs(a - b) / abs(b) for a, b in losses)
    log(f"train {label}: losses kernel/plain {losses}, largest relative "
        f"gap {loss_gap!r}; first-step gradients: largest leaf relative L2 "
        f"gap {gap!r} at {at}; routes {kern['seconds']:.1f} s / "
        f"{plain['seconds']:.1f} s wall")
    if loss_gap > TRAIN_LOSS_RTOL or gap > grad_rtol:
        raise AssertionError(f"train {label}: kernel route off the plain "
                             f"route (loss {loss_gap!r}, gradient {gap!r} "
                             f"at {at})")
    return dict(loss_gap=loss_gap, grad_gap=gap, grad_gap_at=at,
                losses=losses)


def time_ssd_bwd(call) -> dict:
    """The scan's backward kernel at one call (bf16): events and device
    ms (by kernel), the plain backward (autograd of ``ssd_scan_ref`` on
    the same bf16 leaves, as the plain train route runs it) and the
    bound; no one PyTorch call computes it."""
    label, b, S, H, P, N, chunk = call
    *fwd, dy, dfin = ssd_check.bwd_operands(call, torch.bfloat16, DEVICE,
                                            SEED + 95)
    n_bytes, n_ops = ssd_check.bwd_bound(b, S, H, P, N, 2)
    b_ms, b_by, f32_ms = attn_bound(n_bytes, n_ops, torch.bfloat16)

    def kern():
        return ssd_scan_bwd(*fwd, dy, dfin)
    leaves = [t.detach().requires_grad_(True) for t in fwd]
    with torch.enable_grad():
        y, _ = ssd_scan_ref(*leaves, chunk=chunk)

    def plain():
        return torch.autograd.grad(y, leaves, dy, retain_graph=True)

    # the call's kernels from one trace of 100 calls, or None (a trace
    # late in the process can drop some or all of them); three at most
    for _ in range(3):
        per_kernel = device_ms_by_kernel(kern, ssd_check.BWD_KERNEL_NAMES,
                                         reps=100)
        if None not in per_kernel.values():
            break
        time.sleep(TRACE_PAUSE_S)
    if None in per_kernel.values():
        log(f"WARNING ssd_scan_bwd {label}: three profiler traces of 100 "
            f"calls held no device time for "
            f"{[k for k, v in per_kernel.items() if v is None]}; its "
            "device_ms is null in this run (ms, by CUDA events, stands)")
    return dict(ms=event_ms(kern, reps=10, warmup=2),
                device_ms=None if None in per_kernel.values()
                else sum(per_kernel.values()),
                device_ms_by_kernel=per_kernel,
                plain_ms=event_ms(plain, reps=3, warmup=1),
                bound_ms=b_ms, bound_by=b_by, bound_f32_core_ms=f32_ms,
                flops=n_ops, bytes=n_bytes)


def check_ssd_scan_bwd() -> dict:
    """The scan's backward kernel against its plain version on the card
    over ``ssd_check.CASES`` in both dtypes (a final state's gradient in
    ``BWD_FINAL_CASE``; two bf16 calls give the same bits), the planted
    faults (the carried dS dropped, dB summed over one head) in both
    dtypes, the three kernels a call launches by profiler name, and each
    of ``SSD_BWD_CALLS`` checked and timed (``time_ssd_bwd``).  ->
    {"cases", "plants", "calls"}."""
    cases, plants, calls = {}, {}, {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        for i, case in enumerate(ssd_check.CASES):
            r = ssd_check.check_bwd_case(case, dt, DEVICE, SEED + 60 + i)
            cases[f"{case[0]} {name}"] = r
            log(f"ssd_scan_bwd {case[0]} {name}: max |d| "
                f"{r['max_abs_err']!r}, shares of the f32 bound "
                f"{json.dumps(r['shares'])} (within tolerance)")
        plants[name] = ssd_check.check_bwd_plants(ssd_check.CASES[0], dt,
                                                  DEVICE, SEED)
        log(f"ssd_scan_bwd planted faults {ssd_check.CASES[0][0]} {name} "
            f"(max |d| / max |plain| of each output outside the "
            f"tolerance): {json.dumps(plants[name])}")
    for call in SSD_BWD_CALLS:
        args = ssd_check.bwd_operands(call, torch.bfloat16, DEVICE, SEED + 95)
        err, shares, _ = ssd_check.check_bwd(args, f"ssd_scan_bwd {call[0]}")
        got = traced_kernels(lambda: ssd_check.bwd_kernels_launched(
            args, seconds=TRACE_SECONDS), f"ssd_scan_bwd {call[0]}")
        if got != set(ssd_check.BWD_KERNEL_NAMES):
            raise AssertionError(f"ssd_scan_bwd {call[0]}: the trace holds "
                                 f"{sorted(got)}")
        del args
        calls[call[0]] = dict(time_ssd_bwd(call), max_abs_err=err,
                              shares=shares)
        log(f"ssd_scan_bwd {call[0]} (B {call[1]}, S {call[2]}, H "
            f"{call[3]}, N {call[5]}, bf16): launches {sorted(got)}; "
            f"{json.dumps(calls[call[0]])}")
    return {"cases": cases, "plants": plants, "calls": calls}


def _scan_bwd_drops_dx(fn):
    def wrapper(ctx, dy, d_final):
        dx, *rest = fn(ctx, dy, d_final)
        return (torch.zeros_like(dx), *rest)
    return wrapper


def _scan_bwd_plain(fn):
    """``SSDScanFn.backward`` through the plain backward on the card (the
    forward stays the kernel's): isolates the backward kernel."""
    def wrapper(ctx, dy, d_final):
        x, dt, A, B, C, D = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy
        dx, ddt, dA, dB, dC, dD = ssd_check.ssd_scan_bwd_ref(
            x, dt, A, B, C, D, dy, d_final, ctx.chunk)
        return dx, ddt, dA, dB, dC, dD, None
    return wrapper


def train_ssd() -> dict:
    """The SSD families on the card: ``TRAIN_SSM_CFG`` (mamba2-370m at
    full width and depth) ``TRAIN_STEPS`` steps at B ``TRAIN_BATCH``, S
    ``TRAIN_SEQ`` and ``TRAIN_HYBRID`` (cut zamba2-7b) one step, each
    through both scan kernels and held to the plain route; a backward
    that drops dx must break mamba2-370m's gradient check.  -> {config
    name: held, launches, steps}."""
    out = {}
    cfg = TRAIN_SSM_CFG
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=SEED)
    batches = [pipe.batch_at(i) for i in range(TRAIN_STEPS)]
    plain = train_route(cfg, batches, plain=True)
    kern = train_route(cfg, batches, plain=False)
    label = f"{cfg.name} B {TRAIN_BATCH} S {TRAIN_SEQ}"
    held = held_to_plain(label, kern, plain, TRAIN_SSM_BF16_GRAD_RTOL)
    # the kernel forward with the plain backward: the backward kernel
    # alone against the plain backward, and the forwards' rounding alone
    kfpb = train_route(cfg, batches[:1], plain=False,
                       fault=(SSDScanFn, "backward", _scan_bwd_plain))
    bwd_gap, bwd_at = grads_gap(kern["grads"], kfpb["grads"])
    fwd_gap, fwd_at = grads_gap(kfpb["grads"], plain["grads"])
    del kfpb
    f32cfg = dataclasses.replace(cfg, dtype="float32")
    f32 = [train_route(f32cfg, batches[:1], plain=p, cast_bf16=False)
           for p in (True, False)]
    f32_gap, f32_at = grads_gap(f32[1]["grads"], f32[0]["grads"])
    del f32
    log(f"train {label}: the backward kernel against the plain backward on "
        f"the kernel forward, leaf relative L2 gap {bwd_gap!r} at {bwd_at} "
        f"(limit {TRAIN_GRAD_RTOL}); the kernel forward with the plain "
        f"backward against the plain route {fwd_gap!r} at {fwd_at} (the "
        f"forwards' bf16 rounding alone); f32 activations, kernel against "
        f"plain route {f32_gap!r} at {f32_at} (limit "
        f"{TRAIN_SSM_F32_GRAD_RTOL})")
    if bwd_gap > TRAIN_GRAD_RTOL or f32_gap > TRAIN_SSM_F32_GRAD_RTOL:
        raise AssertionError(f"train {label}: backward kernel off the plain "
                             f"backward ({bwd_gap!r} at {bwd_at}) or f32 "
                             f"route off ({f32_gap!r} at {f32_at})")
    held.update(bwd_gap=bwd_gap, fwd_rounding_gap=fwd_gap, f32_gap=f32_gap)
    n = TRAIN_STEPS * cfg.n_layers
    want = {"flash_attention": 0, "flash_attention_bwd": 0, "ssd_scan": n,
            "ssd_scan_bwd": n}
    if kern["launches"] != want or any(plain["launches"].values()):
        raise AssertionError(f"train {label} launches: kernel route "
                             f"{kern['launches']} (want {want}), plain "
                             f"route {plain['launches']}")
    faulty = train_route(cfg, batches[:1], plain=False,
                         fault=(SSDScanFn, "backward", _scan_bwd_drops_dx))
    fault_gap, fault_at = grads_gap(faulty["grads"], plain["grads"])
    log(f"train {label} planted fault (the scan backward's dx dropped): "
        f"leaf relative L2 gap {fault_gap!r} at {fault_at}")
    if fault_gap <= TRAIN_SSM_BF16_GRAD_RTOL:
        raise AssertionError(f"train {label}: the gradient check misses a "
                             "scan backward that drops dx")
    del faulty, plain
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steps = [dict(s, tokens_per_s=tokens / s["seconds"])
             for s in kern["steps"]]
    for i, s in enumerate(steps):
        log(f"train {label} step {i}: {s['seconds']:.3f} s, "
            f"{s['tokens_per_s']:.0f} tokens/s, peak {s['peak_gib']:.2f} "
            f"GiB, loss {s['loss']:.4f}; launches of the {TRAIN_STEPS} "
            f"steps {kern['launches']}")
    out[cfg.name] = dict(held=held, launches=kern["launches"], steps=steps,
                         fault_gap=fault_gap, fault_at=fault_at)
    del kern
    hcfg, hb, hs = TRAIN_HYBRID
    hbatch = [train_batch(hcfg, hb, hs, 0)]
    h_plain = train_route(hcfg, hbatch, plain=True, held="device")
    h_kern = train_route(hcfg, hbatch, plain=False, held="device")
    label = (f"{hcfg.name} ({hcfg.hybrid.n_groups} group of "
             f"{hcfg.hybrid.ssm_per_group} SSM layer, "
             f"{hcfg.hybrid.tail_ssm} tail layer) B {hb} S {hs}")
    held = held_to_plain(label, h_kern, h_plain)
    if not all(h_kern["launches"].values()) or any(
            h_plain["launches"].values()):
        raise AssertionError(f"train {label} launches: kernel route "
                             f"{h_kern['launches']}, plain route "
                             f"{h_plain['launches']}")
    s = dict(h_kern["steps"][0], tokens_per_s=hb * hs
             / h_kern["steps"][0]["seconds"])
    log(f"train {label}: {s['seconds']:.3f} s, {s['tokens_per_s']:.0f} "
        f"tokens/s, peak {s['peak_gib']:.2f} GiB, loss {s['loss']:.4f}; "
        f"launches {h_kern['launches']}")
    out[hcfg.name] = dict(held=held, launches=h_kern["launches"],
                          steps=[s])
    return out


def run_train(kernels: list) -> None:
    """The LM train step on the card: the attention backward kernel
    against its plain version (``check_flash_attention_bwd``),
    qwen2-0.5b at full width and depth, the other attention families at
    full width and 2 layers, the SSD families (``train_ssd``) and the
    scan's backward kernel against its plain version
    (``check_ssd_scan_bwd``).  Adds the ``flash_attention_bwd`` and
    ``ssd_scan_bwd`` records to ``kernels`` and ``launches_train`` to
    the forwards'."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bwd = check_flash_attention_bwd()
    log(f"train: the backward kernel's checks and timings "
        f"{time.perf_counter() - t0:.1f} s wall")
    cfg = TRAIN_CFG
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=SEED)
    batches = [pipe.batch_at(i) for i in range(TRAIN_STEPS)]
    plain = train_route(cfg, batches, plain=True)
    kern = train_route(cfg, batches, plain=False)
    held = held_to_plain(f"{cfg.name} B {TRAIN_BATCH} S {TRAIN_SEQ}", kern,
                         plain)
    n_layers = cfg.n_layers
    want = {"flash_attention": TRAIN_STEPS * n_layers,
            "flash_attention_bwd": TRAIN_STEPS * n_layers,
            "ssd_scan": 0, "ssd_scan_bwd": 0}
    if kern["launches"] != want or any(plain["launches"].values()):
        raise AssertionError(f"train launches: kernel route "
                             f"{kern['launches']} (want {want}), plain "
                             f"route {plain['launches']}")
    faulty = train_route(cfg, batches[:1], plain=False, fault=(
        flash_attention_ops.FlashAttentionFn, "backward", _bwd_drops_dk))
    fault_gap, fault_at = grads_gap(faulty["grads"], plain["grads"])
    log(f"train planted fault (the backward's dK dropped): leaf relative "
        f"L2 gap {fault_gap!r} at {fault_at}")
    if fault_gap <= TRAIN_GRAD_RTOL:
        raise AssertionError("train: the gradient check misses a backward "
                             "that drops dK")
    del faulty, plain
    # train_4k's sequence length, B 4 as accum 4
    long_pipe = TokenPipeline(cfg.vocab_size, TRAIN_BATCH, TRAIN_LONG_SEQ,
                              seed=SEED)
    long = train_route(cfg, [long_pipe.batch_at(i)
                             for i in range(TRAIN_STEPS)],
                       plain=False, accum=TRAIN_LONG_ACCUM, held=None)
    per_step = {k: n // TRAIN_STEPS for k, n in long["launches"].items()
                if k.startswith("flash")}
    if per_step != {k: n_layers * TRAIN_LONG_ACCUM for k in per_step}:
        raise AssertionError(f"train S {TRAIN_LONG_SEQ}: launches a step "
                             f"{per_step}")
    tokens = TRAIN_BATCH * TRAIN_LONG_SEQ
    long_steps = [dict(s, tokens_per_s=tokens / s["seconds"])
                  for s in long["steps"]]
    for i, s in enumerate(long_steps):
        log(f"train {cfg.name} S {TRAIN_LONG_SEQ} B {TRAIN_BATCH} (accum "
            f"{TRAIN_LONG_ACCUM}) step {i}: {s['seconds']:.3f} s, "
            f"{s['tokens_per_s']:.0f} tokens/s, peak "
            f"{s['peak_gib']:.2f} GiB, loss {s['loss']:.4f}, grad norm "
            f"{s['grad_norm']:.4f}; launches a step {per_step} ("
            f"{n_layers} and {n_layers} a microbatch)")
    for s in kern["steps"]:
        log(f"train {cfg.name} S {TRAIN_SEQ} B {TRAIN_BATCH}: "
            f"{s['seconds']:.3f} s, peak {s['peak_gib']:.2f} GiB, loss "
            f"{s['loss']:.4f}")
    families = {}
    for fcfg, fb, fs in TRAIN_FAMILIES:
        fbatch = [train_batch(fcfg, fb, fs, 0)]
        f_plain = train_route(fcfg, fbatch, plain=True, held="device")
        f_kern = train_route(fcfg, fbatch, plain=False, held="device")
        label = f"{fcfg.name} ({fcfg.n_layers} layers) B {fb} S {fs}"
        families[fcfg.name] = dict(
            held_to_plain(label, f_kern, f_plain),
            launches=f_kern["launches"], step=f_kern["steps"][0])
        if not f_kern["launches"]["flash_attention_bwd"]:
            raise AssertionError(f"train {label}: no backward launch")
        del f_plain, f_kern
    ssd = train_ssd()
    torch.cuda.empty_cache()

    main = bwd["main"]
    by_name = {k["name"]: k for k in kernels}
    by_name["flash_attention"]["launches_train"] = kern["launches"][
        "flash_attention"]
    kernels.append(dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:98",
        replaces_note="no Pallas backward: the reference differentiates "
                      "this forward; the port's gradient of it",
        design="bf16: three kernels on tensor cores (wgmma fed by TMA), "
               "no atomics: dQ a (query tile, head, row) block; dK and dV "
               "a (key tile, query head, row) block writing f32 partials, "
               "summed over the group in head order by a third kernel; P "
               "and dS as bf16 hi + lo; f32: two kernels of f32 FMAs on "
               "CUDA cores (PR 31's)",
        launches=kern["launches"]["flash_attention_bwd"],
        max_abs_err=max(c["max_abs_err"] for c in bwd["cases"].values()),
        max_rel_err=max(c["max_rel_err"] for c in bwd["cases"].values()),
        ms=main["ms"], plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=main["library_ms"], device_ms=main["device_ms"],
        device_ms_by_kernel=main["device_ms_by_kernel"],
        library_backward_device_ms=main["library_backward_device_ms"],
        bound_f32_core_ms=main["bound_f32_core_ms"],
        shape=f"B 1, S {TRAIN_LONG_SEQ}, Hq 14, Hkv 2, D 64, causal, bf16",
        s500=bwd["s500"],
        train=dict(
            cfg=cfg.name, held=held, fault_gap=fault_gap,
            steps_s1024=kern["steps"],
            steps_s4096=long_steps, launches_s4096_per_step=per_step,
            families=families)))
    scan_bwd = check_ssd_scan_bwd()
    main = scan_bwd["calls"][SSD_BWD_CALLS[0][0]]
    by_name["ssd_scan"]["launches_train"] = {
        name: cell["launches"]["ssd_scan"] for name, cell in ssd.items()}
    kernels.append(dict(
        name="ssd_scan_bwd", route="cuda",
        source="src/repro_torch/csrc/ssd_scan_bwd.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:85",
        replaces_note="no Pallas backward: the reference differentiates "
                      "_chunked_jnp; the port's gradient of this forward",
        design="three kernels, no atomics: the chunk-entry states by a "
               "forward sweep into scratch; one block a (head, row) "
               "walking 64-row steps in reverse, dS in shared memory, "
               "f32 FMAs on CUDA cores in 64-row tiles, dB and dC as "
               "per-head f32 partials; their sum in head order",
        launches=ssd[TRAIN_SSM_CFG.name]["launches"]["ssd_scan_bwd"],
        max_abs_err=max(c["max_abs_err"]
                        for c in scan_bwd["cases"].values()),
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=None,
        library_note="none: no one PyTorch call",
        device_ms=main["device_ms"],
        device_ms_by_kernel=main["device_ms_by_kernel"],
        bound_f32_core_ms=main["bound_f32_core_ms"],
        shape="B 4, S 1024, H 32, P 64, N 128, chunk 128, bf16",
        calls=scan_bwd["calls"], cases=scan_bwd["cases"],
        plants=scan_bwd["plants"], train=ssd))


def supervised_run(root: str, crash_at: Optional[int]) -> dict:
    """The example's LM (seed 0) trained ``SUPERVISED_STEPS`` steps under
    a ``Supervisor`` checkpointing every ``SUPERVISED_EVERY`` into
    ``root``; with ``crash_at`` the step function raises once, at that
    step, before its update.  -> {"losses": {step: the loss its last
    run gave}, "leaves": the final ``TrainState.leaves()``, "restarts",
    "seconds"}."""
    ex = example("torch_train_lm")
    cfg = ex.make_100m_config()
    model = build_model(cfg)
    weights = model.init_params(0, device=DEVICE)
    opt = adamw(weights.parameters(),
                lr=cosine_schedule(3e-3, 30, TRAIN_LM_STEPS))
    ts = build_train_step(model, opt, max_grad_norm=1.0)
    pipe = TokenPipeline(cfg.vocab_size, 8, 128, seed=0)
    sup = Supervisor(Checkpointer(root, keep=2),
                     checkpoint_every=SUPERVISED_EVERY)
    losses: Dict[int, float] = {}
    crashed = []

    def step_fn(state, step):
        if step == crash_at and not crashed:
            crashed.append(step)
            raise RuntimeError(f"injected crash at step {step}")
        losses[step] = float(ts(state.weights, pipe.batch_at(step))["loss"])
        return state
    t0 = time.perf_counter()
    state = sup.run(TrainState(weights, opt), step_fn, 0, SUPERVISED_STEPS)
    torch.cuda.synchronize()
    return dict(losses=losses, leaves=state.leaves(), restarts=sup.restarts,
                seconds=time.perf_counter() - t0)


def run_train_lm(kernels: list) -> None:
    """``examples/torch_train_lm.py`` at its ``TRAIN_LM_STEPS`` steps (f32:
    ``flash_attention``'s f32 forward and its backward kernel's f32
    instance), its launch counts set to 0 just before and read just
    after; held: every loss finite, the last 20 steps' mean under a
    tenth of the first loss, and its gap to the bigram floor logged.
    Then ``supervised_run`` crashed at ``SUPERVISED_CRASH`` against one
    not crashed: one restart, and whether every step's loss and the
    final weights and moments agree bit for bit is logged (not held: a
    kernel on the path that sums in a varying order makes them differ),
    with the first step and leaves that differ.  Adds
    ``launches_example`` to the attention records."""
    t_phase = time.perf_counter()
    for counter in TRAIN_COUNTERS.values():
        counter.launches = 0
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as d, \
            contextlib.redirect_stdout(buf):
        t0 = time.perf_counter()
        res = example("torch_train_lm").main(
            ["--device", DEVICE, "--steps", str(TRAIN_LM_STEPS), "--ckpt",
             f"{d}/ckpt"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in TRAIN_COUNTERS.items()}
    losses = res["losses"]
    final = float(np.mean(losses[-20:]))
    log("example torch_train_lm --steps "
        f"{TRAIN_LM_STEPS}: {wall:.1f} s wall, "
        f"{res['tokens_per_s']:.0f} tokens/s; loss {losses[0]:.4f} -> "
        f"{final:.4f} (mean of the last 20), bigram floor "
        f"{res['floor']:.4f} (gap {final - res['floor']:.4f}); launches "
        f"{launches}; its output:\n  "
        + "\n  ".join(ln for ln in buf.getvalue().splitlines() if ln))
    if not np.isfinite(losses).all() or final >= 0.1 * losses[0]:
        raise AssertionError(f"torch_train_lm: loss {losses[0]} -> {final}")
    layers = example("torch_train_lm").make_100m_config().n_layers
    want = TRAIN_LM_STEPS * layers
    if launches["flash_attention"] != want \
            or launches["flash_attention_bwd"] != want:
        raise AssertionError(f"torch_train_lm launches {launches}, want "
                             f"{want} of each attention kernel")
    by_name = {k["name"]: k for k in kernels}
    for name in ("flash_attention", "flash_attention_bwd"):
        by_name[name]["launches_example"] = {
            "torch_train_lm (f32)": launches[name]}
    with tempfile.TemporaryDirectory() as d:
        once = supervised_run(f"{d}/crashed", SUPERVISED_CRASH)
        clean = supervised_run(f"{d}/clean", None)
    if once["restarts"] != 1 or sorted(once["losses"]) != sorted(
            clean["losses"]):
        raise AssertionError(f"supervised run: {once['restarts']} restarts,"
                             f" steps {sorted(once['losses'])}")
    differ = [s for s in sorted(clean["losses"])
              if once["losses"][s] != clean["losses"][s]]
    leaves = [k for k in clean["leaves"]
              if not np.array_equal(once["leaves"][k], clean["leaves"][k])]
    log(f"supervised run of {SUPERVISED_STEPS} steps, a checkpoint every "
        f"{SUPERVISED_EVERY}, crashed once at step {SUPERVISED_CRASH} "
        f"(restored from step "
        f"{SUPERVISED_CRASH // SUPERVISED_EVERY * SUPERVISED_EVERY}) "
        f"against one not crashed ({once['seconds']:.1f} s / "
        f"{clean['seconds']:.1f} s wall): losses bit for bit "
        f"{not differ} (first differing step "
        f"{differ[0] if differ else None}; last loss "
        f"{once['losses'][SUPERVISED_STEPS - 1]!r} / "
        f"{clean['losses'][SUPERVISED_STEPS - 1]!r}); final weights and "
        f"moments bit for bit {not leaves} ({len(leaves)} of "
        f"{len(clean['leaves'])} leaves differ"
        f"{', first ' + leaves[0] if leaves else ''})")
    log(f"train_lm phase: {time.perf_counter() - t_phase:.1f} s wall; card "
        f"{nvidia_smi()}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    smi = nvidia_smi()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    log(f"card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, nvcc: {nvcc}")
    t_script = time.perf_counter()
    build_kernels()
    t_video = time.perf_counter()
    video, bank, params, untrained = run_video()
    log(f"video phase: {time.perf_counter() - t_video:.1f} s wall")
    kernels = video + lm_phase("lm", run_lm) + lm_phase("ssm", run_ssm)
    for name, run in (("hybrid", run_hybrid), ("moe", run_moe),
                      ("vlm", run_vlm), ("encdec", run_encdec),
                      ("train", run_train), ("train_lm", run_train_lm)):
        lm_phase(name, run, kernels)
    # the fleet last: after its stream threads, the profiler's traces
    # held no device kernel for the rest of the process (twice), and
    # every phase before it reads the profiler
    fleet, oracle = run_fleet(bank, params)
    # the executor's spans, mirrors and crash dump: after the fleet (no
    # profiler trace is read after it), held to the fleet's solo runs
    traced = run_traced(bank, params, oracle)
    # live ingest after the fleet: it starts threads and reads no trace
    append_walls: list = []

    def publishing(fn):
        def wrapper(ing, clip, report):
            append_walls.append(report.wall_seconds)
            return fn(ing, clip, report)
        return wrapper
    with wrapped(SegmentIngestor, "_publish", publishing):
        live = run_live(bank, params)
    # the SLO engine, health and exposition over what live ingest filled
    read_obs(append_walls)
    # training and tuning: a bank of its own, trained on the card
    tuning = run_tuning(untrained)
    # the registry served over HTTP while a fleet runs, and the CLI
    served = run_served(bank, params, oracle)
    # the two examples last: each trains its own reduced-config system
    examples = run_examples()
    for k in kernels:
        if k["name"] in FLEET_KERNELS:
            k["launches_fleet"] = {path: n[k["name"]]
                                   for path, n in fleet.items()}
            k["launches_live"] = {path: n[k["name"]]
                                  for path, n in live.items()}
            k["launches_traced"] = {path: n[k["name"]]
                                    for path, n in traced.items()}
            k["launches_served"] = {path: n[k["name"]]
                                    for path, n in served.items()}
            if not sum(k["launches_live"].values()):
                raise AssertionError(f"{k['name']} was not launched by "
                                     "the live phase")
        if k["name"] in TUNING_KERNELS:
            k["launches_tuning"] = {path: n[k["name"]]
                                    for path, n in tuning.items()}
        by_example = {ex: n[k["name"]] for ex, n in examples.items()
                      if k["name"] in n}
        if sum(by_example.values()):
            k["launches_examples"] = by_example
    log(f"chip_smoke: {time.perf_counter() - t_script:.1f} s wall from the "
        f"kernels' build to the result; card {smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
