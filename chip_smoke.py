#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --times KERNEL [SRC]   # one kernel's times alone
                       # (KERNEL: wire, flash_bwd, ssd_bwd or gated_bwd)

Phases, in order; any failure exits non-zero before the result line:

1. device  — the card's name and power limit (nvidia-smi) and count;
2. build   — nvcc builds every kernel of the path from ``src/repro_torch/
   kernels/csrc`` (one process per source, all at once);
3. kernels — each kernel against its plain PyTorch version on the card,
   at the main paths' shapes: flash attention within 3e-2 (bf16, every head
   dim, 112 on the 128 tile included, ragged S, a 4096-token prompt, and
   whisper's non-causal encoder: 1500 frames, 20 heads of 64, and
   llama4's prefill: 40 q heads over 8 kv heads of 128) and 2e-5
   (float32), with no copy of its inputs or output in its wrapper; its
   backward (``flash_attention_bwd``, ``check_flash_bwd``) at granite's
   training shape, llama3-405b's group of 16 at hd 128, minicpm's MHA, a
   ragged S, and S off every tile with a group split into chunks (hd 64
   and 128), and non-causal at whisper's encoder (4 x 512, 20 heads of
   64), its 1500 frames and two ragged groups: dq, dk and dv within 1e-2
   (1 + |plain|) and 2^-6 of the largest |plain|, two runs
   bit-identical, the forward's lse within 1e-4 and its output bit-equal
   without the lse, no spill, times at granite's shape, at hd 128 and at
   whisper's encoder (each launch's from the profiler) beside the bound,
   the plain version and PyTorch's flash SDPA backward (the same
   ``is_causal``);
   quantize and dequantize bit-equal (q, scales and output bytes) at
   every served model's width (1280 to 16384), at decode rows and a
   prefill's 2048, in bf16 and float32, with an all-zero row and a row of
   .5 ties, and at the (256, 256) and ragged tiles; by the wrappers' path
   counts, each of those (1, D) calls on quantize's row path and every
   call on the vectorised dequantize, a (256, 256) tile and a misaligned
   view on the general path; no spill in either kernel (``cuobjdump
   -res-usage``); times (``wire_times``, also run alone by ``--times
   wire``) warm, cold, and cold with fresh outputs beside the
   bytes bound and the same-bytes cast ``out.copy_(q)``; the SSD scan within
   |kernel - plain| <= 1e-2 + 1e-2 |plain| (bf16 output) and 2e-4 + 2e-4
   |plain| (float32 output and the float32 state); the three row-invariant
   decode kernels (``rows_matmul`` at granite's wg and tied head, mamba2's
   in_proj, llama3-405b's wg, whisper's wg and head (its rows 4-byte
   aligned: the narrow copies, each shape's path recorded), granite's wg
   as a view 4 bytes off the 16-byte grid, the VLM's wq and
   wg, deepseek-v3's wdq, wuq, wdkv, wo, shared expert and head, and
   llama4's wq, wk, dense and shared-expert MLPs and head,
   ``decode_attention`` at granite's, zamba2's, llama3-405b's and
   llama4's caches and over whisper's and the VLM's fixed cross caches
   (every key read: 1500 and 6400 rows), ``ssm_decode_step`` at mamba2's
   and zamba2's shapes, all at M = 4 rows) within 3e-2 (1 +
   |plain|) in bf16 and 2e-5 (1 + |plain|) on the float32 state (whisper's
   encoder flash and both cross caches also within 2^-6 of the largest
   plain output, a bound that must refuse the kernel's own output with
   the last run of 64 keys dropped: attention over 1500 or 6400 keys
   averages its outputs down to a few hundredths), each
   row's bits the same alone and within batches of 2, 4 and 8, and
   attention's the same over the fast loop's bucket, and over one that
   ends inside a split of 64 keys, as over the whole cache (the plain
   versions' invariance is logged beside: the ops at fault on the card);
   times from CUDA events beside the plain version's, the bound, and the
   library call, ``rows_matmul`` (also at granite's wk and wd) and
   ``decode_attention`` and their library calls cold, each call reading
   its own copy of the weight or cache (copies past 100 MB), and warm
   (``warm_ms``, ``warm_library_ms``) (a yardstick the port never calls:
   ``F.scaled_dot_product_attention`` for flash and decode attention,
   ``x @ w`` for ``rows_matmul``, ``F.rms_norm``; no PyTorch call computes
   the SSD scan or the SSM step), flash and the SSD scan at granite's,
   mamba2's and zamba2's prefill shapes and at B=1 and a 4096-token
   prompt; ``rms_norm_rows`` at eight model widths (deepseek-v3's q_norm
   at 1536 among them) and on MLA's kv_norm rows (512 wide at a row stride
   of 576, read in place), at decode rows and a prefill's 2048, within
   3e-2 (1 + |plain|) and each row's bits the same alone, in a batch of 4
   and among the 2048, its residual and gated forms
   bit-equal to the norm kernel on their plain prologues, beside the plain
   chains and ``F.rms_norm``; the SiLU bit-equal to its plain version over
   all 65536 bf16 inputs and at mamba2's and zamba2's gate and conv shapes,
   beside ``F.silu``, its bytes bound and its issue bound (SASS
   instructions an element); ``conv_silu`` bit-equal to the plain chain
   (output and the shifted conv_buf) at mamba2's and zamba2's widths, a
   decode step, a prefill and the cacheless forward; the SSM training
   path's three backward kernels (``check_ssm_bwd``: ``ssd_scan_bwd``,
   whose bf16 calls at a chunk of 128 run on the tensor cores,
   ``conv_silu_bwd`` and ``gated_rms_norm_bwd``, each one pass over the
   rows and an ordered sum of its slices) against their plain versions at
   mamba2's and zamba2's train shapes (batch 4 x 512), a ragged S and
   float32, within 1e-2 (1 + |plain|) per element (the gated norm's 2e-2;
   the scan's float32 ddt 5e-4 (1 + |plain|) and dA 1e-4 of its largest)
   and 2^-6 of the largest, two runs bit-identical, timed warm and cold
   beside the plain versions and their bounds, each launch from the
   profiler (``per_pass_ms``); the conv pass's also with the SASS
   instructions an element of its loop (fast path and whole), its
   registers (a spill fails), a digest of each output's bytes and its time
   at every run length its plan may take (``--times ssd_bwd``, ``--times
   conv_bwd`` and ``--times gated_bwd`` time each alone, for this or a
   parent's ``src/``: the digests show which outputs two trees give bit for
   bit); the flash backward also at zamba2's head dim 112 (on the 128
   tile);
4. the main paths at full width, with random bf16 weights from seed 0:
   granite-3-2b (40 layers, d_model 2048, tied head), mamba2-1.3b (48
   layers, d_model 2048, 64 SSM heads, state 128), zamba2-7b (81 mamba2
   layers, d_model 3584, 112 SSM heads, state 64, and one shared
   attention+MLP block of 32 heads of 112 before every 6th layer, 14 call
   sites), minicpm-2b (40 layers, d_model 2304, 36 heads of 64, tied head,
   vocab 122753), deepseek-7b (30 layers, d_model 4096, 32 heads of 128)
   and llama3-405b at full width (d_model 16384, 128 q heads over 8 kv
   heads of 128, d_ff 53248, vocab 128256) and 4 of its 126 layers;
   whisper-large-v3 at full depth (32 encoder and 32 decoder layers,
   d_model 1280, 20 heads of 64, 2.02 B params) over 1500 frames with a
   224-token prompt, and llama-3.2-vision-90b at full width (d_model 8192,
   64 q heads over 8 kv heads of 128, d_ff 28672, vocab 128256, 6400
   vision tokens) and 10 of its 100 layers (2 groups of 4 self blocks and
   a cross block; 10.66 B params, 21.3 GB), each request with its own side
   input (frames or vision embeddings, bf16 from the seed); the MoE
   family at full width: deepseek-v3-671b (d_model 7168, MLA over 128
   heads, 256 routed experts top-8 and a shared one, expert d_ff 2048,
   untied head over 129280) at 2 of its 61 layers (24.87 B params and
   0.69 B of multi-token-prediction weights, 51.1 GB), and
   llama4-maverick-400b-a17b (d_model 5120, 40 q heads over 8 kv heads of
   128, a dense block and a MoE block of 128 experts top-1 and a shared
   one) at 2 of its 48 layers (one group; 18.68 B params, 37.4 GB).  Each
   is served by both ``ServeEngine`` loops, whose tokens and every step's
   logits must be bit-identical; one decode step is traced and must run
   only the kinds of ``STEP_KERNELS`` (the port's kernels and torch's
   element-wise, copy, gather and indexing ones: no library GEMM, GEMV or
   reduction); for the MoE family a kind off that list may run only
   inside ``moe_ffn`` or ``mla_attention`` (the router's GEMM, softmax,
   top-k and sorts, the expert buffer's GEMMs, MLA's decompression and
   plain attention: every such launch is linked through the profiler to
   an op inside a range of one of those names, and logged by kind); then a
   stream
   of 6 staggered
   requests over 4 slots of the ``SlotScheduler``, twice, the two runs'
   tokens and every step's logits bit-identical, and each request's tokens
   and every decode step's logits bit-identical to the same request served
   alone (see ``stream_phase``); not for the MoE family, whose rows,
   idle slots' included, contend for expert capacity.
   granite, mamba2, zamba2 and whisper are
   also planned by the SEIFER planner onto a 10-node edge cluster into 4
   stages (zamba2: each stage holds call sites and its own copy of the
   shared block; whisper: the planner charges the encoder as layers
   enc0..enc31, its cut inside them leaves block-free stages, and the
   first runs the whole encoder and ships its output raw to the others),
   the VLM cut at block 5 and deepseek-v3 at block 1 (group boundaries:
   the planner is not group-aware; deepseek-v3's cut is the fixture
   cell's, its MLA caches split across the stages, the whole model
   served, its peak device memory beside a restored stage 1 logged; the
   stage checkpoints go to a tmpfs, ``CKPT_ROOT``, since its two stages
   are 46.3 GiB and the card's machine ends a run that writes more than
   45 GiB to its disk); llama4 needs two
   groups for a pipeline, and 4 layers (70.6 GB) beside a restored stage
   (about 35 GB) do not fit the card, so its pipeline is held on the CPU
   only (``tests/test_torch_pins.py``, ``tests/test_torch_moe.py``); each
   is served by the raw-wire ``PipelineServeEngine``
   (bit-identical tokens, also across a stage kill) and by the int8-wire
   one (a kill and restore gives the same tokens as the run without it).
   The kill takes stage 1 after decode step 3; whisper's stage 1 holds
   nothing, so there the encoder's stage 0 and the first stage with
   decoder blocks die together (``kill_specs``).
   Each pipelined model's int8-wire engine then serves once more through
   a ``BoundaryTransport`` under the seeded fault draw
   ``seeded_wire_faults(0, hops, 32, rate=0.2)``: the tokens of its run
   without the transport, every frame delivered exactly once, no restore
   (``wire_run``).  granite-3-2b also runs the fault surface
   (``fault_runs``) on its raw-wire engine, the 4 planned stages and 5
   spares: the faulty wire with one fault of each kind besides (drop,
   corrupt, duplicate, reorder, stall; each must fire), on both wires;
   stage 1 silent after step 3 (found by the heartbeat monitor within
   ``dead_after_s + poll_s`` on its fake clock, one restore); a live
   replan from telemetry on a step clock (a stage migrated, its params
   bit-equal to its checkpoint, the batch replayed); a replica placed by
   ``replicate_bottlenecks(plan, cluster, budget=1, keep_spares=1)``,
   whose primary's kill costs no checkpoint read and no replay, then the
   last copy's kill (restore and replay); every run with ServeEngine's
   tokens (the int8 wire's: its own).  It logs the transport's host cost
   (prefill and a decode step, with and without it, on both wires), the
   bytes of a hop's frames, the restore and migration seconds.
   Every pipelined model also serves the stream phase's
   requests through its raw-wire engine's per-stage banks
   (``pipelined_stream``: ``SlotScheduler`` over the pipeline engine):
   each request's tokens, and each batched decode step's logits in the
   active slots' rows, bit-identical to the monolithic stream's.  granite
   and mamba2 (``OVERLAP_ARCHS``) and deepseek-v3 also stream with stage
   1 killed after batched step 4 (the in-flight requests replayed into
   their slots; the same bits but for deepseek-v3, whose replay serves each
   request alone and whose rows contend for capacity), through the int8
   wire, and through the int8 wire with that kill (the tokens of the int8
   stream without it, but for deepseek-v3); each of deepseek-v3's streams
   runs twice, bit-identical; granite and mamba2 also run the
   overlapped executor (``overlap_runs``), batch 4 in 2 micro-batches, on
   both wires, staged (every stage given the card) and then, placed anew
   on the same engine (``place``), fused (one CUDA graph a micro-batch,
   ``devices=None``): each form's tokens the sequential
   chain's whole-batch run's and each micro-batch's decode-step logits
   bit-identical to the sequential chain serving its rows alone, also
   with a kill (granite stage 1, mamba2 stage 2, after step 3; the fused
   engine's graphs captured again after the restore); one traced fused
   step runs the eager step's kernels (``overlap_trace``); decode ms a
   step of the sequential, staged and fused forms.  A fused run's launch
   counts hold what the wrappers see: its eager prefills and, a graph it
   captures, one eager step and the capture (a replay calls no wrapper).
   The phases' seconds are logged (``"pipelined"`` in the JSON line).
   For the two new models the plain cross-attention of a prefill (the
   reference leaves it to XLA) is timed alone.  The kernel launch
   counters are zeroed just before each counted run (a model's monolithic
   run, its pipeline and fault runs, its stream) and read just after it,
   and
   each run must launch exactly what it runs: per prefill, flash attention
   once per self-attention layer (the dense layers, zamba2's 14 call
   sites, the VLM's self blocks, whisper's decoder layers, llama4's
   blocks) and encoder layer, never for cross-attention or MLA, the SSD
   scan once per mamba layer, and the head of the last token; per decode
   step, per self-attention layer seven ``rows_matmul`` and one
   ``decode_attention`` (an MLA layer seven and none: wdq, wuq, wdkv, wo
   and the shared expert's three), per VLM cross block five and one, per
   whisper decoder layer nine and two, per mamba layer two
   ``rows_matmul`` and one ``ssm_decode_step``, and the head; per pass (a
   prefill or a decode step), per self-attention layer and cross block
   one ``rms_norm_rows`` (an MLA layer three: ln1, q_norm, kv_norm) and
   one ``residual_rms_norm_rows`` (the residual add and the next norm),
   per decoder layer one and two, per mamba layer one ``rms_norm_rows``,
   one ``conv_silu`` and one ``gated_rms_norm_rows``, and the final norm
   (the encoder's layers and final norm once a prefill); quantize and
   dequantize once per stage boundary per pass in the int8-wire runs,
   each launch on quantize's row path and the vectorised dequantize (the
   wrappers' path counts, read with the launch counts); a fault run's
   replay adds its prefill and steps, a silent kill the step its earlier
   stages computed before the dead stage was found, a transport nothing;
   and nothing else (the standalone ``silu`` runs on no path; the router and
   the experts are plain matmuls, as in the reference).  Each model's
   peak device memory and the seconds of each of its phases are logged.
5. planner_eval (host, numpy; the planner's modelled seconds, not card
   times) — the SEIFER plan granite-3-2b's pipelines serve against the
   paper's §6.1 baselines (the random algorithm's mean over seeds 0-9,
   joint greedy) and the exact optimum of its boundary sizes, which may
   not exceed SEIFER's bottleneck; the same on the paper's ResNet50 at 64
   MB on the same cluster; ``plan_stages`` of the ten archs for the 2-pod
   production cluster (the launcher's ``--plan``); ``evaluate_plans``
   ranking the plans of ``rng`` 0-2 under a node fault of each of 4 seeds;
6. emulated (host; modelled seconds of RPi-class nodes) — granite's
   4-stage IR through ``emulate_plan``, and through the reference
   ``PipelineEmulator`` with the node of stage 1 failing: every batch
   completed and the stage rescheduled;
7. chaos (the card) — ``run_campaign(0, 8)`` of ``repro_torch.chaos`` on
   granite-3-2b at full width and 4 layers (3 stages, batch 2 x 12, 8
   tokens), both halves, every case ok with exactly its prefills' and
   steps' kernel launches (flash, ``rows_matmul`` and
   ``decode_attention`` among them: none through a CPU tensor); a silent
   kill found within ``dead_after_s + poll_s`` on the fake clock; the
   forced exhausting schedule caught and shrunk to its six drops; one
   case through the overlapped executor (the fused CUDA-graph chain for
   its baseline, captured again after a restore, the baseline each row's
   served alone); each case's wall, restores, detections and launches
   are logged (``"chaos"`` in the JSON line);
8. train (the card) — the training path (``train``): one step of
   granite-3-2b at full width and 2 layers, batch 1 x 128, its loss and
   every gradient against the same step on the CPU from the same params;
   ``Trainer`` at full width and depth (40 layers, remat, bf16 params and
   float32 AdamW states), batch 4 x 512, 4 steps, each step's launches
   exactly ``train_launches`` (flash forward and its remat recompute, the
   flash backward, the norms), with step ms, tokens/s and peak device
   memory; a crash at the third step and a restart at full width and 4
   layers (checkpoints every 2 steps under ``CKPT_ROOT``): resumed at
   step 2 with the saved bytes, steps 3-4 the uninterrupted run's losses
   within 1e-3; then the SSM family, the same step check and ``Trainer``
   run for mamba2-1.3b at full width and depth (48 layers) and zamba2-7b
   at full width and 42 of its 81 layers (``SSM_TRAIN``; the scan's, the
   conv pass's and the gated norm's backward kernels, zamba2's shared
   block through the flash backward at head dim 112), one step of
   ``launch/train.py --profile`` on mamba2; then the cross-attention
   families through ``make_train_step`` (the launcher feeds tokens only,
   as the reference's), batch 4 x 512 with frames or vision embeddings
   from a seeded generator, 4 steps, each step's launches exactly
   ``train_launches``: whisper-large-v3 at full width and depth (its
   encoder through the non-causal flash backward, its step at 2 + 2
   layers against the CPU's) and llama-3.2-vision-90b at full width and
   one group of 5 layers (``XATTN_TRAIN``; ``"train"`` in the JSON
   line).

The whole script takes 10 to 16 minutes on one H100 80GB HBM3 at 700 W:
the kernels' build about 30 s, phases 5-7 about 10 s, phase 8 about two
minutes, the rest the main paths (their host walls vary by up to a half
between runs).

The last lines are the card's nvidia-smi line, a JSON line with one record
per kernel, and ``{"ok": true, "device": {...}}``; the streams', the
serving phases', the fault runs' (``"faults"``), the pipelined streams'
and overlapped runs' numbers (``"pipelined"``) and phases 5-8's
(``"planner_eval"``, ``"emulated"``, ``"chaos"``, ``"train"``) are on a
JSON line before them.  A record's
``launches`` is the count from the runs that go through every step of a
main path (planner, int8 wire, stage kill, restore and replay), summed over
the six pipelined models; the flash backward's, the full-depth training
run's 4 steps (``granite-3-2b/train_full``; its ``non_causal`` record
whisper's, ``whisper-large-v3/train_full``), and the SSM backwards',
mamba2's (``mamba2-1.3b/train_full``); ``launches_by_path`` holds
the count from each counted run, keyed ``model/run``.  The decode, norm
and SiLU kernels and the SSM backwards replace no TPU kernel (the
reference leaves these ops to XLA and their gradients to JAX autodiff):
their ``replaces`` names the reference's op.
"""

from __future__ import annotations

import argparse
import gc
import itertools
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

BF16_PEAK = 989e12      # dense bf16 tensor-core FLOP/s, H100 SXM
F32_PEAK = 67e12        # float32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12        # bytes/s
PROMPT, BATCH, GEN = 512, 4, 32
LONG_PROMPT = 4096      # flash and the SSD scan alone, B=1
COLD_BYTES = 100e6      # copies a cold timing rotates over, in total
SCALE_TOL = 2 ** -6     # scaled_check: of the largest output
KILL = {"after_step": 3, "stage": 1}
PLAN_RNG = 8            # the planner's seed for the served pipelines
# served pipelined as well as monolithic: planned by the planner, or cut
# at CUTS (group-aligned cuts: the planner is not group-aware); the VLM at
# a group boundary, deepseek-v3 at block 1 (the fixture cell's cut: the
# MLA caches split across the stages)
PIPELINED = ("granite-3-2b", "mamba2-1.3b", "zamba2-7b", "whisper-large-v3",
             "llama-3.2-vision-90b", "deepseek-v3-671b")
CUTS = {"llama-3.2-vision-90b": [5], "deepseek-v3-671b": [1]}
# served by both ServeEngine loops and the stream only; llama3-405b at full width
# and a cut depth (its 126 layers are about 810 GB of bf16); llama4 is not
# pipelined here: a pipeline needs two of its groups, 4 layers (70.6 GB),
# and beside a restored stage (about 35 GB) they do not fit the card
SERVED = ("minicpm-2b", "deepseek-7b", "llama3-405b",
          "llama4-maverick-400b-a17b")
ARCHS = PIPELINED + SERVED
# the VLM's 100 layers are about 175 GB of bf16: 10 layers, 2 groups;
# deepseek-v3's 61 about 1.4 TB: 2 layers (51.1 GB with its MTP weights);
# llama4's 48 about 800 GB: 2 layers, one group (37.4 GB)
DEPTH = {"llama3-405b": 4, "llama-3.2-vision-90b": 10,
         "deepseek-v3-671b": 2, "llama4-maverick-400b-a17b": 2}
# a pipeline checkpoints every stage at construction: the checkpoints go
# to a tmpfs (host memory) where the machine has one, since the card's
# machine ends a run that writes more than 45 GiB to its disk and
# deepseek-v3's two stages at 2 layers are 46.3 GiB
CKPT_ROOT = Path("/dev/shm")
# the fault surface's model (``fault_runs``)
FAULTS_ARCH = "granite-3-2b"
# the overlapped executor's models, with the stage each kills after
# KILL["after_step"] (``overlap_runs``); they also stream through the
# int8 wire and with a kill: stage 1 after batched decode step 4
OVERLAP_KILL = {"granite-3-2b": 1, "mamba2-1.3b": 2}
OVERLAP_ARCHS = tuple(OVERLAP_KILL)
STREAM_KILL = {"after_step": 4, "stage": 1}
# tokens an overlapped run generates (its decode timings take as many
# steps less one): every step falls in the prompt's first kv bucket
OVERLAP_GEN = 12
# whisper: a decoder prompt of its prompt-conditioning length (224), over
# the 1500 frames of its 30-second window after the conv stem
PROMPT_OF = {"whisper-large-v3": 224}
FRAMES = 1500
# the stream phase: the serve-equivalence fixture's staggered requests
# ((8, 6), (8, 4), (12, 7), (8, 5), (12, 3), (8, 6)) at full width, as
# (prompt, generated tokens)
STREAM = ((256, 24), (256, 16), (384, 28), (256, 20), (512, 12), (256, 24))
SLOTS = 4
DEVICE = "cuda"         # the main paths' device (a rehearsal may set "cpu")


def log(msg=""):
    print(msg, flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Device milliseconds per call of ``fn``: ``iters`` calls captured in
    one CUDA graph, timed with CUDA events around its replay.  A plain loop
    of launches would time the host instead wherever one call's kernels
    take less time than Python takes to issue them."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_cold_ms(fn, nbytes, iters=20):
    """Device milliseconds per call of ``fn(c)``, a call that reads copy
    ``c`` of inputs of ``nbytes``: ``copies`` copies that together pass
    COLD_BYTES (twice the L2), and at least as many calls in the graph,
    call i reading copy i mod copies, so that no call finds its bytes in
    L2, as a decode step finds each weight and cache.  Returns (ms,
    copies); the caller makes the copies with ``cold_copies``."""
    copies = cold_copies(nbytes)
    turn = itertools.count()
    return time_ms(lambda: fn(next(turn) % copies),
                   iters=max(iters, copies)), copies


def cold_copies(nbytes):
    return int(COLD_BYTES // nbytes) + 1


def copy_inputs(ts):
    """Fresh copies of tensors for a cold call, each a view of its own copy
    of its base where it is a view, so that strides and offsets stay (a
    kernel that reads its input in place reads the copy the same way)."""
    out = []
    for t in ts:
        b = t._base
        out.append(t.clone() if b is None else b.clone().as_strided(
            t.size(), t.stride(), t.storage_offset()))
    return tuple(out)


def cold_ms_of(fn, ins):
    """Device ms a call of ``fn(*ins)`` takes on copies of ``ins`` that no
    call finds in L2 (``time_cold_ms``)."""
    nbytes = sum(t.numel() * t.element_size() for t in ins)
    copies = [copy_inputs(ins) for _ in range(cold_copies(nbytes))]
    ms, _ = time_cold_ms(lambda c: fn(*copies[c]), nbytes)
    del copies
    return ms


def scaled_check(name, got, want, fault):
    """Hold a kernel's bf16 output to a bound on the output's own scale:
    max |kernel - plain| <= SCALE_TOL max |plain| (two bf16 ulps of the
    largest output).  Attention over thousands of keys averages its values
    down to about sqrt(e / keys), well below the absolute tolerance, so
    this is the bound that sees a key left out.  ``fault`` is the kernel's
    output for the same work with the last run of 64 keys dropped; the
    check must refuse it.  Returns the error."""
    want = want.float()
    lim = SCALE_TOL * want.abs().max().item()
    err = (got.float() - want).abs().max().item()
    f_err = (fault.float() - want).abs().max().item()
    ok = math.isfinite(err) and err <= lim
    log(f"  {name}: max |kernel - plain| = {err:.3g} <= 2^-6 max |plain| "
        f"= {lim:.3g}: {'ok' if ok else 'FAIL'}; the kernel with the last "
        f"run of 64 keys dropped: {f_err:.3g} ({f_err / lim:.1f}x the "
        f"bound, {'refused' if f_err > lim else 'NOT refused'})")
    if not ok:
        raise SystemExit(f"{name} disagrees with its plain version on the "
                         f"output's scale: {err} > {lim}")
    if not f_err > lim:
        raise SystemExit(f"{name}: the check passes a kernel that drops "
                         f"the last run of keys")
    return err


def last_run(keys):
    """Keys in the last run of 64 of ``keys`` (the partial one if any)."""
    return (keys - 1) % 64 + 1


def bound(nbytes, *work):
    """Least ms for moving ``nbytes`` and doing ``work``, pairs (FLOP, peak
    FLOP/s) for operand types that run on separate units (float32 FMA,
    bf16 tensor cores), which can overlap: the largest of the times.
    Returns (ms, what bounds it)."""
    t_ops = max(flops / peak for flops, peak in work)
    t_bytes = nbytes / HBM_BW
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_flash(torch, gen):
    import torch.nn.functional as F
    from repro_torch.kernels.attention import ops
    from repro_torch.kernels.attention.ref import flash_ref
    bf16, f32 = torch.bfloat16, torch.float32
    tol = {bf16: 3e-2, f32: 2e-5}
    cases = [  # (B, S, H, KV, hd, dtype, causal)
        (BATCH, PROMPT, 32, 8, 64, bf16, True),    # granite prefill
        (BATCH, 300, 32, 8, 64, bf16, True),       # ragged S
        (BATCH, PROMPT, 32, 8, 64, bf16, False),
        *((2, 130, 8, 2, hd, bf16, True) for hd in (8, 16, 32, 128)),
        (2, 384, 32, 8, 64, f32, True),
        (1, LONG_PROMPT, 32, 8, 64, bf16, True),   # operations bound it
        (BATCH, PROMPT, 32, 32, 112, bf16, True),  # zamba2 prefill
        (BATCH, 300, 32, 32, 112, bf16, True),     # ragged S
        (BATCH, PROMPT, 32, 32, 112, f32, True),
        (BATCH, FRAMES, 20, 20, 64, bf16, False),  # whisper's encoder
        (BATCH, PROMPT, 40, 8, 128, bf16, True),   # llama4 prefill, group 5
    ]
    inputs = {}
    err_max = 0.0
    for b, s, h, kv, hd, dt, causal in cases:
        q = torch.randn(b, s, h, hd, generator=gen, device="cuda").to(dt)
        k = torch.randn(b, s, kv, hd, generator=gen, device="cuda").to(dt)
        v = torch.randn(b, s, kv, hd, generator=gen, device="cuda").to(dt)
        out = ops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref = flash_ref(q, k, v, causal=causal)
        err = (out.float() - ref.float()).abs().max().item()
        if s == FRAMES:
            scaled_check(f"flash B={b} S={s} H={h} KV={kv} hd={hd} "
                         f"non-causal", out, ref,
                         ops._launch(q, k, v, False, s - last_run(s)))
        del ref
        ok = math.isfinite(err) and err <= tol[dt]
        log(f"  flash B={b} S={s} H={h} KV={kv} hd={hd} {str(dt)[6:]} "
            f"causal={causal}: max |kernel - plain| = {err:.3g} "
            f"(tol {tol[dt]:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"flash attention disagrees with its plain "
                             f"version: {err} > {tol[dt]}")
        err_max = max(err_max, err)
        if dt == bf16 and (s in (PROMPT, LONG_PROMPT) and causal
                           or s == FRAMES):
            inputs[s, hd, h] = (q, k, v)

    def bound_of(q, k, v, causal=True):
        b, s, h, hd = q.shape
        # QK^T and PV over the keys each query reads
        flops = 4.0 * b * h * hd * s * ((s + 1) / 2 if causal else s)
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
        return bound(nbytes, (flops, BF16_PEAK)), flops, nbytes

    def library(q, k, v, causal=True):
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        return time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True))

    q, k, v = inputs[PROMPT, 64, 32]
    # the wrapper allocates its output and nothing else: no padded,
    # transposed or contiguous copy of q, k, v or the output
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = ops.flash_attention(q, k, v, causal=True)
    extra = torch.cuda.max_memory_allocated() - before
    log(f"  flash wrapper at the prefill shape: {extra} bytes allocated at "
        f"peak for a {out.nbytes}-byte output")
    if extra > out.nbytes:
        raise SystemExit("the flash wrapper copied its inputs or output")
    del out
    k_ms = time_ms(lambda: ops._launch(q, k, v, True, PROMPT))
    w_ms = time_ms(lambda: ops.flash_attention(q, k, v, causal=True))
    p_ms = time_ms(lambda: flash_ref(q, k, v, causal=True))
    l_ms = library(q, k, v)
    (b_ms, b_by), flops, nbytes = bound_of(q, k, v)
    log(f"  flash at the prefill shape: kernel {k_ms:.4f} ms (through the "
        f"wrapper {w_ms:.4f} ms), plain {p_ms:.4f} ms, "
        f"F.scaled_dot_product_attention {l_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB)")
    q, k, v = inputs[LONG_PROMPT, 64, 32]
    lk_ms = time_ms(lambda: ops._launch(q, k, v, True, LONG_PROMPT))
    ll_ms = library(q, k, v)
    (lb_ms, lb_by), lflops, lbytes = bound_of(q, k, v)
    log(f"  flash at a long prompt (B=1, S={LONG_PROMPT}): kernel "
        f"{lk_ms:.4f} ms ({lflops / lk_ms / 1e9:.1f} TFLOP/s), "
        f"F.scaled_dot_product_attention {ll_ms:.4f} ms, bound {lb_ms:.4f} "
        f"ms ({lb_by}; {lflops / 1e9:.2f} GFLOP, {lbytes / 1e6:.2f} MB)")
    zq, zk, zv = inputs[PROMPT, 112, 32]
    zk_ms = time_ms(lambda: ops._launch(zq, zk, zv, True, PROMPT))
    zw_ms = time_ms(lambda: ops.flash_attention(zq, zk, zv, causal=True))
    zp_ms = time_ms(lambda: flash_ref(zq, zk, zv, causal=True))
    zl_ms = library(zq, zk, zv)
    (zb_ms, zb_by), zflops, zbytes = bound_of(zq, zk, zv)
    log(f"  flash at zamba2's prefill shape (hd=112 on the 128 tile): "
        f"kernel {zk_ms:.4f} ms (through the wrapper {zw_ms:.4f} ms), plain "
        f"{zp_ms:.4f} ms, F.scaled_dot_product_attention {zl_ms:.4f} ms, "
        f"bound {zb_ms:.4f} ms ({zb_by}; {zflops / 1e9:.2f} GFLOP, "
        f"{zbytes / 1e6:.2f} MB)")
    wq, wk, wv = inputs[FRAMES, 64, 20]
    wk_ms = time_ms(lambda: ops._launch(wq, wk, wv, False, FRAMES))
    wp_ms = time_ms(lambda: flash_ref(wq, wk, wv, causal=False))
    wl_ms = library(wq, wk, wv, causal=False)
    (wb_ms, wb_by), wflops, wbytes = bound_of(wq, wk, wv, causal=False)
    log(f"  flash at whisper's encoder shape (B={BATCH}, S={FRAMES}, "
        f"H=KV=20, hd=64, non-causal): kernel {wk_ms:.4f} ms, plain "
        f"{wp_ms:.4f} ms, F.scaled_dot_product_attention {wl_ms:.4f} ms, "
        f"bound {wb_ms:.4f} ms ({wb_by}; {wflops / 1e9:.2f} GFLOP, "
        f"{wbytes / 1e6:.2f} MB)")
    mq, mk, mv = inputs[PROMPT, 128, 40]
    mk_ms = time_ms(lambda: ops._launch(mq, mk, mv, True, PROMPT))
    mp_ms = time_ms(lambda: flash_ref(mq, mk, mv, causal=True))
    ml_ms = library(mq, mk, mv)
    (mb_ms, mb_by), mflops, mbytes = bound_of(mq, mk, mv)
    log(f"  flash at llama4's prefill shape (B={BATCH}, S={PROMPT}, H=40, "
        f"KV=8, hd=128): kernel {mk_ms:.4f} ms, plain {mp_ms:.4f} ms, "
        f"F.scaled_dot_product_attention {ml_ms:.4f} ms, bound {mb_ms:.4f} "
        f"ms ({mb_by}; {mflops / 1e9:.2f} GFLOP, {mbytes / 1e6:.2f} MB)")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/attention/kernel.py:44",
            "max_abs_err": err_max, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms,
            "long_prompt": {"B, S, H, KV, hd": [*q.shape[:3], k.shape[2],
                                                q.shape[3]],
                            "ms": lk_ms, "library_ms": ll_ms,
                            "bound_ms": lb_ms, "bound_by": lb_by},
            "zamba2_prefill": {"B, S, H, KV, hd": [*zq.shape[:3],
                                                   zk.shape[2], zq.shape[3]],
                               "ms": zk_ms, "wrapper_ms": zw_ms,
                               "plain_ms": zp_ms, "library_ms": zl_ms,
                               "bound_ms": zb_ms, "bound_by": zb_by},
            "whisper_encoder": {"B, S, H, KV, hd": [BATCH, FRAMES, 20, 20,
                                                    64], "causal": False,
                                "ms": wk_ms, "plain_ms": wp_ms,
                                "library_ms": wl_ms, "bound_ms": wb_ms,
                                "bound_by": wb_by},
            "llama4_prefill": {"B, S, H, KV, hd": [BATCH, PROMPT, 40, 8, 128],
                               "ms": mk_ms, "plain_ms": mp_ms,
                               "library_ms": ml_ms, "bound_ms": mb_ms,
                               "bound_by": mb_by}}


BWD_CASES = (  # (B, S, H, KV, hd, causal): the backward kernel's calls
    (BATCH, PROMPT, 32, 8, 64, True),      # granite's training batch
    (1, PROMPT, 128, 8, 128, True),        # llama3-405b's group of 16, hd 128
    (BATCH, PROMPT, 36, 36, 64, True),     # minicpm's MHA
    (BATCH, 300, 32, 8, 64, True),         # a ragged S
    (2, 330, 8, 1, 64, True),              # S off every tile, two head chunks
    (1, 1000, 16, 2, 128, True),           # the same at hd 128
    (BATCH, PROMPT, 32, 32, 112, True),    # zamba2's shared block (128 tile)
    (2, 300, 8, 8, 112, True),             # the same, a ragged S
    (BATCH, PROMPT, 20, 20, 64, False),    # whisper's encoder, non-causal
    (BATCH, FRAMES, 20, 20, 64, False),    # its 1500 frames: a ragged S
    (2, 200, 16, 4, 128, False),           # ragged, group 4 at hd 128
    (2, 330, 8, 1, 64, False))             # ragged, two head chunks
BWD_HD112 = BWD_CASES[6]
BWD_ENCODER = BWD_CASES[8]
BWD_TIMED = (*BWD_CASES[:2], BWD_HD112, BWD_ENCODER)   # the timed calls
BWD_TOL = 1e-2          # per element, on 1 + |plain|
STEP_LOSS_TOL = 2e-3    # the 2-layer step's loss, card against CPU


def flash_bwd_inputs(torch, gen, b, s, h, kv, hd, causal=True):
    """The flash backward's inputs at one call: q, k, v and do (bf16,
    from ``gen``), and o and lse from the forward kernel."""
    from repro_torch.kernels.attention import ops
    q, k, v, do = (torch.randn(*shape, generator=gen, device="cuda")
                   .to(torch.bfloat16)
                   for shape in ((b, s, h, hd), (b, s, kv, hd),
                                 (b, s, kv, hd), (b, s, h, hd)))
    o, lse = ops._launch(q, k, v, causal, s, with_lse=True)
    return q, k, v, o, lse, do


def check_flash_bwd(torch, gen):
    """The flash-attention backward kernel (``flash_attention_bwd``)
    against its plain version (``flash_bwd_ref``) on the same (o, lse) from
    the forward kernel, at ``BWD_CASES`` (causal and, for whisper's
    encoder, non-causal): dq, dk and dv within 1e-2 (1 +
    |plain|) per element and within 2^-6 of the tensor's largest |plain|,
    two runs bit-identical; the forward's lse within 1e-4 (1 + |plain|) of
    the plain log-sum-exp and its output bit-equal with and without the
    lse; no spill (``cuobjdump -res-usage``).  Times (``bwd_times``) at
    granite's shape, at llama3-405b's group of 16 at hd 128, at
    zamba2's shared block (hd 112 on the 128 tile) and at whisper's
    encoder (non-causal, ``non_causal`` in the record): the kernel
    warm and cold, each of its two launches from the profiler, the plain
    version, the bound and PyTorch's flash SDPA backward
    (``aten._scaled_dot_product_flash_attention_backward``); and the
    forward with and without its lse (the serving path asks for none)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import ops
    from repro_torch.kernels.attention.ref import flash_bwd_ref, flash_ref
    usage = _build.resource_usage("flash_attention_bwd")
    log(f"  flash_attention_bwd registers and stack bytes: "
        + ", ".join(f"{re.sub(r'^.*?(flash_bwd_\w+?)E.*$', r'\1', f)} "
                    f"{r}/{st}" for f, (r, st) in usage.items()))
    spills = {f: st for f, (_, st) in usage.items() if st}
    if spills:
        raise SystemExit(f"flash_attention_bwd spills: {spills}")
    err_max, scaled_max, abs_max, inputs = 0.0, 0.0, 0.0, {}
    for case in BWD_CASES:
        b, s, h, kv, hd, causal = case
        q, k, v, o, lse, do = flash_bwd_inputs(torch, gen, *case)
        o_plain = ops._launch(q, k, v, causal, s)
        before = ops.flash_attention_bwd.noncausal_launches
        got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal)
        again = ops.flash_attention_bwd(q, k, v, o, lse, do, causal)
        torch.cuda.synchronize()
        if ops.flash_attention_bwd.noncausal_launches - before != \
                2 * (not causal):
            raise SystemExit(f"flash_attention_bwd at {case}: the "
                             "non-causal path's count did not move")
        same = all(torch.equal(a.view(torch.int16), c.view(torch.int16))
                   for a, c in zip(got, again))
        o_same = torch.equal(o.view(torch.int16), o_plain.view(torch.int16))
        _, lse_want = flash_ref(q, k, v, causal, with_lse=True)
        lse_err = ((lse - lse_want).abs() / (1 + lse_want.abs())).max().item()
        want = flash_bwd_ref(q, k, v, o, lse, do, causal)
        errs = []
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            g, w = g.float(), w.float()
            e = (g - w).abs()
            errs.append((name, (e / (1 + w.abs())).max().item(),
                         e.max().item() / w.abs().max().item()))
            abs_max = max(abs_max, e.max().item())
        del want
        log(f"  flash_attention_bwd B={b} S={s} H={h} KV={kv} hd={hd} "
            f"{'causal' if causal else 'non-causal'}: "
            + ", ".join(f"{n} {el:.3g} per element (tol {BWD_TOL:g}), "
                        f"{sc:.3g} of the largest (tol 2^-6)"
                        for n, el, sc in errs)
            + f"; two runs bit-identical {same}; lse {lse_err:.3g} (tol "
            f"1e-4); the output bit-equal without the lse {o_same}")
        bad = [n for n, el, sc in errs
               if not (el <= BWD_TOL and sc <= 2 ** -6)]
        if bad or not same or not o_same or not lse_err <= 1e-4:
            raise SystemExit(f"flash_attention_bwd at {case}: "
                             f"{errs}, bit-identical {same}, lse {lse_err}, "
                             f"output with the lse equal {o_same}")
        err_max = max(err_max, *(el for _, el, _ in errs))
        scaled_max = max(scaled_max, *(sc for _, _, sc in errs))
        if case in BWD_TIMED:
            inputs[case] = (q, k, v, o, lse, do)

    timed = {case: bwd_times(torch, *inputs[case], causal=case[-1])
             for case in BWD_TIMED}
    gran, big = timed[BWD_CASES[0]], timed[BWD_CASES[1]]
    q, k, v, o, lse, do = inputs[BWD_CASES[0]]
    s = q.shape[1]
    f_ms = time_ms(lambda: ops._launch(q, k, v, True, s))
    fl_ms = time_ms(lambda: ops._launch(q, k, v, True, s, with_lse=True))
    log(f"  the forward at granite's shape {f_ms:.4f} ms without its lse, "
        f"{fl_ms:.4f} ms with it")
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/models/layers.py:248",
            "max_abs_err": abs_max, "scaled_err": scaled_max,
            "ms": gran["ms"], "cold_ms": gran["cold_ms"],
            "per_pass_ms": gran["per_pass_ms"],
            "plain_ms": gran["plain_ms"], "bound_ms": gran["bound_ms"],
            "bound_by": gran["bound_by"], "library_ms": gran["library_ms"],
            "per_element_err": err_max,
            "forward_ms": f_ms, "forward_with_lse_ms": fl_ms,
            "hd128": dict(big, **{"B, S, H, KV, hd": list(BWD_CASES[1][:5])}),
            "hd112": dict(timed[BWD_HD112],
                          **{"B, S, H, KV, hd": list(BWD_HD112[:5])}),
            "non_causal": dict(timed[BWD_ENCODER],
                               **{"B, S, H, KV, hd": list(BWD_ENCODER[:5])}),
            "registers": {re.sub(r"^.*?(flash_bwd_\w+?)E.*$", r"\1", f): r
                          for f, (r, _) in usage.items()},
            "main_path": f"{TRAIN_ARCH}/train_full"}


def pass_times(torch, fn, tag, iters=20):
    """Device ms a call of each kernel whose name holds ``tag``, from
    torch.profiler over ``iters`` calls of ``fn``: {short name: ms}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and tag in e.key:
            name = re.sub(rf"^.*?({tag}\w*?)(E|I|<|\(|$).*$", r"\1", e.key)
            out[name] = e.device_time_total / e.count / 1e3
    if not out:
        raise SystemExit(f"the profiler saw no {tag} kernel")
    return out


def bwd_times(torch, q, k, v, o, lse, do, causal=True):
    """The backward kernel's times at one call: warm, cold (a copy of the
    inputs a call), each launch's from the profiler, the plain version's,
    the bound (the larger of the bytes over the HBM rate and 2.5x the
    forward's operations, causal or not, over the bf16 peak) and, as a
    yardstick the port never calls, the backward of PyTorch's flash SDPA
    (k and v repeated to the q heads, since it takes no groups; the same
    ``is_causal``)."""
    from repro_torch.kernels.attention import ops
    from repro_torch.kernels.attention.ref import flash_bwd_ref
    b, s, h, hd = q.shape
    kv = k.shape[2]
    fwd_flops = 4.0 * b * h * hd * s * ((s + 1) / 2 if causal else s)
    # q, k, v, o, do and lse read once; dq, dk, dv written once
    nbytes = (2 * (q.numel() + k.numel() + v.numel() + o.numel()
                   + do.numel()) + 4 * lse.numel()
              + 2 * (q.numel() + k.numel() + v.numel()))
    b_ms, b_by = bound(nbytes, (2.5 * fwd_flops, BF16_PEAK))
    k_ms = time_ms(lambda: ops.flash_attention_bwd(q, k, v, o, lse, do,
                                                   causal))
    per = pass_times(torch, lambda: ops.flash_attention_bwd(
        q, k, v, o, lse, do, causal), "flash_bwd")
    copies = [tuple(t.clone() for t in (q, k, v, o, lse, do))
              for _ in range(cold_copies(nbytes))]
    c_ms, _ = time_cold_ms(lambda c: ops.flash_attention_bwd(*copies[c],
                                                             causal), nbytes)
    del copies
    p_ms = time_ms(lambda: flash_bwd_ref(q, k, v, o, lse, do, causal))
    g = h // kv
    qt, ot, dot = (t.transpose(1, 2).contiguous() for t in (q, o, do))
    kt, vt = (t.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
              for t in (k, v))
    fwd = torch.ops.aten._scaled_dot_product_flash_attention(
        qt, kt, vt, 0.0, causal)
    l_out, l_lse = fwd[0], fwd[1]
    sdpa_bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
    l_ms = time_ms(lambda: sdpa_bwd(dot, qt, kt, vt, l_out, l_lse, fwd[2],
                                    fwd[3], fwd[4], fwd[5], 0.0, causal,
                                    fwd[6], fwd[7]))
    log(f"  flash_attention_bwd (B={b}, S={s}, H={h}, KV={kv}, hd={hd}, "
        f"{'causal' if causal else 'non-causal'}): "
        f"kernel {k_ms:.4f} ms warm, {c_ms:.4f} cold ("
        + ", ".join(f"{n} {t:.4f}" for n, t in per.items())
        + f" a launch), plain {p_ms:.4f} ms, the flash SDPA's backward (k, "
        f"v repeated to {h} heads) {l_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}; {2.5 * fwd_flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} "
        f"MB)")
    return {"ms": k_ms, "cold_ms": c_ms, "per_pass_ms": per,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": l_ms}


def time_cold_out_ms(fn, nbytes, iters=20):
    """``time_cold_ms`` for a call ``fn(c)`` that allocates its outputs:
    every call's outputs are kept until the timing ends, so each call
    writes memory of its own and its writes reach device memory, as a
    stream's do, instead of landing on lines the last call left in L2.
    Returns (ms, copies)."""
    keep = []
    out = time_cold_ms(lambda c: keep.append(fn(c)), nbytes, iters)
    del keep
    return out


def quantize_rows(torch, gen, m, n, dt):
    """x (m, n) for the wire's checks: normal rows, row 0 all zero (scale
    1), the last row half-way ties (127, .5, 1.5, 2.5, -.5, ... repeated:
    scale 1, so every .5 decides the rounding)."""
    x = torch.randn(m, n, generator=gen, device="cuda")
    x[0] = 0
    ties = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5],
                        device="cuda")
    x[-1] = ties.repeat(n // 8)
    return x.to(dt)


# the wire's timed shapes: a prefill's rows (B*S, D) and a decode step's
WIRE_TIMED = ([(BATCH * PROMPT, d) for d in (2048, 3584, 7168, 8192, 16384)]
              + [(BATCH, 7168)])


def wire_times(torch, gen):
    """Quantize and dequantize at the wire's rows (``WIRE_TIMED``), bf16,
    one scale a row: warm (one copy, in L2), cold (a copy a call) and cold
    with fresh outputs (a copy a call, outputs kept), beside the plain
    versions, the bounds and the same-bytes cast ``out.copy_(q)``, a
    reference for the card's streaming rate at that size (no single torch
    call computes either kernel).  It calls only the wrappers and the
    plain versions, so ``--times wire SRC`` times another checkout's
    package with the same loop.  Returns {(M, D): record}."""
    from repro_torch.kernels.quantize import ops, ref
    t = {}
    for m, n in WIRE_TIMED:
        nbytes = m * n              # q's: copies enough for dequantize too
        xs = [torch.randn(m, n, generator=gen, device="cuda").bfloat16()
              for _ in range(cold_copies(nbytes))]
        qs = [ops.quantize(x, 1, n) for x in xs]
        x2, (q, s) = xs[0], qs[0]
        out = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
        r = t[m, n] = {
            "M, D": [m, n],
            "q_ms": time_ms(lambda: ops.quantize(x2, 1, n)),
            "q_cold_ms": time_cold_ms(
                lambda c: ops.quantize(xs[c], 1, n), nbytes)[0],
            "q_cold_out_ms": time_cold_out_ms(
                lambda c: ops.quantize(xs[c], 1, n), nbytes)[0],
            "q_plain_ms": time_ms(lambda: ref.quantize_ref(x2, 1, n)),
            "d_ms": time_ms(lambda: ops.dequantize(q, s, 1, n)),
            "d_cold_ms": time_cold_ms(
                lambda c: ops.dequantize(*qs[c], 1, n), nbytes)[0],
            "d_cold_out_ms": time_cold_out_ms(
                lambda c: ops.dequantize(*qs[c], 1, n), nbytes)[0],
            "d_plain_ms": time_ms(lambda: ref.dequantize_ref(q, s, 1, n)),
            "cast_ms": time_ms(lambda: out.copy_(q)),
            "cast_cold_ms": time_cold_ms(
                lambda c: out.copy_(qs[c][0]), nbytes)[0],
            "cast_cold_out_ms": time_cold_out_ms(
                lambda c: torch.empty_like(out).copy_(qs[c][0]), nbytes)[0]}
        # float32 operations per element: quantize |x|, max, x * (1/scale),
        # round, and the clip's two compares; dequantize one multiply
        r["q_bound_ms"], r["q_bound_by"] = bound(2 * m * n + m * n + 4 * m,
                                                 (6.0 * m * n, F32_PEAK))
        r["d_bound_ms"], r["d_bound_by"] = bound(m * n + 4 * m + 2 * m * n,
                                                 (1.0 * m * n, F32_PEAK))
        for k, name in (("q", "quantize"), ("d", "dequantize")):
            b = r[k + "_bound_ms"]
            cold, fresh = r[k + "_cold_ms"], r[k + "_cold_out_ms"]
            log(f"  {name} ({m}, {n}) bf16: kernel {r[k + '_ms']:.4f} ms "
                f"warm, {cold:.4f} cold ({b / cold:.0%} of the bound), "
                f"{fresh:.4f} cold with fresh outputs ({b / fresh:.0%}), "
                f"plain {r[k + '_plain_ms']:.4f} ms, bound {b:.5f} ms "
                f"({r[k + '_bound_by']})")
        log(f"  the cast out.copy_(q) ({m}, {n}) int8 -> bf16: "
            f"{r['cast_ms']:.4f} ms warm, {r['cast_cold_ms']:.4f} cold, "
            f"{r['cast_cold_out_ms']:.4f} with fresh outputs")
        del xs, qs, out
        torch.cuda.empty_cache()
    return t


def check_quantize(torch, gen):
    """Quantize and dequantize bit-equal (q, scales, output bytes) to their
    plain versions at every wire width of the served models and 16384, at
    decode rows and a prefill's, in bf16 and float32, and at the blockwise
    (256, 256) and ragged tiles; by the wrappers' path counts, every such
    (1, D) call on quantize's row path and every call on the vectorised
    dequantize, a (256, 256) tile and a misaligned view off the row path;
    the kernels' registers and spills; times (``wire_times``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.quantize import ops, ref
    usage = {f: v for f, v in _build.resource_usage("quantize").items()
             if "rows_kernel" in f or "vec_kernel" in f}

    def short(f):     # quantize_rows_kernel<bf16, 4> as rows<bf16,4>
        kind = "rows" if "rows_kernel" in f else "dq"
        args = "".join("," + a for a in re.findall(r"Li(\d+)E", f))
        return f"{kind}<{'bf16' if 'bfloat16' in f else 'f32'}{args}>"
    log("  registers (spill stack bytes) by instance: " + ", ".join(
        f"{short(f)} {r} ({st})" for f, (r, st) in sorted(usage.items())))
    if any(st for _, st in usage.values()):
        raise SystemExit("a row-path or vectorised kernel spills")

    def paths(fn):
        """fn()'s result, and its launches on quantize's row path and of
        the vectorised dequantize."""
        r0, v0 = ops.quantize.row_launches, ops.dequantize.vec_launches
        out = fn()
        return (out, ops.quantize.row_launches - r0,
                ops.dequantize.vec_launches - v0)
    served = sorted({get_config(a, "full").d_model for a in ARCHS}
                    | {16384})
    cases = ([((m, d), 1, d) for d in served for m in (BATCH, BATCH * PROMPT)]
             + [((2048, 2048), 256, 256), ((300, 520), 256, 256)])
    q_err = d_err = 0.0
    for shape, bm, bn in cases:
        for dt in (torch.bfloat16, torch.float32):
            x = quantize_rows(torch, gen, *shape, dt)
            (q, s), rows, _ = paths(lambda: ops.quantize(x, bm, bn))
            torch.cuda.synchronize()
            qr, sr = ref.quantize_ref(x, bm, bn)
            d, _, vec = paths(lambda: ops.dequantize(q, s, bm, bn,
                                                     out_dtype=dt))
            torch.cuda.synchronize()
            dr = ref.dequantize_ref(q, s, bm, bn, out_dtype=dt)
            same_q, same_s = torch.equal(q, qr), torch.equal(s, sr)
            same_d = torch.equal(d.view(torch.uint8), dr.view(torch.uint8))
            q_err = max(q_err, (q.int() - qr.int()).abs().max().item())
            d_err = max(d_err, (d.float() - dr.float()).abs().max().item())
            log(f"  quantize {shape} tile ({bm}, {bn}) {str(dt)[6:]} "
                f"({'row' if rows else 'general'} path): q bit-equal "
                f"{same_q}, scales equal {same_s}; dequantize "
                f"({'vectorised' if vec else 'scalar'}) bit-equal {same_d}")
            if not (same_q and same_s and same_d):
                raise SystemExit("quantize/dequantize disagree with their "
                                 "plain versions")
            if rows != (bm == 1) or not vec:
                raise SystemExit(f"quantize {shape} tile ({bm}, {bn}) took "
                                 f"the {'row' if rows else 'general'} path, "
                                 f"dequantize the "
                                 f"{'vectorised' if vec else 'scalar'} "
                                 f"kernel")
            if bm == 1 and shape[0] == BATCH and dt == torch.bfloat16:
                if q[-1, :8].tolist() != [127, 0, 2, 2, 0, -2, -2, 4]:
                    raise SystemExit("the row path rounds .5 ties off even")
    # a view off a 16-byte boundary takes the general path, bit-equal too
    flat = torch.randn(3 * 7168 + 1, generator=gen, device="cuda").bfloat16()
    view = flat[1:].view(3, 7168)
    (q, s), rows, _ = paths(lambda: ops.quantize(view, 1, 7168))
    qr, sr = ref.quantize_ref(view, 1, 7168)
    if rows or not (torch.equal(q, qr) and torch.equal(s, sr)):
        raise SystemExit("quantize on a misaligned view took the row path "
                         "or disagrees")
    log(f"  every (1, D) call at {served} on the row path, every dequantize "
        f"vectorised; the (256, 256) tiles and a misaligned view on the "
        f"general path")

    t = wire_times(torch, gen)
    common = {"route": "cuda",
              "source": "src/repro_torch/kernels/csrc/quantize.cu",
              "library_ms": None}

    def of(kind, key):
        return dict({k: t[key][kind + "_" + k]
                     for k in ("ms", "cold_ms", "cold_out_ms", "plain_ms",
                               "bound_ms", "bound_by")},
                    **{k: t[key][k] for k in ("cast_ms", "cast_cold_ms",
                                              "cast_cold_out_ms")})

    def wire(kind):
        names = {3584: "zamba2_wire", 7168: "deepseek_v3_wire",
                 8192: "vlm_wire", 16384: "width_16384"}
        rec = {f"{v}": dict(of(kind, (BATCH * PROMPT, n)),
                            **{"M, D": [BATCH * PROMPT, n], "path": "row",
                               "plan": list(ops.row_plan(n, 2))})
               for n, v in names.items()}
        rec["decode_7168"] = dict(of(kind, (BATCH, 7168)),
                                  **{"M, D": [BATCH, 7168], "path": "row",
                                     "plan": list(ops.row_plan(7168, 2))})
        return rec
    return [dict(common, name="quantize",
                 replaces="src/repro/kernels/quantize/kernel.py:22",
                 max_abs_err=float(q_err), **of("q", (BATCH * PROMPT, 2048)),
                 shapes=wire("q")),
            dict(common, name="dequantize",
                 replaces="src/repro/kernels/quantize/kernel.py:34",
                 max_abs_err=d_err, **of("d", (BATCH * PROMPT, 2048)),
                 shapes=wire("d"))]


def ssd_inputs(torch, gen, b, s, h, p, n, dtype):
    """x, B and C as views of one (B, S, H*P + 2N) tensor, the layout in
    which the model's convolution output hands them to the kernel; dt and A
    drawn as the reference's kernel tests draw them."""
    import torch.nn.functional as F
    conv = torch.randn(b, s, h * p + 2 * n, generator=gen, device="cuda")
    conv[..., h * p:] *= 0.5
    conv = conv.to(dtype)
    x = conv[..., :h * p].reshape(b, s, h, p)
    dt = F.softplus(torch.randn(b, s, h, generator=gen, device="cuda"))
    A = -torch.exp(torch.randn(h, generator=gen, device="cuda") * 0.3)
    return x, dt, A, conv[..., h * p:h * p + n], conv[..., h * p + n:]


def ssd_work(b, s, h, p, n, q):
    """What the scan needs at bf16 x/B/C, per (b, h, chunk): the causal
    halves of C B^T (bf16 operands) and, with a float32 operand, of its
    product with x (the weights L o dt), C state^T past the first chunk
    (the state is zero before it) and the state update (float32 state,
    decay-weighted x); and the bytes of every input and output once.
    Returns (bf16 FLOP, float32-operand FLOP, bytes)."""
    nc = -(-s // q)
    tri = q * (q + 1) / 2
    cb_flops = 2.0 * b * h * nc * tri * n
    f32_flops = 2.0 * b * h * (nc * tri * p + (nc - 1) * q * p * n
                               + nc * q * p * n)
    nbytes = (2 * 2 * b * s * h * p          # x in, y out (bf16)
              + 4 * b * h * p * n            # the final state (f32)
              + 2 * 2 * b * s * n            # B and C (bf16)
              + 4 * b * s * h + 4 * h)       # dt and A (f32)
    return cb_flops, f32_flops, nbytes


def check_ssd(torch, gen):
    from repro_torch.kernels.ssd import ops
    from repro_torch.kernels.ssd.ref import ssd_chunked
    bf16, f32 = torch.bfloat16, torch.float32
    tol = {bf16: 1e-2, f32: 2e-4}     # |kernel - plain| <= tol (1 + |plain|)
    cases = [  # (B, S, H, P, N, Q, dtype)
        (BATCH, PROMPT, 64, 64, 128, 128, bf16),   # mamba2-1.3b prefill
        (BATCH, 300, 64, 64, 128, 128, bf16),      # ragged S
        (1, LONG_PROMPT, 64, 64, 128, 128, bf16),  # a long prompt
        (2, 40, 8, 16, 16, 16, bf16),              # the smoke config's
        (2, 384, 8, 64, 128, 128, f32),
        (BATCH, PROMPT, 112, 64, 64, 128, bf16),   # zamba2-7b prefill
        (BATCH, 300, 112, 64, 64, 128, bf16),      # ragged S
    ]
    inputs, err_max = {}, 0.0
    for b, s, h, p, n, q, dt_ in cases:
        ins = ssd_inputs(torch, gen, b, s, h, p, n, dt_)
        y, st = ops.ssd_scan(*ins, q)
        torch.cuda.synchronize()
        yr, sr = ssd_chunked(*ins, q)
        ey = (y.float() - yr.float()).abs()
        es = (st - sr).abs()
        err = max(ey.max().item(), es.max().item())
        ok = bool((ey <= tol[dt_] * (1 + yr.float().abs())).all()
                  and (es <= tol[f32] * (1 + sr.abs())).all()
                  and math.isfinite(err))
        log(f"  ssd B={b} S={s} H={h} P={p} N={n} Q={q} {str(dt_)[6:]}: max "
            f"|kernel - plain| = {ey.max().item():.3g} on y (max |y| "
            f"{yr.float().abs().max().item():.3g}), {es.max().item():.3g} on "
            f"the state (tol {tol[dt_]:g} on y, {tol[f32]:g} on the state, "
            f"each times 1 + |plain|) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("the SSD scan disagrees with its plain version")
        err_max = max(err_max, err)
        if dt_ == bf16 and s in (PROMPT, LONG_PROMPT):
            inputs[s, h] = ins
        del y, st, yr, sr, ey, es

    def timed_shape(ins):
        b, s, h, p = ins[0].shape
        n = ins[3].shape[-1]
        k_ms = time_ms(lambda: ops._launch(*ins, 128))
        p_ms = time_ms(lambda: ssd_chunked(*ins, 128))
        cb_flops, f32_flops, nbytes = ssd_work(b, s, h, p, n, 128)
        # the kernel's products on the bf16 tensor cores, each float32
        # operand split into two bf16 terms
        b_ms, b_by = bound(nbytes, (cb_flops + 2 * f32_flops, BF16_PEAK))
        # the first kernel's count: the float32-operand products at the
        # float32 FMA rate
        o_ms, o_by = bound(nbytes, (cb_flops, BF16_PEAK),
                           (f32_flops, F32_PEAK))
        log(f"  ssd B={b} S={s} H={h} P={p} N={n}: kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
            f"{cb_flops / 1e9:.2f} GFLOP bf16 + 2 x {f32_flops / 1e9:.2f} "
            f"GFLOP split, {nbytes / 1e6:.2f} MB; counted at the float32 "
            f"FMA rate {o_ms:.4f} ms, {o_by}); {b * h * -(-p // 32)} blocks")
        return k_ms, p_ms, b_ms, b_by

    ins = inputs[PROMPT, 64]
    k_ms, p_ms, b_ms, b_by = timed_shape(ins)
    w_ms = time_ms(lambda: ops.ssd_scan(*ins, 128))
    log(f"  ssd at the prefill shape through the wrapper: {w_ms:.4f} ms")
    lk_ms, lp_ms, lb_ms, lb_by = timed_shape(inputs[LONG_PROMPT, 64])
    zins = inputs[PROMPT, 112]
    zk_ms, zp_ms, zb_ms, zb_by = timed_shape(zins)
    zw_ms = time_ms(lambda: ops.ssd_scan(*zins, 128))
    log(f"  ssd at zamba2's prefill shape through the wrapper: {zw_ms:.4f} "
        f"ms")
    return {"name": "ssd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd.cu",
            "replaces": "src/repro/kernels/ssd/kernel.py:32",
            "max_abs_err": err_max, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "long_prompt": {"B, S, H, P, N": [1, LONG_PROMPT, 64, 64, 128],
                            "ms": lk_ms, "plain_ms": lp_ms,
                            "bound_ms": lb_ms, "bound_by": lb_by,
                            "library_ms": None},
            "zamba2_prefill": {"B, S, H, P, N": [BATCH, PROMPT, 112, 64, 64],
                               "ms": zk_ms, "wrapper_ms": zw_ms,
                               "plain_ms": zp_ms, "bound_ms": zb_ms,
                               "bound_by": zb_by, "library_ms": None}}


def _sass(tag):
    """(address, instruction) of each instruction but NOPs of the function
    of ``csrc/silu.cu``'s built library whose mangled name holds ``tag``,
    from ``cuobjdump -sass``; None where there is no such function."""
    from repro_torch.kernels import _build
    exe = Path(_build.nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(exe), "-sass", str(_build.library_path(
        "silu"))], capture_output=True, text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", out)
    body = next((f for f in funcs[1:] if tag in f.split("\n", 1)[0]), None)
    if body is None:
        return None
    found = (re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(\S.*)$", line)
             for line in body.splitlines())
    return [(int(m.group(1), 16), m.group(2)) for m in found
            if m and not m.group(2).startswith("NOP")]


def sass_per_element(name, elements):
    """SASS instructions an element of the bf16 instance of the kernel
    ``name`` of ``csrc/silu.cu``: the instructions of its function in
    ``cuobjdump -sass`` of the built library (the exact fallback is a
    function of its own, not counted) over the ``elements`` one pass of its
    unrolled loop computes.  Returns (per element, instructions)."""
    n = len(_sass(f"{len(name)}{name}I13__nv_bfloat16"))
    return n / elements, n


def sass_loop_per_element(tag, elements):
    """SASS instructions an element of the main loop of the function whose
    mangled name holds ``tag``: those from the target of its widest
    backward branch to that branch, over the ``elements`` one trip of the
    loop computes; and those on its fast path, without the code inside the
    loop that a forward branch skips and that holds a ``CALL`` and no
    exponential (the IEEE quotient's out-of-range cases).  Returns (per
    element, per element on the fast path, the loop's instructions, the
    function's), or None where the library has no such function or loop (a
    tree without the kernel)."""
    lines = _sass(tag) or []
    branches = []
    for addr, ins in lines:
        m = re.search(r"\bBRA\b[^;]*?0x([0-9a-f]+)", ins)
        if m:
            branches.append((addr, int(m.group(1), 16)))
    loops = [(a - to, to, a) for a, to in branches if to <= a]
    if not loops:
        return None
    _, lo, hi = max(loops)
    inside = [(a, i) for a, i in lines if lo <= a <= hi]

    def slow(f, t):
        held = [i for a, i in inside if f < a < t]
        return any("CALL" in i for i in held) and not any(
            "MUFU.EX2" in i for i in held)
    skips = [(f, t) for f, t in branches if lo <= f < t <= hi and slow(f, t)]
    fast = [a for a, _ in inside if not any(f < a < t for f, t in skips)]
    return (len(inside) / elements, len(fast) / elements, len(inside),
            len(lines))


def sm_clock_hz():
    """The card's top SM clock, from nvidia-smi."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]) * 1e6


def check_silu(torch, gen):
    """The redesigned SiLU kernel: the shared SiLU (``csrc/silu.cuh``)
    bit-equal to its plain version (the four roundings of the reference's
    bf16 SiLU under XLA on the CPU, as four torch ops) over all 65536 bf16
    inputs, and the kernel bit-equal at the prefill shapes of mamba2's and
    zamba2's z (a slice of the in_proj output read in place) and conv
    outputs; times beside the plain version, ``F.silu``, the bytes bound
    (one read and one write of each element) and the issue-rate bound (the
    SASS instructions an element, ``cuobjdump -sass``, at 4 warp
    instructions a clock an SM at the card's top SM clock)."""
    import torch.nn.functional as F
    from repro_torch.kernels.silu import ops
    from repro_torch.kernels.silu.ref import silu_ref
    every = torch.arange(-32768, 32768, dtype=torch.int32,
                         device="cuda").to(torch.int16).view(torch.bfloat16)
    same = torch.equal(ops.silu(every).view(torch.int16),
                       silu_ref(every).view(torch.int16))
    log(f"  silu over all 65536 bf16 inputs: bit-equal to its plain version "
        f"{same}")
    if not same:
        raise SystemExit("the shared SiLU disagrees with its plain version")
    per_elem, n_sass = sass_per_element("silu_kernel", 2 * 8)
    clock = sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"  silu_kernel<bf16>: {n_sass} SASS instructions for its 16 "
        f"elements a thread, {per_elem:.2f} an element; {sms} SMs at "
        f"{clock / 1e6:.0f} MHz")
    cases = {"mamba2_z": (4096, 8512), "mamba2_conv": (4352, 4352),
             "zamba2_z": (7168, 14576), "zamba2_conv": (7296, 7296)}
    rec = {}
    for key, (d, row) in cases.items():
        for dt in (torch.bfloat16, torch.float32):
            x = (torch.randn(BATCH * PROMPT, row, generator=gen,
                             device="cuda") * 4).to(dt)[:, :d]
            y = ops.silu(x)
            torch.cuda.synchronize()
            same = torch.equal(y.view(torch.uint8),
                               silu_ref(x).contiguous().view(torch.uint8))
            log(f"  silu[{key}] ({BATCH * PROMPT}, {d}) of rows {row} "
                f"{str(dt)[6:]}: bit-equal to its plain version {same}")
            if not same:
                raise SystemExit("silu disagrees with its plain version")
            if dt == torch.bfloat16:
                xb = x
        x = xb
        n = BATCH * PROMPT * d
        rec[key] = {"rows, d": [BATCH * PROMPT, d],
                    "ms": time_ms(lambda: ops.silu(x)),
                    "plain_ms": time_ms(lambda: silu_ref(x)),
                    "library_ms": time_ms(lambda: F.silu(x)),
                    "issue_bound_ms": per_elem * n / (32 * 4 * sms * clock)
                    * 1e3}
        rec[key]["bound_ms"], rec[key]["bound_by"] = bound(
            2 * 2 * n, (4.0 * n, F32_PEAK))
        log(f"  silu[{key}] bf16: kernel {rec[key]['ms']:.4f} ms, plain "
            f"{rec[key]['plain_ms']:.4f} ms, F.silu "
            f"{rec[key]['library_ms']:.4f} ms, bound "
            f"{rec[key]['bound_ms']:.4f} ms (bytes), issue bound "
            f"{rec[key]['issue_bound_ms']:.4f} ms; "
            f"{rec[key]['bound_ms'] / rec[key]['ms']:.0%} of the bytes bound")
    g = rec["mamba2_z"]
    return dict({k: g[k] for k in ("ms", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by", "issue_bound_ms")},
                name="silu", route="cuda",
                source="src/repro_torch/kernels/csrc/silu.cu",
                replaces="src/repro/models/ssm.py:185", max_abs_err=0.0,
                sass_per_element=per_elem,
                shapes={k: v for k, v in rec.items() if k != "mamba2_z"})


def check_conv_silu(torch, gen):
    """The mamba block's conv pass (``conv_silu``) bit-equal to the plain
    chain it replaces, output and the shifted ``conv_buf``, at mamba2's and
    zamba2's widths: a decode step (s = 1) and a prefill (s = 512) into a
    cache with history, and the cacheless forward (zero history), in bf16
    and float32, conv_in read in place from an in_proj-shaped tensor; times
    beside that chain at both widths, the decode step cold (each call reads
    its own copy of the weight and the cache).  No single PyTorch call
    computes it (``F.conv1d`` leaves out the rounding of each tap and the
    SiLU)."""
    from repro_torch.kernels.silu import ops
    from repro_torch.kernels.silu.ref import conv_silu_ref
    widths = {"mamba2": (4096, 128, 64), "zamba2": (7168, 64, 112)}
    k = 4
    rec = {}
    for key, (di, n, h) in widths.items():
        c = di + 2 * n
        row = 2 * di + 2 * n + h
        for s in (1, PROMPT):
            for dt in (torch.bfloat16, torch.float32):
                z = torch.randn(BATCH, s, row, generator=gen, device="cuda")
                conv_in = z.to(dt)[..., di:di + c]
                w = (torch.randn(k, c, generator=gen, device="cuda")
                     * 0.5).to(dt)
                b = (torch.randn(c, generator=gen, device="cuda")
                     * 0.1).to(dt)
                hist = torch.randn(BATCH, k - 1, c, generator=gen,
                                   device="cuda").to(dt)
                for cached in (True, False):
                    hk = hist.clone() if cached else None
                    hp = hist.clone() if cached else None
                    got = ops.conv_silu(hk, conv_in, w, b)
                    torch.cuda.synchronize()
                    want = conv_silu_ref(hp, conv_in, w, b)
                    same = torch.equal(got.view(torch.uint8),
                                       want.contiguous().view(torch.uint8))
                    if cached:
                        same &= torch.equal(hk.view(torch.uint8),
                                            hp.view(torch.uint8))
                    log(f"  conv_silu[{key}] B={BATCH} s={s} C={c} "
                        f"{str(dt)[6:]} {'cache' if cached else 'no cache'}"
                        f": output{' and conv_buf' if cached else ''} "
                        f"bit-equal to the plain chain {same}")
                    if not same:
                        raise SystemExit("conv_silu disagrees with its plain "
                                         "chain")
            # times in bf16
            conv_in = torch.randn(BATCH, s, row, generator=gen,
                                  device="cuda").bfloat16()[..., di:di + c]
            nbytes = 2 * (2 * BATCH * s * c + 2 * BATCH * (k - 1) * c
                          + k * c + c)
            copies = cold_copies(nbytes)
            ws = [(torch.randn(k, c, generator=gen, device="cuda")
                   * 0.5).bfloat16() for _ in range(copies)]
            hs = [torch.randn(BATCH, k - 1, c, generator=gen,
                              device="cuda").bfloat16()
                  for _ in range(copies)]
            b = torch.zeros(c, dtype=torch.bfloat16, device="cuda")
            r = {"B, s, C": [BATCH, s, c],
                 "ms": time_ms(lambda: ops.conv_silu(hs[0], conv_in, ws[0],
                                                     b)),
                 "plain_ms": time_ms(lambda: conv_silu_ref(hs[0], conv_in,
                                                           ws[0], b)),
                 "library_ms": None}
            if s == 1:
                r["cold_ms"], _ = time_cold_ms(
                    lambda i: ops.conv_silu(hs[i], conv_in, ws[i], b), nbytes)
                r["plain_cold_ms"], _ = time_cold_ms(
                    lambda i: conv_silu_ref(hs[i], conv_in, ws[i], b),
                    nbytes)
            r["bound_ms"], r["bound_by"] = bound(
                nbytes, ((2.0 * k + 5) * BATCH * s * c, F32_PEAK))
            rec[f"{key}_s{s}"] = r
            cold = (f" (cold {r['cold_ms']:.4f})", f" (cold "
                    f"{r['plain_cold_ms']:.4f})") if s == 1 else ("", "")
            log(f"  conv_silu[{key}] B={BATCH} s={s} C={c} bf16: kernel "
                f"{r['ms']:.4f} ms{cold[0]}, plain chain "
                f"{r['plain_ms']:.4f} ms{cold[1]}, "
                f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
            del ws, hs
    g = rec["mamba2_s1"]
    return dict({key: g[key] for key in ("ms", "plain_ms", "library_ms",
                                         "bound_ms", "bound_by")},
                name="conv_silu", route="cuda",
                source="src/repro_torch/kernels/csrc/silu.cu",
                replaces="src/repro/models/ssm.py:151", max_abs_err=0.0,
                shapes={key: v for key, v in rec.items()
                        if key != "mamba2_s1"})


# (B, S, H, P, N, Q) and the conv width C of the train runs (batch 4 x 512)
SSM_BWD_SHAPES = {"mamba2": ((BATCH, PROMPT, 64, 64, 128, 128), 4352),
                  "zamba2": ((BATCH, PROMPT, 112, 64, 64, 128), 7296)}
SSM_CONV = 4            # their conv width K (ssm_conv)
# the SSD backward's ddt and dA are float32 outputs of float32 arithmetic in
# the kernel and in its plain version alike, from the same inputs whatever
# their type, so they are held to float32 limits: ddt per element, at 5e-4
# (1 + |plain|), since each element ends a reverse sum over the chunk of
# row and column sums of T whose terms are far larger than it (read on an
# H100: 1.8e-4 at mamba2's training shape, 2.6e-4 at zamba2's); dA on its
# largest |plain| (a sum over the batch and the sequence whose terms
# cancel: 9.9e-6 of the largest at mamba2's shape)
SSD_DDT_TOL, SSD_DA_TOL = 5e-4, 1e-4
# the gated norm's bf16 gradients pass through a chain of roundings (dv,
# then dy = r(dv silu(z)), then dxh = r(dy D)): where the float32 sums of
# the kernel and the plain version round dv to neighbouring bf16 values,
# dxh moves by up to two bf16 steps (1.14x the 1e-2 bound at zamba2's
# width, measured on an H100)
GATED_BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
ELEM_BWD_TOL = {"bfloat16": BWD_TOL, "float32": 1e-4}


def _grad_errs(torch, got, want, limits):
    """Per gradient: (max |kernel - plain|, the worst of it over its limit,
    over 2^-6 of the largest |plain|).  ``limits[name]`` is (tol, on): on
    "element", tol (1 + |plain|) per element; on "largest", tol times the
    largest |plain| (a float32 sum over the batch and the sequence whose
    terms cancel)."""
    out = {}
    for name in got:
        g, w = got[name].float(), want[name].float()
        e = (g - w).abs()
        top = w.abs().max().item()
        tol, on = limits[name]
        scale = top if on == "largest" else (1 + w.abs())
        elem = (e / (tol * scale)).max().item()
        out[name] = (e.max().item(), elem, e.max().item() / (2 ** -6 * top))
    return out


def bwd_check(torch, label, fn, plain, limits):
    """``fn()`` (a dict of gradients) twice against ``plain()`` on the same
    inputs: each gradient finite, within its limit (``_grad_errs``) and
    2^-6 of its largest |plain|, the two runs bit-identical; logged, and a
    failure exits.  Returns the largest |kernel - plain|."""
    got = fn()
    again = fn()
    torch.cuda.synchronize()
    same = all(torch.equal(a.contiguous().view(torch.uint8),
                           c.contiguous().view(torch.uint8))
               for a, c in zip(got.values(), again.values()))
    errs = _grad_errs(torch, got, plain(), limits)
    ok = same and all(math.isfinite(a) and el <= 1 and sc <= 1
                      for a, el, sc in errs.values())
    log(f"  {label}: " + ", ".join(
        f"{k} {a:.3g} ({el:.3g} of its limit, {limits[k][0]:g} on the "
        f"{limits[k][1]}; {sc:.3g} of 2^-6 of the largest)"
        for k, (a, el, sc) in errs.items())
        + f"; two runs bit-identical {same}: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{label} disagrees with its plain version or is "
                         "not bit-identical twice")
    return max(a for a, _, _ in errs.values())


def ssd_bwd_work(b, s, h, p, n, q):
    """What the SSD backward does, per (b, chunk): C B^T's causal half
    (bf16 operands), and per (b, h, chunk) dy x^T's causal half (bf16
    operands), then with a float32 operand W^T dy, E^T C and E B (causal
    halves), G B, x^T G and dy^T S, and the recomputed chunk states and
    their gradients (Q P N each); the bytes of x, dt, A, B, C and dy read
    once and dx, ddt, dA, dB and dC written once (bf16 x/B/C/dy).  Returns
    (bf16 FLOP, float32-operand FLOP, bytes)."""
    nc = -(-s // q)
    tri = q * (q + 1) / 2
    bf = 2.0 * b * nc * (tri * n + h * tri * p)
    f32 = 2.0 * b * nc * h * (tri * p + 2 * tri * n + 5 * q * p * n)
    nbytes = (2 * 2 * 2 * b * s * h * p        # x, dy in; dx out
              + 2 * 2 * 2 * b * s * n          # B, C in; dB, dC out
              + 2 * 4 * b * s * h + 3 * 4 * h)  # dt in, ddt out; A, dA
    return bf, f32, nbytes


def ssd_bwd_case(torch, gen, b, s, h, p, n, q, dtype):
    """``ssd_scan_bwd`` against ``ssd_bwd_ref`` at one shape (``bwd_check``:
    dxh, dBm and dCm within ``ELEM_BWD_TOL`` of their type, ddt and dA
    within float32's).  Returns (the largest |kernel - plain|, the inputs,
    dy)."""
    from repro_torch.kernels.ssd import ops, ref
    ins = ssd_inputs(torch, gen, b, s, h, p, n, dtype)
    dy = (torch.randn(b, s, h, p, generator=gen, device="cuda")
          .to(dtype))
    names = ("dxh", "ddt", "dA", "dBm", "dCm")
    t = ELEM_BWD_TOL[str(dtype)[6:]]
    limits = {"dxh": (t, "element"), "ddt": (SSD_DDT_TOL, "element"),
              "dA": (SSD_DA_TOL, "largest"), "dBm": (t, "element"),
              "dCm": (t, "element")}
    err = bwd_check(
        torch, f"ssd_scan_bwd B={b} S={s} H={h} P={p} N={n} Q={q} "
        f"{str(dtype)[6:]}",
        lambda: dict(zip(names, ops.ssd_scan_bwd(*ins, dy, q))),
        lambda: dict(zip(names, ref.ssd_bwd_ref(*ins, dy, q))), limits)
    return err, ins, dy


def ssd_bwd_timing(torch, ins, dy, q):
    """The SSD backward's times at one shape: the kernel warm, each of its
    launches from the profiler, the plain version, and the bound: the
    float32-operand products counted as the forward kernel runs them, two
    bf16 terms each on the tensor cores (``check_ssd``), with their time at
    the float32 FMA rate logged beside."""
    from repro_torch.kernels.ssd import ops, ref
    b, s, h, p = ins[0].shape
    n = ins[3].shape[-1]
    bf, fl, nbytes = ssd_bwd_work(b, s, h, p, n, q)
    b_ms, b_by = bound(nbytes, (bf + 2 * fl, BF16_PEAK))
    o_ms, o_by = bound(nbytes, (bf, BF16_PEAK), (fl, F32_PEAK))
    t = {"B, S, H, P, N": [b, s, h, p, n],
         "ms": time_ms(lambda: ops.ssd_scan_bwd(*ins, dy, q)),
         "cold_ms": cold_ms_of(lambda *a: ops.ssd_scan_bwd(*a, q),
                               (*ins, dy)),
         "plain_ms": time_ms(lambda: ref.ssd_bwd_ref(*ins, dy, q), iters=5),
         "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
         "fma_bound_ms": o_ms,
         "per_pass_ms": pass_times(
             torch, lambda: ops.ssd_scan_bwd(*ins, dy, q), "ssd_bwd",
             iters=5)}
    log(f"  ssd_scan_bwd B={b} S={s} H={h} P={p} N={n}: kernel "
        f"{t['ms']:.4f} ms warm, {t['cold_ms']:.4f} cold (per launch, warm: "
        + ", ".join(f"{k} {v:.4f}" for k, v in t["per_pass_ms"].items())
        + f" a launch), plain {t['plain_ms']:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}; {bf / 1e9:.2f} GFLOP bf16 + 2 x {fl / 1e9:.2f} GFLOP "
        f"split, {nbytes / 1e6:.2f} MB), {b_ms / t['ms']:.2%} of it; "
        f"counted at the float32 FMA rate {o_ms:.4f} ms ({o_by})")
    return t


def gated_bwd_case(torch, gen, key, dtype):
    """``gated_rms_norm_bwd`` against ``gated_rms_norm_bwd_ref`` at a train
    run's shape (``SSM_BWD_SHAPES[key]``: rows B x S, width H x P), xh and z
    read in place from their rows (``bwd_check``, ``GATED_BWD_TOL``).
    Returns (the largest |kernel - plain|, the inputs (y, D, xh, z, w,
    g))."""
    from repro_torch.kernels.decode import ops as dops, ref as dref
    b, s, h, p, n = SSM_BWD_SHAPES[key][0][:5]
    di = h * p

    def randn(*shape, scale=1.0, dt=dtype):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(dt)

    zx = randn(b, s, 2 * di + 2 * n + h, scale=3.0)
    conv = randn(b, s, di + 2 * n)
    z, xh = zx[..., :di], conv[..., :di].reshape(b, s, h, p)
    y = randn(b, s, h, p)
    D = 1 + 0.5 * randn(h, dt=torch.float32)
    w = (1 + 0.1 * randn(di, dt=torch.float32)).to(dtype)
    g = randn(b, s, di)
    ins = (y, D, xh, z, w, g)
    names = ("dy", "dD", "dxh", "dz", "dw")
    err = bwd_check(
        torch, f"gated_rms_norm_bwd[{key}] ({b * s}, {di}) H={h} "
        f"{str(dtype)[6:]}",
        lambda: dict(zip(names, dops.gated_rms_norm_bwd(
            y, D, xh, z, w, 1e-5, g))),
        lambda: dict(zip(names, dref.gated_rms_norm_bwd_ref(
            y, D, xh, z, w, 1e-5, g))),
        {k: (GATED_BWD_TOL[str(dtype)[6:]], "element") for k in names})
    return err, ins


def gated_bwd_timing(torch, ins):
    """The gated norm's backward times at one shape: the kernel warm, each
    of its launches from the profiler, the plain version, and the bound (y,
    xh, z, g read once, dy, dxh, dz written once, w and D in, dw and dD
    out)."""
    from repro_torch.kernels.decode import ops as dops, ref as dref
    y, D, xh, z, w, g = ins
    b, s, h, p = y.shape
    di = h * p
    nbytes = 2 * (7 * b * s * di + 2 * di) + 8 * h
    b_ms, b_by = bound(nbytes, (40.0 * b * s * di, F32_PEAK))

    def call():
        return dops.gated_rms_norm_bwd(y, D, xh, z, w, 1e-5, g)
    t = {"rows, d, H": [b * s, di, h], "ms": time_ms(call),
         "cold_ms": cold_ms_of(lambda *a: dops.gated_rms_norm_bwd(
             *a[:5], 1e-5, a[5]), ins),
         "plain_ms": time_ms(lambda: dref.gated_rms_norm_bwd_ref(
             y, D, xh, z, w, 1e-5, g)),
         "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
         "per_pass_ms": pass_times(torch, call, "gated_bwd")}
    log(f"  gated_rms_norm_bwd ({b * s}, {di}) H={h}: kernel {t['ms']:.4f} "
        f"ms warm, {t['cold_ms']:.4f} cold (per launch, warm: "
        + ", ".join(f"{k} {v:.4f}" for k, v in
                          t["per_pass_ms"].items())
        + f" a launch), plain {t['plain_ms']:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}; {nbytes / 1e6:.2f} MB), {b_ms / t['ms']:.2%} of it")
    return t


def conv_bwd_case(torch, gen, key, dtype):
    """``conv_silu_bwd`` against ``conv_silu_bwd_ref`` at a train run's
    shape (``SSM_BWD_SHAPES[key]``: B x S rows of C channels), conv_in read
    in place from an in_proj row (``bwd_check``, ``ELEM_BWD_TOL``).
    Returns (the largest |kernel - plain|, the inputs (conv_in, w, bias,
    g))."""
    from repro_torch.kernels.silu import ops as sops, ref as sref
    shape, c = SSM_BWD_SHAPES[key]
    b, s, n = shape[0], shape[1], shape[4]
    di = c - 2 * n

    def randn(*sh, scale=1.0):
        return (torch.randn(*sh, generator=gen, device="cuda")
                * scale).to(dtype)

    conv_in = randn(b, s, 2 * di + 2 * n + shape[2], scale=2.0)[
        ..., di:di + c]
    w = randn(SSM_CONV, c, scale=0.5)
    bias = randn(c, scale=0.1)
    g = randn(b, s, c)
    ins = (conv_in, w, bias, g)
    names = ("dconv_in", "dw", "db")
    err = bwd_check(
        torch, f"conv_silu_bwd[{key}] B={b} S={s} C={c} {str(dtype)[6:]}",
        lambda: dict(zip(names, sops.conv_silu_bwd(*ins))),
        lambda: dict(zip(names, sref.conv_silu_bwd_ref(*ins))),
        {k: (ELEM_BWD_TOL[str(dtype)[6:]], "element") for k in names})
    return err, ins


def digest(torch, t):
    """A short digest of a tensor's bytes: two trees whose outputs share it
    gave the same bits."""
    import hashlib
    return hashlib.sha256(t.contiguous().view(-1).view(
        torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]


def conv_bwd_timing(torch, ins):
    """The conv pass's backward times at one shape: the kernel warm and
    cold, each of its launches from the profiler, the plain version, and
    the bound (conv_in and g read once, dconv_in written once, w and the
    bias in, dw and db out; 3K + 8 float32 operations an element); a digest
    of each output's bytes, which tells what two trees give bit for bit;
    and, where the port plans the pass in runs (``conv_bwd_plan``), the
    kernel at each run length the plan may take."""
    from repro_torch.kernels.silu import ops as sops, ref as sref
    conv_in, w, bias, g = ins
    b, s, c = conv_in.shape
    k = w.shape[0]
    nbytes = conv_in.element_size() * (3 * b * s * c + 2 * (k + 1) * c)
    b_ms, b_by = bound(nbytes, (2.0 * (3 * k + 8) * b * s * c, F32_PEAK))

    def call():
        return sops.conv_silu_bwd(conv_in, w, bias, g)
    t = {"B, S, C": [b, s, c], "ms": time_ms(call),
         "cold_ms": cold_ms_of(sops.conv_silu_bwd, ins),
         "plain_ms": time_ms(lambda: sref.conv_silu_bwd_ref(*ins)),
         "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
         "per_pass_ms": pass_times(torch, call, "conv_silu_bwd"),
         "digest": {n: digest(torch, o)
                    for n, o in zip(("dconv_in", "dw", "db"), call())}}
    plan = getattr(sops, "conv_bwd_plan", None)
    if plan is not None:
        t["plan"] = plan(b, s, c * conv_in.element_size() // 16,
                         torch.cuda.get_device_properties(
                             0).multi_processor_count)
        t["by_run"] = {}
        try:
            for run in sops.CONV_BWD_RUNS:
                sops.conv_bwd_plan = (lambda *_, r=run: (
                    r, -(-sops.CONV_BWD_SLICE // r)))
                t["by_run"][run] = time_ms(call)
        finally:
            sops.conv_bwd_plan = plan
    log(f"  conv_silu_bwd B={b} S={s} C={c}: kernel {t['ms']:.4f} ms warm, "
        f"{t['cold_ms']:.4f} cold (per launch, warm: "
        + ", ".join(f"{n} {v:.4f}" for n, v in t["per_pass_ms"].items())
        + f"), plain {t['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
        f"{nbytes / 1e6:.2f} MB), {b_ms / t['ms']:.2%} of it, "
        f"{nbytes / t['ms'] / 1e9:.3f} TB/s; plan {t.get('plan')}, by run "
        f"{t.get('by_run')}; digests {t['digest']}")
    return t


def conv_bwd_sass(torch):
    """The pass's SASS instructions an element (bf16, K = 4, the 16-byte
    path: a trip of its loop takes K tokens of 8 channels; on its fast path,
    and the whole loop), the issue bound the fast path sets at mamba2's
    shape (4 warp instructions a clock an SM at the top SM clock), and
    every instance's registers and spill stack; fails on a spill.  None for
    a tree whose pass has no such loop."""
    from repro_torch.kernels import _build
    got = sass_loop_per_element(
        f"20conv_silu_bwd_kernelI13__nv_bfloat16Li{SSM_CONV}ELi8E",
        SSM_CONV * 8)
    if got is None:
        return {"sass_per_element": None}
    per, fast, n_loop, n_all = got
    shape, c = SSM_BWD_SHAPES["mamba2"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = sm_clock_hz()
    issue = fast * shape[0] * shape[1] * c / (32 * 4 * sms * clock) * 1e3
    usage = {re.sub(r"^_ZN12_GLOBAL__N_1\d+", "", f): r
             for f, r in _build.resource_usage("silu").items()
             if "conv_silu_bwd" in f}
    log(f"  conv_silu_bwd_kernel<bf16, {SSM_CONV}, 8>: {n_loop} SASS "
        f"instructions a trip of its loop ({SSM_CONV * 8} elements), "
        f"{per:.2f} an element, {fast:.2f} on its fast path ({n_all} in the "
        f"function); issue bound at mamba2's shape {issue:.4f} ms ({sms} SMs "
        f"at {clock / 1e6:.0f} MHz); registers (spill stack bytes): "
        + ", ".join(
            f"{f} {r} ({st})" for f, (r, st) in sorted(usage.items())))
    spills = {f: st for f, (_, st) in usage.items() if st}
    if spills:
        raise SystemExit(f"conv_silu_bwd spills: {spills}")
    return {"sass_per_element": fast, "sass_per_element_loop": per,
            "issue_bound_ms": issue,
            "registers": {f: r for f, (r, _) in usage.items()}}


def check_ssm_bwd(torch, gen):
    """The SSM training path's three backward kernels against their plain
    versions at the train runs' shapes (mamba2-1.3b and zamba2-7b, batch
    4 x 512), two runs bit-identical, each gradient within 2^-6 of its
    largest |plain| and, per element, 1e-2 (1 + |plain|) in bf16 (a bf16
    step is under 0.8% of the value; the gated norm's 2e-2, argued at
    ``GATED_BWD_TOL``) or 1e-4 in float32; the scan's float32 ddt and dA
    within float32 limits whatever the inputs' type (``SSD_DDT_TOL`` per
    element, ``SSD_DA_TOL`` of the largest): ``ssd_scan_bwd`` (also a
    ragged S and the float32 path), ``conv_silu_bwd`` (conv_in read in
    place from an in_proj row), ``gated_rms_norm_bwd`` (xh and z read in
    place).  Times beside the plain version and the bound; no single
    PyTorch call computes any of the three (``library_ms`` null)."""
    from repro_torch.kernels.silu import ops as sops, ref as sref
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(dtype)

    def elem(names, tol):
        return {k: (tol, "element") for k in names}

    recs = {}
    # the scan
    err, timing = 0.0, {}
    for b, s, h, p, n, q, dt_ in (
            (*SSM_BWD_SHAPES["mamba2"][0], bf16),
            (*SSM_BWD_SHAPES["zamba2"][0], bf16),
            (1, 300, 64, 64, 128, 128, bf16), (2, 40, 8, 16, 16, 16, bf16),
            (2, 200, 8, 64, 128, 128, f32)):
        e, ins, dy = ssd_bwd_case(torch, gen, b, s, h, p, n, q, dt_)
        err = max(err, e)
        if s == PROMPT and dt_ == bf16:
            timing[h] = ssd_bwd_timing(torch, ins, dy, q)
        del ins, dy
    m = timing[64]
    recs["ssd_scan_bwd"] = dict(
        {k: m[k] for k in ("ms", "cold_ms", "plain_ms", "bound_ms",
                           "bound_by", "library_ms", "per_pass_ms")},
        name="ssd_scan_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_bwd.cu",
        replaces="src/repro/models/ssm.py:55 (JAX autodiff of ssd_chunked)",
        max_abs_err=err, zamba2=timing[112],
        main_path="mamba2-1.3b/train_full")

    # the conv pass
    err, timing = 0.0, {}
    for key in SSM_BWD_SHAPES:
        for dt_ in (bf16, f32):
            e, ins = conv_bwd_case(torch, gen, key, dt_)
            err = max(err, e)
            if dt_ == bf16:
                timing[key] = conv_bwd_timing(torch, ins)
            del ins
    m = timing["mamba2"]
    recs["conv_silu_bwd"] = dict(
        {k_: m[k_] for k_ in ("ms", "cold_ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms", "per_pass_ms")},
        name="conv_silu_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/silu.cu",
        replaces="src/repro/models/ssm.py:151 (JAX autodiff of the conv "
                 "and SiLU)",
        max_abs_err=err, zamba2=timing["zamba2"],
        main_path="mamba2-1.3b/train_full", **conv_bwd_sass(torch))

    # the gated norm
    err, timing = 0.0, {}
    for key in SSM_BWD_SHAPES:
        for dt_ in (bf16, f32):
            e, ins = gated_bwd_case(torch, gen, key, dt_)
            err = max(err, e)
            if dt_ == bf16:
                timing[key] = gated_bwd_timing(torch, ins)
            del ins
    m = timing["mamba2"]
    recs["gated_rms_norm_bwd"] = dict(
        {k_: m[k_] for k_ in ("ms", "cold_ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms", "per_pass_ms")},
        name="gated_rms_norm_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/norm.cu",
        replaces="src/repro/models/ssm.py:183 (JAX autodiff of the skip, "
                 "gate and rms_norm)",
        max_abs_err=err, zamba2=timing["zamba2"],
        main_path="mamba2-1.3b/train_full")
    return list(recs.values())


def check_norm(torch, gen):
    """``rms_norm_rows`` and its fused forms.  The norm within 3e-2 (1 +
    |plain|) of the plain float32 chain at decode rows (M = BATCH) and at a
    prefill's rows (BATCH x PROMPT), each row's bits the same alone, in a
    batch of 4 and among the prefill's rows; the residual form bit-equal to
    ``h + delta`` and the norm kernel on it, the gated form bit-equal to the
    norm kernel on the plain prologue (skip, SiLU gate), at granite's,
    mamba2's and zamba2's widths; times beside the plain chain each
    replaces and, for the plain norm, ``F.rms_norm``."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode import ops, ref
    from repro_torch.kernels.silu.ref import silu_ref
    bf16, tol = torch.bfloat16, 3e-2
    rows = BATCH * PROMPT
    records, err_max = {}, 0.0

    def randn(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(dtype)

    def bits(a, b):
        return torch.equal(a.contiguous().view(torch.uint8),
                           b.contiguous().view(torch.uint8))

    # the plain norm at decode and prefill rows
    rn = {}
    for key, d in (("granite", 2048), ("minicpm", 2304), ("zamba2", 3584),
                   ("deepseek", 4096), ("llama3", 16384),
                   ("deepseek_v3", 7168), ("llama4", 5120),
                   ("deepseek_v3_q_norm", 1536)):
        x, w = randn(rows, d, scale=3.0), randn(d, scale=0.1) + 1
        out = ops.rms_norm_rows(x, w, 1e-5)
        torch.cuda.synchronize()
        want = ref.rms_norm_ref(x, w, 1e-5)
        e = (out.float() - want.float()).abs()
        ok = bool((e <= tol * (1 + want.float().abs())).all())
        err_max = max(err_max, e.max().item())
        inv = all(bits(ops.rms_norm_rows(x[r:r + 1], w, 1e-5), out[r:r + 1])
                  for r in (0, 1, 2, 3, 777, rows - 1)) and bits(
            ops.rms_norm_rows(x[:BATCH], w, 1e-5), out[:BATCH])
        log(f"  rms_norm_rows[{key}] ({rows}, {d}) bf16: max |kernel - "
            f"plain| = {e.max().item():.3g} (tol {tol:g} (1 + |plain|)); a "
            f"row alone = in a batch of {BATCH} = among {rows}: {inv}")
        if not (ok and inv and math.isfinite(e.max().item())):
            raise SystemExit(f"rms_norm_rows[{key}] disagrees with its plain "
                             f"version or depends on the rows around it")
        if key == "minicpm" or key == "deepseek":
            continue
        xb = x[:BATCH]
        r = {"D": d}
        for m, xs in ((BATCH, xb), (rows, x)):
            sfx = "" if m == BATCH else "_prefill"
            r["ms" + sfx] = time_ms(lambda: ops.rms_norm_rows(xs, w, 1e-5))
            r["plain_ms" + sfx] = time_ms(lambda: ref.rms_norm_ref(xs, w,
                                                                    1e-5))
            r["library_ms" + sfx] = time_ms(lambda: F.rms_norm(xs, (d,), w,
                                                               1e-5))
            r["bound_ms" + sfx], r["bound_by" + sfx] = bound(
                2 * (2 * m * d + d), (4.0 * m * d, F32_PEAK))
        rn[key] = r
        log(f"  rms_norm_rows[{key}] D={d}: ({BATCH} rows) kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, F.rms_norm "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms; "
            f"({rows} rows) kernel {r['ms_prefill']:.4f} ms, plain "
            f"{r['plain_ms_prefill']:.4f} ms, F.rms_norm "
            f"{r['library_ms_prefill']:.4f} ms, bound "
            f"{r['bound_ms_prefill']:.4f} ms")
    records["rms_norm_rows"] = dict(
        {k: rn["granite"][k] for k in ("ms", "plain_ms", "library_ms",
                                       "bound_ms", "bound_by")},
        max_abs_err=err_max,
        shapes={k: v for k, v in rn.items() if k != "granite"} | {
            "granite_prefill": {k: rn["granite"][k + "_prefill"]
                                for k in ("ms", "plain_ms", "library_ms",
                                          "bound_ms", "bound_by")}})

    # MLA's kv_norm: the first 512 of each 576-wide row of wdkv's output,
    # read in place at the row stride 576; the bits of the norm of the
    # same rows made contiguous
    kl, row = 512, 576
    w = randn(kl, scale=0.1) + 1
    r = {"D, row stride": [kl, row]}
    for m, s_ in ((BATCH, 1), (rows, PROMPT)):
        x = randn(BATCH, s_, row, scale=3.0)[..., :kl]
        out = ops.rms_norm_rows(x, w, 1e-5)
        torch.cuda.synchronize()
        want = ref.rms_norm_ref(x, w, 1e-5)
        e = (out.float() - want.float()).abs()
        ok = bool((e <= tol * (1 + want.float().abs())).all())
        err_max = max(err_max, e.max().item())
        same = bits(out, ops.rms_norm_rows(x.contiguous(), w, 1e-5)) and \
            bits(ops.rms_norm_rows(x[:1], w, 1e-5), out[:1])
        log(f"  rms_norm_rows[kv_norm] ({m}, {kl}) at row stride {row} bf16: "
            f"max |kernel - plain| = {e.max().item():.3g} (tol {tol:g} (1 + "
            f"|plain|)); bit-equal to the norm of the contiguous rows, a "
            f"row alone = among {m}: {same}")
        if not (ok and same and math.isfinite(e.max().item())):
            raise SystemExit("rms_norm_rows on MLA's strided kv_norm rows "
                             "disagrees with its plain version")
        sfx = "" if m == BATCH else "_prefill"
        r["ms" + sfx] = time_ms(lambda: ops.rms_norm_rows(x, w, 1e-5))
        r["plain_ms" + sfx] = time_ms(lambda: ref.rms_norm_ref(x, w, 1e-5))
        r["library_ms" + sfx] = time_ms(lambda: F.rms_norm(x, (kl,), w,
                                                           1e-5))
        r["bound_ms" + sfx], r["bound_by" + sfx] = bound(
            2 * (2 * m * kl + kl), (4.0 * m * kl, F32_PEAK))
        log(f"  rms_norm_rows[kv_norm] ({m}, {kl}): kernel "
            f"{r['ms' + sfx]:.4f} ms, plain {r['plain_ms' + sfx]:.4f} ms, "
            f"F.rms_norm {r['library_ms' + sfx]:.4f} ms, bound "
            f"{r['bound_ms' + sfx]:.5f} ms")
    records["rms_norm_rows"]["shapes"]["deepseek_v3_kv_norm"] = r
    records["rms_norm_rows"]["max_abs_err"] = err_max

    # the residual form: the dense block's h + attention before ln2
    rs = {}
    for key, d in (("granite", 2048), ("zamba2", 3584), ("llama3", 16384)):
        w = randn(d, scale=0.1) + 1
        for m in (BATCH, rows):
            h, delta = randn(m, d, scale=3.0), randn(m, d)
            hk, xk = ops.residual_rms_norm_rows(h, delta, w, 1e-5)
            torch.cuda.synchronize()
            hp = h + delta
            same = bits(hk, hp) and bits(xk, ops.rms_norm_rows(hp, w, 1e-5))
            log(f"  residual_rms_norm_rows[{key}] ({m}, {d}) bf16: h + delta "
                f"and its norm bit-equal to the norm kernel on the plain "
                f"add {same}")
            if not same:
                raise SystemExit("residual_rms_norm_rows moves a bit")
            if m == rows and key == "llama3":
                continue
            sfx = "" if m == BATCH else "_prefill"
            r = rs.setdefault(key, {"D": d})
            r["ms" + sfx] = time_ms(lambda: ops.residual_rms_norm_rows(
                h, delta, w, 1e-5))
            r["plain_ms" + sfx] = time_ms(lambda: ref.residual_rms_norm_ref(
                h, delta, w, 1e-5))
            r["library_ms" + sfx] = None
            r["bound_ms" + sfx], r["bound_by" + sfx] = bound(
                2 * (4 * m * d + d), (5.0 * m * d, F32_PEAK))
            log(f"  residual_rms_norm_rows[{key}] ({m}, {d}): kernel "
                f"{r['ms' + sfx]:.4f} ms, plain chain "
                f"{r['plain_ms' + sfx]:.4f} ms, bound "
                f"{r['bound_ms' + sfx]:.5f} ms")
    records["residual_rms_norm_rows"] = dict(
        {k: rs["granite"][k] for k in ("ms", "plain_ms", "library_ms",
                                       "bound_ms", "bound_by")},
        max_abs_err=0.0,
        shapes={k: v for k, v in rs.items() if k != "granite"} | {
            "granite_prefill": {k: rs["granite"][k + "_prefill"]
                                for k in ("ms", "plain_ms", "library_ms",
                                          "bound_ms", "bound_by")}})

    # the gated form: the mamba block's skip, SiLU gate and norm
    gt = {}
    for key, (h, p, n) in (("mamba2", (64, 64, 128)),
                           ("zamba2", (112, 64, 64))):
        di = h * p
        row = 2 * di + 2 * n + h
        w = randn(di, scale=0.1) + 1
        dv = torch.rand(h, generator=gen, device="cuda") + 0.5
        for s in (1, PROMPT):
            for dt in (bf16, torch.float32):
                zx = randn(BATCH, s, row, scale=3.0, dtype=dt)
                conv = randn(BATCH, s, di + 2 * n, dtype=dt)
                z, xh = zx[..., :di], conv[..., :di].reshape(BATCH, s, h, p)
                y = randn(BATCH, s, h, p, dtype=dt)
                got = ops.gated_rms_norm_rows(y, dv, xh, z, w.to(dt), 1e-5)
                torch.cuda.synchronize()
                g = (y + dv[None, None, :, None].to(dt) * xh).reshape(
                    z.shape) * silu_ref(z)
                same = bits(got, ops.rms_norm_rows(g, w.to(dt), 1e-5))
                log(f"  gated_rms_norm_rows[{key}] B={BATCH} s={s} H={h} "
                    f"P={p} {str(dt)[6:]}: bit-equal to the norm kernel on "
                    f"the plain skip and gate {same}")
                if not same:
                    raise SystemExit("gated_rms_norm_rows moves a bit")
            sfx = "" if s == 1 else "_prefill"
            zx = randn(BATCH, s, row, scale=3.0)
            conv = randn(BATCH, s, di + 2 * n)
            z, xh = zx[..., :di], conv[..., :di].reshape(BATCH, s, h, p)
            y = randn(BATCH, s, h, p)
            r = gt.setdefault(key, {"H, P": [h, p]})
            r["ms" + sfx] = time_ms(lambda: ops.gated_rms_norm_rows(
                y, dv, xh, z, w, 1e-5))
            r["plain_ms" + sfx] = time_ms(lambda: ref.gated_rms_norm_ref(
                y, dv, xh, z, w, 1e-5))
            r["library_ms" + sfx] = None
            m = BATCH * s
            r["bound_ms" + sfx], r["bound_by" + sfx] = bound(
                2 * (4 * m * di + di) + 4 * h, (12.0 * m * di, F32_PEAK))
            log(f"  gated_rms_norm_rows[{key}] ({m}, {di}): kernel "
                f"{r['ms' + sfx]:.4f} ms, plain chain "
                f"{r['plain_ms' + sfx]:.4f} ms, bound "
                f"{r['bound_ms' + sfx]:.5f} ms")
    records["gated_rms_norm_rows"] = dict(
        {k: gt["mamba2"][k] for k in ("ms", "plain_ms", "library_ms",
                                      "bound_ms", "bound_by")},
        max_abs_err=0.0,
        shapes={k: v for k, v in gt.items() if k != "mamba2"} | {
            "mamba2_prefill": {k: gt["mamba2"][k + "_prefill"]
                               for k in ("ms", "plain_ms", "library_ms",
                                         "bound_ms", "bound_by")}})
    replaces = {"rms_norm_rows": "src/repro/models/layers.py:126",
                "residual_rms_norm_rows": "src/repro/models/model.py:75",
                "gated_rms_norm_rows": "src/repro/models/ssm.py:185"}
    return [dict(r, name=name, route="cuda",
                 source="src/repro_torch/kernels/csrc/norm.cu",
                 replaces=replaces[name]) for name, r in records.items()]


def rows_bits(torch, fn, xs, m_max=8):
    """Whether row r of ``fn`` on the first m rows of the inputs ``xs``
    (each with rows on dim 0) has the bits of the same row alone, for m in
    2, 4 and 8 and every r < m."""
    full = fn(*(x[:m_max] for x in xs))
    for m in (1, 2, 4):
        part = fn(*(x[:m] for x in xs))
        if not torch.equal(part.view(-1).view(torch.uint8),
                           full[:m].contiguous().view(-1).view(torch.uint8)):
            return False
    for r in range(m_max):
        alone = fn(*(x[r:r + 1] for x in xs))
        if not torch.equal(alone.view(-1).view(torch.uint8),
                           full[r:r + 1].contiguous().view(-1)
                           .view(torch.uint8)):
            return False
    return True


def check_decode(torch, gen):
    """The row-invariant decode kernels at the main paths' decode shapes
    (M = BATCH rows): each against its plain version, row r's bits alone
    and within batches of 2, 4 and 8 (and for attention against a cache cut
    to the fast loop's bucket, and to one that ends inside a split of 64
    keys, and the whole cache), the plain versions' invariance logged
    beside them (the ops at fault on this card), and times beside the
    bound and the library call each replaces.  ``rows_matmul`` and
    ``decode_attention``, and their library calls, are timed cold (a copy
    of the weight or cache a call, as a decode step reads them: ``ms``,
    ``library_ms``) and warm (one copy, in L2 where it fits: ``warm_ms``,
    ``warm_library_ms``); the others warm."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode import ops, ref
    bf16, f32 = torch.bfloat16, torch.float32
    tol = {bf16: 3e-2, f32: 2e-5}
    records, errs = {}, {}

    def close(name, got, want, dt):
        err = (got.float() - want.float()).abs()
        ok = bool((err <= tol[dt] * (1 + want.float().abs())).all())
        e = err.max().item()
        errs[name] = max(errs.get(name, 0.0), e)
        log(f"  {name} {tuple(got.shape)} {str(dt)[6:]}: max |kernel - "
            f"plain| = {e:.3g} (tol {tol[dt]:g} (1 + |plain|)) "
            f"{'ok' if ok and math.isfinite(e) else 'FAIL'}")
        if not (ok and math.isfinite(e)):
            raise SystemExit(f"{name} disagrees with its plain version")

    def invariant(name, kernel, plain, xs):
        k_ok = rows_bits(torch, kernel, xs)
        p_ok = rows_bits(torch, plain, xs)
        log(f"  {name}: row bits alone = in batches of 2, 4, 8: kernel "
            f"{k_ok}, plain version (the library op) {p_ok}")
        if not k_ok:
            raise SystemExit(f"{name}: a row's bits depend on the batch")
        return p_ok

    def randn(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(dtype)

    # rows_matmul: granite's wg, wk, wd and tied head (embed.T), mamba2's
    # in_proj, llama3's wg, whisper's wg and head (N = 51866: rows 4-byte
    # aligned, the narrow copies), granite's wg as a view 4 bytes off the
    # 16-byte grid (the narrow copies at a shape the 16-byte copies also
    # take), the VLM's wq and wg, the MoE models' projections and heads;
    # timed cold (a copy of the weight a call) and warm (one weight),
    # beside x @ w the same two ways; each with the path its weight takes
    # (ops.weight_copy: 16-byte copies, narrow copies, elements, or the
    # transposed weight's path)
    shapes = {"granite_wg": (2048, 8192, False),
              "granite_wk": (2048, 512, False),
              "granite_wd": (8192, 2048, False),
              "granite_head": (2048, 49155, True),
              "mamba2_in_proj": (2048, 8512, False),
              "llama3_wg": (16384, 53248, False),
              "whisper_wg": (1280, 5120, False),
              "whisper_head": (1280, 51866, False),   # rows not 16-B aligned
              "granite_wg_off4": (2048, 8192, "off4"),
              "vlm_wq": (8192, 8192, False),
              "vlm_wg": (8192, 28672, False),
              # deepseek-v3's MLA projections (wdkv's N = 512 + 64), shared
              # expert and head
              "deepseek_v3_wdq": (7168, 1536, False),
              "deepseek_v3_wuq": (1536, 24576, False),
              "deepseek_v3_wdkv": (7168, 576, False),
              "deepseek_v3_wo": (16384, 7168, False),
              "deepseek_v3_shared_wg": (7168, 2048, False),
              "deepseek_v3_shared_wd": (2048, 7168, False),
              "deepseek_v3_head": (7168, 129280, False),
              # llama4's 5120-wide projections, dense and shared-expert
              # MLPs and head
              "llama4_wq": (5120, 5120, False),
              "llama4_wk": (5120, 1024, False),
              "llama4_wg": (5120, 16384, False),
              "llama4_wd": (16384, 5120, False),
              "llama4_shared_wg": (5120, 8192, False),
              "llama4_shared_wd": (8192, 5120, False),
              "llama4_head": (5120, 202048, False)}
    mm = {}
    for key, (k, n, tied) in shapes.items():
        def draw():
            if tied == "off4":       # rows 4 bytes off the 16-byte grid
                return randn(k, n + 8, scale=k ** -0.5)[:, 2:2 + n]
            return (randn(n, k, scale=k ** -0.5).T if tied
                    else randn(k, n, scale=k ** -0.5))
        ws = [draw() for _ in range(cold_copies(2 * k * n))]
        w = ws[0]
        x = randn(8, k)
        close(f"rows_matmul[{key}]", ops.rows_matmul(x[:BATCH], w),
              x[:BATCH] @ w, bf16)
        p_ok = invariant(f"rows_matmul[{key}]",
                         lambda a: ops.rows_matmul(a, w), lambda a: a @ w,
                         [x])
        xb = x[:BATCH]
        k_ms, copies = time_cold_ms(lambda c: ops.rows_matmul(xb, ws[c]),
                                    2 * k * n)
        l_ms, _ = time_cold_ms(lambda c: xb @ ws[c], 2 * k * n)
        kw_ms = time_ms(lambda: ops.rows_matmul(xb, w))
        lw_ms = time_ms(lambda: xb @ w)
        b_ms, b_by = bound(2 * (k * n + BATCH * k + BATCH * n),
                           (2.0 * BATCH * k * n, BF16_PEAK))
        tn, ks = ((None, None) if tied is True else ops.rows_plan(
            k, n, 2, ops._sms(torch.cuda.current_device())))
        path = ("transposed" if tied is True else
                {16: "copies16", 8: "narrow8", 4: "narrow4", 0: "elements"}[
                    ops.weight_copy(w.data_ptr(), 2 * w.stride(0), 2 * n)])
        mm[key] = {"K, N": [k, n], "transposed_w": tied is True,
                   "path": path, "ms": k_ms,
                   "plain_ms": lw_ms, "library_ms": l_ms, "warm_ms": kw_ms,
                   "warm_library_ms": lw_ms, "bound_ms": b_ms,
                   "bound_by": b_by, "cold_copies": copies,
                   "plan": None if tied is True else {
                       "tn": tn, "ks": ks, "splits": -(-k // ks)},
                   "plain_row_invariant": p_ok}
        log(f"  rows_matmul[{key}] M={BATCH}: kernel cold {k_ms:.4f} ms "
            f"(warm {kw_ms:.4f}), x @ w cold {l_ms:.4f} ms (warm "
            f"{lw_ms:.4f}), bound {b_ms:.4f} ms ({b_by}; "
            f"{2 * k * n / 1e6:.1f} MB of weight, {copies} copies); plan "
            f"{mm[key]['plan']}, path {path}")
        if key in ("whisper_head", "granite_wg_off4") \
                and not path.startswith("narrow"):
            raise SystemExit(f"rows_matmul[{key}] took the {path} path, "
                             "not the narrow copies")
        del w, ws
    torch.cuda.empty_cache()
    g = mm["granite_wg"]
    records["rows_matmul"] = dict(
        {k: g[k] for k in ("ms", "plain_ms", "library_ms", "warm_ms",
                           "warm_library_ms", "bound_ms", "bound_by")},
        shapes={k: v for k, v in mm.items() if k != "granite_wg"})

    def attention_times(key, q, k, v, lens, h, kv, hd, s):
        """Cold and warm times of decode attention over (B, s) caches at
        the rows' lengths ``lens``, beside the masked SDPA, the plain
        version and the bound."""
        qb, lb = q[:BATCH], lens[:BATCH]
        mask = (torch.arange(s, device="cuda")[None, :]
                < lb[:, None])[:, None, None, :]
        qt = qb.transpose(1, 2).contiguous()
        cache_bytes = 2 * 2 * BATCH * s * kv * hd
        kvs = [(k[:BATCH], v[:BATCH])] + [
            (randn(BATCH, s, kv, hd), randn(BATCH, s, kv, hd))
            for _ in range(cold_copies(cache_bytes) - 1)]
        kvt = [tuple(t.transpose(1, 2).contiguous() for t in pair)
               for pair in kvs]
        n_keys = int(lb.clamp(max=s).sum())
        k_ms, copies = time_cold_ms(
            lambda c: ops.decode_attention(qb, *kvs[c], lb), cache_bytes)
        l_ms, _ = time_cold_ms(lambda c: F.scaled_dot_product_attention(
            qt, *kvt[c], attn_mask=mask, enable_gqa=True), cache_bytes)
        kb, vb = kvs[0]
        kt, vt = kvt[0]
        r = {"B, S, H, KV, hd": [BATCH, s, h, kv, hd],
             "kv_len": lb.tolist(), "ms": k_ms, "library_ms": l_ms,
             "warm_ms": time_ms(lambda: ops.decode_attention(qb, kb, vb,
                                                             lb)),
             "warm_library_ms": time_ms(
                 lambda: F.scaled_dot_product_attention(
                     qt, kt, vt, attn_mask=mask, enable_gqa=True)),
             "plain_ms": time_ms(lambda: ref.decode_attention_ref(
                 qb, kb, vb, lb)),
             "cold_copies": copies}
        r["bound_ms"], r["bound_by"] = bound(
            2 * (2 * BATCH * h * hd + 2 * n_keys * kv * hd) + 4 * BATCH,
            (4.0 * n_keys * h * hd, BF16_PEAK))
        log(f"  decode_attention[{key}] B={BATCH} S={s} H={h} KV={kv} "
            f"hd={hd}: kernel cold {k_ms:.4f} ms (warm "
            f"{r['warm_ms']:.4f}), plain {r['plain_ms']:.4f} ms, "
            f"F.scaled_dot_product_attention cold {l_ms:.4f} ms (warm "
            f"{r['warm_library_ms']:.4f}), bound {r['bound_ms']:.5f} ms "
            f"({copies} copies)")
        del kvs, kvt
        return r

    # decode_attention at the caches of the main paths: max_len rows, the
    # rows' lengths as in a stream (one freed slot at length 1)
    max_len = PROMPT + GEN
    at = {}
    for key, (h, kv, hd) in (("granite", (32, 8, 64)),
                             ("zamba2", (32, 32, 112)),
                             ("llama3", (128, 8, 128)),
                             ("llama4", (40, 8, 128))):
        q = randn(8, 1, h, hd)
        k, v = randn(8, max_len, kv, hd), randn(8, max_len, kv, hd)
        lens = torch.tensor([530, 1, 300, 513, 544, 257, 64, 65],
                            dtype=torch.int32, device="cuda")
        close(f"decode_attention[{key}]",
              ops.decode_attention(q[:BATCH], k[:BATCH], v[:BATCH],
                                   lens[:BATCH]),
              ref.decode_attention_ref(q[:BATCH], k[:BATCH], v[:BATCH],
                                       lens[:BATCH]), bf16)
        p_ok = invariant(f"decode_attention[{key}]", ops.decode_attention,
                         ref.decode_attention_ref, [q, k, v, lens])
        # buckets shorter than the cache, rows up to 300 long: the fast
        # loop's (a multiple of 32) and one that ends inside a split
        short = torch.tensor([300, 17, 200, 257], dtype=torch.int32,
                             device="cuda")
        same = {"kernel": True, "plain": True}
        for bucket in (-(-int(short.max()) // 32) * 32, int(short.max())):
            for which, fn in (("kernel", ops.decode_attention),
                              ("plain", ref.decode_attention_ref)):
                cut = fn(q[:BATCH], k[:BATCH, :bucket], v[:BATCH, :bucket],
                         short)
                whole = fn(q[:BATCH], k[:BATCH], v[:BATCH], short)
                same[which] &= torch.equal(cut.view(torch.uint8),
                                           whole.view(torch.uint8))
            log(f"  decode_attention[{key}]: a bucket of {bucket} rows "
                f"(split {bucket // ops.SPLIT} cut at key "
                f"{bucket % ops.SPLIT}) = the whole cache of {max_len}: "
                f"kernel {same['kernel']}, plain {same['plain']}")
        if not same["kernel"]:
            raise SystemExit("decode attention depends on the bucket")
        at[key] = attention_times(key, q, k, v, lens, h, kv, hd, max_len)
        at[key].update(plain_row_invariant=p_ok,
                       plain_bucket_invariant=same["plain"])

    # cross-attention at decode: every row reads the whole fixed cross
    # cache, kv_len its length (whisper's encoder output, the VLM's vision
    # embeddings); held on the output's scale as well
    for key, (h, kv, hd, s) in (("whisper_cross", (20, 20, 64, FRAMES)),
                                ("vlm_cross", (64, 8, 128, 6400))):
        q = randn(8, 1, h, hd)
        k, v = randn(8, s, kv, hd), randn(8, s, kv, hd)
        lens = torch.full((8,), s, dtype=torch.int32, device="cuda")
        qb, kb, vb, lb = q[:BATCH], k[:BATCH], v[:BATCH], lens[:BATCH]
        got = ops.decode_attention(qb, kb, vb, lb)
        want = ref.decode_attention_ref(qb, kb, vb, lb)
        close(f"decode_attention[{key}]", got, want, bf16)
        scaled_check(f"decode_attention[{key}]", got, want,
                     ops.decode_attention(qb, kb, vb, lb - last_run(s)))
        del qb, kb, vb, lb, got, want
        p_ok = invariant(f"decode_attention[{key}]", ops.decode_attention,
                         ref.decode_attention_ref, [q, k, v, lens])
        at[key] = attention_times(key, q, k, v, lens, h, kv, hd, s)
        at[key]["plain_row_invariant"] = p_ok
        del q, k, v
    torch.cuda.empty_cache()
    records["decode_attention"] = dict(
        {k: at["granite"][k] for k in ("ms", "plain_ms", "library_ms",
                                       "warm_ms", "warm_library_ms",
                                       "bound_ms", "bound_by")},
        shapes={k: v for k, v in at.items() if k != "granite"})

    # ssm_decode_step at mamba2's and zamba2's shapes
    sd = {}
    for key, (h, p, n) in (("mamba2", (64, 64, 128)),
                           ("zamba2", (112, 64, 64))):
        conv = randn(8, h * p + 2 * n)
        x = conv[:, :h * p].view(8, h, p)
        bm, cm = conv[:, h * p:h * p + n], conv[:, h * p + n:]
        dt = F.softplus(randn(8, h, dtype=f32))
        a = -torch.exp(randn(h, scale=0.3, dtype=f32))
        st = randn(8, h, p, n, dtype=f32)
        sk, sp = st[:BATCH].clone(), st[:BATCH].clone()
        close(f"ssm_decode_step[{key}]",
              ops.ssm_decode_step(sk, x[:BATCH], dt[:BATCH], a, bm[:BATCH],
                                  cm[:BATCH]),
              ref.ssm_decode_ref(sp, x[:BATCH], dt[:BATCH], a, bm[:BATCH],
                                 cm[:BATCH]), bf16)
        close(f"ssm_decode_step[{key}] state", sk, sp, f32)

        def step(fn):
            return lambda s_, x_, d_, b_, c_: fn(s_.clone(), x_, d_, a, b_,
                                                 c_)
        p_ok = invariant(f"ssm_decode_step[{key}]",
                         step(ops.ssm_decode_step), step(ref.ssm_decode_ref),
                         [st, x, dt, bm, cm])
        args = (sk, x[:BATCH], dt[:BATCH], a, bm[:BATCH], cm[:BATCH])
        sd[key] = {"B, H, P, N": [BATCH, h, p, n],
                   "ms": time_ms(lambda: ops.ssm_decode_step(*args)),
                   "plain_ms": time_ms(lambda: ref.ssm_decode_ref(*args)),
                   "library_ms": None, "plain_row_invariant": p_ok}
        sd[key]["bound_ms"], sd[key]["bound_by"] = bound(
            2 * 4 * BATCH * h * p * n + 2 * 2 * BATCH * h * p
            + 2 * 2 * BATCH * n + 4 * (BATCH * h + h),
            (5.0 * BATCH * h * p * n, F32_PEAK))
        log(f"  ssm_decode_step[{key}] B={BATCH} H={h} P={p} N={n}: kernel "
            f"{sd[key]['ms']:.4f} ms, plain {sd[key]['plain_ms']:.4f} ms, "
            f"bound {sd[key]['bound_ms']:.5f} ms")
    records["ssm_decode_step"] = dict(
        {k: sd["mamba2"][k] for k in ("ms", "plain_ms", "library_ms",
                                      "bound_ms", "bound_by")},
        shapes={"zamba2": sd["zamba2"]})

    # no TPU kernel computes these: the reference leaves them to XLA, and
    # "replaces" names the reference's op
    replaces = {"rows_matmul": "src/repro/models/layers.py:364",
                "decode_attention": "src/repro/models/layers.py:310",
                "ssm_decode_step": "src/repro/models/ssm.py:168"}
    return [dict(r, name=name, route="cuda",
                 source="src/repro_torch/kernels/csrc/decode.cu",
                 replaces=replaces[name],
                 max_abs_err=max(e for k, e in errs.items()
                                 if k.startswith(name)))
            for name, r in records.items()]


# ---------------------------------------------------------------------------
# phase 4: the main paths at full width
# ---------------------------------------------------------------------------

def expected_launches(cfg, n_stages, path, steps, prefills=None,
                      aborted=0):
    """Launches of every kernel in one counted run of ``steps`` decode
    steps and ``prefills`` prefills (by default what the run's name says:
    one, two for a run with a kill, one a request for the stream); a fault
    run's replay adds its prefill and its steps, and a transport adds
    nothing.  ``aborted``: the blocks of a dense model whose decode step
    ran and was abandoned (a silent stage found dead mid-step: the stages
    before it had computed), each one step's launches of its block.  Per prefill, flash attention once per self-attention layer
    (the dense layers, zamba2's 14 call sites of its shared block, the
    VLM's self blocks, whisper's decoder blocks) and per encoder layer,
    none for cross-attention, and the SSD scan once per mamba layer (a run
    with a kill prefills again in its replay; the stream run once per
    request).  Per decode step, per self-attention layer seven
    ``rows_matmul`` and one ``decode_attention``, per VLM cross block five
    and one, per decoder block nine and two (self and cross), per mamba
    layer two ``rows_matmul`` and one ``ssm_decode_step``, and the head's
    ``rows_matmul`` (a prefill's head once, its last token).  Per pass (a
    prefill or a decode step) one ``rms_norm_rows`` a layer (ln1, lnq, or
    a mamba layer's pre-norm) and the final norm, per self-attention layer
    and cross block one ``residual_rms_norm_rows`` (the residual add and
    the next norm), per decoder block two, per mamba layer one
    ``conv_silu`` and one ``gated_rms_norm_rows``; per prefill the
    encoder's layers as dense blocks, and its final norm.  The MoE family:
    llama4's blocks (dense and MoE) are self-attention layers, the shared
    expert's three products taking the MLP's place; an MLA layer is one
    with no flash and no ``decode_attention`` (plain attention), seven
    ``rows_matmul`` a step (wdq, wuq, wdkv, wo and the shared expert's
    three) and two more ``rms_norm_rows`` a pass (q_norm, kv_norm).  The
    wire kernels once per stage boundary per pass on the int8 wire (a
    replay repeats the prefill and the decode steps before the kill).  The
    standalone ``silu`` runs on no path."""
    from repro_torch import kernels
    from repro_torch.models.model import hybrid_apps
    want = dict.fromkeys(kernels.WRAPPERS, 0)
    if prefills is None:
        prefills = (len(STREAM) if path == "stream"
                    else 2 if path.endswith("_kill") else 1)
    n = cfg.n_layers
    attn = cross = dec = mamba = enc = mla = 0
    if cfg.family == "moe" and cfg.use_mla:
        mla = n
    elif cfg.family in ("dense", "moe"):
        attn = n
    elif cfg.family == "vlm":
        cross = n // (cfg.cross_attn_every + 1)
        attn = n - cross
    elif cfg.family == "encdec":
        dec, enc = n, cfg.n_enc_layers
    else:
        attn, mamba = hybrid_apps(cfg, 0, n)[1], n
    want["flash_attention"] = (attn + dec + enc) * prefills
    want["ssd"] = mamba * prefills
    want["decode_attention"] = (attn + cross + 2 * dec) * steps
    want["ssm_decode_step"] = mamba * steps
    passes = prefills + steps
    want["rms_norm_rows"] = ((attn + cross + dec + mamba + 3 * mla + 1)
                             * passes + (enc + (enc > 0)) * prefills)
    want["residual_rms_norm_rows"] = ((attn + cross + 2 * dec + mla)
                                      * passes + enc * prefills)
    want["gated_rms_norm_rows"] = want["conv_silu"] = mamba * passes
    want["rows_matmul"] = ((7 * (attn + mla) + 5 * cross + 9 * dec
                            + 2 * mamba + 1) * steps + prefills)
    if "int8" in path:
        want["quantize"] = want["dequantize"] = \
            (n_stages - 1) * (prefills + steps)
    if aborted:
        if cfg.family != "dense" or "int8" in path:
            raise SystemExit(f"[{path}] aborted steps are counted for the "
                             "raw-wire dense family only")
        want["rows_matmul"] += 7 * aborted
        for name in ("decode_attention", "rms_norm_rows",
                     "residual_rms_norm_rows"):
            want[name] += aborted
    return want


def stream_schedule(requests, slots):
    """Slot -> request id at each batched decode step, as
    ``SlotScheduler.run`` admits (arrival order, lowest free slot) and
    evicts."""
    free, active, nxt, maps = list(range(slots)), {}, 0, []
    while nxt < len(requests) or active:
        while free and nxt < len(requests):
            r = requests[nxt]
            nxt += 1
            slot = free.pop(0)
            if r.gen_len > 1:
                active[slot] = [r, 1]
            else:
                free.append(slot)
                free.sort()
        if not active:
            continue
        maps.append({slot: st[0].rid for slot, st in active.items()})
        for slot in list(active):
            active[slot][1] += 1
            if active[slot][1] >= active[slot][0].gen_len:
                del active[slot]
                free.append(slot)
        free.sort()
    return maps


def stream_phase(torch, cfg, params, timed, counted, prompt=PROMPT):
    """Continuous batching: STREAM requests (prompts scaled to ``prompt``;
    each with its own side input: vision embeddings, or FRAMES frames)
    over SLOTS slots, run twice: the tokens and every batched decode
    step's logits (recorded as the scheduler's decode steps return them)
    bit-identical between the runs.  Each stream is held against the same
    request served alone, bit for bit: its tokens equal to the
    per-request reference loop's, and the logits of each of its batched
    decode steps equal to those of the request alone (batch 1, attention
    over the whole cache) fed the same tokens; not for the MoE family,
    whose rows contend for expert capacity (idle slots' rows too), so a
    request's tokens depend on the other slots'.  Returns the phase's
    numbers, the decode steps of the counted run, and (the requests, their
    streams, each batched step's logits) for the pipelined streams."""
    import numpy as np
    from repro_torch.models import decode_step, init_serve_cache, prefill
    from repro_torch.serve import scheduler
    from repro_torch.serve.engine import ServeEngine, as_batch, make_batch

    eng = ServeEngine(cfg, params, max_len=prompt + GEN, kv_block=32)
    sched = scheduler.SlotScheduler(eng, SLOTS)
    shapes = [(pl * prompt // PROMPT, gl) for pl, gl in STREAM]
    reqs = []
    for i, (pl, gl) in enumerate(shapes):
        one = make_batch(cfg, 1, pl, seed=1000 + i, frames_len=FRAMES)
        reqs.append(scheduler.Request(i, one.pop("tokens"), gl, extras=one))
    sched.run(reqs[:1])                                   # warm-up
    # each run records its batched steps' logits (views: no launch)
    recorded, decode = [[], []], scheduler.decode_step

    def recording(run):
        def step(*args, **kw):
            logits, cache = decode(*args, **kw)
            recorded[run].append(logits[:, 0])
            return logits, cache
        return step

    scheduler.decode_step = recording(0)
    try:
        (streams, stats), wall = timed(lambda: counted(
            "stream", lambda: sched.run(reqs)))
        scheduler.decode_step = recording(1)
        (again, _), again_wall = timed(lambda: sched.run(reqs))
    finally:
        scheduler.decode_step = decode
    n_tok = sum(len(t) for t in streams)
    moe = cfg.family == "moe"
    ref_streams, ref_wall = None, math.nan
    if not moe:
        (ref_streams, _), ref_wall = timed(lambda: sched.run(
            reqs, engine="reference"))
    maps = stream_schedule(reqs, SLOTS)
    twice = len(recorded[0]) == len(recorded[1]) == len(maps) and all(
        torch.equal(a.view(torch.int32), b.view(torch.int32))
        for a, b in zip(*recorded)) and all(
        np.array_equal(a, b) for a, b in zip(again, streams))
    log(f"  stream of {len(reqs)} requests (prompt, gen) {shapes} over "
        f"{SLOTS} slots: {n_tok} tokens in {wall:.3f}s ({n_tok / wall:.1f} "
        f"tok/s; again {again_wall:.3f}s), {stats['decode_steps']} decode "
        f"steps, slot utilisation {stats['slot_utilization']:.3f}; the two "
        f"runs' tokens and every step's logits bit-identical: {twice}"
        + ("" if moe else f"; the requests served alone (reference loop) "
           f"{ref_wall:.3f}s ({n_tok / ref_wall:.1f} tok/s)"))
    if len(maps) != stats["decode_steps"] or not twice:
        raise SystemExit(f"[{cfg.name}/stream] the schedule, tokens or "
                         "logits changed between two runs")
    recorded = recorded[1]
    if moe:
        log("  (MoE: the slots' rows contend for expert capacity, so no "
            "request is held to itself served alone)")
        return {"wall_s": wall, "again_wall_s": again_wall,
                "tokens": n_tok, "decode_steps": stats["decode_steps"],
                "slot_utilization": stats["slot_utilization"],
                "two_runs_bit_identical": twice,
                "bit_identical_to_solo": None}, stats["decode_steps"], (
                    reqs, streams, recorded)

    @torch.inference_mode()
    def solo_run(r, toks):
        """One request alone, fed the stream's tokens: (gen_len - 1, V)
        decode logits."""
        batch = as_batch({"tokens": r.tokens, **r.extras}, DEVICE)
        cache = init_serve_cache(cfg, 1, eng.max_len, batch=batch,
                                 device=DEVICE)
        _, cache = prefill(cfg, params, batch, cache)
        out = []
        for j in range(1, r.gen_len):
            fed = torch.tensor([[int(toks[j - 1])]], dtype=torch.int32,
                               device=DEVICE)
            logits, cache = decode_step(cfg, params, fed, cache)
            out.append(logits[0, 0])
        return torch.stack(out)

    bad, worst, n_steps = [], 0.0, 0
    for r, toks, ref in zip(reqs, streams, ref_streams):
        steps = torch.stack([recorded[i][slot] for i, m in enumerate(maps)
                             for slot, rid in m.items() if rid == r.rid])
        solo = solo_run(r, toks)
        n_steps += len(steps)
        worst = max(worst, (steps - solo).abs().max().item())
        if not torch.equal(steps.view(torch.int32), solo.view(torch.int32)):
            bad.append(f"request {r.rid}: stream logits not bit-identical "
                       f"to the request alone (max |diff| "
                       f"{(steps - solo).abs().max().item():.4g})")
        if not np.array_equal(toks, ref):
            at = int(np.nonzero(toks != ref)[0][0])
            bad.append(f"request {r.rid}: tokens differ from the request "
                       f"alone from step {at}")
    log(f"  stream vs each request alone: {n_steps} decode steps' logits "
        f"and {n_tok} tokens compared, max |stream - solo| {worst:.4g} "
        f"({'bit-identical' if not bad else 'NOT identical'})")
    if bad:
        raise SystemExit(f"[{cfg.name}/stream] " + "; ".join(bad))
    return {"wall_s": wall, "again_wall_s": again_wall,
            "reference_wall_s": ref_wall, "tokens": n_tok,
            "decode_steps": stats["decode_steps"],
            "slot_utilization": stats["slot_utilization"],
            "two_runs_bit_identical": twice,
            "bit_identical_to_solo": True,
            "max_logit_diff": worst}, stats["decode_steps"], (
                reqs, streams, recorded)


# Device kernels a decode step may run: the port's own and torch's
# element-wise, copy, concatenation, gather and indexing kernels, none of
# which sums across a row.  Any other kind (a cuBLAS GEMM or GEMV, named
# gemm, gemv or nvjet_*, a reduction, a softmax) fails the step.
STEP_KERNELS = ("rows_matmul_kn_kernel", "rows_matmul_nk_kernel",
                "rms_norm_rows_kernel", "decode_attention_kernel",
                "ssm_decode_kernel", "conv_silu_kernel", "elementwise_kernel",
                "CatArrayBatchedCopy", "gather_kernel", "index", "Memcpy",
                "Memset")
# The ops a MoE decode step runs in plain torch beside them, as the
# reference leaves them to XLA: the router's float32 GEMM, softmax, top-k,
# the dispatch's stable sort and search, the aux loss's and gates' sums and
# the expert buffer's batched GEMMs inside ``moe_ffn``; MLA's decompression
# GEMMs, plain attention and softmax inside ``mla_attention``.  Each such
# launch must come from inside one of these two functions.
MOE_SCOPES = ("moe_ffn", "mla_attention")


def decode_step_kernels(torch, cfg, params, batch, prompt=PROMPT):
    """Device kernels of one decode step at batch BATCH (after a prefill,
    untraced), traced with torch.profiler: every kind on the allow-list
    ``STEP_KERNELS``, so no library GEMM, GEMV or reduction is left in it.
    For the MoE family a kind off the list may run only inside
    ``MOE_SCOPES``: the model's calls of those functions run inside
    profiler ranges of their names, and each launch of such a kind must
    be linked to an op within one (logged by kind and range).  Returns the
    launches of the step."""
    from collections import Counter
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import (decode_step, init_serve_cache, model,
                                    prefill)
    from repro_torch.serve.engine import as_batch

    def scoped(name, fn):
        def run(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return run
    saved = {name: getattr(model, name) for name in MOE_SCOPES}
    with torch.inference_mode():
        batch = as_batch(batch, DEVICE)
        cache = init_serve_cache(cfg, BATCH, prompt + GEN, batch=batch,
                                 device=DEVICE)
        logits, cache = prefill(cfg, params, batch, cache)
        tok = logits.argmax(-1).int()
        torch.cuda.synchronize()
        try:
            for name, fn in saved.items():
                setattr(model, name, scoped(name, fn))
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                decode_step(cfg, params, tok, cache, kv_bucket=prompt + 32)
                torch.cuda.synchronize()
        finally:
            for name, fn in saved.items():
                setattr(model, name, fn)
    # the ranges themselves appear on the device's timeline too
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in MOE_SCOPES]
    launches = sum(e.count for e in kern)
    other = sorted({e.key for e in kern
                    if not any(w in e.key for w in STEP_KERNELS)})
    if cfg.family == "moe" and other:
        def scope_of(e):
            while e is not None:
                if e.name in MOE_SCOPES:
                    return e.name
                e = e.cpu_parent
            return None
        placed = Counter()
        for e in prof.events():
            if e.device_type == DeviceType.CPU and e.kernels:
                where = scope_of(e)
                for k in e.kernels:
                    if k.name in other:
                        placed[k.name, where] += 1
        total = {e.key: e.count for e in kern if e.key in other}

        def where(key):
            return ", ".join(f"{placed[key, sc]} in {sc}"
                             for sc in MOE_SCOPES)
        log(f"  the MoE step's plain torch kinds ({sum(total.values())} "
            f"launches): " + "; ".join(f"{n}x {key[:80]} ({where(key)})"
                                       for key, n in total.items()))
        outside = {key: n - sum(placed[key, sc] for sc in MOE_SCOPES)
                   for key, n in total.items()}
        other = sorted(key for key, n in outside.items() if n)
        if other:
            log("  launches not linked to an op inside "
                f"{' or '.join(MOE_SCOPES)}: "
                + "; ".join(f"{outside[k]}x {k[:90]}" for k in other))
    log(f"  one decode step (B={BATCH}): {launches} kernel launches of "
        f"{len(kern)} kinds; kinds off the allow-list: {other or 'none'}")
    if not kern:
        raise SystemExit("the profiler saw no device kernel in a decode step")
    if other:
        log("  every kind: " + "; ".join(sorted(e.key[:100] for e in kern)))
        raise SystemExit(f"[{cfg.name}] a decode step runs {other}")
    return launches


def decode_hunt(torch, cfg, params, batch, prompt=PROMPT):
    """The ops at fault, found on the card: every row-kernel call of one
    decode step at batch BATCH is recorded, and those of the first layer
    (the hybrid's first call site of its shared block and mamba layer)
    and of the head are replayed on each row alone, through the kernel and
    through its plain version (the library ops the port used before).  A
    kernel whose rows change bits fails; the plain ops that do are logged.
    Returns their names."""
    from repro_torch.kernels.decode import ops, ref
    from repro_torch.models import (decode_step, init_serve_cache, layers,
                                    prefill, ssm)
    from repro_torch.serve.engine import as_batch
    plain = {"rows_matmul": ref.rows_matmul_ref,
             "rms_norm_rows": ref.rms_norm_ref,
             "decode_attention": ref.decode_attention_ref,
             "ssm_decode_step": ref.ssm_decode_ref}
    batched = {"rows_matmul": (0,), "rms_norm_rows": (0,),
               "decode_attention": (0, 1, 2, 3),
               "ssm_decode_step": (0, 1, 2, 4, 5)}
    calls, saved = [], {}
    for mod, name in ((layers, "rows_matmul"), (layers, "rms_norm_rows"),
                      (layers, "decode_attention"),
                      (ssm, "ssm_decode_step")):
        fn = saved[mod, name] = getattr(mod, name)

        def rec(*args, _fn=fn, _name=name):
            # the step updates the SSM state in place: keep its input
            calls.append((_name, [args[0].clone(), *args[1:]]
                          if _name == "ssm_decode_step" else list(args)))
            return _fn(*args)
        setattr(mod, name, rec)
    try:
        with torch.inference_mode():
            batch = as_batch(batch, DEVICE)
            cache = init_serve_cache(cfg, BATCH, prompt + GEN, batch=batch,
                                     device=DEVICE)
            logits, cache = prefill(cfg, params, batch, cache)
            calls.clear()
            decode_step(cfg, params, logits.argmax(-1).int(), cache)
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    # the first layer's calls: a dense block's (llama4's first block too)
    # or an MLA MoE block's (ln1, wdq, q_norm, wuq, wdkv, kv_norm, wo and
    # the shared expert's three)
    first = 10 if cfg.use_mla else {"dense": 9, "ssm": 4, "hybrid": 13,
                                    "vlm": 9, "encdec": 12,
                                    "moe": 9}[cfg.family]
    differ = []
    with torch.inference_mode():
        for i, (name, args) in enumerate(calls[:first] + calls[-2:]):
            for which, fn in (("kernel", getattr(ops, name)),
                              ("plain", plain[name])):
                def run(a):
                    a = list(a)
                    if name == "ssm_decode_step":
                        a[0] = a[0].clone()
                    return fn(*a)
                whole = run(args)
                same = all(torch.equal(
                    run([x[r:r + 1] if j in batched[name] else x
                         for j, x in enumerate(args)]).view(torch.uint8),
                    whole[r:r + 1].contiguous().view(torch.uint8))
                    for r in range(BATCH))
                if not same and which == "kernel":
                    raise SystemExit(f"[{cfg.name}] {name} (call {i}): a "
                                     f"row's bits depend on the batch")
                if not same:
                    shape = "x".join(str(d) for d in args[1].shape) \
                        if name == "rows_matmul" else ""
                    differ.append(f"{name}{'[' + shape + ']' if shape else ''}"
                                  f"{'[head]' if i >= first else ''}")
    log(f"  the hunt, one decode step's first layer and head at B={BATCH}: "
        f"{len(calls[:first]) + 2} row-kernel calls; the plain ops whose "
        f"row bits change with the batch: {differ or 'none'}")
    return differ


def main_path(torch, tmp, cfg, pipelined, prompt=PROMPT, cuts=None):
    """One model at full width: random bf16 weights from seed 0, both
    ServeEngine loops (bit-identical logits), one decode step's kernels,
    for a PIPELINED model the planner (or ``cuts``) and the raw and int8
    pipelines with a stage kill, and the stream (``stream_phase``);
    prompts of ``prompt`` tokens.  Each counted run logs its peak device
    memory.  Returns ({run: launches}, the stream's numbers, {timings})."""
    from repro_torch import kernels
    from repro_torch._tree import tree_leaves
    from repro_torch.models import init_params
    from repro_torch.models.model import hybrid_apps
    from repro_torch.serve.engine import ServeEngine, as_batch, make_batch

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    params, dt = timed(lambda: init_params(cfg, gen, device=DEVICE))
    n_par = sum(t.numel() for t in tree_leaves(params))
    ssm = (f"{cfg.ssm_heads} SSM heads of {cfg.ssm_head_dim}, state "
           f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}")
    attn = (f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv of "
            f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}")
    mixer = {"dense": attn, "ssm": ssm,
             "hybrid": f"{ssm}; one shared block of {attn} at "
                       f"{hybrid_apps(cfg, 0, cfg.n_layers)[1]} call sites, "
                       f"every {cfg.hybrid_attn_every} layers",
             "vlm": f"{attn}; groups of {cfg.cross_attn_every} self blocks "
                    f"and one cross block over {cfg.vision_tokens} vision "
                    f"tokens",
             "encdec": f"{attn}; {cfg.n_enc_layers} encoder layers over "
                       f"{FRAMES} frames, each decoder layer cross-attending "
                       f"to their output",
             "moe": (f"{cfg.n_experts} experts top-{cfg.experts_per_tok} of "
                     f"d_ff {cfg.moe_d_ff} and {cfg.n_shared_experts} "
                     f"shared, every {cfg.moe_interleave} block(s); "
                     + (f"MLA over {cfg.n_heads} heads (q_lora "
                        f"{cfg.q_lora_rank}, kv_lora {cfg.kv_lora_rank}, "
                        f"qk {cfg.qk_nope_dim}+{cfg.qk_rope_dim}, v "
                        f"{cfg.v_head_dim})" if cfg.use_mla else attn))
             }[cfg.family]
    head = "tied head (embed.T)" if cfg.tie_embeddings else "untied head"
    log(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{mixer}, vocab {cfg.vocab}, {head}: {n_par / 1e9:.3f} B params "
        f"({2 * n_par / 1e9:.2f} GB bf16) initialised in {dt:.1f}s")

    batch = as_batch(make_batch(cfg, BATCH, prompt, seed=0,
                                frames_len=FRAMES), DEVICE)
    max_len = prompt + GEN
    by_path, steps = {}, {}   # run -> {kernel: launches}, decode steps
    wire = {}                 # run -> the wire's launches on its fast paths

    def counted(path, fn):
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        by_path[path] = kernels.launch_counts()
        wire[path] = (kernels.WRAPPERS["quantize"].row_launches,
                      kernels.WRAPPERS["dequantize"].vec_launches)
        peak[path] = torch.cuda.max_memory_allocated() / 1e9
        log(f"  [{path}] kernel launches: {by_path[path]}; quantize on the "
            f"row path {wire[path][0]}, dequantize vectorised "
            f"{wire[path][1]}; peak device memory {peak[path]:.2f} GB")
        return out

    peak = {}

    mono = ServeEngine(cfg, params, max_len=max_len, kv_block=32)
    mono.generate(batch, 2)                               # warm-up
    toks_mono, gen_s = timed(lambda: counted(
        "monolithic", lambda: mono.generate(batch, GEN)))
    steps["monolithic"] = GEN - 1
    (_, logits), pre_s = timed(lambda: mono.generate(
        batch, 1, collect_logits=True))                   # prefill only
    if logits.shape != (BATCH, 1, cfg.vocab) or not \
            bool(torch.isfinite(torch.from_numpy(logits)).all()):
        raise SystemExit(f"prefill logits {logits.shape} not finite")
    decode_ms = (gen_s - pre_s) / (GEN - 1) * 1e3
    log(f"  ServeEngine: prefill (B={BATCH}, S={prompt}) {pre_s * 1e3:.1f} "
        f"ms; generate {GEN} tokens {gen_s:.3f}s, decode {decode_ms:.2f} "
        f"ms/step")
    (toks_ref, logits_ref), ref_s = timed(lambda: mono.generate(
        batch, GEN, engine="reference", collect_logits=True))
    toks_fast, logits_fast = mono.generate(batch, GEN, collect_logits=True)
    same = bool((toks_ref == toks_mono).all()
                and (toks_fast == toks_mono).all()
                and logits_ref.tobytes() == logits_fast.tobytes())
    log(f"  ServeEngine reference loop {ref_s:.3f}s: tokens and every "
        f"step's logits bit-identical to the fast loop: {same}")
    log(f"  tokens row 0: {toks_mono[0].tolist()}")
    if not same:
        raise SystemExit("fast and reference loops disagree")
    del logits_ref, logits_fast
    (step_launches, at_fault), trace_s = timed(lambda: (
        decode_step_kernels(torch, cfg, params, batch, prompt),
        decode_hunt(torch, cfg, params, batch, prompt)))
    log(f"  the decode-step trace and the hunt took {trace_s:.1f}s")
    extra = {}
    if cfg.family in ("vlm", "encdec"):
        extra["cross_prefill_ms"] = cross_prefill_ms(torch, cfg, params,
                                                     batch, prompt)

    stream, steps["stream"], mono_stream = stream_phase(
        torch, cfg, params, timed, counted, prompt)
    n_stages = 1
    runs = {}                 # run -> (prefills, decode steps, aborted)
    if pipelined:
        del mono                      # its caches: the kill runs need room
        gc.collect()
        torch.cuda.empty_cache()
        n_stages, runs, extra["faults"], extra["pipelined"] = \
            pipeline_runs(torch, tmp, cfg, params, batch, toks_mono, timed,
                          counted, prompt, cuts, mono_stream)
        steps.update(pipeline_raw=GEN - 1, pipeline_int8=GEN - 1,
                     pipeline_raw_kill=GEN - 1 + KILL["after_step"],
                     pipeline_int8_kill=GEN - 1 + KILL["after_step"])
    for path, got in by_path.items():
        prefills, n_steps, aborted = runs.get(path, (None, steps.get(path),
                                                     0))
        want = expected_launches(cfg, n_stages, path, n_steps, prefills,
                                 aborted)
        if got != want:
            raise SystemExit(f"[{cfg.name}/{path}] launched {got}, "
                             f"expected {want}")
        if wire[path] != (got["quantize"], got["dequantize"]):
            raise SystemExit(f"[{cfg.name}/{path}] of {got['quantize']} "
                             f"quantize launches {wire[path][0]} on the row "
                             f"path, of {got['dequantize']} dequantize "
                             f"launches {wire[path][1]} vectorised")
    return by_path, stream, dict({"prefill_ms": pre_s * 1e3,
                                  "decode_ms_per_step": decode_ms,
                                  "decode_step_launches": step_launches,
                                  "plain_ops_at_fault": at_fault,
                                  "peak_gb": peak}, **extra)


def cross_prefill_ms(torch, cfg, params, batch, prompt):
    """Device ms of one cross-attention at prefill (the first cross block's,
    q from ``prompt`` rows against the whole cross cache), in plain torch
    as the reference leaves it to XLA: the mean of 3 calls between CUDA
    events, after one untimed."""
    from repro_torch.models import layers, model
    with torch.inference_mode():
        cache = model.init_serve_cache(cfg, BATCH, prompt + GEN,
                                       batch=batch, device=DEVICE)
        model.fill_cross_caches(cfg, params, cache,
                                model._side_inputs(cfg, params, batch))
        blocks = (params["groups"]["cross"] if cfg.family == "vlm"
                  else params["dec_blocks"])
        p = model.layer_view(blocks, 0)["xattn"]
        x = torch.randn(BATCH, prompt, cfg.d_model, device=DEVICE).to(
            torch.bfloat16)
        xc = model.layer_view(cache["cross"], 0)

        def run():
            return layers.cross_attention(p, x, cfg, xc)
        run()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            run()
        end.record()
        end.synchronize()
    ms = start.elapsed_time(end) / 3
    s_kv = xc["k"].shape[1]
    log(f"  plain cross-attention at prefill: q ({BATCH}, {prompt}) against "
        f"{s_kv} keys, {cfg.n_heads} heads of {cfg.resolved_head_dim}: "
        f"{ms:.3f} ms a block (float32 scores "
        f"{4 * BATCH * cfg.n_heads * prompt * s_kv / 1e9:.2f} GB)")
    return ms


def host_available():
    """Bytes of host memory available (``MemAvailable``)."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    raise SystemExit("no MemAvailable in /proc/meminfo")


def edge_instance(cfg, prompt=PROMPT):
    """What the planner plans a pipelined model with: its block graph at
    a prefill of BATCH x ``prompt``, the 10-node edge cluster and the
    stage capacity (a 3.5th of the params, at least 1.2 times the largest
    segment)."""
    from repro_torch.core import lm_block_graph, random_geometric_cluster
    from repro_torch.models.config import ShapeConfig
    graph = lm_block_graph(cfg, ShapeConfig("serve", prompt, BATCH,
                                            "prefill"))
    cluster = random_geometric_cluster(10, rng=7)
    pts = graph.candidate_partition_points()
    segs = graph.segment_layers(pts)
    min_cap = max(graph.run_memory_bytes(pts, segs, i, i)
                  for i in range(len(pts)))
    return graph, cluster, max(graph.total_param_bytes() / 3.5,
                               min_cap * 1.2)


def kill_specs(ranges):
    """KILL: stage 1 dies after decode step 3.  Where stage 1 holds no
    block (whisper: the planner's cuts fall inside the encoder's layers),
    the encoder's stage 0 and the first stage that holds blocks (and cross
    caches) die instead, after the same step: one restore each, one
    replay."""
    if ranges[1][0] < ranges[1][1]:
        return [dict(KILL)]
    first = next(k for k, (lo, hi) in enumerate(ranges) if lo < hi)
    return [dict(KILL, stage=0), dict(KILL, stage=first)]


def pipeline_runs(torch, tmp, cfg, params, batch, toks_mono, timed,
                  counted, prompt=PROMPT, cuts=None, mono_stream=None):
    """The planner's 4 stages (or the stages of ``cuts``), the raw-wire
    pipeline (bit-identical to ServeEngine, also across a stage kill) and
    the int8-wire one (a kill gives the tokens of the run without it);
    the stream through the raw-wire pipeline (``pipelined_stream``;
    OVERLAP_ARCHS also with a kill and through the int8 wire) and, for
    OVERLAP_ARCHS, the overlapped executor (``overlap_runs``).  Returns
    the stage count, each counted run's (prefills, decode steps, aborted
    blocks), the fault surface's numbers and the streams' and overlapped
    runs' numbers."""
    from repro_torch.core import from_block_cuts, partition_and_place
    from repro_torch._tree import tree_leaves
    from repro_torch.models.staging import stage_granularity
    from repro_torch.serve.pipeline import PipelineServeEngine

    if cuts:
        cluster = None
        # a spare a restore: the kill run, and the MoE stream's kill run
        # twice, on each wire
        ep_raw, ep_int8 = (from_block_cuts(cfg, cuts,
                                           spare_nodes=(8, 9, 10, 11),
                                           wire_bits=bits)
                           for bits in (0, 8))
        log(f"  cut at blocks {cuts} (group-aligned: stage granularity "
            f"{stage_granularity(cfg)})")
    else:
        graph, cluster, cap = edge_instance(cfg, prompt)
        plan = partition_and_place(graph, cluster, cap, n_classes=3,
                                   rng=PLAN_RNG)
        ep_raw = plan.execution_plan(cluster, wire_bits=0, arch=cfg.name)
        ep_int8 = plan.execution_plan(cluster, wire_bits=8, arch=cfg.name)
        log(plan.describe())
    log(ep_int8.describe())
    ranges = ep_raw.block_ranges(cfg.n_layers)
    log(f"  stage block ranges: {ranges}")
    if cfg.family == "encdec":
        # the planner charges the encoder as layers enc0..enc{N-1}; a cut
        # inside them leaves block-free stages, and the first runs the
        # whole encoder
        log("  stages' planner layers (first, last): "
            + ", ".join(f"({st.layers[0]}, {st.layers[-1]})"
                        for st in ep_raw.stages)
            + "; the encoder runs on stage 0, its output shipped raw to "
              "stages 1.." + str(len(ranges) - 1))
    if not cuts and len(ranges) != 4:
        raise SystemExit(f"planner gave {len(ranges)} stages, expected 4")
    if cfg.family == "hybrid":
        every = cfg.hybrid_attn_every
        sites = [[i for i in range(lo, hi) if i % every == 0]
                 for lo, hi in ranges]
        log(f"  shared-block call sites by stage (each such stage holds "
            f"its own copy of the block): {sites}")
        if sum(1 for x in sites if x) < 2:
            raise SystemExit("fewer than two stages hold a call site of the "
                             "shared block")
    kill = kill_specs(ranges)
    killed = (f"stage{'s' if len(kill) > 1 else ''} "
              f"{' and '.join(str(k['stage']) for k in kill)} killed after "
              f"step {KILL['after_step']}")
    log(f"  the kill runs: {killed}")
    max_len = prompt + GEN
    leaves = tree_leaves(params)
    need = sum(t.nbytes for t in leaves)       # every stage's params at most
    leaf = max(t.nbytes for t in leaves)
    free = shutil.disk_usage(tmp).free
    avail = host_available()
    on_tmpfs = Path(tmp).is_relative_to(CKPT_ROOT)
    log(f"  stage checkpoints go to {tmp} ({'tmpfs' if on_tmpfs else 'disk'}"
        f"; {free / 1e9:.1f} GB free there, {avail / 1e9:.1f} GB of host "
        f"memory available) for {need / 1e9:.2f} GB of params (largest leaf "
        f"{leaf / 1e9:.2f} GB, copied through the host)")
    # room for the checkpoint set and, in host memory, for a leaf's host
    # copy (the save's, the restore's) beside the set where it is a tmpfs
    if free < need or avail < leaf + (need if on_tmpfs else 0):
        raise SystemExit(f"[{cfg.name}] no room for the stage checkpoints: "
                         f"{free / 1e9:.1f} GB free, {avail / 1e9:.1f} GB of "
                         f"host memory available")
    raw, ck_s = timed(lambda: PipelineServeEngine(
        cfg, params, ep_raw, max_len=max_len, kv_block=32,
        ckpt_dir=Path(tmp) / "raw", cluster=cluster))
    ck_gb = sum(t.nbytes for sp in raw.stage_params
                for t in tree_leaves(sp)) / 1e9
    log(f"  raw-wire pipeline: {raw.n_stages} stages on nodes "
        f"{raw.node_of_stage}; checkpointing the stages ({ck_gb:.2f} GB) "
        f"took {ck_s:.1f}s; host memory available after it "
        f"{host_available() / 1e9:.1f} GB")
    toks_raw, raw_s = timed(lambda: counted(
        "pipeline_raw", lambda: raw.generate(batch, GEN)))
    same = bool((toks_raw == toks_mono).all())
    log(f"  raw-wire pipeline generate {raw_s:.3f}s: bit-identical to "
        f"ServeEngine: {same}")
    if not same:
        raise SystemExit("raw-wire pipeline tokens differ from ServeEngine")
    toks_rk, rk_s = timed(lambda: counted(
        "pipeline_raw_kill", lambda: raw.generate(
            batch, GEN, kill=kill)))
    same = bool((toks_rk == toks_mono).all())
    log(f"  raw-wire pipeline with {killed}: {rk_s:.3f}s, bit-identical "
        f"to ServeEngine: {same}")
    for t, msg in raw.events:
        log(f"    t={t:7.2f}s  {msg}")
    if not same:
        raise SystemExit("raw-wire kill/restore changed the tokens")
    runs, faults = {}, {}
    if cfg.name == FAULTS_ARCH:
        t_faults = time.perf_counter()
        faults = fault_runs(torch, raw, batch, toks_mono, cluster, ranges,
                            timed, counted, runs)
        faults["raw_seconds"] = time.perf_counter() - t_faults
    piped = {}
    overlap = cfg.name in OVERLAP_ARCHS
    # the streams with a kill and on the int8 wire: granite's and mamba2's,
    # and the MoE pipeline's (its rows coupled by expert capacity)
    more = overlap or cfg.family == "moe"
    t_new = time.perf_counter()
    if mono_stream is not None:
        piped["stream_raw"] = pipelined_stream(
            torch, raw, mono_stream, "pipeline_stream_raw", timed, counted,
            runs)
    if more:
        piped["stream_raw_kill"] = pipelined_stream(
            torch, raw, mono_stream, "pipeline_stream_raw_kill", timed,
            counted, runs, kill=STREAM_KILL)
    if overlap:
        piped["overlap_raw"] = overlap_runs(
            torch, tmp, cfg, params, batch, raw, ep_raw, cluster, timed,
            counted, runs)
    piped["seconds"] = time.perf_counter() - t_new
    # the restored stage is a second copy of its params (deepseek-v3's
    # stage 1 is about 24.9 GB): free it before the next engine restores
    del raw
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(Path(tmp) / "raw", ignore_errors=True)

    i8, ck_s = timed(lambda: PipelineServeEngine(
        cfg, params, ep_int8, max_len=max_len, kv_block=32,
        ckpt_dir=Path(tmp) / "int8", cluster=cluster))
    log(f"  int8-wire pipeline: checkpointing the stages took {ck_s:.1f}s")
    toks_i8, i8_s = timed(lambda: counted(
        "pipeline_int8", lambda: i8.generate(batch, GEN)))
    toks_i8k, i8k_s = timed(lambda: counted(
        "pipeline_int8_kill", lambda: i8.generate(
            batch, GEN, kill=kill)))
    same = bool((toks_i8k == toks_i8).all())
    agree = float((toks_i8 == toks_mono).mean())
    log(f"  int8-wire pipeline {i8_s:.3f}s, with {killed} {i8k_s:.3f}s: "
        f"identical streams: {same}; share of tokens equal to the raw "
        f"wire's: {agree:.3f}")
    for t, msg in i8.events:
        log(f"    t={t:7.2f}s  {msg}")
    if not same:
        raise SystemExit("int8-wire kill/restore changed the tokens")
    for spec in kill:
        if not any(f"stage {spec['stage']}: pod rescheduled" in m
                   and "restored from checkpoint" in m for _, m in i8.events):
            raise SystemExit(f"the int8-wire kill logged no restore of "
                             f"stage {spec['stage']}")
    # the wire kernels' payload through the framed wire, at this width
    t_wire = time.perf_counter()
    runs["pipeline_int8_wire"] = (1, GEN - 1, 0)
    faults["int8_wire"] = wire_run(torch, i8, batch, toks_i8,
                                   "pipeline_int8_wire", timed, counted,
                                   every_kind=cfg.name == FAULTS_ARCH)
    if cfg.name == FAULTS_ARCH:
        faults["int8_cost"] = transport_cost(torch, i8, batch, timed)
    faults["int8_seconds"] = time.perf_counter() - t_wire
    t_new = time.perf_counter()
    if more:
        calm = piped["stream_int8"] = pipelined_stream(
            torch, i8, mono_stream, "pipeline_stream_int8", timed, counted,
            runs)
        piped["stream_int8_kill"] = pipelined_stream(
            torch, i8, mono_stream, "pipeline_stream_int8_kill", timed,
            counted, runs, kill=STREAM_KILL,
            want=None if cfg.family == "moe" else calm.pop("streams"))
    if overlap:
        piped["overlap_int8"] = overlap_runs(
            torch, tmp, cfg, params, batch, i8, ep_int8, cluster, timed,
            counted, runs)
    piped["seconds"] += time.perf_counter() - t_new
    for v in piped.values():
        if isinstance(v, dict):
            v.pop("streams", None)
    log(f"  the pipelined streams and the overlapped executor took "
        f"{piped['seconds']:.1f}s")
    del i8
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(Path(tmp) / "int8", ignore_errors=True)
    return len(ranges), runs, faults, piped


# ---------------------------------------------------------------------------
# phase 4: streams across the stages, and the overlapped executor
# ---------------------------------------------------------------------------

def pipelined_stream(torch, eng, mono, path, timed, counted, runs, kill=None,
                     want=None):
    """The stream phase's requests over SLOTS slots through ``eng``'s
    per-stage banks (``SlotScheduler`` over the pipeline engine), a counted
    run: each request's tokens equal to ``want`` (default: the monolithic
    stream's); on the raw wire each batched decode step's logits, in the
    rows of the active slots, bit-identical to the monolithic stream's
    step, also after a kill replays the in-flight requests into their
    slots (the card's decode kernels are row-invariant).  A MoE model's
    replay serves each in-flight request alone, as the reference's does,
    and its rows contend for expert capacity, so its stream with a kill is
    held to nothing but itself: every MoE stream runs twice, its tokens
    and every step's logits bit-identical between the runs.  ``runs``
    gains the run's prefills (one an admission, one a replayed request)
    and decode steps (the batched ones and the replays').  Returns its
    numbers, and its streams under ``"streams"``."""
    import numpy as np
    from repro_torch.serve.scheduler import SlotScheduler
    reqs, mono_streams, mono_logits = mono
    moe = eng.cfg.family == "moe"
    coupled = moe and kill is not None      # held to its second run only
    if want is None and not eng.wire_bits and not coupled:
        want = mono_streams
    recorded, replays = [[], []], [[], []]
    step, recover = eng.bank_step, eng.recover_and_replay
    run = [0]

    def stepped(*args):
        out = step(*args)
        recorded[run[0]].append(out[1][:, 0])
        return out

    def recovered(inflight, caches, slot_tokens):
        replays[run[0]].append([n for _, _, n in inflight])
        return recover(inflight, caches, slot_tokens)

    eng.bank_step, eng.recover_and_replay = stepped, recovered
    since = len(eng.events)
    twice = None
    try:
        (streams, stats), secs = timed(lambda: counted(
            path, lambda: SlotScheduler(eng, SLOTS).run(reqs, kill=kill)))
        if moe:
            run[0] = 1
            again, _ = SlotScheduler(eng, SLOTS).run(reqs, kill=kill)
            twice = len(recorded[0]) == len(recorded[1]) and all(
                torch.equal(a.view(torch.int32), b.view(torch.int32))
                for a, b in zip(*recorded)) and all(
                np.array_equal(a, b) for a, b in zip(again, streams))
    finally:
        del eng.bank_step, eng.recover_and_replay
    recorded, replays = recorded[0], replays[0]
    runs[path] = (len(reqs) + sum(map(len, replays)),
                  stats["decode_steps"] + sum(n - 1 for r in replays
                                              for n in r), 0)
    maps = stream_schedule(reqs, SLOTS)
    agree = float(np.mean(np.concatenate(streams)
                          == np.concatenate(mono_streams)))
    same = want is None or all(np.array_equal(a, b)
                               for a, b in zip(streams, want))
    bits = None
    if not eng.wire_bits and not coupled:
        bits = len(recorded) == len(mono_logits) == len(maps) and all(
            torch.equal(a[list(m)].view(torch.int32),
                        b[list(m)].view(torch.int32))
            for a, b, m in zip(recorded, mono_logits, maps))
    msgs = new_messages(eng, since)
    log(f"  [{path}] {len(reqs)} requests over {SLOTS} slots through "
        f"{eng.n_stages} stages: {secs:.3f}s ({stats['decode_steps']} "
        f"decode steps{', ' + str(replays) + ' replayed' if kill else ''});"
        + ("" if want is None else
           f" tokens equal to the "
           f"{'monolithic stream' if want is mono_streams else 'int8 stream'}"
           f"'s: {same};")
        + f" share of tokens equal to the monolithic stream's {agree:.3f}"
        + ("" if bits is None else f"; every step's logits bit-identical "
                                   f"to the monolithic stream's: {bits}")
        + ("" if twice is None else f"; a second run's tokens and every "
                                    f"step's logits bit-identical: {twice}"))
    for m in msgs:
        log(f"    {m}")
    if not same or bits is False or twice is False or (kill and not replays):
        raise SystemExit(f"[{path}] the pipelined stream failed")
    return {"seconds": secs, "decode_steps": stats["decode_steps"],
            "replayed": replays, "logits_bit_identical": bits,
            "two_runs_bit_identical": twice,
            "tokens_equal": None if want is None else same,
            "share_equal_to_monolithic": agree, "streams": streams}


def kind_counts(torch, fn):
    """Device kernels of ``fn`` traced with torch.profiler: {kind:
    launches}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


# the port's kernels, by the substrings of their device names
PORT_KINDS = ("rows_matmul", "rms_norm_rows", "decode_attention",
              "ssm_decode", "conv_silu", "quantize", "flash", "ssd")


def traced_step(torch, eng, batch):
    """{kind: launches} of one traced decode step of the overlapped engine
    ``eng`` (after a prefill and one untraced step: on the fused chain
    both micro-batches' graphs replayed)."""
    with torch.inference_mode():
        mbs = eng._split_batch(batch, 2)
        toks, _, caches = eng._overlap_prefill(mbs)
        bucket = eng.bucket_for(mbs[0]["tokens"].shape[1] + 1)
        toks, _, caches = eng._overlap_step(toks, caches, bucket)
        return kind_counts(torch, lambda: eng._overlap_step(toks, caches,
                                                            bucket))


def overlap_trace(f, s):
    """A traced fused step (``f``: {kind: launches}) against the eager
    staged one (``s``): the same kinds of kernel, copies aside.  Returns
    the two."""
    def kinds(c):                # the fused step's copies in and out aside
        return {k for k in c if not k.startswith(("Memcpy", "Memset"))}
    port = sorted(k for k in kinds(f) if any(w in k for w in PORT_KINDS))
    names = [m.group(1) if (m := re.search(r"::(\w+)<", k)) else k[:60]
             for k in port]
    differ = {k[:80]: (f.get(k), s.get(k)) for k in sorted(set(f) | set(s))
              if f.get(k) != s.get(k)}
    # the profiler's counts of one step are not exact (it has dropped 1 to
    # 3 records of a step's 1350-3950): the kinds are compared, the counts
    # logged; the wrappers' counters hold the launches exactly
    log(f"  one traced decode step, fused (2 graphs replayed): "
        f"{sum(f.values())} launches of {len(f)} kinds; staged (eager): "
        f"{sum(s.values())} of {len(s)}; the port's kinds {names}; counts "
        f"that differ "
        f"(fused, staged): {differ or 'none'}")
    if not port:
        raise SystemExit("the profiler saw no kernel of the port in a fused "
                         "step")
    if kinds(f) != kinds(s):
        raise SystemExit(f"a fused step runs the kinds {kinds(f)}, the "
                         f"eager step {kinds(s)}")
    return f, s


def overlap_runs(torch, tmp, cfg, params, batch, seq, plan, cluster, timed,
                 counted, runs):
    """The overlapped executor, batch BATCH in 2 micro-batches, on
    ``seq``'s plan and wire, in two forms of one engine: the staged
    schedule (every stage given the card: ``devices=[card] * n``), then,
    placed anew with ``devices=None`` (``place``: the stage checkpoints are
    written once), the fused chain (one CUDA graph a micro-batch).  Each
    form's tokens equal the sequential chain's whole-batch run and each
    micro-batch's decode-step logits the sequential chain's run of its rows
    alone, bit for bit (the largest logit difference from the whole-batch
    run is logged); then the same with a stage killed after step 3
    (OVERLAP_KILL; the fused form's graph captures logged before and after
    the restore).  A traced fused step runs the eager step's kernels
    (``overlap_trace``).  Decode ms a step of the sequential, staged and
    fused forms on the raw wire (``timed_decode``).  The runs generate
    OVERLAP_GEN tokens.  Counted runs: both forms count the launches that
    ran, the fused form's eager first steps and every graph replay (the
    engine adds a replay's recorded launches; a capture counts nothing),
    so each form is held to the same count: 2 prefills and
    2 (OVERLAP_GEN - 1) decode steps, and a killed run its replay's."""
    import numpy as np
    from repro_torch.serve.pipeline import PipelineServeEngine
    wire = "int8" if seq.wire_bits else "raw"
    kill = {"after_step": KILL["after_step"], "stage": OVERLAP_KILL[cfg.name]}
    halves = [slice(0, BATCH // 2), slice(BATCH // 2, BATCH)]
    whole, whole_logits = seq.generate(batch, OVERLAP_GEN,
                                       collect_logits=True)
    alone = [seq.generate({k: v[h] for k, v in batch.items()}, OVERLAP_GEN,
                          collect_logits=True) for h in halves]
    steps = OVERLAP_GEN - 1              # the decode timings' steps
    out = {}
    if not seq.wire_bits:
        out["sequential_decode_ms"] = (seq.timed_decode(batch, steps)
                                       / steps * 1e3)
    card = params["embed"].device
    eng, ck_s = timed(lambda: PipelineServeEngine(
        cfg, params, plan, max_len=seq.max_len, kv_block=seq.kv_block,
        ckpt_dir=Path(tmp) / f"overlap_{wire}", cluster=cluster, overlap=True,
        micro_batches=2, devices=[card] * seq.n_stages))
    out["checkpoint_s"] = ck_s
    traced = {}
    for form in ("staged", "fused"):
        if form == "fused":
            eng.place(None)
        path = f"overlap_{form}_{wire}"
        (toks, logits), secs = timed(lambda: counted(path, lambda: (
            eng.generate(batch, OVERLAP_GEN, collect_logits=True))))
        caps = eng.graph_captures
        runs[path] = (2, 2 * (OVERLAP_GEN - 1), 0)
        same = bool((toks == whole).all())
        bits = all(logits[h].tobytes() == lg.tobytes() and
                   np.array_equal(toks[h], t)
                   for h, (t, lg) in zip(halves, alone))
        diff = float(np.abs(logits - whole_logits).max())
        since = len(eng.events)
        (ktoks, kill_s) = timed(lambda: counted(path + "_kill", lambda: (
            eng.generate(batch, OVERLAP_GEN, kill=kill))))
        new_caps = eng.graph_captures - caps
        replays = sum("replayed" in m for m in new_messages(eng, since))
        runs[path + "_kill"] = (
            4, 2 * (OVERLAP_GEN - 1 + KILL["after_step"]), 0)
        decode_ms = (eng.timed_decode(batch, steps) / steps * 1e3
                     if not seq.wire_bits else None)
        killed = bool((ktoks == whole).all())
        how = ("one CUDA graph a micro-batch" if form == "fused"
               else f"the staged schedule on {eng.devices}")
        log(f"  [{path}] {eng.n_stages} stages, 2 micro-batches, {how} "
            f"(checkpoints {ck_s:.1f}s, once): generate {secs:.3f}s, tokens "
            f"equal to the sequential chain's: {same}; each micro-batch's "
            f"logits bit-identical to its rows served alone: {bits}; max "
            f"|logits - whole batch's| {diff:.4g}; with stage "
            f"{kill['stage']} killed after step {kill['after_step']}: "
            f"{kill_s:.3f}s, tokens equal: "
            f"{killed}, {replays} replay(s); graph captures {caps} before "
            f"the restore, {new_caps} after"
            + ("" if decode_ms is None else f"; decode {decode_ms:.2f} ms a "
                                            f"step"))
        if not (same and bits and killed and replays == 1) or (
                form == "fused" and not (caps and new_caps)):
            raise SystemExit(f"[{path}] the overlapped executor failed")
        out[form] = {"generate_s": secs, "kill_s": kill_s,
                     "decode_ms": decode_ms, "captures": [caps, new_caps],
                     "max_logit_diff_whole_batch": diff}
        traced[form] = traced_step(torch, eng, batch)
    f, s = overlap_trace(traced["fused"], traced["staged"])
    out["trace_launches"] = {"fused": sum(f.values()),
                             "staged": sum(s.values())}
    if not seq.wire_bits:
        log(f"  decode ms a step (raw wire, {steps} steps at batch "
            f"{BATCH}): sequential {out['sequential_decode_ms']:.2f}, "
            f"staged {out['staged']['decode_ms']:.2f}, fused "
            f"{out['fused']['decode_ms']:.2f}")
    del eng
    shutil.rmtree(Path(tmp) / f"overlap_{wire}", ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 4, granite-3-2b: the pipeline's fault surface at full width
# ---------------------------------------------------------------------------

WIRE_KINDS = ("dropped", "corrupt_rejected", "stale_dropped", "dup_dropped",
              "stalls")
# one fault of each kind besides the seeded draw (the -wire cells' five)
EVERY_KIND = [["drop", 0, 1], ["corrupt", 1, 2, 3], ["dup", 0, 3],
              ["reorder", 1, 4], ["stall", 0, 5, 3.0]]


class StepClock:
    """A telemetry clock that advances one second a read, so the samples
    (and the replan they drive) are the same on every run."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def faulty_wire(n_stages, faults):
    """A BoundaryTransport under ``faults`` (6 attempts a frame) and a
    HeartbeatMonitor, on one fake clock."""
    from repro_torch.serve.retry import RetryPolicy
    from repro_torch.serve.transport import (BoundaryTransport,
                                             FakeWireClock, HeartbeatMonitor)
    clk = FakeWireClock()
    mon = HeartbeatMonitor(n_stages, clock=clk, sleep=clk.sleep)
    tr = BoundaryTransport(n_stages - 1, faults=faults,
                           policy=RetryPolicy(attempts=6, base_delay_s=0.05),
                           monitor=mon, clock=clk, sleep=clk.sleep)
    return tr, mon


def clocked(torch, obj, name):
    """Wrap ``obj.name`` (on the instance) so that each call's seconds,
    the card synchronised at both ends, go into the returned list; ``del
    obj.name`` unwraps it."""
    secs, fn = [], getattr(obj, name)

    def wrapped(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        return out

    setattr(obj, name, wrapped)
    return secs


def new_messages(eng, since):
    return [m for _, m in eng.events[since:]]


def wire_run(torch, eng, batch, want, path, timed, counted, every_kind):
    """One counted generate of ``eng`` through a faulty wire: the chaos
    generator's draw ``seeded_wire_faults(0, hops, GEN, rate=0.2)`` over a
    run's GEN frames a hop, and with ``every_kind`` one fault of each kind
    besides.  The tokens must be ``want`` (the engine's own without a
    transport), every frame delivered exactly once, and no stage
    restored; with ``every_kind``, each kind must have fired.  Returns the
    transport's totals."""
    from repro_torch.serve.transport import (parse_wire_faults,
                                             seeded_wire_faults)
    hops = eng.n_stages - 1
    faults = seeded_wire_faults(0, hops, GEN, rate=0.2)
    if every_kind:
        faults += parse_wire_faults(EVERY_KIND)
    tr, mon = faulty_wire(eng.n_stages, faults)
    eng.attach_wire(tr, mon)
    since = len(eng.events)
    toks, secs = timed(lambda: counted(path, lambda: eng.generate(batch,
                                                                  GEN)))
    eng.attach_wire(None, None)
    totals = {f: tr.total(f) for f in ("sent", "delivered", "retransmits",
                                       *WIRE_KINDS, "suspected", "bytes")}
    restored = [m for m in new_messages(eng, since)
                if "restored from checkpoint" in m]
    same = bool((toks == want).all())
    log(f"  [{path}] {len(faults)} wire faults over {hops} hop(s) "
        f"({tr.total('sent')} frames): {secs:.3f}s; tokens equal to the run "
        f"without the transport: {same}; exactly once: "
        f"{tr.exactly_once()}; {totals}; restores: {len(restored)}")
    missing = [k for k in WIRE_KINDS if every_kind and not totals[k]]
    if not same or not tr.exactly_once() or restored or missing:
        raise SystemExit(f"[{path}] the faulty wire failed: tokens equal "
                         f"{same}, exactly once {tr.exactly_once()}, "
                         f"restores {restored}, kinds that never fired "
                         f"{missing}")
    return dict(totals, faults=len(faults), seconds=secs)


def transport_cost(torch, eng, batch, timed):
    """What the transport costs the host on ``eng``'s wire: the prefill (a
    one-token generate) and a decode step (the rest of a GEN-token
    generate, a step), the best of two each, without and with a
    fault-free transport; and the bytes of a hop's prefill frame and
    decode frame."""
    from repro_torch.serve.transport import BoundaryTransport
    out = {}
    for label in ("without", "with"):
        pre = dec = math.inf
        for _ in range(2):
            trs = [BoundaryTransport(eng.n_stages - 1) if label == "with"
                   else None for _ in range(2)]
            eng.attach_wire(trs[0], None)
            _, p = timed(lambda: eng.generate(batch, 1))
            eng.attach_wire(trs[1], None)
            _, g = timed(lambda: eng.generate(batch, GEN))
            pre, dec = min(pre, p), min(dec, (g - p) / (GEN - 1))
        out[f"prefill_ms_{label}"] = pre * 1e3
        out[f"decode_ms_per_step_{label}"] = dec * 1e3
    eng.attach_wire(None, None)
    out["prefill_frame_bytes"] = trs[0].stats[0].bytes
    out["decode_frame_bytes"] = ((trs[1].stats[0].bytes
                                  - trs[0].stats[0].bytes) // (GEN - 1))
    log(f"  transport's host cost ({'int8' if eng.wire_bits else 'raw'} "
        f"wire): prefill {out['prefill_ms_without']:.2f} -> "
        f"{out['prefill_ms_with']:.2f} ms, decode "
        f"{out['decode_ms_per_step_without']:.2f} -> "
        f"{out['decode_ms_per_step_with']:.2f} ms a step; a hop's prefill "
        f"frame {out['prefill_frame_bytes']} bytes, decode frame "
        f"{out['decode_frame_bytes']} bytes")
    return out


def fault_runs(torch, eng, batch, toks_mono, cluster, ranges, timed,
               counted, runs):
    """The fault surface on the raw-wire engine (after its kill run), each
    a counted run whose tokens must be ServeEngine's: a faulty wire with
    every kind of fault; a silent kill of stage 1 after step 3 found by the
    heartbeat monitor (detection within ``dead_after_s + poll_s``, one
    restore); a live replan from telemetry on a step clock (a stage
    migrated, its params bit-equal to its checkpoint, the batch replayed);
    a replica of the stage ``replicate_bottlenecks`` picks, whose primary's
    kill costs no checkpoint read and no replay, then the last copy's
    kill, restored and replayed.  ``runs`` gains each run's (prefills,
    decode steps, aborted blocks).  Returns the phase's numbers."""
    import dataclasses

    from repro_torch._tree import tree_leaves
    from repro_torch.checkpoint import restore_checkpoint, template_of
    from repro_torch.core import replicate_bottlenecks
    from repro_torch.serve.telemetry import ClusterState, TelemetryStream
    from repro_torch.serve.transport import FakeWireClock, HeartbeatMonitor

    out = {"stages": eng.n_stages, "ranges": ranges}
    step = KILL["after_step"]
    log(f"  -- the fault surface on {eng.n_stages} stages, nodes "
        f"{eng.node_of_stage}, spares {eng.spares}")
    runs["faults_raw_wire"] = (1, GEN - 1, 0)
    out["raw_wire"] = wire_run(torch, eng, batch, toks_mono,
                               "faults_raw_wire", timed, counted, True)
    out["raw_cost"] = transport_cost(torch, eng, batch, timed)

    # a silent kill: the stages before it compute the step it dies in
    clk = FakeWireClock()
    mon = HeartbeatMonitor(eng.n_stages, clock=clk, sleep=clk.sleep)
    eng.attach_wire(None, mon)
    restore_s = clocked(torch, eng, "restore_stage")
    since = len(eng.events)
    runs["faults_silent"] = (2, GEN - 1 + step, ranges[KILL["stage"]][0])
    toks = counted("faults_silent", lambda: eng.generate(
        batch, GEN, kill=dict(KILL, silent=True)))
    del eng.restore_stage
    msgs = new_messages(eng, since)
    restores = [m for m in msgs if "restored from checkpoint" in m]
    (stage, latency), = eng.detections
    bound = mon.dead_after_s + mon.poll_s
    same = bool((toks == toks_mono).all())
    log(f"  [faults_silent] stage {stage} found dead after {latency:g}s of "
        f"silence (bound {bound:g}s, fake clock); {len(restores)} restore "
        f"({restore_s[-1]:.2f}s: spare, checkpoint read onto the card); "
        f"tokens equal to ServeEngine's: {same}")
    for m in msgs:
        log(f"    {m}")
    if not same or len(restores) != 1 or latency > bound \
            or stage != KILL["stage"]:
        raise SystemExit("[faults_silent] the silent kill failed")
    eng.attach_wire(None, None)
    out["silent"] = {"detection_s": latency, "bound_s": bound,
                     "restore_s": restore_s[-1]}

    # a live replan: telemetry on a step clock slows the estimate of the
    # hops that carried traffic, and a stage moves onto a spare
    eng.telemetry = TelemetryStream(eng.n_stages, clock=StepClock())
    results, replan_live = [], eng.replan_live

    def recorded(*args, **kw):
        results.append(replan_live(*args, **kw))
        return results[-1]

    eng.replan_live = recorded
    migrate_s = clocked(torch, eng, "migrate_stage")
    since = len(eng.events)
    runs["faults_replan"] = (2, GEN - 1 + step, 0)
    toks = counted("faults_replan", lambda: eng.generate(
        batch, GEN, replan={"after_step": step,
                            "cluster": ClusterState(cluster)}))
    del eng.replan_live, eng.migrate_stage
    eng.telemetry = None
    res, = results
    same = bool((toks == toks_mono).all())
    moved = res.migrated_stages
    bits = False
    if moved:
        k = moved[0]
        ck = restore_checkpoint(eng.ckpt_dir / f"stage_{k}", 0,
                                template_of(eng.stage_params[k]),
                                device=DEVICE)
        bits = all(a.dtype == b.dtype and torch.equal(
            a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
            for a, b in zip(tree_leaves(eng.stage_params[k]),
                            tree_leaves(ck)))
        del ck
    log(f"  [faults_replan] moves {res.moves}, bottleneck "
        f"{res.bottleneck_before_s:.6g} -> {res.bottleneck_after_s:.6g}s "
        f"est.; migration {sum(migrate_s):.2f}s; the migrated stage's "
        f"params bit-equal to its checkpoint: {bits}; tokens equal to "
        f"ServeEngine's: {same}")
    for m in new_messages(eng, since):
        log(f"    {m}")
    if not (res.changed and moved and bits and same):
        raise SystemExit("[faults_replan] the live replan failed")
    out["replan"] = {"moves": [dataclasses.astuple(m) for m in res.moves],
                     "bottleneck_before_s": res.bottleneck_before_s,
                     "bottleneck_after_s": res.bottleneck_after_s,
                     "migrate_s": sum(migrate_s)}

    # a replica of the bottleneck stage; its primary dies (no read, no
    # replay), then its last copy (restore and replay)
    plan = replicate_bottlenecks(eng.current_plan(), cluster, budget=1,
                                 keep_spares=1)
    k, node = next((i, s.replicas[0]) for i, s in enumerate(plan.stages)
                   if s.replicas)
    reads = clocked(torch, eng, "_restore_params")
    eng.add_replica(k, node)
    deployed = all([(st.node, tuple(st.replicas)) for st in p.stages]
                   == [(st.node, tuple(st.replicas)) for st in plan.stages]
                   and tuple(p.spare_nodes) == tuple(plan.spare_nodes)
                   for p in [eng.current_plan()])
    log(f"  replicate_bottlenecks: stage {k} gets a replica on node {node} "
        f"(copies {eng.stage_copies(k)}, spares {eng.spares}); the engine "
        f"now serves that plan: {deployed}")
    n_reads, since, n_inc = len(reads), len(eng.events), len(eng.incidents)
    runs["faults_replica_kill"] = (1, GEN - 1, 0)
    toks = counted("faults_replica_kill", lambda: eng.generate(
        batch, GEN, kill={"after_step": step, "stage": k}))
    msgs = new_messages(eng, since)
    lost = eng.incidents[n_inc:]
    quiet = not any("restored" in m or "replayed" in m for m in msgs)
    same = bool((toks == toks_mono).all())
    log(f"  [faults_replica_kill] {lost}; checkpoint reads "
        f"{len(reads) - n_reads}, no restore or replay: {quiet}; tokens "
        f"equal to ServeEngine's: {same}")
    if not (deployed and len(lost) == 1 and lost[0].promoted and quiet
            and len(reads) == n_reads and same):
        raise SystemExit("[faults_replica_kill] the replica kill failed")
    since = len(eng.events)
    runs["faults_lastcopy_kill"] = (2, GEN - 1 + step, 0)
    toks = counted("faults_lastcopy_kill", lambda: eng.generate(
        batch, GEN, kill={"after_step": step, "stage": k}))
    del eng._restore_params
    msgs = new_messages(eng, since)
    restores = [m for m in msgs if "restored from checkpoint" in m]
    replays = [m for m in msgs if "replayed" in m]
    same = bool((toks == toks_mono).all())
    log(f"  [faults_lastcopy_kill] {msgs}; tokens equal to ServeEngine's: "
        f"{same}")
    if not (len(restores) == 1 and len(replays) == 1 and same):
        raise SystemExit("[faults_lastcopy_kill] the last copy's kill "
                         "failed")
    out["replica"] = {"stage": k, "node": node,
                      "checkpoint_read_s": reads[0],
                      "incident": dataclasses.astuple(lost[0])}
    log(f"  -- after the fault surface: nodes {eng.node_of_stage}, "
        f"replicas {eng.replica_nodes}, spares {eng.spares}")
    return out


# ---------------------------------------------------------------------------
# phases 5-7: the paper's evaluation surface
# ---------------------------------------------------------------------------

PLANNER_ARCH = "granite-3-2b"     # the planner's and the emulator's model
RANDOM_SEEDS = range(10)          # random_algorithm's draws
EVAL_PLAN_RNGS = range(3)         # the plans evaluate_plans ranks
EVAL_FAULT_SEEDS = (0, 1, 2, 3)
EMU_BATCHES = 20                  # the emulated runs' batches
EMU_FAULT_AT_S = 5.0              # the emulated node failure (modelled s)
CHAOS_ARCH = "granite-3-2b"
CHAOS_CASES = 8
# a silent kill besides the campaign's (seed 0 draws none): the detection
FORCED_SILENT = {"after_step": 2, "stage": 1, "silent": True}
# six drops of one frame defeat the 6-attempt retry policy; the dup and
# the reorder are incidental and must shrink away
FORCED_WIRE = tuple([("drop", 0, 1)] * 6) + (("dup", 1, 2), ("reorder", 0, 4))


def baseline_rows(graph, cluster, cap, plan):
    """SEIFER's bottleneck beside the §6.1 baselines on one instance: the
    random algorithm's mean over RANDOM_SEEDS (seeds whose draw needs more
    nodes than the cluster has are counted, not averaged), joint greedy
    (or why it found no plan), and the exact optimum of the plan's
    boundary sizes.  All are the planner's modelled seconds."""
    import numpy as np
    from repro_torch.core import (PartitionInfeasible,
                                  exact_optimal_bottleneck, joint_greedy,
                                  random_algorithm)
    rand, infeasible = [], 0
    for s in RANDOM_SEEDS:
        try:
            rand.append(random_algorithm(graph, cluster, cap,
                                         rng=s).bottleneck_s)
        except PartitionInfeasible:
            infeasible += 1
    try:
        joint = joint_greedy(graph, cluster, cap).bottleneck_s
    except PartitionInfeasible as e:
        joint = f"infeasible: {e}"
    row = {"seifer_s": plan.bottleneck_s,
           "random_mean_s": float(np.mean(rand)) if rand else None,
           "random_feasible": len(rand), "random_infeasible": infeasible,
           "joint_greedy_s": joint,
           "optimum_s": exact_optimal_bottleneck(
               plan.partition.boundary_sizes, cluster)}
    row["seifer_over_optimum"] = row["seifer_s"] / row["optimum_s"]
    if rand:
        row["random_over_seifer"] = row["random_mean_s"] / row["seifer_s"]
    if not isinstance(joint, str):
        row["joint_over_seifer"] = joint / row["seifer_s"]
    return row


def planner_eval():
    """Phase 5 (host, numpy): the SEIFER plan of full-width granite-3-2b
    that the main path serves, against the random algorithm, joint greedy
    and the exact optimum, and the same on the paper's ResNet50 at 64 MB
    on the same cluster; ``plan_stages`` of every ported arch for the
    2-pod production cluster (the launcher's ``--plan``); and
    ``evaluate_plans`` ranking the plans of EVAL_PLAN_RNGS under a node
    fault of each of EVAL_FAULT_SEEDS.  The optimum may not exceed
    SEIFER's bottleneck (it is the minimum over every placement); the
    rest is printed.  Every number is a modelled estimate of the
    planner's or the emulator's, not a card time."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.configs.paper_cnns import PAPER_MODELS
    from repro_torch.core import (partition_and_place, plan_stages,
                                  tpu_cluster)
    from repro_torch.core.api import evaluate_plans
    from repro_torch.emulator import RandomNodeFaults
    from repro_torch.models.config import SHAPES

    t0 = time.perf_counter()
    out = {}
    cfg = get_config(PLANNER_ARCH, "full")
    graph, cluster, cap = edge_instance(cfg)
    plan = partition_and_place(graph, cluster, cap, n_classes=3,
                               rng=PLAN_RNG)
    resnet = PAPER_MODELS["ResNet50"]()
    for name, (g, c) in {PLANNER_ARCH: (graph, cap),
                         "ResNet50@64MB": (resnet, 64e6)}.items():
        p = plan if g is graph else partition_and_place(
            g, cluster, c, n_classes=3, rng=PLAN_RNG)
        row = out[name] = baseline_rows(g, cluster, c, p)
        log(f"  {name} on random_geometric_cluster(10, rng=7), "
            f"{len(p.partition.runs)} runs (modelled s): {row}")
        if not row["optimum_s"] <= row["seifer_s"] * (1 + 1e-9):
            raise SystemExit(f"[planner_eval] {name}: the exact optimum "
                             f"{row['optimum_s']} exceeds SEIFER's "
                             f"bottleneck {row['seifer_s']}")
    stages = {}
    for arch in ARCH_IDS:
        sp = plan_stages(get_config(arch, "full"), SHAPES["prefill_32k"],
                         cluster=tpu_cluster(n_pods=2, slots_per_pod=8),
                         hbm_per_stage_bytes=16e9 * 32)
        stages[arch] = {"n_stages": sp.n_stages, "cut_after": sp.cut_after,
                        "bottleneck_s": sp.plan.bottleneck_s}
    out["plan_stages"] = stages
    log("  plan_stages at prefill_32k, 512 GB a stage, 2 pods of 8: "
        + ", ".join(f"{a} {v['n_stages']}" for a, v in stages.items()))
    plans = [partition_and_place(graph, cluster, cap, n_classes=3, rng=r)
             for r in EVAL_PLAN_RNGS]
    rows = evaluate_plans(plans, cluster, seeds=EVAL_FAULT_SEEDS,
                          n_batches=EMU_BATCHES,
                          fault_model=RandomNodeFaults(n_faults=1,
                                                       window_s=(5.0, 30.0)))
    out["evaluate_plans"] = [
        {k: v for k, v in r.items() if k not in ("plan", "cells")}
        for r in rows]
    for r in out["evaluate_plans"]:
        log(f"  evaluate_plans (modelled): {r}")
    out["seconds"] = time.perf_counter() - t0
    log(f"  planner_eval took {out['seconds']:.2f}s")
    return out


def emulated():
    """Phase 6 (host): the stage-execution IR the granite raw-wire
    pipeline serves (the planner's 4 stages) through the emulator:
    ``emulate_plan`` fault-free, then the reference ``PipelineEmulator``
    with the node of stage KILL["stage"] failing at EMU_FAULT_AT_S (the
    emulator's RPi-class nodes: modelled seconds).  Every batch must
    complete and the stage must be rescheduled."""
    from repro_torch.configs import get_config
    from repro_torch.core import partition_and_place
    from repro_torch.emulator import (FaultInjector, NodeFault,
                                      PipelineEmulator, emulate_plan)
    t0 = time.perf_counter()
    cfg = get_config(PLANNER_ARCH, "full")
    graph, cluster, cap = edge_instance(cfg)
    ep = partition_and_place(graph, cluster, cap, n_classes=3,
                             rng=PLAN_RNG).execution_plan(
        cluster, wire_bits=0, arch=cfg.name)
    node = ep.stages[KILL["stage"]].node
    free = emulate_plan(ep, cluster, n_batches=EMU_BATCHES)
    emu = PipelineEmulator(cluster, *ep.emulator_args())
    FaultInjector(emu).schedule([NodeFault(EMU_FAULT_AT_S, node)])
    faulty = emu.run(EMU_BATCHES, 1e9)
    keys = ("completed", "throughput_hz", "mean_e2e_s", "p95_e2e_s")
    out = {"nodes": ep.nodes, "killed_node": node,
           "fault_free": {k: free[k] for k in keys},
           "node_fault": {k: faulty[k] for k in keys},
           "events": [(t, m) for t, m in faulty["events"]]}
    log(f"  {cfg.name}: {ep.n_stages} stages on nodes {ep.nodes}; "
        f"fault-free {out['fault_free']}; node {node} (stage "
        f"{KILL['stage']}) failing at {EMU_FAULT_AT_S:g}s "
        f"{out['node_fault']} (modelled)")
    for t, m in out["events"]:
        log(f"    t={t:9.2f}s  {m}")
    rescheduled = any("rescheduled" in m for _, m in faulty["events"])
    if (free["completed"] != EMU_BATCHES
            or faulty["completed"] != EMU_BATCHES or not rescheduled):
        raise SystemExit(f"[emulated] {free['completed']} and "
                         f"{faulty['completed']} of {EMU_BATCHES} batches "
                         f"completed; rescheduled: {rescheduled}")
    out["seconds"] = time.perf_counter() - t0
    return out


def chaos_launches(cfg, ranges, kill, micro=1):
    """What one chaos case launches (``expected_launches``): a prefill and
    GEN_LEN - 1 decode steps a micro-batch, and for a kill after step s
    the replay's prefill and s steps; a silent kill also the blocks before
    the dead stage, computed in the step it was found in.  None for a
    silent kill under overlap (the skewed schedule's aborted tick)."""
    from repro_torch.chaos.campaign import GEN_LEN
    prefills, steps, aborted = 1, GEN_LEN - 1, 0
    if kill is not None:
        if kill.get("silent") and micro > 1:
            return None
        prefills, steps = 2, GEN_LEN - 1 + kill["after_step"]
        if kill.get("silent"):
            aborted = ranges[kill["stage"]][0]
    return expected_launches(cfg, len(ranges), "chaos", micro * steps,
                             micro * prefills, aborted)


def on_card(torch, harness):
    """Every param and batch tensor of ``harness`` on the card."""
    from repro_torch._tree import tree_leaves
    eng = harness.eng
    leaves = [t for sp in eng.stage_params for t in tree_leaves(sp)]
    return all(t.is_cuda for t in leaves + list(harness.batch.values()))


def chaos(torch):
    """Phase 7 (the card): the chaos campaign's serving half on the port.
    ``run_campaign(0, CHAOS_CASES)`` on full-width granite-3-2b at 4
    layers, both halves, every case ok; then a silent kill (the detection
    within ``dead_after_s + poll_s`` on the fake clock); each case's
    launches exactly what its prefills and steps run (so none went through
    a CPU tensor), flash, ``rows_matmul`` and ``decode_attention`` among
    them.  One case through the overlapped executor: its baseline on the
    fused CUDA-graph chain, the case on the staged schedule (its wire
    observes the stages), then, the wire detached, a kill of stage 1 whose
    restore drops the graphs and captures them again; its baseline each
    row's tokens served alone by the sequential chain (the executor's
    contract).  The forced exhausting schedule must fail and shrink to
    exactly its six drops."""
    from repro_torch import kernels
    from repro_torch.chaos import (ChaosCase, ChaosHarness,
                                   generate_campaign, run_campaign,
                                   shrink_case)
    from repro_torch.chaos.campaign import GEN_LEN, case_fails

    out = {"arch": CHAOS_ARCH, "cases": {}}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(
            prefix="chip-smoke-chaos-",
            dir=CKPT_ROOT if CKPT_ROOT.is_dir() else None) as tmp:
        t0 = time.perf_counter()
        h = ChaosHarness(CHAOS_ARCH, seed=0, preset="full", device=DEVICE,
                         ckpt_dir=Path(tmp) / "sequential")
        torch.cuda.synchronize()
        eng = h.eng
        cfg = eng.cfg
        out["harness_s"] = time.perf_counter() - t0
        out["baseline"] = h.baseline
        log(f"  harness: {cfg.name} d_model {cfg.d_model}, {cfg.n_layers} "
            f"layers, stages {eng.ranges} on nodes {eng.node_of_stage}, "
            f"spares {eng.spares}; batch {tuple(h.batch['tokens'].shape)}, "
            f"{GEN_LEN} tokens; built with its baseline in "
            f"{out['harness_s']:.2f}s; on the card: {on_card(torch, h)}")
        if not on_card(torch, h):
            raise SystemExit("[chaos] the harness holds CPU tensors")
        cases = {c.cid: c for c in generate_campaign(0, CHAOS_CASES)}
        cases["silent"] = ChaosCase(cid="silent", kill=FORCED_SILENT)
        serve_s = clocked(torch, h, "run_case")
        state = {"t": time.perf_counter(), "events": len(eng.events)}

        def case_log(msg, cid=None):
            torch.cuda.synchronize()
            cid = cid or msg.split(":")[0]
            got = kernels.launch_counts()
            kernels.reset_launch_counts()
            msgs = [m for _, m in eng.events[state["events"]:]]
            state["events"] = len(eng.events)
            tr = eng.transport
            want = chaos_launches(cfg, eng.ranges, cases[cid].kill)
            rec = {"verdict": msg, "wall_s": time.perf_counter() - state["t"],
                   "serve_s": serve_s[-1],
                   "restores": sum("restored from checkpoint" in m
                                   for m in msgs),
                   "detections": list(eng.detections),
                   "retransmits": tr.total("retransmits"),
                   "launches": got, "launches_exact": got == want}
            state["t"] = time.perf_counter()
            out["cases"][cid] = rec
            log(f"  [{cid}] {msg}; {rec['wall_s']:.3f}s ({rec['serve_s']:.3f}"
                f"s serving); restores {rec['restores']}, detections "
                f"{rec['detections']}, retransmits {rec['retransmits']}; "
                f"launches {got}, exactly its prefills' and steps': "
                f"{rec['launches_exact']}")
            if want != got:
                log(f"    expected {want}")

        kernels.reset_launch_counts()
        report = run_campaign(0, CHAOS_CASES, arch=CHAOS_ARCH,
                              preset="full", device=DEVICE, harness=h,
                              log=case_log)
        log("  " + report.summary().replace("\n", "\n  "))
        fails = h.run_case(cases["silent"])
        case_log(f"silent: {'ok' if not fails else 'FAIL'} {fails}",
                 "silent")
        stage, latency = (eng.detections or [(None, math.inf)])[-1]
        bound = eng.monitor.dead_after_s + eng.monitor.poll_s
        out["silent"] = {"stage": stage, "detection_s": latency,
                         "bound_s": bound, "failures": fails}
        log(f"  silent kill of stage {FORCED_SILENT['stage']}: found dead "
            f"(stage {stage}) after {latency:g}s of silence on the fake "
            f"clock (bound {bound:g}s)")
        del h.run_case

        t0 = time.perf_counter()
        bad = ChaosCase(cid="forced", wire=FORCED_WIRE)
        probes = []

        def fails_forced(c):
            probes.append(len(c.wire))
            return case_fails(h, c, emulator=False)

        caught = fails_forced(bad)
        small = shrink_case(bad, fails_forced) if caught else bad
        kernels.reset_launch_counts()
        out["forced"] = {"caught": caught, "shrunk_to": list(small.wire),
                         "probes": len(probes),
                         "seconds": time.perf_counter() - t0}
        log(f"  forced exhausting schedule {list(FORCED_WIRE)}: caught "
            f"{caught}, shrunk in {len(probes)} probes "
            f"({out['forced']['seconds']:.2f}s) to {list(small.wire)}, "
            f"kill {small.kill}, emu {list(small.emu)}")
        # the overlapped executor's contract: each micro-batch (a row
        # here) the sequential chain serving its rows alone
        eng.attach_wire(None, None)
        rows = h.batch["tokens"].shape[0]
        alone = [eng.generate({k: v[r:r + 1] for k, v in h.batch.items()},
                              GEN_LEN).tolist()[0] for r in range(rows)]
        del h, eng
        gc.collect()
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        ov = ChaosHarness(CHAOS_ARCH, seed=0, preset="full", device=DEVICE,
                          overlap=True, ckpt_dir=Path(tmp) / "overlap")
        torch.cuda.synchronize()
        ovs = {"harness_s": time.perf_counter() - t0,
               "baseline_captures": ov.eng.graph_captures,
               "micro_batches": ov.eng.micro_batches}
        case = next(iter(cases.values()))
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        ovs["failures"] = ov.run_case(case)
        torch.cuda.synchronize()
        ovs["case_s"] = time.perf_counter() - t0
        got = kernels.launch_counts()
        want = chaos_launches(ov.eng.cfg, ov.eng.ranges, case.kill, 2)
        ovs["launches"] = got
        ovs["launches_exact"] = want is None or got == want
        ov.eng.attach_wire(None, None)
        before = ov.eng.graph_captures
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        toks = ov.eng.generate(ov.batch, GEN_LEN, kill=dict(KILL))
        torch.cuda.synchronize()
        ovs["fused_kill_s"] = time.perf_counter() - t0
        fused = kernels.launch_counts()
        ovs["fused_kill_launches"] = fused
        ovs["fused_kill_exact"] = fused == chaos_launches(
            ov.eng.cfg, ov.eng.ranges, KILL, 2)
        ovs["recaptures"] = ov.eng.graph_captures - before
        ovs["fused_kill_tokens_equal"] = toks.tolist() == ov.baseline
        ovs["baseline_rows_alone"] = ov.baseline == alone
        ovs["baseline_equal_batch"] = ov.baseline == out["baseline"]
        out["overlap"] = ovs
        log(f"  overlapped ({ovs['micro_batches']} micro-batches): baseline "
            f"on the fused chain, {ovs['baseline_captures']} graph(s) "
            f"captured; [{case.cid}] on the staged schedule "
            f"{ovs['failures'] or 'ok'} in {ovs['case_s']:.3f}s, launches "
            f"{got} (exact: {ovs['launches_exact']}); wire detached, stage "
            f"{KILL['stage']} killed after step {KILL['after_step']}: "
            f"{ovs['recaptures']} graph(s) captured again, tokens the "
            f"baseline's {ovs['fused_kill_tokens_equal']}, launches exact "
            f"{ovs['fused_kill_exact']} ({ovs['fused_kill_s']:.3f}s); the "
            f"baseline each row's served alone by the sequential chain: "
            f"{ovs['baseline_rows_alone']}, the 2-row batch's (not "
            f"required: a prefill GEMM's bits may depend on its rows): "
            f"{ovs['baseline_equal_batch']}")
        del ov
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  chaos took {out['seconds']:.1f}s")

    bad_cases = [cid for cid, r in out["cases"].items()
                 if not r["verdict"].split(": ")[1].startswith("ok")
                 or not r["launches_exact"]
                 or not all(r["launches"][k] for k in (
                     "flash_attention", "rows_matmul", "decode_attention"))]
    if not report.ok or bad_cases:
        raise SystemExit(f"[chaos] cases failed: {bad_cases}")
    sil = out["silent"]
    if (sil["failures"] or sil["stage"] != FORCED_SILENT["stage"]
            or not sil["detection_s"] <= sil["bound_s"]):
        raise SystemExit(f"[chaos] the silent kill: {sil}")
    if not caught or small.kill is not None or small.emu != () \
            or list(small.wire) != [("drop", 0, 1)] * 6:
        raise SystemExit(f"[chaos] the forced case: {out['forced']}")
    if (ovs["failures"] or not ovs["launches_exact"]
            or not ovs["baseline_captures"] or not ovs["recaptures"]
            or not ovs["fused_kill_tokens_equal"]
            or not ovs["fused_kill_exact"]
            or not ovs["baseline_rows_alone"]):
        raise SystemExit(f"[chaos] the overlapped case: {ovs}")
    return out


# ---------------------------------------------------------------------------
# phase 8: training on the card
# ---------------------------------------------------------------------------

TRAIN_ARCH = "granite-3-2b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 4
CHECK_DEPTH, CHECK_SEQ = 2, 128     # the step held against the CPU's
RESTART_DEPTH = 4                   # the crash and restart's model
# the SSM family's train runs: mamba2-1.3b at full depth (48 layers, about
# 16 GB of bf16 params and grads and float32 AdamW states); zamba2-7b at 42
# of its 81 layers (7 call sites of the shared block, about 3.7 G params
# and 45 GB of them; 81 layers, about 82 GB, do not fit the card)
SSM_TRAIN = {"mamba2-1.3b": None, "zamba2-7b": 42}
PROFILE_ARCH = "mamba2-1.3b"        # launch/train.py --profile's model
# the cross-attention families, through make_train_step with a side input:
# whisper-large-v3 at full depth (32 + 32 layers, about 2 G params, 24 GB
# with float32 AdamW states), llama-3.2-vision-90b at one group of its 20
# (5 layers, about 6.4 G params with the embedding and head, 51 GB with
# bf16 states; two groups, about 86 GB, do not fit the card); None: full
# depth.  The 2-layer step against the CPU's is whisper's only (the VLM's
# smallest depth is a group, whose CPU step at full width is too large)
XATTN_TRAIN = {"llama-3.2-vision-90b": 5, "whisper-large-v3": None}
XATTN_CHECK = ("whisper-large-v3",)


def _by_path(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_by_path(v, f"{pre}{k}/"))
        else:
            out[pre + k] = v
    return out


def _bytes_equal(torch, a, b):
    from repro_torch._tree import tree_leaves
    return all(x.dtype == y.dtype and x.shape == y.shape and torch.equal(
        x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
        for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _sync(torch):
    if torch.device(DEVICE).type == "cuda":
        torch.cuda.synchronize()


def _free(torch):
    gc.collect()
    if torch.device(DEVICE).type == "cuda":
        torch.cuda.empty_cache()


def side_batch(torch, cfg, b, s, seed, device):
    """A training batch of ``launch.steps.batch_specs``: tokens from
    ``SyntheticTokens`` and the family's side input (frames or vision
    embeddings, bf16) from a seeded CPU ``torch.Generator``, on
    ``device``."""
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.steps import batch_specs
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, (shape, dtype) in batch_specs(cfg, b, s).items():
        out[name] = (torch.from_numpy(SyntheticTokens(cfg.vocab, s, b)
                                      .batch(seed)["tokens"])
                     if name == "tokens" else
                     torch.randn(shape, generator=gen).to(dtype))
    return {k: v.to(device) for k, v in out.items()}


def train_check(torch, full):
    """One train step's loss and gradients of ``full`` at ``CHECK_DEPTH``
    layers (an encoder-decoder's encoder too), bf16, batch 1 x
    ``CHECK_SEQ`` (with its frames), on the card (the kernels and
    their backwards) against the same on the CPU (the plain versions)
    from the same params: the loss within 2e-3, every gradient leaf within
    3e-2 of the CPU leaf's largest |value|, finite and not zero; the
    card's launches exactly ``train_launches``.  A hybrid's bf16 shared
    block rounds differently on the card and the CPU, each run about as far
    from the float32 run as the other
    (``tests/test_torch_cuda.py::test_ssm_train_step_on_card_vs_cpu``, six
    seeds), and the encoder-decoder's bf16 loss on the CPU is the further
    one (``test_whisper_train_step_on_card_vs_cpu``, four seeds), so these
    may instead be held to the CPU's float32 run: the loss within max(5e-3,
    twice the CPU's bf16 distance) of it, and a leaf over 3e-2 no further
    from the float32 leaf, in norm, than twice the CPU's bf16 leaf is.
    Returns (record, launches)."""
    from repro_torch import kernels
    from repro_torch._tree import tree_map
    from repro_torch.launch.steps import loss_and_grads, train_launches
    from repro_torch.models import init_params
    cfg = full.replace(n_layers=CHECK_DEPTH)
    if cfg.family == "encdec":
        cfg = cfg.replace(n_enc_layers=CHECK_DEPTH)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    card = init_params(cfg, gen, device=DEVICE)
    host = tree_map(lambda t: t.cpu(), card)
    batch = side_batch(torch, cfg, 1, CHECK_SEQ, 0, "cpu")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    m_card, g_card = loss_and_grads(
        cfg, card, {k: v.to(DEVICE) for k, v in batch.items()})
    _sync(torch)
    card_s = time.perf_counter() - t0
    got = kernels.launch_counts()
    t0 = time.perf_counter()
    m_host, g_host = loss_and_grads(cfg, host, batch)
    host_s = time.perf_counter() - t0
    loss_c, loss_h = float(m_card["loss"]), float(m_host["loss"])
    exact = loss_x = None
    if cfg.family in ("hybrid", "encdec"):
        m_x, g_x = loss_and_grads(cfg.replace(param_dtype="float32"),
                                  tree_map(lambda t: t.float(), host), batch)
        loss_x, exact = float(m_x["loss"]), _by_path(g_x)
        del g_x
    leaves, bad = {}, []
    hosts = _by_path(g_host)
    for path, gc_ in _by_path(g_card).items():
        gc_, gh = gc_.float().cpu(), hosts[path].float()
        top = gh.abs().max().item()
        leaves[path] = (gc_ - gh).abs().max().item() / top
        ok = leaves[path] <= 3e-2
        if exact is not None and not ok:
            gx = exact[path].float()
            ok = bool((gc_ - gx).norm() <= 2 * (gh - gx).norm())
        if not (torch.isfinite(gc_).all() and gc_.abs().max() > 0 and ok):
            bad.append(path)
    loss_ok = abs(loss_c - loss_h) <= STEP_LOSS_TOL or (
        loss_x is not None
        and abs(loss_c - loss_x) <= max(5e-3, 2 * abs(loss_h - loss_x)))
    want = train_launches(cfg, 1)
    rec = {"depth": CHECK_DEPTH, "tokens": [1, CHECK_SEQ],
           "loss_card": loss_c, "loss_cpu": loss_h,
           "loss_cpu_float32": loss_x,
           "worst_leaf": max(leaves.values()), "card_s": card_s,
           "cpu_s": host_s, "launches": got, "launches_exact": got == want}
    worst = max(leaves, key=leaves.get)
    log(f"  {cfg.name}: one step at full width, {CHECK_DEPTH} layers"
        + (f" (and {cfg.n_enc_layers} encoder layers)"
           if cfg.family == "encdec" else "")
        + f", batch 1 x {CHECK_SEQ}: loss {loss_c:.6f} on the card, "
        f"{loss_h:.6f} on "
        f"the CPU (tol {STEP_LOSS_TOL:g}"
        + ("" if loss_x is None else f", or max(5e-3, twice the CPU's "
           f"distance) from its float32 run's {loss_x:.6f}")
        + f"); the worst of {len(leaves)} gradient leaves {worst} at "
        f"{leaves[worst]:.3g} of its largest (tol 3e-2); every leaf finite, "
        f"not zero and within its limit: {not bad}; {card_s:.2f}s on the "
        f"card (first use), {host_s:.2f}s on the CPU; launches {got} "
        f"(exact: {got == want})")
    if bad or not loss_ok or got != want:
        raise SystemExit(f"[train] {cfg.name}: the step against the CPU's: "
                         f"{rec}, leaves {bad}, expected launches {want}")
    del card, host, g_card, g_host, exact
    _free(torch)
    return rec, got


def train_full(torch, cfg, ckpt_dir):
    """``Trainer`` on ``cfg`` at full width (bf16 params, float32 AdamW
    states), batch ``TRAIN_BATCH`` x ``TRAIN_SEQ``, ``TRAIN_STEPS`` steps:
    finite losses, each step's launches exactly ``train_launches``; step
    ms (the median of steps 2-4, a host clock around ``run(1)`` ending in
    a synchronise), tokens/s and peak device memory.  Returns (record,
    the launches of all steps)."""
    from repro_torch import kernels
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.steps import train_launches
    from repro_torch.runtime import Trainer, TrainerConfig
    card_run = torch.device(DEVICE).type == "cuda"
    t0 = time.perf_counter()
    tr = Trainer(cfg, SyntheticTokens(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH),
                 TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=10 ** 9,
                               log_every=1, device=DEVICE))
    tr.init_or_restore()
    _sync(torch)
    init_s = time.perf_counter() - t0
    state_gb = sum(t.nbytes for t in
                   _by_path({"p": tr.params, "m": tr.opt.m,
                             "v": tr.opt.v}).values()) / 1e9
    if card_run:
        torch.cuda.reset_peak_memory_stats()
    steps_ms, counts = [], []
    for _ in range(TRAIN_STEPS):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        tr.run(1)
        _sync(torch)
        steps_ms.append((time.perf_counter() - t0) * 1e3)
        counts.append(kernels.launch_counts())
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9 if card_run
               else math.nan)
    losses = [m["loss"] for m in tr.history]
    want = train_launches(cfg, 1)
    step_ms = sorted(steps_ms[1:])[len(steps_ms[1:]) // 2]
    rec = {"layers": cfg.n_layers, "batch": [TRAIN_BATCH, TRAIN_SEQ],
           "params_b": sum(t.numel() for t in _by_path(tr.params).values())
           / 1e9, "init_s": init_s, "state_gb": state_gb,
           "steps_ms": steps_ms, "step_ms": step_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
           "peak_gb": peak_gb, "losses": losses,
           "launches_a_step": counts[0],
           "launches_exact": all(c == want for c in counts)}
    log(f"  Trainer, {cfg.name} at full width and {cfg.n_layers} layers "
        f"(remat {cfg.remat}), batch {TRAIN_BATCH} x {TRAIN_SEQ}: "
        f"{rec['params_b']:.3f} G params, params and AdamW states "
        f"{state_gb:.2f} GB, made in {init_s:.2f}s; steps "
        f"{[f'{x:.1f}' for x in steps_ms]} ms, the median of steps "
        f"2-{TRAIN_STEPS} {step_ms:.1f} ms, {rec['tokens_per_s']:.0f} "
        f"tokens/s; peak device memory {peak_gb:.2f} GB; losses {losses}; "
        f"launches a step {counts[0]} (each step exact: "
        f"{rec['launches_exact']})")
    if not (all(math.isfinite(x) for x in losses) and rec["launches_exact"]):
        raise SystemExit(f"[train] {cfg.name}: {rec}, expected {want} a "
                         "step")
    del tr
    _free(torch)
    return rec, {k: sum(c[k] for c in counts) for k in counts[0]}


def train_side(torch, cfg):
    """``make_train_step`` on a cross-attention model at full width (bf16
    params, AdamW states in the config's ``opt_state_dtype``), batch
    ``TRAIN_BATCH`` x ``TRAIN_SEQ`` with its side input (``side_batch``:
    whisper's frames (B, S, D), the VLM's vision embeddings (B, 6400, D)),
    ``TRAIN_STEPS`` steps (the launcher refuses these families: the
    reference's feeds tokens only): finite losses, each step's launches
    exactly ``train_launches`` (whisper's encoder through the non-causal
    flash backward: ``noncausal_launches``); step ms (the median of steps
    2-4, a host clock around a step ending in a synchronise), tokens/s and
    peak device memory.  Returns (record, the launches of all steps)."""
    from repro_torch import kernels
    from repro_torch.launch.steps import make_train_step, train_launches
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    params = init_params(cfg, gen, device=DEVICE)
    opt = adamw_init(params, getattr(torch, cfg.opt_state_dtype))
    step = make_train_step(cfg)
    _sync(torch)
    init_s = time.perf_counter() - t0
    state_gb = sum(t.nbytes for t in _by_path(
        {"p": params, "m": opt.m, "v": opt.v}).values()) / 1e9
    n_par = sum(t.numel() for t in _by_path(params).values())
    card_run = torch.device(DEVICE).type == "cuda"
    if card_run:
        torch.cuda.reset_peak_memory_stats()
    steps_ms, counts, noncausal, losses = [], [], [], []
    bwd = kernels.WRAPPERS["flash_attention_bwd"]
    for i in range(TRAIN_STEPS):
        batch = side_batch(torch, cfg, TRAIN_BATCH, TRAIN_SEQ, i, DEVICE)
        _sync(torch)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        _sync(torch)
        steps_ms.append((time.perf_counter() - t0) * 1e3)
        counts.append(kernels.launch_counts())
        noncausal.append(bwd.noncausal_launches)
        losses.append(float(m["loss"]))
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9 if card_run
               else math.nan)
    want = train_launches(cfg, 1)
    want_nc = cfg.n_enc_layers if cfg.family == "encdec" else 0
    step_ms = sorted(steps_ms[1:])[len(steps_ms[1:]) // 2]
    side = [k for k in batch if k != "tokens"][0]
    rec = {"layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers
           if cfg.family == "encdec" else 0,
           "batch": [TRAIN_BATCH, TRAIN_SEQ],
           "side_input": {side: list(batch[side].shape)},
           "params_b": n_par / 1e9, "init_s": init_s, "state_gb": state_gb,
           "state_dtype": cfg.opt_state_dtype, "steps_ms": steps_ms,
           "step_ms": step_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
           "peak_gb": peak_gb, "losses": losses,
           "launches_a_step": counts[0],
           "noncausal_bwd_a_step": noncausal[0],
           "launches_exact": all(c == want for c in counts)
           and all(n == want_nc for n in noncausal)}
    log(f"  make_train_step, {cfg.name} at full width and {cfg.n_layers} "
        f"layers" + (f" + {cfg.n_enc_layers} encoder layers"
                     if cfg.family == "encdec" else "")
        + f" (remat {cfg.remat}), batch {TRAIN_BATCH} x {TRAIN_SEQ} with "
        f"{side} {list(batch[side].shape)}: {n_par / 1e9:.3f} G params, "
        f"params and {cfg.opt_state_dtype} AdamW states {state_gb:.2f} GB, "
        f"made in {init_s:.2f}s; steps {[f'{x:.1f}' for x in steps_ms]} "
        f"ms, the median of steps 2-{TRAIN_STEPS} {step_ms:.1f} ms, "
        f"{rec['tokens_per_s']:.0f} tokens/s; peak device memory "
        f"{peak_gb:.2f} GB; losses {losses}; launches a step {counts[0]}, "
        f"{noncausal[0]} of the backward's non-causal (each step exact: "
        f"{rec['launches_exact']})")
    if not (all(math.isfinite(x) for x in losses) and rec["launches_exact"]):
        raise SystemExit(f"[train] {cfg.name}: {rec}, expected {want} and "
                         f"{want_nc} non-causal a step")
    del params, opt, step
    _free(torch)
    return rec, {k: sum(c[k] for c in counts) for k in counts[0]}


def train_profile(torch, arch, ckpt_dir):
    """``python -m repro_torch.launch.train --arch ARCH --preset full
    --seq-len TRAIN_SEQ --global-batch TRAIN_BATCH --steps 1 --profile``,
    in this process: one step, then one traced step; its printed lines
    (wall, device busy time, kernel launches, the kernels that took the
    most device time) are logged and parsed."""
    import contextlib
    import io
    from repro_torch.launch import train as train_cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_cli.main(["--arch", arch, "--preset", "full", "--device",
                        DEVICE, "--steps", "1", "--seq-len", str(TRAIN_SEQ),
                        "--global-batch", str(TRAIN_BATCH), "--ckpt-dir",
                        ckpt_dir, "--profile"])
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"  | {line}")
    m = re.search(r"wall ([\d.]+) ms \(traced\), device busy ([\d.]+) ms "
                  r"\(([\d.]+)%\), (\d+) kernel launches", text)
    if not m:
        raise SystemExit(f"[train] {arch}: no profile line in {text!r}")
    top = re.findall(r"^\s+([\d.]+) ms\s+(\d+)x\s+(.*)$", text, re.M)
    _free(torch)
    return {"wall_ms": float(m.group(1)), "busy_ms": float(m.group(2)),
            "busy_share": float(m.group(3)) / 100,
            "kernel_launches": int(m.group(4)),
            "top": [{"ms": float(a), "count": int(c), "kernel": k}
                    for a, c, k in top]}


def train(torch):
    """Phase 8 (the card): the training path.

    1. granite-3-2b (``train_check``): one step at full width and
       ``CHECK_DEPTH`` layers on the card against the CPU's.
    2. ``train_full``: ``Trainer`` on granite-3-2b at full width and depth
       (40 layers), batch ``TRAIN_BATCH`` x ``TRAIN_SEQ``, ``TRAIN_STEPS``
       steps, each step's launches exactly ``train_launches``.
    3. A crash and restart at full width and ``RESTART_DEPTH`` layers,
       checkpoints under ``CKPT_ROOT`` every 2 steps: a crash at the third
       step (``raise_at=2``), a new ``Trainer`` resumes at step 2 with the
       saved params' and states' bytes, and its steps 3-4 give the losses
       of an uninterrupted run within 1e-3 relative (whether they are
       bit-equal is logged: the embedding's backward on the card may sum
       in another order).
    4. The SSM family (``SSM_TRAIN``): mamba2-1.3b at full width and depth
       and zamba2-7b at full width and 42 layers, each through 1. and 2.
       (the scan's, the conv pass's and the gated norm's backward kernels,
       zamba2's shared block through the flash backward at head dim 112),
       and ``launch/train.py --profile`` on mamba2 (``train_profile``).
    5. The cross-attention families (``XATTN_TRAIN``): whisper-large-v3 at
       full width and depth and llama-3.2-vision-90b at full width and one
       group (5 layers) through ``train_side`` (whisper's encoder through
       the non-causal flash backward, its decoder through the causal one;
       the cross blocks' attention plain torch), whisper also through 1.
       at 2 encoder and 2 decoder layers."""
    from repro_torch import kernels
    from repro_torch._tree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.steps import train_launches
    from repro_torch.runtime import Trainer, TrainerConfig

    out, by_path = {}, {}
    t_phase = time.perf_counter()
    full = get_config(TRAIN_ARCH, "full")
    out["check"], by_path[f"{TRAIN_ARCH}/train_check"] = train_check(torch,
                                                                     full)
    with tempfile.TemporaryDirectory(
            prefix="chip-smoke-train-",
            dir=CKPT_ROOT if CKPT_ROOT.is_dir() else None) as tmp:
        out["full"], by_path[f"{TRAIN_ARCH}/train_full"] = train_full(
            torch, full, f"{tmp}/full")

        # 3. crash and restart
        cfg = full.replace(n_layers=RESTART_DEPTH)
        data = SyntheticTokens(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH)

        def trainer(name, every=2):
            return Trainer(cfg, data, TrainerConfig(
                ckpt_dir=f"{tmp}/{name}", ckpt_every=every, log_every=1,
                device=DEVICE))

        t0 = time.perf_counter()
        whole = trainer("whole", every=10 ** 9)
        whole.init_or_restore()
        whole.run(4)
        want_losses = [m["loss"] for m in whole.history]
        del whole
        crashed = trainer("restart")
        crashed.init_or_restore()
        try:
            crashed.run(4, raise_at=2)
            msg = None
        except RuntimeError as e:
            msg = str(e)
        saved = tree_map(lambda t: t.clone(),
                         {"params": crashed.params, "opt": crashed.opt})
        del crashed
        gc.collect()
        t1 = time.perf_counter()
        again = trainer("restart")
        start = again.init_or_restore()
        _sync(torch)
        restore_s = time.perf_counter() - t1
        same_state = _bytes_equal(torch, saved,
                                  {"params": again.params, "opt": again.opt})
        del saved
        kernels.reset_launch_counts()
        again.run(2)
        _sync(torch)
        by_path[f"{TRAIN_ARCH}/train_restart"] = got = \
            kernels.launch_counts()
        resumed = [m["loss"] for m in again.history]
        rel = max(abs(a - b) / abs(b) for a, b in zip(resumed,
                                                     want_losses[2:]))
        out["restart"] = {
            "layers": RESTART_DEPTH, "crash": msg, "resumed_at": start,
            "restore_s": restore_s, "state_bytes_equal": same_state,
            "losses": resumed, "uninterrupted": want_losses[2:],
            "max_rel_diff": rel, "bit_equal": resumed == want_losses[2:],
            "launches": got, "launches_exact": got == train_launches(cfg, 2),
            "seconds": time.perf_counter() - t0}
        del again
        _free(torch)
        r = out["restart"]
        log(f"  crash and restart at full width, {RESTART_DEPTH} layers, "
            f"checkpoints every 2 steps: {r['crash']!r}; resumed at step "
            f"{r['resumed_at']} in {r['restore_s']:.2f}s, the saved params' "
            f"and states' bytes {r['state_bytes_equal']}; steps 3-4 losses "
            f"{r['losses']} against the uninterrupted {r['uninterrupted']} "
            f"(max relative {r['max_rel_diff']:.3g}, tol 1e-3; bit-equal "
            f"{r['bit_equal']}); launches exact {r['launches_exact']}; "
            f"{r['seconds']:.1f}s")
        if (r["crash"] != "injected crash at step 2" or r["resumed_at"] != 2
                or not r["state_bytes_equal"] or not r["max_rel_diff"] <= 1e-3
                or not r["launches_exact"]):
            raise SystemExit(f"[train] crash and restart: {r}")

        # 4. the SSM family
        out["ssm"] = {}
        for arch, depth in SSM_TRAIN.items():
            t0 = time.perf_counter()
            cfg = get_config(arch, "full")
            if depth:
                cfg = cfg.replace(n_layers=depth)
            rec = {}
            rec["check"], by_path[f"{arch}/train_check"] = train_check(
                torch, cfg)
            rec["full"], by_path[f"{arch}/train_full"] = train_full(
                torch, cfg, f"{tmp}/{arch}")
            if arch == PROFILE_ARCH:
                rec["profile"] = train_profile(torch, arch,
                                               f"{tmp}/{arch}-profile")
            rec["seconds"] = time.perf_counter() - t0
            log(f"  {arch} took {rec['seconds']:.1f}s")
            out["ssm"][arch] = rec

        # 5. the cross-attention families
        out["xattn"] = {}
        for arch, depth in XATTN_TRAIN.items():
            t0 = time.perf_counter()
            cfg = get_config(arch, "full")
            if depth:
                cfg = cfg.replace(n_layers=depth)
            rec = {}
            rec["full"], by_path[f"{arch}/train_full"] = train_side(torch,
                                                                    cfg)
            if arch in XATTN_CHECK:
                rec["check"], by_path[f"{arch}/train_check"] = train_check(
                    torch, cfg)
            rec["seconds"] = time.perf_counter() - t0
            log(f"  {arch} took {rec['seconds']:.1f}s")
            out["xattn"][arch] = rec
    out["launches_by_path"] = by_path
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  training took {out['seconds']:.1f}s")
    return out


def smi_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _wire_times(torch, gen):
    return {f"{m}x{n}": r for (m, n), r in wire_times(torch, gen).items()}


def _flash_bwd_times(torch, gen):
    return {"x".join(map(str, case[:5])) + ("" if case[5] else "-noncausal"):
            bwd_times(torch, *flash_bwd_inputs(torch, gen, *case),
                      causal=case[5]) for case in BWD_TIMED}


def _ssd_bwd_times(torch, gen):
    out = {}
    for key, (shape, _) in SSM_BWD_SHAPES.items():
        _, ins, dy = ssd_bwd_case(torch, gen, *shape, torch.bfloat16)
        out[key] = ssd_bwd_timing(torch, ins, dy, shape[-1])
    return out


def _conv_bwd_times(torch, gen):
    out = {}
    for key in SSM_BWD_SHAPES:
        _, ins = conv_bwd_case(torch, gen, key, torch.bfloat16)
        out[key] = conv_bwd_timing(torch, ins)
    out.update(conv_bwd_sass(torch))
    return out


def _gated_bwd_times(torch, gen):
    out = {}
    for key in SSM_BWD_SHAPES:
        _, ins = gated_bwd_case(torch, gen, key, torch.bfloat16)
        out[key] = gated_bwd_timing(torch, ins)
    return out


# ``--times KERNEL``: what each times, with its check's own inputs (and,
# for the SSM backwards, their checks against the plain versions first)
TIMES = {"wire": _wire_times,               # quantize and dequantize
         "flash_bwd": _flash_bwd_times,     # at BWD_TIMED
         "ssd_bwd": _ssd_bwd_times,         # at SSM_BWD_SHAPES
         "conv_bwd": _conv_bwd_times,       # at SSM_BWD_SHAPES' widths
         "gated_bwd": _gated_bwd_times}     # at SSM_BWD_SHAPES' widths


def times_only(torch, kernel, src=str(ROOT / "src")):
    """``--times KERNEL [SRC]``: one kernel's times alone, with the port
    imported from ``SRC`` (default: this checkout's ``src/``), so that one
    run can time two checkouts; the JSON of the times is the last line."""
    sys.path.insert(0, str(Path(src).resolve()))
    import repro_torch
    log(smi_line())
    log(f"  the port from {Path(repro_torch.__file__).resolve().parents[2]}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    print(json.dumps({f"{kernel}_times": TIMES[kernel](torch, gen)}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Drive the PyTorch/CUDA port's main path once on one "
                    "NVIDIA card.")
    ap.add_argument("--times", nargs="+", metavar=("KERNEL", "SRC"),
                    help="time only KERNEL (one of: " + ", ".join(TIMES)
                         + "), with the port imported from SRC (default: "
                         "this checkout's src/)")
    args = ap.parse_args(argv)
    if args.times and (len(args.times) > 2 or args.times[0] not in TIMES):
        ap.error(f"--times KERNEL [SRC], KERNEL one of {', '.join(TIMES)}")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if args.times:
        return times_only(torch, *args.times)
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    starts = []                 # (phase, its start): each phase's seconds

    def phase(title):
        starts.append((title.split(".")[0], time.perf_counter()))
        log(f"== {title}")

    phase("1. device")
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"  nvidia-smi: {smi}")
    log(f"  torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"{kind}, {count} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("2. build")
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"  nvcc {' '.join(_build.NVCC_FLAGS)}: "
        + ", ".join(f"{n}.cu {s:.1f}s" for n, s in secs.items())
        + f"; {time.perf_counter() - t0:.1f}s wall")

    phase("3. kernels against their plain versions")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    records = [check_flash(torch, gen), check_flash_bwd(torch, gen),
               *check_quantize(torch, gen),
               check_ssd(torch, gen), *check_decode(torch, gen),
               *check_norm(torch, gen), check_silu(torch, gen),
               check_conv_silu(torch, gen), *check_ssm_bwd(torch, gen)]
    torch.cuda.empty_cache()

    phase("4. main paths at full width")
    by_path, streams, timings = {}, {}, {}
    for arch in ARCHS:
        cfg = get_config(arch, "full")
        if arch in DEPTH:
            log(f"-- {arch} at {DEPTH[arch]} of its {cfg.n_layers} layers")
            cfg = cfg.replace(n_layers=DEPTH[arch])
        else:
            log(f"-- {arch}")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(
                prefix="chip-smoke-",
                dir=CKPT_ROOT if CKPT_ROOT.is_dir() else None) as tmp:
            counts, streams[arch], timings[arch] = main_path(
                torch, tmp, cfg, arch in PIPELINED,
                PROMPT_OF.get(arch, PROMPT), CUTS.get(arch))
        for path, got in counts.items():
            by_path[f"{arch}/{path}"] = got
        gc.collect()                  # this model's weights and caches
        torch.cuda.empty_cache()
        timings[arch]["seconds"] = time.perf_counter() - t0
        log(f"-- {arch} took {timings[arch]['seconds']:.1f}s; peak device "
            f"memory by run (GB): {timings[arch]['peak_gb']}")
    phase("5. the planner against the paper's baselines (host; modelled "
        "seconds)")
    evaluation = {"planner_eval": planner_eval()}
    phase("6. the emulator on the served pipeline's plan (host; modelled "
        "seconds)")
    evaluation["emulated"] = emulated()
    phase("7. the chaos campaign's serving half on the card")
    evaluation["chaos"] = chaos(torch)
    for cid, rec in evaluation["chaos"]["cases"].items():
        by_path[f"{CHAOS_ARCH}/chaos_{cid}"] = rec["launches"]
    phase("8. training on the card")
    evaluation["train"] = train(torch)
    by_path.update(evaluation["train"].pop("launches_by_path"))
    for r in records:
        own = r.pop("main_path", None)   # a record's own counted run
        r["launches"] = (by_path[own][r["name"]] if own else
                         sum(by_path[f"{a}/pipeline_int8_kill"][r["name"]]
                             for a in PIPELINED))
        r["launches_by_path"] = {p: c[r["name"]] for p, c in by_path.items()}
        if "non_causal" in r:   # the flash backward's: whisper's encoder
            enc = evaluation["train"]["xattn"]["whisper-large-v3"]["full"]
            r["non_causal"]["launches"] = (enc["noncausal_bwd_a_step"]
                                           * TRAIN_STEPS)
            r["non_causal"]["main_path"] = "whisper-large-v3/train_full"
    ends = [t for _, t in starts[1:]] + [time.perf_counter()]
    log(f"== done in {ends[-1] - t_start:.1f}s; seconds by phase: "
        + ", ".join(f"{n} {e - t:.1f}" for (n, t), e in zip(starts, ends)))
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms",
            "cold_ms", "cold_out_ms", "cast_ms",   # quantize's, dequantize's
            "cast_cold_ms", "cast_cold_out_ms",
            "warm_ms", "warm_library_ms",      # the two decode kernels'
            "issue_bound_ms", "sass_per_element",   # silu's

            "scaled_err", "per_element_err",   # the flash backward's
            "per_pass_ms", "hd128", "hd112", "non_causal",
            "zamba2",                          # the SSM backwards'

            "forward_ms", "forward_with_lse_ms", "registers",
            "long_prompt", "zamba2_prefill",   # flash's and the SSD scan's
            "whisper_encoder", "llama4_prefill",   # flash's
            "shapes")                          # the decode kernels'
    faults = {a: t.pop("faults") for a, t in timings.items()
              if t.get("faults")}
    pipelined = {a: t.pop("pipelined") for a, t in timings.items()
                 if "pipelined" in t}
    log(f"  the pipelined streams and the overlapped executor took "
        f"{sum(p['seconds'] for p in pipelined.values()):.1f}s in all")
    log(json.dumps({"streams": streams, "serving": timings,
                    "faults": faults, "pipelined": pipelined, **evaluation}))
    print(smi)
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in records]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
