#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. device  — the card's name and power limit (nvidia-smi) and count;
2. build   — nvcc builds every kernel of the path from ``src/repro_torch/
   kernels/csrc`` (one process per source, all at once);
3. kernels — each kernel against its plain PyTorch version on the card,
   at the main paths' shapes: flash attention within 3e-2 (bf16, every head
   dim, 112 on the 128 tile included, ragged S, and a 4096-token prompt)
   and 2e-5 (float32), with no copy of its inputs or output in its wrapper,
   quantize and dequantize bit-equal (zamba2's 3584-wide wire rows on the
   rowwise path), the SSD scan within
   |kernel - plain| <= 1e-2 + 1e-2 |plain| (bf16 output) and 2e-4 + 2e-4
   |plain| (float32 output and the float32 state); times from CUDA events
   beside the plain version's, the bound, and for flash the library call
   ``F.scaled_dot_product_attention`` (a yardstick the port never calls;
   no PyTorch call computes the SSD scan), at granite's and mamba2's
   prefill shapes, at zamba2's (``zamba2_prefill`` in the records), and
   flash and the SSD scan again at B=1 and a 4096-token prompt;
4. the main paths at full width and full depth, with random bf16 weights
   from seed 0: granite-3-2b (40 layers, d_model 2048), mamba2-1.3b (48
   layers, d_model 2048, 64 SSM heads, state 128) and zamba2-7b (81 mamba2
   layers, d_model 3584, 112 SSM heads, state 64, and one shared
   attention+MLP block of 32 heads of 112 before every 6th layer, 14 call
   sites), each planned by the SEIFER planner onto a 10-node edge cluster
   into 4 stages (zamba2: each stage holds call sites and its own copy of
   the shared block), served by the monolithic ``ServeEngine`` (fast and
   reference loops), by the raw-wire ``PipelineServeEngine`` (bit-identical
   tokens, also across a stage kill) and by the int8-wire one (a kill and
   restore gives the same tokens as the run without it), and then as a
   stream of 6 staggered requests over 4 slots of the ``SlotScheduler``,
   each request's stream held against the same request served alone (see
   ``stream_phase``).  The kernel launch counters are zeroed just before
   each of these six counted runs of each model and read just after it,
   and each run must launch exactly what it runs: per prefill, flash
   attention once per attention layer (granite's 40, zamba2's 14 call
   sites) and the SSD scan once per mamba layer, quantize and dequantize
   once per stage boundary per pass in the int8-wire runs, and nothing
   else.

The last lines are the card's nvidia-smi line, a JSON line with one record
per kernel, and ``{"ok": true, "device": {...}}``; the stream phase's
numbers are on a JSON line before them.  A record's ``launches`` is the
count from the runs that go through every step of a main path (planner,
int8 wire, stage kill, restore and replay), summed over the three models;
``launches_by_path`` holds the count from each of the eighteen runs, keyed
``model/run``.
"""

from __future__ import annotations

import gc
import json
import math
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
KILL = {"after_step": 3, "stage": 1}
ARCHS = ("granite-3-2b", "mamba2-1.3b", "zamba2-7b")
# the stream phase: the serve-equivalence fixture's staggered requests
# ((8, 6), (8, 4), (12, 7), (8, 5), (12, 3), (8, 6)) at full width, as
# (prompt, generated tokens)
STREAM = ((256, 24), (256, 16), (384, 28), (256, 20), (512, 12), (256, 24))
SLOTS = 4
STREAM_TOL = 3e-2


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
        del ref
        ok = math.isfinite(err) and err <= tol[dt]
        log(f"  flash B={b} S={s} H={h} KV={kv} hd={hd} {str(dt)[6:]} "
            f"causal={causal}: max |kernel - plain| = {err:.3g} "
            f"(tol {tol[dt]:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"flash attention disagrees with its plain "
                             f"version: {err} > {tol[dt]}")
        err_max = max(err_max, err)
        if dt == bf16 and causal and s in (PROMPT, LONG_PROMPT):
            inputs[s, hd] = (q, k, v)

    def bound_of(q, k, v):
        b, s, h, hd = q.shape
        flops = 4.0 * b * h * hd * s * (s + 1) / 2      # QK^T and PV, causal
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
        return bound(nbytes, (flops, BF16_PEAK)), flops, nbytes

    def library(q, k, v):
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        return time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))

    q, k, v = inputs[PROMPT, 64]
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
    q, k, v = inputs[LONG_PROMPT, 64]
    lk_ms = time_ms(lambda: ops._launch(q, k, v, True, LONG_PROMPT))
    ll_ms = library(q, k, v)
    (lb_ms, lb_by), lflops, lbytes = bound_of(q, k, v)
    log(f"  flash at a long prompt (B=1, S={LONG_PROMPT}): kernel "
        f"{lk_ms:.4f} ms ({lflops / lk_ms / 1e9:.1f} TFLOP/s), "
        f"F.scaled_dot_product_attention {ll_ms:.4f} ms, bound {lb_ms:.4f} "
        f"ms ({lb_by}; {lflops / 1e9:.2f} GFLOP, {lbytes / 1e6:.2f} MB)")
    zq, zk, zv = inputs[PROMPT, 112]
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
                               "bound_ms": zb_ms, "bound_by": zb_by}}


def check_quantize(torch, gen):
    from repro_torch.kernels.quantize import ops, ref
    cases = [((BATCH * PROMPT, 2048), 1, 2048),      # the wire at prefill
             ((BATCH * PROMPT, 3584), 1, 3584),      # zamba2's wire
             ((2048, 2048), 256, 256), ((300, 520), 256, 256)]
    q_err = d_err = 0.0
    for shape, bm, bn in cases:
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(*shape, generator=gen, device="cuda").to(dt)
            rowwise = ops.rowwise_path(x, bm, bn)
            if rowwise != (bm == 1):
                raise SystemExit(f"quantize {shape} tile ({bm}, {bn}) takes "
                                 f"the {'rowwise' if rowwise else 'general'} "
                                 f"path")
            q, s = ops.quantize(x, bm, bn)
            torch.cuda.synchronize()
            qr, sr = ref.quantize_ref(x, bm, bn)
            d = ops.dequantize(q, s, bm, bn, out_dtype=dt)
            torch.cuda.synchronize()
            dr = ref.dequantize_ref(q, s, bm, bn, out_dtype=dt)
            same_q, same_s = torch.equal(q, qr), torch.equal(s, sr)
            same_d = torch.equal(d.view(torch.uint8), dr.view(torch.uint8))
            q_err = max(q_err, (q.int() - qr.int()).abs().max().item())
            d_err = max(d_err, (d.float() - dr.float()).abs().max().item())
            log(f"  quantize {shape} tile ({bm}, {bn}) {str(dt)[6:]} "
                f"({'rowwise' if rowwise else 'general'} path): q "
                f"bit-equal {same_q}, scales equal {same_s}; dequantize "
                f"bit-equal {same_d}")
            if not (same_q and same_s and same_d):
                raise SystemExit("quantize/dequantize disagree with their "
                                 "plain versions")
    # times at the wire's prefill shape: (B*S, D) rows, one scale per row
    x2 = torch.randn(BATCH * PROMPT, 2048, generator=gen,
                     device="cuda").bfloat16()
    q, s = ops.quantize(x2, 1, 2048)
    m, n = x2.shape
    qk_ms = time_ms(lambda: ops.quantize(x2, 1, 2048))
    qp_ms = time_ms(lambda: ref.quantize_ref(x2, 1, 2048))
    dk_ms = time_ms(lambda: ops.dequantize(q, s, 1, 2048))
    dp_ms = time_ms(lambda: ref.dequantize_ref(q, s, 1, 2048))
    # float32 operations per element: quantize |x|, max, x * (1/scale),
    # round, and the clip's two compares; dequantize one multiply
    qb_ms, qb_by = bound(2 * m * n + m * n + 4 * m, (6.0 * m * n, F32_PEAK))
    db_ms, db_by = bound(m * n + 4 * m + 2 * m * n, (1.0 * m * n, F32_PEAK))
    log(f"  quantize ({m}, {n}) bf16 rowwise: kernel {qk_ms:.4f} ms, plain "
        f"{qp_ms:.4f} ms, bound {qb_ms:.4f} ms ({qb_by})")
    log(f"  dequantize ({m}, {n}) -> bf16 rowwise: kernel {dk_ms:.4f} ms, "
        f"plain {dp_ms:.4f} ms, bound {db_ms:.4f} ms ({db_by})")
    common = {"route": "cuda",
              "source": "src/repro_torch/kernels/csrc/quantize.cu",
              "library_ms": None}
    return [dict(common, name="quantize",
                 replaces="src/repro/kernels/quantize/kernel.py:22",
                 max_abs_err=float(q_err), ms=qk_ms, plain_ms=qp_ms,
                 bound_ms=qb_ms, bound_by=qb_by),
            dict(common, name="dequantize",
                 replaces="src/repro/kernels/quantize/kernel.py:34",
                 max_abs_err=d_err, ms=dk_ms, plain_ms=dp_ms,
                 bound_ms=db_ms, bound_by=db_by)]


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


# ---------------------------------------------------------------------------
# phase 4: the main paths at full width
# ---------------------------------------------------------------------------

def expected_launches(cfg, n_stages, path):
    """Launches of every kernel in one counted run: per prefill, flash
    attention once per attention layer (granite's 40 layers, zamba2's 14
    call sites of its shared block) and the SSD scan once per mamba layer
    (a run with a kill prefills again in its replay; the stream run once
    per request), the wire kernels once per stage boundary per pass on the
    int8 wire (a replay repeats the prefill and the decode steps before the
    kill)."""
    from repro_torch import kernels
    from repro_torch.models.model import hybrid_apps
    want = dict.fromkeys(kernels.WRAPPERS, 0)
    kill = path.endswith("_kill")
    prefills = len(STREAM) if path == "stream" else 2 if kill else 1
    if cfg.family == "dense":
        want["flash_attention"] = cfg.n_layers * prefills
    else:
        want["ssd"] = cfg.n_layers * prefills
        want["flash_attention"] = (hybrid_apps(cfg, 0, cfg.n_layers)[1]
                                   * prefills)
    if "int8" in path:
        passes = GEN + (1 + KILL["after_step"] if kill else 0)
        want["quantize"] = want["dequantize"] = (n_stages - 1) * passes
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


def stream_phase(torch, cfg, params, timed, counted):
    """Continuous batching: STREAM requests over SLOTS slots, each stream
    held against the same request served alone, teacher-forced on the
    stream's own tokens: the solo run's logits at every step against the
    stream's (recorded as the scheduler's decode steps return them) within
    STREAM_TOL (1 + |solo|) — or, for a model whose bf16 solo run is itself
    further than STREAM_TOL from the same run in float32 (its bf16 rounding
    noise), the stream no further from the float32 run than twice the solo
    run is.  Tokens: the stream's equal to the solo argmax wherever the
    solo top-1/top-2 gap is above twice the logits' difference (a flip
    needs less), and to the per-request reference loop's up to the first
    step whose gap is not above the larger of that and STREAM_TOL.  Every
    flip is logged with its gap."""
    import numpy as np
    from repro_torch._tree import tree_map
    from repro_torch.models import decode_step, init_serve_cache, prefill
    from repro_torch.serve import scheduler
    from repro_torch.serve.engine import ServeEngine, make_batch

    eng = ServeEngine(cfg, params, max_len=PROMPT + GEN, kv_block=32)
    sched = scheduler.SlotScheduler(eng, SLOTS)
    reqs = [scheduler.Request(i, make_batch(cfg, 1, pl, seed=1000 + i)[
        "tokens"], gl) for i, (pl, gl) in enumerate(STREAM)]
    sched.run(reqs[:1])                                   # warm-up
    (streams, stats), wall = timed(lambda: counted(
        "stream", lambda: sched.run(reqs)))
    n_tok = sum(len(t) for t in streams)
    (ref_streams, _), ref_wall = timed(lambda: sched.run(
        reqs, engine="reference"))
    log(f"  stream of {len(reqs)} requests (prompt, gen) {STREAM} over "
        f"{SLOTS} slots: {n_tok} tokens in {wall:.3f}s ({n_tok / wall:.1f} "
        f"tok/s), {stats['decode_steps']} decode steps, slot utilisation "
        f"{stats['slot_utilization']:.3f}; the requests served alone "
        f"(reference loop) {ref_wall:.3f}s ({n_tok / ref_wall:.1f} tok/s)")

    # the same run again, recording each batched step's logits
    recorded, decode = [], scheduler.decode_step

    def recording(*args, **kw):
        logits, cache = decode(*args, **kw)
        recorded.append(logits[:, 0])
        return logits, cache

    scheduler.decode_step = recording
    try:
        again, _ = sched.run(reqs)
    finally:
        scheduler.decode_step = decode
    maps = stream_schedule(reqs, SLOTS)
    if len(maps) != stats["decode_steps"] or len(recorded) != len(maps) \
            or any((a != b).any() for a, b in zip(again, streams)):
        raise SystemExit("the stream's schedule or tokens changed between "
                         "two runs")

    @torch.inference_mode()
    def solo_run(cfg_, params_, r, toks):
        """One request alone, fed the stream's tokens: (gen_len, V)."""
        cache = init_serve_cache(cfg_, 1, eng.max_len, device="cuda")
        logits, cache = prefill(cfg_, params_, {"tokens": torch.as_tensor(
            r.tokens, device="cuda")}, cache)
        out = [logits[0, 0].float()]
        for j in range(1, r.gen_len):
            fed = torch.tensor([[int(toks[j - 1])]], dtype=torch.int32,
                               device="cuda")
            logits, cache = decode_step(cfg_, params_, fed, cache)
            out.append(logits[0, 0].float())
        return torch.stack(out)

    cfg32 = cfg.replace(param_dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    worst = {"stream-solo": 0.0, "solo-f32": 0.0, "stream-f32": 0.0}
    bad, n_flips = [], 0
    for r, toks, ref in zip(reqs, streams, ref_streams):
        steps = torch.stack([recorded[i][slot] for i, m in enumerate(maps)
                             for slot, rid in m.items() if rid == r.rid])
        solo = solo_run(cfg, params, r, toks)
        exact = solo_run(cfg32, params32, r, toks)[1:]
        d = (steps - solo[1:]).abs().max().item()
        e = (solo[1:] - exact).abs().max().item()
        s = (steps - exact).abs().max().item()
        for k, v in zip(worst, (d, e, s)):
            worst[k] = max(worst[k], v)
        within = bool(((steps - solo[1:]).abs()
                       <= STREAM_TOL * (1 + solo[1:].abs())).all())
        if not (within or (e > STREAM_TOL and s <= 2 * e)):
            bad.append(f"request {r.rid}: stream off solo by {d:.4g}, "
                       f"solo off float32 by {e:.4g}, stream off float32 "
                       f"by {s:.4g}")
        top2 = solo.topk(2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        argmax = solo.argmax(-1).cpu().numpy()
        for j in np.nonzero(toks != argmax)[0]:
            n_flips += 1
            log(f"    flip: request {r.rid} step {j}: stream token "
                f"{toks[j]}, solo {argmax[j]}, solo top-1/top-2 gap "
                f"{gap[j]:.4g} (logits differ by up to {d:.4g})")
            if gap[j] > 2 * d:
                bad.append(f"request {r.rid} step {j} flipped at gap "
                           f"{gap[j]:.4g} > 2 x {d:.4g}")
        low = np.nonzero(gap <= max(STREAM_TOL, 2 * d))[0]
        upto = low[0] if len(low) else r.gen_len
        if (toks[:upto] != ref[:upto]).any():
            bad.append(f"request {r.rid}: differs from the reference loop "
                       f"before step {upto}")
    del params32
    log(f"  stream vs each request alone (teacher-forced, max over the "
        f"requests): |stream - solo| {worst['stream-solo']:.4g} (tol "
        f"{STREAM_TOL:g} (1 + |solo|)); the float32 run's distance from the "
        f"solo run {worst['solo-f32']:.4g} and from the stream "
        f"{worst['stream-f32']:.4g}; {n_flips} token flip(s)")
    if bad:
        raise SystemExit(f"[{cfg.name}/stream] " + "; ".join(bad))
    return {"wall_s": wall, "reference_wall_s": ref_wall, "tokens": n_tok,
            "decode_steps": stats["decode_steps"],
            "slot_utilization": stats["slot_utilization"],
            "max_logit_diff": worst["stream-solo"],
            "solo_vs_float32": worst["solo-f32"],
            "stream_vs_float32": worst["stream-f32"], "flips": n_flips}


def main_path(torch, tmp, cfg):
    from repro_torch import kernels
    from repro_torch._tree import tree_leaves
    from repro_torch.core import (lm_block_graph, partition_and_place,
                                  random_geometric_cluster)
    from repro_torch.models import init_params
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.model import hybrid_apps
    from repro_torch.serve.engine import ServeEngine, make_batch
    from repro_torch.serve.pipeline import PipelineServeEngine

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params, dt = timed(lambda: init_params(cfg, gen, device="cuda"))
    n_par = sum(t.numel() for t in tree_leaves(params))
    ssm = (f"{cfg.ssm_heads} SSM heads of {cfg.ssm_head_dim}, state "
           f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}")
    attn = (f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv of "
            f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}")
    mixer = {"dense": attn, "ssm": ssm,
             "hybrid": f"{ssm}; one shared block of {attn} at "
                       f"{hybrid_apps(cfg, 0, cfg.n_layers)[1]} call sites, "
                       f"every {cfg.hybrid_attn_every} layers"}[cfg.family]
    log(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{mixer}, vocab {cfg.vocab}: {n_par / 1e9:.3f} B params "
        f"({2 * n_par / 1e9:.2f} GB bf16) initialised in {dt:.1f}s")

    graph = lm_block_graph(cfg, ShapeConfig("serve", PROMPT, BATCH,
                                            "prefill"))
    cluster = random_geometric_cluster(10, rng=7)
    pts = graph.candidate_partition_points()
    segs = graph.segment_layers(pts)
    min_cap = max(graph.run_memory_bytes(pts, segs, i, i)
                  for i in range(len(pts)))
    cap = max(graph.total_param_bytes() / 3.5, min_cap * 1.2)
    plan = partition_and_place(graph, cluster, cap, n_classes=3, rng=8)
    ep_raw = plan.execution_plan(cluster, wire_bits=0, arch=cfg.name)
    ep_int8 = plan.execution_plan(cluster, wire_bits=8, arch=cfg.name)
    log(plan.describe())
    log(ep_int8.describe())
    ranges = ep_raw.block_ranges(cfg.n_layers)
    log(f"  stage block ranges: {ranges}")
    if len(ranges) != 4:
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

    batch = make_batch(cfg, BATCH, PROMPT, seed=0)
    max_len = PROMPT + GEN
    by_path = {}          # run -> {kernel: launches in that run alone}

    def counted(path, fn):
        kernels.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        by_path[path] = kernels.launch_counts()
        log(f"  [{path}] kernel launches: {by_path[path]}")
        return out

    mono = ServeEngine(cfg, params, max_len=max_len, kv_block=32)
    mono.generate(batch, 2)                               # warm-up
    toks_mono, gen_s = timed(lambda: counted(
        "monolithic", lambda: mono.generate(batch, GEN)))
    (_, logits), pre_s = timed(lambda: mono.generate(
        batch, 1, collect_logits=True))                   # prefill only
    if logits.shape != (BATCH, 1, cfg.vocab) or not \
            bool(torch.isfinite(torch.from_numpy(logits)).all()):
        raise SystemExit(f"prefill logits {logits.shape} not finite")
    log(f"  ServeEngine: prefill (B={BATCH}, S={PROMPT}) {pre_s * 1e3:.1f} "
        f"ms; generate {GEN} tokens {gen_s:.3f}s, decode "
        f"{(gen_s - pre_s) / (GEN - 1) * 1e3:.2f} ms/step")
    toks_ref, ref_s = timed(lambda: mono.generate(
        batch, GEN, engine="reference"))
    same = bool((toks_ref == toks_mono).all())
    log(f"  ServeEngine reference loop {ref_s:.3f}s: tokens equal to the "
        f"fast loop: {same}")
    log(f"  tokens row 0: {toks_mono[0].tolist()}")
    if not same:
        raise SystemExit("fast and reference loops disagree")

    free = shutil.disk_usage(tmp).free
    log(f"  stage checkpoints go to a temporary directory "
        f"({free / 1e9:.1f} GB free there)")
    raw, ck_s = timed(lambda: PipelineServeEngine(
        cfg, params, ep_raw, max_len=max_len, kv_block=32,
        ckpt_dir=Path(tmp) / "raw", cluster=cluster))
    log(f"  raw-wire pipeline: {raw.n_stages} stages on nodes "
        f"{raw.node_of_stage}; checkpointing the stages took {ck_s:.1f}s")
    toks_raw, raw_s = timed(lambda: counted(
        "pipeline_raw", lambda: raw.generate(batch, GEN)))
    same = bool((toks_raw == toks_mono).all())
    log(f"  raw-wire pipeline generate {raw_s:.3f}s: bit-identical to "
        f"ServeEngine: {same}")
    if not same:
        raise SystemExit("raw-wire pipeline tokens differ from ServeEngine")
    toks_rk, rk_s = timed(lambda: counted(
        "pipeline_raw_kill", lambda: raw.generate(
            batch, GEN, kill=KILL)))
    same = bool((toks_rk == toks_mono).all())
    log(f"  raw-wire pipeline with stage 1 killed after step 3: "
        f"{rk_s:.3f}s, bit-identical to ServeEngine: {same}")
    for t, msg in raw.events:
        log(f"    t={t:7.2f}s  {msg}")
    if not same:
        raise SystemExit("raw-wire kill/restore changed the tokens")
    del raw
    shutil.rmtree(Path(tmp) / "raw", ignore_errors=True)

    i8, ck_s = timed(lambda: PipelineServeEngine(
        cfg, params, ep_int8, max_len=max_len, kv_block=32,
        ckpt_dir=Path(tmp) / "int8", cluster=cluster))
    log(f"  int8-wire pipeline: checkpointing the stages took {ck_s:.1f}s")
    toks_i8, i8_s = timed(lambda: counted(
        "pipeline_int8", lambda: i8.generate(batch, GEN)))
    toks_i8k, i8k_s = timed(lambda: counted(
        "pipeline_int8_kill", lambda: i8.generate(
            batch, GEN, kill=KILL)))
    same = bool((toks_i8k == toks_i8).all())
    agree = float((toks_i8 == toks_mono).mean())
    log(f"  int8-wire pipeline {i8_s:.3f}s, with stage 1 killed after step "
        f"3 {i8k_s:.3f}s: identical streams: {same}; share of tokens equal "
        f"to the raw wire's: {agree:.3f}")
    for t, msg in i8.events:
        log(f"    t={t:7.2f}s  {msg}")
    if not same:
        raise SystemExit("int8-wire kill/restore changed the tokens")
    if not any("restored from checkpoint" in m for _, m in i8.events):
        raise SystemExit("the int8-wire kill logged no restore")
    del i8
    shutil.rmtree(Path(tmp) / "int8", ignore_errors=True)
    stream = stream_phase(torch, cfg, params, timed, counted)
    for path, got in by_path.items():
        want = expected_launches(cfg, len(ranges), path)
        if got != want:
            raise SystemExit(f"[{cfg.name}/{path}] launched {got}, "
                             f"expected {want}")
    return by_path, stream


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    log("== 1. device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"  nvidia-smi: {smi}")
    log(f"  torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"{kind}, {count} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("== 2. build")
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"  nvcc {' '.join(_build.NVCC_FLAGS)}: "
        + ", ".join(f"{n}.cu {s:.1f}s" for n, s in secs.items())
        + f"; {time.perf_counter() - t0:.1f}s wall")

    log("== 3. kernels against their plain versions")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    records = [check_flash(torch, gen), *check_quantize(torch, gen),
               check_ssd(torch, gen)]

    log("== 4. main paths at full width")
    by_path, streams = {}, {}
    for arch in ARCHS:
        log(f"-- {arch}")
        with tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
            counts, streams[arch] = main_path(torch, tmp,
                                              get_config(arch, "full"))
        for path, got in counts.items():
            by_path[f"{arch}/{path}"] = got
        gc.collect()                  # this model's weights and caches
        torch.cuda.empty_cache()
    for r in records:
        r["launches"] = sum(by_path[f"{a}/pipeline_int8_kill"][r["name"]]
                            for a in ARCHS)
        r["launches_by_path"] = {p: c[r["name"]] for p, c in by_path.items()}
    log(f"== done in {time.perf_counter() - t_start:.1f}s")
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms",
            "long_prompt", "zamba2_prefill")   # flash's and the SSD scan's
    log(json.dumps({"streams": streams}))
    print(smi)
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in records]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
