"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Prefill + greedy decode of a batch of synthetic requests through the
monolithic ``ServeEngine``, or with ``--cuts C1,C2,...`` through the
``PipelineServeEngine`` over those block cuts (``--wire-bits 8`` sends
stage boundaries as rowwise int8; ``--overlap`` runs the overlapped
executor with ``--micro-batches`` in flight, ``--devices`` places the
stages: ``auto`` round-robins them over the visible cards, or a
comma-separated device list).  The ``--cuts`` path prints its mode, the
stages' devices, the micro-batches in flight and the decode-only tok/s of
``timed_decode``.  ``--stream N`` serves N requests (each
``--prompt-len`` tokens long, ``--gen-len`` tokens to generate) through
the continuous-batching ``SlotScheduler`` over ``--batch`` slots instead
of one synchronized batch, through the pipeline engine under ``--cuts``.
Every request of the VLM (llama-3.2-vision-90b) and the encoder-decoder
(whisper-large-v3) brings its side input from ``make_batch``: vision
embeddings, or the ``FRAMES`` frame embeddings of whisper's 30-second
window (where the reference's launcher makes them as long as the prompt).
Runs on the card unless ``--device cpu``.

The flags are those of ``repro/launch/serve.py``'s monolithic, ``--stream``
and ``--cuts`` paths (``--overlap``, ``--micro-batches``, ``--devices``
among them) and its ``--plan`` (the SEIFER stage plan of the full config
for the 2-pod production cluster, printed on the host), plus three:
``--wire-bits``, since the reference launcher never reaches the int8 wire
that the served pipeline sends (the paper's lambda compression),
``--profile``, which traces one prefill-only run and one full run with
``torch.profiler`` and prints the device busy time, the kernel launches
and the kernels that took the most device time, and
``--layers``, which cuts the depth (llama3-405b's 126 layers are about 810
GB in bf16; ``chip_smoke.py`` serves 4 of them, 2 of deepseek-v3-671b's 61
and of llama4-maverick-400b-a17b's 48).  A MoE model's cut depth and
``--cuts`` fall on its groups (llama4: an even count); its ``--stream``
couples the slots' rows through expert capacity, as the reference's does
(``serve/scheduler.py``).

Timing: the first generate is a warm-up (it builds the kernels on first
use, and captures the fused chain's graphs) and is reported separately;
every reported time ends in ``torch.cuda.synchronize()`` on the card,
since PyTorch returns before the device finishes.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import init_params
from repro_torch.serve.engine import ServeEngine, make_batch

# the encoder-decoder's frames: whisper's 30-second window after its conv
# stem (arXiv:2212.04356), whatever the prompt's length
FRAMES = 1500


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device):
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--engine", default="fast",
                    choices=["fast", "reference"])
    ap.add_argument("--stream", type=int, default=0, metavar="N",
                    help="serve N staggered requests via continuous "
                         "batching over --batch slots instead of one "
                         "synchronized batch")
    ap.add_argument("--plan", action="store_true",
                    help="print the SEIFER pipeline-stage plan of the full "
                         "config for the 2-pod production cluster (host "
                         "only: no card needed)")
    ap.add_argument("--cuts", default="", metavar="C1,C2",
                    help="serve through PipelineServeEngine over these "
                         "block cuts (e.g. 10,20,30)")
    ap.add_argument("--overlap", action="store_true",
                    help="overlapped pipeline executor: micro-batches on "
                         "the skewed schedule, the fused chain (a CUDA "
                         "graph a micro-batch on the card) on one device "
                         "(needs --cuts)")
    ap.add_argument("--micro-batches", type=int, default=None,
                    help="micro-batches in flight under --overlap "
                         "(default: the stage count across devices, else 1)")
    ap.add_argument("--devices", default=None,
                    help="per-stage placement under --cuts: 'auto' "
                         "round-robins the stages over the visible cards, "
                         "or a comma-separated device list (cpu,cpu,...)")
    ap.add_argument("--wire-bits", type=int, default=0, choices=[0, 8],
                    help="stage-boundary wire format under --cuts: 0 = raw, "
                         "8 = rowwise int8")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' to run on the "
                         "CPU)")
    ap.add_argument("--layers", type=int, default=0, metavar="N",
                    help="serve the first N layers only (a cut depth, for "
                         "a model whose weights do not fit one card: "
                         "llama3-405b 4, llama-3.2-vision-90b 10, "
                         "deepseek-v3-671b 2, llama4-maverick-400b-a17b 2; "
                         "a multiple of the VLM's or MoE model's group)")
    ap.add_argument("--profile", action="store_true",
                    help="after the timed run, trace a prefill-only run and "
                         "a full run with torch.profiler and print device "
                         "busy time, kernel launches and the top kernels")
    args = ap.parse_args(argv)
    if (args.overlap or args.micro_batches or args.devices) and not args.cuts:
        ap.error("--overlap, --micro-batches and --devices need --cuts")
    if args.plan:
        from repro_torch.core.cluster import tpu_cluster
        from repro_torch.core.pipeline import plan_stages
        from repro_torch.models.config import SHAPES
        full = get_config(args.arch, "full")
        sp = plan_stages(full, SHAPES["prefill_32k"],
                         cluster=tpu_cluster(n_pods=2, slots_per_pod=8),
                         hbm_per_stage_bytes=16e9 * 32)
        print(sp.describe())
        return

    device = resolve_device(args.device)
    cfg = get_config(args.arch, args.preset)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    rng = torch.Generator(device=device)
    rng.manual_seed(0)
    params = init_params(cfg, rng, device=device)
    b, pl, gl = args.batch, args.prompt_len, args.gen_len

    if args.cuts:
        from repro_torch.core.stageplan import from_block_cuts
        from repro_torch.serve.pipeline import PipelineServeEngine
        cuts = [int(c) for c in args.cuts.split(",")]
        devices = args.devices
        if devices and devices != "auto":
            devices = devices.split(",")
        eng = PipelineServeEngine(
            cfg, params, from_block_cuts(cfg, cuts, wire_bits=args.wire_bits),
            max_len=pl + gl, kv_block=32, overlap=args.overlap,
            micro_batches=args.micro_batches, devices=devices)
        placed = ("one device" if eng.devices is None else
                  ",".join(str(d) for d in eng.devices))
        label = (f"pipeline-{'overlap' if args.overlap else 'sequential'}-"
                 f"{'int8' if args.wire_bits else 'raw'}, {len(cuts) + 1} "
                 f"stages on {placed}, {eng._resolve_micro(b)} "
                 "micro-batch(es) in flight")
    else:
        eng = ServeEngine(cfg, params, max_len=pl + gl, kv_block=32)
        label = args.engine

    if args.stream:
        from repro_torch.serve.scheduler import Request, SlotScheduler
        sched = SlotScheduler(eng, slots=b)
        reqs = []
        for i in range(args.stream):
            one = make_batch(cfg, 1, pl, seed=1000 + i, frames_len=FRAMES)
            reqs.append(Request(i, one.pop("tokens"), gl, extras=one))
        def run():
            return sched.run(reqs, engine=args.engine)
        _, warm_s = _timed(run, device)
        (streams, stats), dt = _timed(run, device)
        total = sum(len(t) for t in streams)
        what = (f"stream-{args.engine}" if not args.cuts
                else f"stream-{args.engine}, {label}")
        print(f"[serve/{what}] {cfg.name} on {device}: "
              f"{args.stream} requests x {gl} tokens over {b} slots: "
              f"{total} tokens in {dt:.3f}s ({total / dt:.1f} tok/s; "
              f"{stats['decode_steps']} decode steps, slot utilisation "
              f"{stats['slot_utilization']:.1%}; warm-up {warm_s:.2f}s, "
              f"excluded); sample: {streams[0][:8].tolist()}")
        if args.profile:
            _profile(what, run, device)
        return streams

    batch = make_batch(cfg, b, pl, seed=0, frames_len=FRAMES)
    if args.cuts:
        def run(n):
            return eng.generate(batch, n)
    else:
        def run(n):
            return eng.generate(batch, n, engine=args.engine)
    _, warm_s = _timed(lambda: run(gl), device)
    toks, dt = _timed(lambda: run(gl), device)
    decode = ""
    if args.cuts:
        decode_s = eng.timed_decode(batch, gl - 1)
        decode = f"; decode-only {b * (gl - 1) / decode_s:.1f} tok/s"
    print(f"[serve/{label}] {cfg.name} on {device}: {b * gl} tokens "
          f"(batch {b}, prompt {pl}) in {dt:.3f}s "
          f"({b * gl / dt:.1f} tok/s{decode}; warm-up {warm_s:.2f}s, "
          f"excluded); sample: {toks[0, :8].tolist()}")
    if args.profile:
        for what, n in (("prefill only", 1), (f"{gl} tokens", gl)):
            _profile(f"{label}, {what}", lambda: run(n), device)
    return toks


def _profile(label, fn, device, top=10):
    """One traced run: wall time, device busy time (the sum of kernel
    times; kernels on one stream do not overlap), kernel launches, and the
    kernels that took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        _, wall = _timed(fn, device)
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    launches = sum(e.count for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:top]
    print(f"[profile/{label}] wall {wall * 1e3:.2f} ms (traced), device "
          f"busy {busy * 1e3:.2f} ms ({busy / wall:.1%}), {launches} kernel "
          f"launches")
    for e in top:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x"
              f"  {e.key[:90]}")


if __name__ == "__main__":
    main()
