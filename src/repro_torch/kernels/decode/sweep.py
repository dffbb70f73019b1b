"""Time the decode kernels' plans on the card, cold.

    PYTHONPATH=src python -m repro_torch.kernels.decode.sweep

For each (K, N) weight of the main paths it times ``rows_matmul`` under
every column tile of ``ops.TILES`` and a ladder of K-slice counts, marks
the plan ``ops.rows_plan`` picks, and times ``x @ w`` beside it; then
``decode_attention`` at granite's, zamba2's and llama3-405b's caches
beside the masked ``F.scaled_dot_product_attention``.  Every time is the
mean of one CUDA graph's calls, each reading its own copy of the weight or
cache (copies enough to pass 100 MB, twice the L2), so that no call finds
its bytes in L2; the warm time (one copy) is printed beside.  Rows of x:
M = 4, the served batch.  Needs a card; prints the card's name and power
limit first.
"""

from __future__ import annotations

import itertools
import subprocess

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.decode import ops

COLD_BYTES = 100e6
HBM_BW = 3.35e12
M = 4
WEIGHTS = {"granite wq": (2048, 2048), "granite wk": (2048, 512),
           "granite wg": (2048, 8192), "granite wd": (8192, 2048),
           "mamba2 in_proj": (2048, 8512), "mamba2 out_proj": (4096, 2048),
           "zamba2 in_proj": (3584, 14576), "llama3 wk": (16384, 1024),
           "llama3 wg": (16384, 53248)}
SPLITS = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 24, 32, 48)


def graph_ms(fn, iters):
    """Device ms a call: ``iters`` calls of ``fn`` in one CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
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


def copies_for(nbytes):
    """Copies of an input of ``nbytes`` that together pass COLD_BYTES."""
    return int(COLD_BYTES // nbytes) + 1


def cold_ms(fn, copies, iters=20):
    """``fn(c)`` reads copy ``c``; the graph's calls rotate over the copies
    and number at least as many, so no call finds its copy in L2."""
    turn = itertools.count()
    return graph_ms(lambda: fn(next(turn) % copies), max(iters, copies))


def sweep_rows(gen):
    sms = ops._sms(torch.cuda.current_device())
    for name, (k, n) in WEIGHTS.items():
        nbytes = 2 * k * n
        copies = copies_for(nbytes)
        ws = [(torch.randn(k, n, generator=gen, device="cuda")
               * k ** -0.5).bfloat16() for _ in range(copies)]
        x = torch.randn(M, k, generator=gen, device="cuda").bfloat16()
        chosen = ops.rows_plan(k, n, 2, sms)
        lib = cold_ms(lambda c: x @ ws[c], copies)
        print(f"{name} K={k} N={n} ({nbytes / 1e6:.1f} MB, {copies} copies,"
              f" bound {nbytes / HBM_BW * 1e3:.4f} ms): x @ w cold "
              f"{lib:.4f} ms, warm {graph_ms(lambda: x @ ws[0], 20):.4f}; "
              f"the plan {chosen}", flush=True)
        saved, best = ops.rows_plan, None
        try:
            for tn in ops.TILES:
                seen = set()
                for want in SPLITS:
                    ks = -(-(-(-k // want)) // ops.SLICE) * ops.SLICE
                    if ks in seen:
                        continue
                    seen.add(ks)
                    ops.rows_plan = lambda *a, _p=(tn, ks): _p
                    t = cold_ms(lambda c: ops.rows_matmul(x, ws[c]), copies)
                    splits = -(-k // ks)
                    blocks = -(-n // tn) * splits
                    mark = "  <- rows_plan" if (tn, ks) == chosen else ""
                    print(f"    tn={tn:3d} ks={ks:6d} splits={splits:3d} "
                          f"blocks={blocks:6d}: {t:.4f} ms ({lib / t:.2f}x "
                          f"x @ w){mark}", flush=True)
                    best = min(best or (t, tn, ks), (t, tn, ks))
        finally:
            ops.rows_plan = saved
        print(f"  best {name}: tn={best[1]} ks={best[2]} {best[0]:.4f} ms",
              flush=True)
        del ws
        torch.cuda.empty_cache()


def sweep_attention(gen):
    s = 544
    for name, (h, kv, hd) in (("granite", (32, 8, 64)),
                              ("zamba2", (32, 32, 112)),
                              ("llama3", (128, 8, 128))):
        for ls in ([530, 1, 300, 513], [544] * 4, [64] * 4):
            lens = torch.tensor(ls, dtype=torch.int32, device="cuda")
            nbytes = 2 * 2 * len(lens) * s * kv * hd
            copies = copies_for(nbytes)
            q = torch.randn(len(lens), 1, h, hd, generator=gen,
                            device="cuda").bfloat16()
            kvs = [tuple(torch.randn(len(lens), s, kv, hd, generator=gen,
                                     device="cuda").bfloat16()
                         for _ in range(2)) for _ in range(copies)]
            mask = (torch.arange(s, device="cuda")[None, :]
                    < lens[:, None])[:, None, None, :]
            qt = q.transpose(1, 2).contiguous()
            kvt = [tuple(t.transpose(1, 2).contiguous() for t in pair)
                   for pair in kvs]
            lib = cold_ms(lambda c: F.scaled_dot_product_attention(
                qt, *kvt[c], attn_mask=mask, enable_gqa=True), copies)
            read = 2 * 2 * int(lens.sum()) * kv * hd
            print(f"decode_attention {name} H={h} KV={kv} hd={hd} lens "
                  f"{ls} ({copies} copies; {read / 1e6:.2f} MB read, bound "
                  f"{read / HBM_BW * 1e3:.5f} ms): masked SDPA cold "
                  f"{lib:.4f} ms", flush=True)
            chosen, saved = ops.attention_cluster(kv), ops.attention_cluster
            try:
                for cl in (1, 2, 4, 8):
                    ops.attention_cluster = lambda *a, _c=cl: _c
                    t = cold_ms(lambda c: ops.decode_attention(q, *kvs[c],
                                                               lens), copies)
                    mark = "  <- attention_cluster" if cl == chosen else ""
                    print(f"    cluster {cl}: kernel cold {t:.4f} ms "
                          f"({lib / t:.2f}x SDPA){mark}", flush=True)
            finally:
                ops.attention_cluster = saved
            del kvs, kvt
            torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("sweep: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    _build.build_all(("decode",))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    with torch.inference_mode():
        sweep_attention(gen)
        sweep_rows(gen)


if __name__ == "__main__":
    main()
