"""MoE streams through the port's ``SlotScheduler`` against the
reference's, on the CPU: deepseek-v3-671b (MLA) and llama4-maverick-400b-
a17b at their smoke sizes.

Expert capacity couples the rows of a MoE batch, idle slots' rows
included, so a MoE stream is held to the reference's stream of the same
requests (never to its requests served alone), and the idle slots must
step as the reference's do.  The schedule here (3 slots, ``max_len`` 16,
buckets of 8) leaves slot 0 idle from its first decode step while slot 1
decodes 13 more: slot 0's length reaches 22, so its last decode writes
fall past the cache, and its reads run past the bucket of the active
rows.  What the reference does there is pinned first: its decode write
``cache.at[rows, lens].set(...)`` drops an update out of bounds (it does
not clamp it), and a row reads the keys of its cache's slice to the
bucket.

* float32: the streams equal the reference's token for token (the
  smallest router margin seen is printed; float32 noise is about 5e-6).
* bfloat16: the gap contract of ``ROADMAP.md``, over the coupled batch:
  the streams equal the reference's up to the first decode step at which
  some row's (active or idle) top-1/top-2 gap in the reference's logits is
  within twice the larger of 3e-2 and that step's largest logit
  difference; every flip is printed with its gap.
* The raw-wire pipelined stream equals the monolithic one, and the serve
  launcher streams both models.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.models.layers import _batched_update as jax_batched_update
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.scheduler import Request as JaxRequest
from repro.serve.scheduler import SlotScheduler as JaxSlotScheduler
from repro_torch.configs import get_config
from repro_torch.core.stageplan import from_block_cuts
from repro_torch.kernels.decode import ref as decode_ref
from repro_torch.launch import serve as launch_serve
from repro_torch.models import init_params, layers
from repro_torch.models.bridge import params_from_jax
from repro_torch.serve import scheduler as port_scheduler
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.pipeline import PipelineServeEngine
from repro_torch.serve.scheduler import Request, SlotScheduler

torch.set_num_threads(2)

DEEPSEEK, LLAMA4 = "deepseek-v3-671b", "llama4-maverick-400b-a17b"
ARCHS = [DEEPSEEK, LLAMA4]
CUTS = {DEEPSEEK: [1], LLAMA4: [2]}        # group boundaries
MAX_LEN, KV_BLOCK, SLOTS = 16, 8, 3
SHAPES = [(8, 2), (2, 15), (2, 4)]         # (prompt, gen) a request
TOL = 3e-2


def margin(probs, k):
    top = -np.sort(-np.asarray(probs, np.float64), axis=-1)
    return top[:, k - 1] - top[:, k]


def prompts(seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (1, p)).astype(np.int32)
            for p, _ in SHAPES]


def jax_stream(jcfg, jp):
    """The reference's stream and each decode step's logits (B, V)."""
    eng = JaxServeEngine(jcfg, jp, max_len=MAX_LEN, kv_block=KV_BLOCK)
    logits, decode = [], eng._decode_quiet

    def recording(toks, cache, bucket):
        out = decode(toks, cache, bucket)
        logits.append(np.asarray(out[1], np.float32)[:, 0])
        return out

    eng._decode_quiet = recording
    streams, stats = JaxSlotScheduler(eng, SLOTS).run(
        [JaxRequest(i, t, g) for i, (t, (_, g))
         in enumerate(zip(prompts(), SHAPES))])
    return streams, logits, stats


def port_stream(eng):
    """The port's stream, each decode step's logits and the smallest
    router margin of its routings."""
    logits, seen = [], []
    decode, route = port_scheduler.decode_step, layers._route

    def recording(*args, **kw):
        out, cache = decode(*args, **kw)
        logits.append(out[:, 0].float().numpy().copy())
        return out, cache

    def routing(params, xf, k):
        out = route(params, xf, k)
        seen.append(float(margin(out[0].float().numpy(), k).min()))
        return out

    port_scheduler.decode_step, layers._route = recording, routing
    try:
        streams, stats = SlotScheduler(eng, SLOTS).run(
            [Request(i, t, g) for i, (t, (_, g))
             in enumerate(zip(prompts(), SHAPES))])
    finally:
        port_scheduler.decode_step, layers._route = decode, route
    return streams, logits, stats, min(seen)


@functools.cache
def reference_params(arch, dtype):
    """The reference's params of an arch's smoke config.  Its ``ninit``
    draws float32 and casts, so its bfloat16 tree is the float32 tree cast
    leaf by leaf, bit for bit, but for the router, float32 in both (one
    draw instead of two: the draws dominate this file's time)."""
    if dtype == "bfloat16":
        return _cast_bf16(reference_params(arch, "float32"))
    jcfg = jax_get_config(arch, "smoke").replace(param_dtype=dtype)
    with jax.threefry_partitionable(False):
        return jax_init_params(jcfg, jax.random.PRNGKey(0))


def _cast_bf16(tree):
    return {k: (_cast_bf16(v) if isinstance(v, dict) else
                v if k == "router" else v.astype(jnp.bfloat16))
            for k, v in tree.items()}


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def streams(request):
    """Both packages' streams of one arch and dtype, from the reference's
    params."""
    arch, dtype = request.param
    jcfg = jax_get_config(arch, "smoke").replace(param_dtype=dtype)
    cfg = get_config(arch, "smoke").replace(param_dtype=dtype)
    jp = reference_params(arch, dtype)
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    eng = ServeEngine(cfg, params, max_len=MAX_LEN, kv_block=KV_BLOCK)
    return arch, dtype, jax_stream(jcfg, jp), port_stream(eng)


def idle_slot_lengths(n_steps):
    """Slot 0's length after each decode step: its request leaves after
    the first, and it idles on."""
    return [SHAPES[0][0] + i + 1 for i in range(n_steps)]


def test_reference_drops_a_decode_write_past_the_cache():
    """The reference's decode write at a length past the cache changes
    nothing (an out-of-bounds scatter is dropped, not clamped to the last
    row), and the port's ``_batched_update`` writes the same caches, row
    by row, for lengths inside and past the cache."""
    cache = np.arange(3 * 4 * 2 * 2, dtype=np.float32).reshape(3, 4, 2, 2)
    new = -np.ones((3, 1, 2, 2), np.float32)
    lens = np.array([1, 4, 9], np.int32)
    want = np.asarray(jax_batched_update(jnp.asarray(cache), jnp.asarray(new),
                                         jnp.asarray(lens)))
    assert (want[1:] == cache[1:]).all() and (want[0, 1] == -1).all()
    got = torch.from_numpy(cache.copy())
    layers._batched_update(((got, torch.from_numpy(new)),),
                           torch.from_numpy(lens), None)
    np.testing.assert_array_equal(got.numpy(), want)


def test_decode_attention_past_its_keys_reads_them_all():
    """A row whose length passes the keys it is given (an idle slot past
    the bucket, or past the cache) attends to all of them: the reference's
    mask over its slice of the cache."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=gen) for s in
               ((2, 1, 4, 8), (2, 6, 2, 8), (2, 6, 2, 8)))
    past = decode_ref.decode_attention_ref(q, k, v, torch.tensor([9, 40]))
    whole = decode_ref.decode_attention_ref(q, k, v, torch.tensor([6, 6]))
    assert torch.equal(past, whole)


def test_the_schedule_idles_a_slot_past_max_len(streams):
    _, _, (_, jlog, jstats), (_, plog, pstats, _) = streams
    n = pstats["decode_steps"]
    assert n == jstats["decode_steps"] == 14 == len(jlog) == len(plog)
    lens = idle_slot_lengths(n)
    assert lens[-1] == 22 > MAX_LEN
    # slot 1's length + 1 sets the bucket; slot 0 runs past it
    assert any(ln + 1 > -(-(SHAPES[1][0] + i + 1) // KV_BLOCK) * KV_BLOCK
               for i, ln in enumerate(lens))


def first_near_tie(jlog, plog):
    """The first decode step at which some row's reference gap is within
    twice the larger of TOL and the step's largest logit difference, and
    that threshold (None: no such step)."""
    for i, (a, b) in enumerate(zip(jlog, plog)):
        top = -np.sort(-a, axis=-1)
        thr = 2 * max(TOL, float(np.abs(a - b).max()))
        if ((top[:, 0] - top[:, 1]) <= thr).any():
            return i, thr
    return None, None


def test_stream_against_the_reference(streams):
    """float32: token for token.  bfloat16: the gap contract over the
    coupled batch, every flip printed with its gap."""
    arch, dtype, (jst, jlog, _), (pst, plog, _, low) = streams
    print(f"{arch} {dtype}: smallest router margin {low:.3g}")
    if dtype == "float32":
        for a, b in zip(jst, pst):
            np.testing.assert_array_equal(a, b)
        return
    stop, thr = first_near_tie(jlog, plog)
    for i, (a, b) in enumerate(zip(jlog, plog)):
        top = -np.sort(-a, axis=-1)
        for row in np.flatnonzero(a.argmax(-1) != b.argmax(-1)):
            print(f"{arch} step {i} row {row}: flip at a reference gap of "
                  f"{top[row, 0] - top[row, 1]:.4g}")
        if stop is None or i < stop:
            assert (a.argmax(-1) == b.argmax(-1)).all(), (arch, i)
    print(f"{arch}: first near tie at step {stop} (threshold {thr})")
    # each request's first token comes from its prefill, alone
    assert [s[0] for s in jst] == [s[0] for s in pst]


@pytest.mark.parametrize("arch", ARCHS)
def test_raw_pipelined_stream_equals_the_monolithic_one(arch):
    cfg = get_config(arch, "smoke")
    params = init_params(cfg, device="cpu")
    reqs = [Request(i, t, g) for i, (t, (_, g))
            in enumerate(zip(prompts(), SHAPES))]
    mono, _ = SlotScheduler(ServeEngine(cfg, params, max_len=MAX_LEN,
                                        kv_block=KV_BLOCK), SLOTS).run(reqs)
    pipe = PipelineServeEngine(cfg, params, from_block_cuts(cfg, CUTS[arch]),
                               max_len=MAX_LEN, kv_block=KV_BLOCK)
    piped, stats = SlotScheduler(pipe, SLOTS).run(reqs)
    assert stats["decode_steps"] == 14
    for a, b in zip(mono, piped):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_streams_the_moe_family(arch, capsys):
    args = ["--arch", arch, "--device", "cpu", "--batch", "2",
            "--prompt-len", "6", "--gen-len", "4", "--stream", "3"]
    fast = launch_serve.main(args)
    out = capsys.readouterr().out
    assert "3 requests x 4 tokens over 2 slots: 12 tokens" in out
    piped = launch_serve.main(args + ["--cuts", ",".join(map(str,
                                                              CUTS[arch]))])
    for a, b in zip(fast, piped):
        np.testing.assert_array_equal(a, b)
