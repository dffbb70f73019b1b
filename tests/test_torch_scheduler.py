"""The port's continuous batching (``serve/scheduler.py``) on the CPU.

* Within the port: every request's stream through the slot bank is
  bit-identical to the same request served alone by the reference loop
  (``ServeEngine.generate(..., engine="reference")``), for granite, mamba2
  and zamba2 at their smoke configs, in bfloat16 and float32; also when a
  freed slot is never reused while the other slot runs past ``max_len``;
  a pipeline engine's stream equals the monolithic one (the launcher's
  ``--stream --cuts`` too), and the launcher's overlapped pipeline prints
  the sequential one's tokens.
* Against the reference: the fixture's ``stream/<arch>`` scenarios
  (``tests/data/serve_equivalence.json``, captured under
  ``jax.threefry_partitionable(False)``) under the matching rule of
  ``tests/test_torch_serve.py``: each request's teacher-forced logits
  within 3e-2 of the reference's (the untied heads of zamba2, whisper and
  the VLM: as accurate as the reference's against the exact run, as
  ``tests/test_torch_hybrid.py`` explains), each request of whisper and
  the VLM with its own side input,
  greedy tokens equal to the pin wherever the reference's top-1/top-2 gap
  exceeds 2 x 3e-2, and the stream equal to the pin up to its first step
  with a smaller gap.  Flips are printed with their gap.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import init_serve_cache as jax_init_serve_cache
from repro.models import prefill as jax_prefill
from repro.serve.equivalence import make_batch as jax_make_batch
from repro.serve.equivalence import scenarios
from repro_torch import core
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import decode_step, init_serve_cache, prefill
from repro_torch.models.bridge import params_from_jax
from repro_torch.serve.engine import ServeEngine, as_batch, make_batch
from repro_torch.serve.pipeline import PipelineServeEngine
from repro_torch.serve.scheduler import (Request, SlotScheduler,
                                         leaf_batch_axes)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["granite-3-2b", "mamba2-1.3b", "zamba2-7b"]
TOL = 3e-2
SCENARIOS = {s["id"]: s for s in scenarios()}


def jax_params(jcfg):
    with jax.threefry_partitionable(False):
        return jax_init_params(jcfg, jax.random.PRNGKey(0))


def port_engine(arch, dtype="bfloat16", max_len=32, kv_block=16):
    jcfg = jax_get_config(arch, "smoke").replace(param_dtype=dtype)
    cfg = get_config(arch, "smoke").replace(param_dtype=dtype)
    jp = jax_params(jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, ServeEngine(cfg, params, max_len=max_len,
                                 kv_block=kv_block)


def requests(cfg, shape, seed=1):
    return [Request(i, make_batch(cfg, 1, plen, seed * 1000 + i)["tokens"],
                    glen) for i, (plen, glen) in enumerate(shape)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_stream_equals_each_request_served_alone(arch, dtype):
    """The fixture's request shapes over 2 slots: bit-identical streams,
    and the schedule's step count and slot utilisation."""
    _, _, eng = port_engine(arch, dtype)
    reqs = requests(eng.cfg, SCENARIOS[f"stream/{arch}"]["requests"])
    sched = SlotScheduler(eng, slots=2)
    fast, stats = sched.run(reqs)
    ref, _ = sched.run(reqs, engine="reference")
    for got, want, r in zip(fast, ref, reqs):
        assert got.dtype == np.int32 and got.shape == (r.gen_len,)
        np.testing.assert_array_equal(got, want)
    # 31 tokens, 6 of them from the admissions' prefills: 25 decode rows
    # in 14 steps of 2 slots
    assert stats["decode_steps"] == 14
    assert stats["slot_utilization"] == pytest.approx(25 / 28)


@pytest.mark.parametrize("arch", ARCHS)
def test_idle_slot_past_max_len_changes_no_stream(arch):
    """Slot 0 frees after one decode step and is never reused while slot
    1 decodes 27 more steps: its rows step on to length 9 + 27 > max_len
    32, writing nowhere past the cache; the streams equal the requests
    served alone.  More slots than requests: the idle slots step too."""
    _, _, eng = port_engine(arch)
    reqs = requests(eng.cfg, [(8, 2), (4, 29)], seed=5)
    for slots in (2, 3):
        fast, stats = SlotScheduler(eng, slots=slots).run(reqs)
        assert stats["decode_steps"] == 28 and 8 + stats["decode_steps"] > 32
        ref, _ = SlotScheduler(eng, slots=slots).run(reqs,
                                                     engine="reference")
        for got, want in zip(fast, ref):
            np.testing.assert_array_equal(got, want)


def test_leaf_batch_axes_are_behind_the_layer_axis():
    """Every cache leaf is stacked by layer (or call site) first, so its
    batch axis is 1; found from caches built on the meta device."""
    for arch in ARCHS:
        _, _, eng = port_engine(arch)
        sched = SlotScheduler(eng, slots=2)
        axes = sched._leaf_batch_axes()
        flat = jax.tree.leaves(axes)
        assert flat and set(flat) == {1}, (arch, axes)
    cfg = get_config("zamba2-7b", "smoke")
    axes = leaf_batch_axes(
        lambda b: init_serve_cache(cfg, b, 16, device="meta"))
    assert sorted(axes) == ["mamba", "shared"]


def test_run_serves_a_pipeline_engine():
    """The pipeline engine's stream (a cache bank a stage) equals the
    monolithic one; a request that does not fit is refused by both."""
    _, _, eng = port_engine("granite-3-2b")
    cfg = eng.cfg.replace(n_layers=2)
    peng = PipelineServeEngine(
        cfg, eng.params, core.from_block_cuts(cfg, [1], spare_nodes=(9,)),
        max_len=32, kv_block=16)
    reqs = requests(cfg, SCENARIOS["stream/granite-3-2b"]["requests"])
    mono, mono_stats = SlotScheduler(eng, slots=2).run(reqs)
    piped, stats = SlotScheduler(peng, slots=2).run(reqs)
    assert stats["decode_steps"] == mono_stats["decode_steps"] == 14
    for a, b in zip(mono, piped):
        np.testing.assert_array_equal(a, b)
    for e in (eng, peng):
        with pytest.raises(ValueError, match="exceeds max_len"):
            SlotScheduler(e, slots=2).run(requests(cfg, [(30, 4)]))


# ---------------------------------------------------------------------------
# the fixture's stream scenarios, against their pins
# ---------------------------------------------------------------------------

def jax_teacher_forced(jcfg, jp, batch, fed, max_len, cache_dtype):
    """The reference's logits (gen_len, V) along ``fed`` (its pin), for a
    request ``batch`` (tokens and side input)."""
    cache = jax.tree.map(
        lambda a: a.astype(cache_dtype) if a.dtype == jnp.bfloat16 else a,
        jax_init_serve_cache(jcfg, 1, max_len, batch=batch))
    logits, cache = jax_prefill(jcfg, jp, batch, cache)
    out = [logits]
    for j in range(len(fed) - 1):
        logits, cache = jax_decode_step(
            jcfg, jp, jnp.asarray(fed[j:j + 1][None], jnp.int32), cache)
        out.append(logits)
    return np.concatenate([np.asarray(o, np.float32)[0] for o in out])


def port_teacher_forced(eng, batch, fed):
    batch = as_batch(batch, "cpu")
    cache = init_serve_cache(eng.cfg, 1, eng.max_len, batch=batch,
                             device="cpu")
    with torch.inference_mode():
        logits, cache = prefill(eng.cfg, eng.params, batch, cache)
        out = [logits[0]]
        for j in range(len(fed) - 1):
            logits, cache = decode_step(
                eng.cfg, eng.params,
                torch.tensor([[int(fed[j])]], dtype=torch.int32), cache)
            out.append(logits[0])
    return torch.cat(out).numpy()


@pytest.mark.parametrize("arch", ARCHS + ["whisper-large-v3",
                                          "llama-3.2-vision-90b"])
def test_fixture_stream_scenarios_hold_their_pins(arch):
    sc = SCENARIOS[f"stream/{arch}"]
    pins = json.loads((ROOT / "tests/data/serve_equivalence.json")
                      .read_text())[sc["id"]]["tokens"]
    jcfg, jp, eng = port_engine(arch, max_len=sc["max_len"],
                                kv_block=sc["kv_block"])
    reqs = []
    with jax.threefry_partitionable(False):
        for i, (plen, glen) in enumerate(sc["requests"]):
            one = {k: np.asarray(v) for k, v in jax_make_batch(
                jcfg, 1, plen, sc["seed"] * 1000 + i).items()}
            reqs.append(Request(i, one.pop("tokens"), glen, extras=one))
    streams, _ = SlotScheduler(eng, slots=sc["slots"]).run(reqs)
    exact = (jcfg.replace(param_dtype="float32"),
             jax.tree.map(lambda a: a.astype(jnp.float32), jp))
    port_err = jax_err = 0.0
    for r, pin, got in zip(reqs, pins, streams):
        pin = np.asarray(pin)
        batch = {"tokens": r.tokens, **r.extras}
        jl = jax_teacher_forced(jcfg, jp, batch, pin, sc["max_len"],
                                jnp.bfloat16)
        tl = port_teacher_forced(eng, batch, pin)
        if not eng.cfg.tie_embeddings:
            el = jax_teacher_forced(*exact, batch, pin, sc["max_len"],
                                    jnp.float32)
            port_err = max(port_err, float(np.abs(tl - el).max()))
            jax_err = max(jax_err, float(np.abs(jl - el).max()))
        else:
            np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
        top2 = np.sort(jl, axis=-1)[:, -2:]
        gap = top2[:, 1] - top2[:, 0]
        for t in np.nonzero(tl.argmax(-1) != pin)[0]:
            print(f"flip: request {r.rid} step {t} reference top-1/top-2 "
                  f"gap {gap[t]:.4g}")
            assert gap[t] <= 2 * TOL, (r.rid, t, gap[t])
        low = np.nonzero(gap <= 2 * TOL)[0]
        upto = low[0] if len(low) else r.gen_len
        np.testing.assert_array_equal(got[:upto], pin[:upto])
    assert port_err <= 2 * jax_err, (port_err, jax_err)


def test_launcher_streams_on_the_cpu(capsys):
    args = ["--arch", "granite-3-2b", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--gen-len", "5", "--stream", "3"]
    fast = launch_serve.main(args)
    out = capsys.readouterr().out
    assert "[serve/stream-fast] granite-3-2b-smoke on cpu: 3 requests x 5 " \
        "tokens over 2 slots: 15 tokens" in out
    ref = launch_serve.main(args + ["--engine", "reference"])
    for a, b in zip(fast, ref):
        np.testing.assert_array_equal(a, b)
    # --stream with --cuts: the same stream through the pipeline engine
    piped = launch_serve.main(args + ["--cuts", "1"])
    assert "pipeline-sequential-raw, 2 stages" in capsys.readouterr().out
    for a, b in zip(fast, piped):
        np.testing.assert_array_equal(a, b)


def test_launcher_overlap_on_the_cpu(capsys):
    """The overlapped pipeline (4 stages, 2 micro-batches in flight)
    prints the token sample of the sequential one."""
    args = ["--arch", "granite-3-2b", "--device", "cpu", "--layers", "4",
            "--batch", "2", "--prompt-len", "8", "--gen-len", "5",
            "--cuts", "1,2,3"]
    seq = launch_serve.main(args)
    over = launch_serve.main(args + ["--overlap", "--micro-batches", "2"])
    out = capsys.readouterr().out
    assert "[serve/pipeline-overlap-raw, 4 stages on one device, 2 " \
        "micro-batch(es) in flight]" in out and "decode-only" in out
    sample = [line.split("sample: ")[1] for line in out.splitlines()
              if "sample: " in line]
    assert len(sample) == 2 and sample[0] == sample[1]
    np.testing.assert_array_equal(seq, over)
    with pytest.raises(SystemExit):
        launch_serve.main(args[:-2] + ["--overlap"])     # needs --cuts
