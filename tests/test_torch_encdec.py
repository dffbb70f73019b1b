"""The port's encoder-decoder family (whisper-large-v3) against the
reference on the CPU, and its serving paths against each other.

Params come from the reference's ``init_params`` and inputs (tokens and
the bf16 frame embeddings) from ``repro.serve.equivalence.make_batch``,
both under ``jax.threefry_partitionable(False)``, crossed to torch through
``params_from_jax``.  Tolerances, on |port - ref| <= tol (1 + |ref|):

* float32 params — 5e-6: ``encode``, one decoder block fed the reference's
  input, the forward's logits, and prefill with teacher-forced decode
  along the reference's greedy tokens (the fixture cell's 8 logits: the
  prefill's and 7 decode steps'), decoded through float32 caches, since a
  bf16 cache turns last-ulp float32 differences of a k/v element into
  whole bf16 steps;
* bfloat16 params — the encoder's and the block's output within 2 bf16
  ulps of its scale; whisper's head is untied, so the logits are held to
  the reference's own accuracy (``hold``: the port at most twice as far
  from the reference's float32 run as the reference is).

Within the port: the bridge and the checkpoint carry the tree byte for
byte; the raw-wire pipeline (the encoder on the first stage, its output
shipped raw to the others) equals ``ServeEngine`` across cuts and a stage
kill; an int8-wire run with a kill equals the run without it; a stream
equals its requests served alone.

``tests/test_torch_vlm.py`` imports the helpers of this file.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import init_serve_cache as jax_init_serve_cache
from repro.models import model as jax_model
from repro.models import prefill as jax_prefill
from repro.serve.equivalence import make_batch as jax_make_batch
from repro_torch import core
from repro_torch._tree import tree_map
from repro_torch.checkpoint import (restore_checkpoint, save_checkpoint,
                                    template_of)
from repro_torch.configs import get_config
from repro_torch.models import (decode_step, forward, init_params,
                                init_serve_cache, model, prefill)
from repro_torch.models.bridge import params_from_jax, params_to_jax
from repro_torch.models.config import ShapeConfig
from repro_torch.serve.engine import ServeEngine, as_batch, make_batch
from repro_torch.serve.pipeline import PipelineServeEngine
from repro_torch.serve.scheduler import Request, SlotScheduler

torch.set_num_threads(2)

ARCH = "whisper-large-v3"
TOL = 5e-6                    # float32, times (1 + |ref|)
B, PROMPT, GEN = 2, 12, 8     # the fixture's sync cell


def reference(arch, dtype, **over):
    """(reference config, params; port config, params) at the smoke
    config."""
    jcfg = jax_get_config(arch, "smoke").replace(param_dtype=dtype, **over)
    cfg = get_config(arch, "smoke").replace(param_dtype=dtype, **over)
    with jax.threefry_partitionable(False):
        jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp),
                                          "cpu")


def fixture_batch(jcfg, b=B, s=PROMPT, seed=0):
    """The reference's batch (numpy; bf16 side inputs as
    ``ml_dtypes.bfloat16``)."""
    with jax.threefry_partitionable(False):
        batch = jax_make_batch(jcfg, b, s, seed)
    return {k: np.asarray(v) for k, v in batch.items()}


def close(got, want, tol=TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def bf16_ulps(want, got):
    """|got - want| at its largest, in bf16 ulps of want's largest
    magnitude (the output's scale)."""
    want = np.asarray(want, np.float32)
    ulp = 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)
    return float(np.abs(got.float().numpy() - want).max() / ulp)


def hold_block(want, got, dtype):
    if dtype == "float32":
        close(got, want)
    else:
        assert bf16_ulps(want, got) <= 2.0, bf16_ulps(want, got)


def exact_model(jcfg, jp):
    """The reference's float32 run on the same (rounded) params."""
    return (jcfg.replace(param_dtype="float32"),
            jax.tree.map(lambda a: a.astype(jnp.float32), jp))


def hold(got, want, exact, dtype):
    """Logits: float32 within TOL of the reference; bf16 (an untied head)
    at most twice as far from the exact run as the reference is.  Prints
    the worst relative difference of each step."""
    rel = [float((np.abs(np.asarray(g) - np.asarray(w))
                  / (1 + np.abs(np.asarray(w)))).max())
           for g, w in zip(got, want)]
    print(f"{dtype}: |port - ref| / (1 + |ref|) by step: "
          + " ".join(f"{r:.2g}" for r in rel))
    if dtype == "float32":
        for g, w in zip(got, want):
            close(g, w)
        return
    port = max(float(np.abs(np.asarray(g) - np.asarray(e)).max())
               for g, e in zip(got, exact))
    ref = max(float(np.abs(np.asarray(w) - np.asarray(e)).max())
              for w, e in zip(want, exact))
    assert port <= 2 * ref, (port, ref)


def widen_jax(cache):
    return jax.tree.map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        cache)


def widen(cache):
    return tree_map(
        lambda a: a.float() if a.dtype == torch.bfloat16 else a, cache)


def check_forward(arch, dtype):
    jcfg, jp, cfg, params = reference(arch, dtype)
    nb = fixture_batch(jcfg)
    want, _ = jax_forward(jcfg, jp, nb)
    exact, _ = jax_forward(*exact_model(jcfg, jp), nb)
    got, (h, _) = forward(cfg, params, as_batch(nb, "cpu"))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert h.dtype == getattr(torch, dtype)
    hold([got], [want], [exact], dtype)


def check_teacher_forced(arch, dtype):
    """Prefill, then GEN - 1 decode steps fed the reference's own greedy
    tokens, through the port's bucketed decode; float32 decodes through
    float32 caches in both packages."""
    jcfg, jp, cfg, params = reference(arch, dtype)
    nb = fixture_batch(jcfg)
    max_len = PROMPT + GEN + 8
    wide = dtype == "float32"

    def jax_steps(jc, jpar, fed=None, f32=wide):
        cache = jax_init_serve_cache(jc, B, max_len, batch=nb)
        if f32:
            cache = widen_jax(cache)
        logits, cache = jax_prefill(jc, jpar, nb, cache)
        out, toks = [logits], []
        for step in range(GEN - 1):
            t = (jnp.argmax(logits, -1).astype(jnp.int32) if fed is None
                 else fed[step])
            toks.append(t)
            logits, cache = jax_decode_step(jc, jpar, t, cache)
            out.append(logits)
        return out, toks

    want, fed = jax_steps(jcfg, jp)
    exact = (jax_steps(*exact_model(jcfg, jp), fed, f32=True)[0]
             if dtype == "bfloat16" else want)
    batch = as_batch(nb, "cpu")
    cache = init_serve_cache(cfg, B, max_len, batch=batch, device="cpu")
    if wide:
        cache = widen(cache)
    got = []
    with torch.inference_mode():
        tl, cache = prefill(cfg, params, batch, cache)
        got.append(tl)
        for step in range(GEN - 1):
            cur = PROMPT + step + 1
            tl, cache = decode_step(cfg, params,
                                    torch.as_tensor(np.array(fed[step])),
                                    cache, kv_bucket=-(-cur // 8) * 8)
            got.append(tl)
    hold(got, want, exact, dtype)


def check_layout(arch):
    """Leaf for leaf the reference's tree, shapes and dtypes."""
    jcfg = jax_get_config(arch, "smoke")
    want = jax.eval_shape(lambda: jax_init_params(jcfg,
                                                  jax.random.PRNGKey(0)))
    got = init_params(get_config(arch, "smoke"), device="cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (_, w), (_, g) in zip(flat_w, flat_g):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)


def check_round_trip(arch, tmp_path):
    """The bridge both ways, and a checkpoint written by the port read by
    the reference, byte for byte."""
    from repro import checkpoint as jax_ckpt
    nparams = jax.tree.map(np.asarray, jax_init_params(
        jax_get_config(arch, "smoke"), jax.random.PRNGKey(0)))
    tparams = params_from_jax(nparams, "cpu")
    assert jax.tree.structure(nparams) == jax.tree.structure(tparams)
    back = params_to_jax(tparams)
    for x, y in zip(jax.tree.leaves(nparams), jax.tree.leaves(back)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()
    save_checkpoint(tmp_path / "ck", 3, tparams)
    again = restore_checkpoint(tmp_path / "ck", 3, template_of(tparams),
                               device="cpu")
    ref = jax_ckpt.restore_checkpoint(tmp_path / "ck", 3, nparams)
    for x, y, z in zip(jax.tree.leaves(tparams), jax.tree.leaves(again),
                       jax.tree.leaves(ref)):
        assert torch.equal(x.view(-1).view(torch.uint8),
                           y.view(-1).view(torch.uint8))
        assert np.asarray(z).tobytes() == x.contiguous().view(
            torch.uint8).numpy().tobytes()


def plan_of(cfg, cuts, bits):
    """``from_block_cuts`` over ``cuts``, or, for a list of layer-name
    tuples, a plan of those stages (a planner's plan may hold no blocks in
    a stage)."""
    if isinstance(cuts[0], int):
        return core.from_block_cuts(cfg, cuts, spare_nodes=(8, 9),
                                    wire_bits=bits)
    return core.StageExecutionPlan(
        stages=[core.StageSpec(k, layers, k + 1)
                for k, layers in enumerate(cuts)], spare_nodes=(8, 9),
        compression=core.BoundarySpec(wire_bits=bits), arch=cfg.name)


def check_pipelines(arch, n_layers, cuts, kill, seed=3):
    """The raw-wire pipeline over ``cuts`` (``plan_of``; with ``kill``)
    bit-identical to ``ServeEngine``, and the int8 wire's run with the
    kill equal to the same run without it."""
    cfg = get_config(arch, "smoke").replace(n_layers=n_layers)
    params = init_params(cfg, device="cpu")
    batch = make_batch(cfg, 3, PROMPT, seed=seed)
    want = ServeEngine(cfg, params, max_len=PROMPT + GEN,
                       kv_block=8).generate(batch, GEN)
    for bits in (0, 8):
        eng = PipelineServeEngine(cfg, params, plan_of(cfg, cuts, bits),
                                  max_len=PROMPT + GEN, kv_block=8)
        got = eng.generate(batch, GEN, kill=kill)
        if bits == 0:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_array_equal(eng.generate(batch, GEN), got)
        assert any("restored from checkpoint" in m
                   for _, m in eng.events) == (kill is not None)
        assert eng.down == set()


def check_stream(arch, shapes, dtype, slots=2):
    """Each request's stream through the slot bank, with its own side
    input, bit-identical to the request served alone."""
    cfg = get_config(arch, "smoke").replace(param_dtype=dtype)
    params = init_params(cfg, device="cpu")
    eng = ServeEngine(cfg, params, max_len=32, kv_block=16)
    reqs = []
    for i, (plen, glen) in enumerate(shapes):
        one = make_batch(cfg, 1, plen, seed=1000 + i, frames_len=8)
        reqs.append(Request(i, one.pop("tokens"), glen, extras=one))
    sched = SlotScheduler(eng, slots=slots)
    fast, stats = sched.run(reqs)
    ref, _ = sched.run(reqs, engine="reference")
    for got, want, r in zip(fast, ref, reqs):
        assert got.shape == (r.gen_len,)
        np.testing.assert_array_equal(got, want)
    return stats


# ---------------------------------------------------------------------------
# whisper against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_reference(dtype):
    jcfg, jp, cfg, params = reference(ARCH, dtype)
    frames = fixture_batch(jcfg)["frames"]
    want = jax_model.encode(jcfg, jp, jnp.asarray(frames))
    with torch.inference_mode():
        got = model.encode(cfg, params, as_batch({"f": frames}, "cpu")["f"])
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    hold_block(want, got, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_block_matches_reference(dtype):
    """One decoder block fed the reference's input: the embedded prompt,
    and the reference's encoder output, cacheless (cross-attention to
    ``cross_kv``'s keys and values over it)."""
    jcfg, jp, cfg, params = reference(ARCH, dtype)
    nb = fixture_batch(jcfg)
    enc = jax_model.encode(jcfg, jp, jnp.asarray(nb["frames"]))
    h = jp["embed"][jnp.asarray(nb["tokens"])]
    pos = np.broadcast_to(np.arange(PROMPT)[None], (B, PROMPT))
    for i in range(cfg.n_layers):
        want, _ = jax_model.apply_decoder_block(
            jax.tree.map(lambda a: a[i], jp["dec_blocks"]), h, jcfg,
            jnp.asarray(pos), enc_out=enc)
        t = as_batch({"h": np.asarray(h), "e": np.asarray(enc)}, "cpu")
        bp = model.layer_view(params["dec_blocks"], i)
        with torch.inference_mode():
            got = model.apply_decoder_block(
                bp, t["h"], cfg, torch.from_numpy(pos.copy()),
                model.cross_kv(bp, cfg, t["e"]))
        hold_block(want, got, dtype)
        h = want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits(dtype):
    check_forward(ARCH, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_teacher_forced_decode(dtype):
    check_teacher_forced(ARCH, dtype)


def test_init_params_layout_matches_reference():
    check_layout(ARCH)


def test_bridge_and_checkpoint_round_trip(tmp_path):
    check_round_trip(ARCH, tmp_path)


def test_cross_cache_sized_by_the_frames():
    """The cross caches hold the frames' rows whatever the prompt; a
    stage's, the rows it is given."""
    cfg = get_config(ARCH, "smoke")
    batch = as_batch(make_batch(cfg, 2, 5, seed=0, frames_len=9), "cpu")
    assert batch["frames"].shape == (2, 9, cfg.d_model)
    assert batch["frames"].dtype == torch.bfloat16
    cache = init_serve_cache(cfg, 2, 16, batch=batch, device="cpu")
    assert cache["cross"]["k"].shape == (cfg.n_layers, 2, 9, cfg.n_kv_heads,
                                         cfg.resolved_head_dim)
    assert cache["self"]["k"].shape[2] == 16


# ---------------------------------------------------------------------------
# the port's serving paths against each other
# ---------------------------------------------------------------------------

ENCODER_STAGE = [("input", "embed", "enc0"), ("enc1", "block0", "block1"),
                 ("block2", "block3", "head")]


@pytest.mark.parametrize("cuts,kill", [
    ([1], None), ([2], None), ([3], None),
    ([2], {"after_step": 3, "stage": 1}),
    ([1, 2, 3], {"after_step": 0, "stage": 0}),
    (ENCODER_STAGE, {"after_step": 2, "stage": 0}),
    (ENCODER_STAGE, {"after_step": 1, "stage": 2})])
def test_pipelines_over_cuts(cuts, kill):
    """``ENCODER_STAGE``: a block-free first stage that runs the whole
    encoder (a plan that cuts inside the planner's encoder layers)."""
    check_pipelines(ARCH, 4, cuts, kill)


def test_planned_stages_put_the_encoder_first():
    """The planner's graph charges the encoder as layers enc0..enc{N-1}
    ahead of the decoder blocks, and its encoder-only stage is
    block-free."""
    cfg = get_config(ARCH, "smoke").replace(n_layers=4, n_enc_layers=4)
    g = core.lm_block_graph(cfg, ShapeConfig("s", 12, 2, "prefill"))
    names = list(g.layers)
    assert names[2:6] == [f"enc{i}" for i in range(4)]
    assert all(g.layers[f"block{i}"].side_in_bytes > 0 for i in range(4))
    assert plan_of(cfg, ENCODER_STAGE, 0).block_ranges(4) == [
        (0, 0), (0, 2), (2, 4)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_stream_equals_each_request_served_alone(dtype):
    """The fixture's whisper stream shapes (one prompt length, the frames
    shared in length) over 2 slots."""
    stats = check_stream(ARCH, [[8, g] for g in (6, 4, 7, 5, 3, 6)], dtype)
    assert stats["decode_steps"] > 0
