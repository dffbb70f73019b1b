"""The port's cross-attention VLM family (llama-3.2-vision-90b) against
the reference on the CPU, and its serving paths against each other.

The same method and tolerances as ``tests/test_torch_encdec.py``, whose
helpers this file uses: params from the reference's ``init_params`` and
inputs (tokens and the bf16 vision embeddings) from
``repro.serve.equivalence.make_batch`` under
``jax.threefry_partitionable(False)``; float32 within 5e-6 (1 + |ref|),
decoding through float32 caches; bf16 blocks within 2 bf16 ulps of their
output's scale, and the logits of the untied head held to the reference's
own accuracy against its float32 run.  Stages hold whole groups
(``cross_attn_every`` self blocks and one cross block), and every stage
fills its cross caches from the vision embeddings it is given.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as jax_model
from repro_torch import core
from repro_torch.configs import get_config
from repro_torch.models import init_params, init_serve_cache, model, staging
from repro_torch.serve.engine import as_batch, make_batch
from repro_torch.serve.pipeline import PipelineServeEngine
from test_torch_encdec import (B, PROMPT, check_forward, check_layout,
                               check_pipelines, check_round_trip,
                               check_stream, check_teacher_forced,
                               fixture_batch, hold_block, reference)

torch.set_num_threads(2)

ARCH = "llama-3.2-vision-90b"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocks_match_reference(dtype):
    """Each block of the smoke model's group fed the reference's input:
    the self blocks, then the cross block attending to the vision
    embeddings (cacheless: ``cross_kv``'s keys and values over them)."""
    jcfg, jp, cfg, params = reference(ARCH, dtype)
    nb = fixture_batch(jcfg)
    vision = jnp.asarray(nb["vision"]).astype(jp["embed"].dtype)
    h = jp["embed"][jnp.asarray(nb["tokens"])]
    pos = np.broadcast_to(np.arange(PROMPT)[None], (B, PROMPT)).copy()
    gp, tg = (jax.tree.map(lambda a: a[0], jp["groups"]),
              model.layer_view(params["groups"], 0))
    for i in range(cfg.cross_attn_every + 1):
        t = as_batch({"h": np.asarray(h), "v": nb["vision"]}, "cpu")
        with torch.inference_mode():
            if i < cfg.cross_attn_every:
                want, _ = jax_model.apply_dense_block(
                    jax.tree.map(lambda a: a[i], gp["self"]), h, jcfg,
                    jnp.asarray(pos))
                got = model.apply_dense_block(
                    model.layer_view(tg["self"], i), t["h"], cfg,
                    torch.from_numpy(pos))
            else:
                want = jax_model.apply_cross_block(
                    gp["cross"], h, jcfg, jnp.asarray(pos), kv_x=vision)
                got = model.apply_cross_block(
                    tg["cross"], t["h"], cfg, model.cross_kv(
                        tg["cross"], cfg, t["v"].to(getattr(torch, dtype))))
        hold_block(want, got, dtype)
        h = want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_cache_fill_matches_reference(dtype):
    """The cross caches a prefill fills from the vision embeddings: the
    reference's bits (bf16 caches of the same products)."""
    jcfg, jp, cfg, params = reference(ARCH, dtype)
    nb = fixture_batch(jcfg)
    jc = jax_model._fill_cross_caches(
        jcfg, jp, jax_model.init_serve_cache(jcfg, B, 16, batch=nb), nb)
    cache = init_serve_cache(cfg, B, 16, device="cpu")
    with torch.inference_mode():
        model.fill_cross_caches(cfg, params, cache,
                                {"vision": as_batch(nb, "cpu")["vision"]})
    for key in ("k", "v"):
        want = np.asarray(jc[1][key], np.float32)
        got = cache["cross"][key].float().numpy()
        if dtype == "bfloat16":
            np.testing.assert_array_equal(got, want)
        else:
            # float32 products rounded to bf16: an ulp where the two
            # packages' sums straddle a rounding point
            np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=1e-6)


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


def test_cache_layout():
    """Self caches stacked (groups, self blocks) with the batch on axis 2,
    cross caches by group with the batch on axis 1; a stage's cache holds
    its groups only."""
    cfg = get_config(ARCH, "smoke").replace(n_layers=10)
    cache = init_serve_cache(cfg, 3, 16, device="cpu")
    g, k = 2, cfg.cross_attn_every
    assert cache["self"]["k"].shape[:4] == (g, k, 3, 16)
    assert cache["self"]["len"].shape == (g, k, 3)
    assert cache["cross"]["k"].shape[:3] == (g, 3, cfg.vision_tokens)
    st = staging.init_stage_cache(cfg, 5, 10, 3, 16, device="cpu")
    assert st["self"]["k"].shape[:2] == (1, k)
    assert staging.stage_granularity(cfg) == k + 1


@pytest.mark.parametrize("cuts,kill", [
    ([5], None), ([5], {"after_step": 3, "stage": 1}),
    ([5], {"after_step": 0, "stage": 0})])
def test_pipelines_over_group_cuts(cuts, kill):
    check_pipelines(ARCH, 10, cuts, kill)


def test_cut_inside_a_group_is_refused():
    cfg = get_config(ARCH, "smoke").replace(n_layers=10)
    params = init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="granularity 5"):
        PipelineServeEngine(cfg, params, core.from_block_cuts(cfg, [3]),
                            max_len=32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_stream_equals_each_request_served_alone(dtype):
    """The fixture's staggered request shapes over 2 slots, each request
    with its own vision embeddings."""
    stats = check_stream(ARCH, [[8, 6], [8, 4], [12, 7], [8, 5], [12, 3],
                                [8, 6]], dtype)
    assert stats["decode_steps"] > 0


def test_stream_vision_reaches_its_own_slot():
    """Two requests with the same prompt and different vision embeddings
    give different streams, each the one it gets alone."""
    cfg = get_config(ARCH, "smoke")
    one = make_batch(cfg, 1, 8, seed=7)
    other = make_batch(cfg, 1, 8, seed=8)
    assert not np.array_equal(one["vision"], other["vision"])
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import Request, SlotScheduler
    eng = ServeEngine(cfg, init_params(cfg, device="cpu"), max_len=32,
                      kv_block=16)
    reqs = [Request(i, one["tokens"], 8, extras={"vision": b["vision"]})
            for i, b in enumerate((one, other))]
    fast, _ = SlotScheduler(eng, slots=2).run(reqs)
    ref, _ = SlotScheduler(eng, slots=2).run(reqs, engine="reference")
    for got, want in zip(fast, ref):
        np.testing.assert_array_equal(got, want)
    assert not np.array_equal(fast[0], fast[1])


@pytest.mark.parametrize("arch,self_axis", [(ARCH, 2),
                                            ("whisper-large-v3", 1)])
def test_leaf_batch_axes_of_the_cross_caches(arch, self_axis):
    """The slot bank's batch axes, found from caches shaped on the meta
    device by the first request's side input: the VLM's self caches
    (groups, self blocks, batch, ...) on axis 2, whisper's on axis 1, every
    cross cache on axis 1; the cross caches have no length to reset."""
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import SlotScheduler
    cfg = get_config(arch, "smoke")
    eng = ServeEngine(cfg, init_params(cfg, device="cpu"), max_len=16)
    proto = make_batch(cfg, 1, 4, seed=0, frames_len=6)
    proto.pop("tokens")
    axes = SlotScheduler(eng, slots=2)._leaf_batch_axes(proto)
    assert axes["self"] == {"k": self_axis, "v": self_axis,
                            "len": self_axis}
    assert axes["cross"] == {"k": 1, "v": 1}
