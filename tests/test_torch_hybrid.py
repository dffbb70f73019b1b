"""The port's hybrid family (zamba2) against the reference on the CPU.

Params come from the reference's ``init_params`` at the zamba2-7b smoke
config (5 mamba2 layers; the shared attention block before layers 0, 2 and
4) under ``jax.threefry_partitionable(False)``, the setting the committed
pins were captured under, and cross to torch through ``params_from_jax``;
tokens come from numpy seeds.

Tolerances:

* float32 params and float32 caches — forward, prefill and 8 teacher-forced
  decode logits within 1e-5, cache leaves within 1e-5 of the leaf's
  largest magnitude.  This pins the algorithm: the call sites of the
  shared block before their mamba layer, their caches, the offsets a
  pipeline stage passes.
* float32 params with the serving caches (bfloat16): within 3e-2, the
  bfloat16 tolerance (the two packages' k and v round to different bf16
  neighbours wherever their float32 values differ by an ulp; seen 3e-3).
* bfloat16 params: every product rounds at slightly different places in
  the two packages.  At this config the residual stream reaches |h| of
  about 10 and the logits 4, where one bf16 step is 0.03 or more, so the
  port's bf16 logits are up to 0.21 off the reference's (four prompts),
  which misses the 3e-2 of the other families (recorded in ROADMAP Queue
  3) — and the reference's own bf16 logits are as far (0.11–0.23) from
  the exact ones, float32 arithmetic on the same rounded params.  So the
  bf16 runs are held to the reference's own accuracy: the port's largest
  distance from the exact logits at most twice the reference's (seen up
  to 1.27 times); cache leaves within 5e-2 of the leaf's largest
  magnitude.
* pipelines and streams within the port: bit-identical.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import from_block_cuts as jax_from_block_cuts
from repro.kernels.attention.kernel import flash_attention_pallas
from repro.kernels.attention.ref import attention_ref as jax_attention_ref
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import init_serve_cache as jax_init_serve_cache
from repro.models import prefill as jax_prefill
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro.models import ssm as jax_ssm
from repro.models import staging as jax_staging
from repro.serve import PipelineServeEngine as JaxPipelineServeEngine
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch import core
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.checkpoint import template_of
from repro_torch.configs import get_config
from repro_torch.kernels.attention.ref import flash_ref
from repro_torch.launch import serve as launch_serve
from repro_torch.models import (decode_step, forward, init_params,
                                init_serve_cache, prefill, staging)
from repro_torch.models import layers as port_layers
from repro_torch.models import model as port_model
from repro_torch.models import ssm as port_ssm
from repro_torch.models.bridge import (params_from_jax, params_to_jax,
                                       tensor_from_numpy)
from repro_torch.serve.engine import ServeEngine, make_batch
from repro_torch.serve.pipeline import PipelineServeEngine

torch.set_num_threads(2)

ARCH = "zamba2-7b"
TOL = {"bfloat16": 3e-2, "float32": 1e-5}
CACHE_TOL = 5e-2            # bf16 cache leaves, of the leaf's max |.|
STEPS = 8
PROMPT, GEN = 20, 8         # one full and one ragged SSD chunk of 16
F32 = jnp.float32


def close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def _cfgs(dtype):
    return (jax_get_config(ARCH, "smoke").replace(param_dtype=dtype),
            get_config(ARCH, "smoke").replace(param_dtype=dtype))


def jax_params(jcfg, seed=0):
    with jax.threefry_partitionable(False):
        return jax_init_params(jcfg, jax.random.PRNGKey(seed))


@pytest.fixture(scope="module", params=["bfloat16", "float32"])
def model(request):
    dtype = request.param
    jcfg, cfg = _cfgs(dtype)
    jp = jax_params(jcfg)
    return dtype, jcfg, jp, cfg, params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu")


def tokens(cfg, b=2, s=PROMPT, seed=0):
    return make_batch(cfg, b, s, seed)["tokens"]


def as_cache_dtype(cache, dtype):
    """Every bf16 leaf of a port cache as ``dtype`` (the caches are bf16
    whatever the params; float32 caches take their rounding out)."""
    return tree_map(lambda a: a.to(dtype) if a.dtype == torch.bfloat16
                    else a, cache)


def jax_run(jcfg, jp, toks, fed, cache_dtype):
    """The reference: forward, prefill (logits, cache) and decode steps fed
    ``fed`` (B, STEPS), with its caches in ``cache_dtype``."""
    batch = {"tokens": jnp.asarray(toks)}
    fwd, _ = jax_forward(jcfg, jp, batch)
    cache = jax.tree.map(
        lambda a: a.astype(cache_dtype) if a.dtype == jnp.bfloat16 else a,
        jax_init_serve_cache(jcfg, toks.shape[0], PROMPT + STEPS + 8))
    logits, cache = jax_prefill(jcfg, jp, batch, cache)
    out = [np.asarray(logits, np.float32)]
    filled = jax.tree.map(np.asarray, cache)
    for i in range(STEPS):
        logits, cache = jax_decode_step(jcfg, jp,
                                        jnp.asarray(fed[:, i:i + 1]), cache)
        out.append(np.asarray(logits, np.float32))
    return np.asarray(fwd, np.float32), out, filled


def port_run(cfg, params, toks, fed, cache_dtype):
    """The port, the same way (bucketed decode: kv_bucket 32)."""
    fwd, _ = forward(cfg, params, {"tokens": torch.as_tensor(toks)})
    cache = init_serve_cache(cfg, toks.shape[0], PROMPT + STEPS + 8,
                             device="cpu")
    cache = as_cache_dtype(cache, cache_dtype)
    with torch.inference_mode():
        logits, cache = prefill(cfg, params,
                                {"tokens": torch.as_tensor(toks)}, cache)
        out = [logits.numpy()]
        filled = tree_map(lambda t: t.clone(), cache)
        for i in range(STEPS):
            logits, cache = decode_step(
                cfg, params, torch.as_tensor(fed[:, i:i + 1]).int(), cache,
                kv_bucket=32)
            out.append(logits.numpy())
    return fwd.numpy(), out, filled


def greedy(jcfg, jp, toks):
    """The reference's own greedy tokens (B, STEPS) after the prompt."""
    jeng = JaxServeEngine(jcfg, jp, max_len=PROMPT + STEPS + 8, kv_block=8)
    out = jeng.generate({"tokens": jnp.asarray(toks, jnp.int32)}, STEPS)
    return np.asarray(out).astype(np.int32)


def cache_leaves(tree):
    """(path, leaf) pairs of a cache tree, mamba and shared."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(jax.tree_util.keystr(p), x) for p, x in flat]


def test_float32_forward_prefill_caches_and_decode():
    """float32 params and caches: every logit and cache leaf within 1e-5."""
    jcfg, cfg = _cfgs("float32")
    jp = jax_params(jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    toks = tokens(cfg, seed=1)
    fed = greedy(jcfg, jp, toks)
    jf, jsteps, jcache = jax_run(jcfg, jp, toks, fed, F32)
    tf, tsteps, tcache = port_run(cfg, params, toks, fed, torch.float32)
    close(tf, jf, TOL["float32"])
    for got, want in zip(tsteps, jsteps):
        close(got, want, TOL["float32"])
    got, want = cache_leaves(tcache), cache_leaves(jcache)
    assert [p for p, _ in got] == [p for p, _ in want]
    assert "['shared']['k']" in dict(got)
    for (path, g), (_, w) in zip(got, want):
        g = g.float().numpy() if g.dtype != torch.int32 else g.numpy()
        assert g.shape == w.shape, path
        scale = TOL["float32"] * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=0, atol=scale, err_msg=path)


def as_accurate(got, ref, exact):
    """The port's largest distance from the exact logits at most twice
    the reference's (lists of per-step logits)."""
    port = max(float(np.abs(g - e).max()) for g, e in zip(got, exact))
    jax_ = max(float(np.abs(r - e).max()) for r, e in zip(ref, exact))
    assert port <= 2 * jax_, (port, jax_)


def bf16_ulps(want, got):
    """|got - want| at its largest, in bf16 ulps of want's largest
    magnitude (the block output's scale)."""
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    ulp = 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)
    return float(np.abs(got - want).max() / ulp)


@pytest.mark.parametrize("seed", range(4))
def test_each_block_within_two_bf16_ulps_of_the_reference(seed):
    """The bf16 gap bisected by block: each call of the shared block and
    each mamba block of the smoke model, fed the reference's own input
    (its residual stream before that block), gives the reference's output
    within 2 bf16 ulps of the output's scale.  (The mamba blocks were up
    to 2.12 ulps off until their SiLU, the ``silu`` kernel, took the
    rounding points of the reference's under XLA on the CPU; the shared
    block, with torch's SiLU in its MLP and flash attention, whose scores
    stay float32 where the reference's ``_sdpa`` rounds them to bf16, sits
    at 0.5-2 ulps.)  The end-to-end gap of
    ``test_serving_caches_against_reference`` is this model's own
    amplification of last-ulp differences, as large in the reference's own
    bf16 run against its float32 run."""
    jcfg, cfg = _cfgs("bfloat16")
    jp = jax_params(jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    toks = tokens(cfg, seed=seed)
    b, s = toks.shape
    h = jp["embed"][jnp.asarray(toks)]
    jpos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
    pos = torch.arange(s)[None].expand(b, s)
    worst = {}
    with torch.inference_mode():
        for i in range(cfg.n_layers):
            if i % cfg.hybrid_attn_every == 0:
                want, _ = jax_model.apply_dense_block(jp["shared_attn"], h,
                                                      jcfg, jpos)
                got = port_model.apply_dense_block(
                    params["shared_attn"], tensor_from_numpy(h, "cpu"), cfg,
                    pos)
                worst[f"shared before {i}"] = bf16_ulps(want, got)
                h = want
            jb = jax.tree.map(lambda a: a[i], jp["blocks"])
            tb = port_model.layer_view(params["blocks"], i)
            want, _ = jax_ssm.mamba_block(
                jb, jax_layers.rms_norm(h, jb["pre_norm"], jcfg.norm_eps),
                jcfg)
            got = port_ssm.mamba_block(
                tb, port_layers.rms_norm(tensor_from_numpy(h, "cpu"),
                                         tb["pre_norm"], cfg.norm_eps), cfg)
            worst[f"mamba {i}"] = bf16_ulps(want, got)
            h = h + want
    print(worst)
    assert max(worst.values()) <= 2.0, worst


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_serving_caches_against_reference(dtype):
    """The serving caches (bf16): prefill and 8 teacher-forced decode
    logits, and forward; float32 params within 3e-2 of the reference,
    bf16 params as accurate as the reference against the exact run
    (float32 arithmetic and caches on the same params); every cache leaf
    of the reference's dtype and shape, within 5e-2 of its largest
    magnitude."""
    jcfg, cfg = _cfgs(dtype)
    jp = jax_params(jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    toks = tokens(cfg, seed=1)
    fed = greedy(jcfg, jp, toks)
    jf, jsteps, jcache = jax_run(jcfg, jp, toks, fed, jnp.bfloat16)
    tf, tsteps, tcache = port_run(cfg, params, toks, fed, torch.bfloat16)
    if dtype == "float32":
        for got, want in zip(tsteps, jsteps):
            close(got, want, TOL["bfloat16"])
    else:
        ef, esteps, _ = jax_run(jcfg.replace(param_dtype="float32"),
                                jax.tree.map(lambda a: a.astype(F32), jp),
                                toks, fed, F32)
        as_accurate([tf, *tsteps], [jf, *jsteps], [ef, *esteps])
    for (path, g), (_, w) in zip(cache_leaves(tcache),
                                 cache_leaves(jcache)):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), path
        assert tuple(g.shape) == w.shape, path
        w = np.asarray(w, np.float32)
        scale = CACHE_TOL * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0, atol=scale,
                                   err_msg=path)


def test_init_params_layout_matches_reference(model):
    """Leaf for leaf the same tree, shapes and dtypes; ``shared_attn`` one
    unstacked dense block."""
    _, jcfg, _, cfg, _ = model
    want = jax.eval_shape(lambda: jax_init_params(jcfg,
                                                  jax.random.PRNGKey(0)))
    got = init_params(cfg, device="cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (_, w), (_, g) in zip(flat_w, flat_g):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
    assert got["shared_attn"]["attn"]["wq"].shape == (
        cfg.d_model, cfg.n_heads * cfg.resolved_head_dim)


def test_bridge_round_trips_every_leaf(model):
    _, _, jp, _, params = model
    nparams = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(nparams) == jax.tree.structure(params)
    back = params_to_jax(params)
    for x, y in zip(jax.tree.leaves(nparams), jax.tree.leaves(back)):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_param_count_matches_reference():
    for preset in ("smoke", "full"):
        assert get_config(ARCH, preset).param_count() == \
            jax_get_config(ARCH, preset).param_count()


# ---------------------------------------------------------------------------
# staging: call sites per stage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lo,hi", [(0, 5), (0, 1), (1, 3), (3, 5), (1, 2),
                                   (2, 5), (4, 5), (3, 4), (2, 2)])
def test_stage_slices_match_reference(lo, hi):
    """The call sites before and inside ``[lo, hi)``, which stage carries
    ``shared_attn``, and the stage cache's shapes, as the reference's."""
    jcfg, cfg = _cfgs("bfloat16")
    assert staging._hybrid_apps(cfg, lo, hi) == \
        jax_staging._hybrid_apps(jcfg, lo, hi)
    jp = jax_params(jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    for first, last in ((lo == 0, hi == 5), (False, False)):
        want = jax_staging.extract_stage_params(jcfg, jp, lo, hi, first,
                                                last)
        got = staging.extract_stage_params(cfg, params, lo, hi, first, last)
        assert sorted(got) == sorted(want)
        assert jax.tree.structure(got) == jax.tree.structure(
            jax.tree.map(np.asarray, want))
    want = jax.eval_shape(lambda: jax_staging.init_stage_cache(
        jcfg, lo, hi, 2, 24))
    got = staging.init_stage_cache(cfg, lo, hi, 2, 24, device="meta")
    assert [(p, tuple(x.shape)) for p, x in cache_leaves(got)] == \
        [(p, tuple(x.shape)) for p, x in cache_leaves(want)]


@pytest.mark.parametrize("lo,hi", [(1, 3), (3, 5), (1, 5)])
def test_stage_backbone_matches_reference(lo, hi):
    """A stage that starts off a call site (``lo % 2 == 1``), float32:
    the prefill through blocks ``[lo, hi)`` and its caches, within 1e-5 of
    the reference's stage."""
    jcfg, cfg = _cfgs("float32")
    jp = jax_params(jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    h = np.random.default_rng(lo).standard_normal(
        (2, PROMPT, cfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(PROMPT)[None], (2, PROMPT)).copy()
    jsp = jax_staging.extract_stage_params(jcfg, jp, lo, hi, False, False)
    jc = jax.tree.map(lambda a: a.astype(F32) if a.dtype == jnp.bfloat16
                      else a, jax_staging.init_stage_cache(jcfg, lo, hi, 2,
                                                           PROMPT))
    want, jc = jax_staging.stage_backbone(jcfg, jsp, jnp.asarray(h),
                                          jnp.asarray(pos), {}, jc,
                                          "prefill", lo, hi)
    sp = staging.extract_stage_params(cfg, params, lo, hi, False, False)
    c = as_cache_dtype(staging.init_stage_cache(cfg, lo, hi, 2, PROMPT,
                                                device="cpu"), torch.float32)
    got, c = staging.stage_backbone(cfg, sp, torch.from_numpy(h),
                                    torch.from_numpy(pos), c, lo, hi)
    close(got, want, TOL["float32"])
    for (path, g), (_, w) in zip(cache_leaves(c), cache_leaves(jc)):
        close(g.float() if g.dtype != torch.int32 else g, w,
              TOL["float32"])


# ---------------------------------------------------------------------------
# the flash kernel's plain version at zamba2's head dim
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,valid", [(True, 200), (False, 200),
                                          (True, 150)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_at_head_dim_112_vs_reference(causal, valid, dtype):
    """``flash_ref`` at hd = 112, full MHA (group 1), ragged S, against the
    reference's Pallas kernel in interpret mode (on its folded layout) and
    its attention oracle."""
    import ml_dtypes
    npdt = {"float32": np.float32,
            "bfloat16": np.dtype(ml_dtypes.bfloat16)}[dtype]
    b, s, h, hd = 1, 200, 4, 112
    r = np.random.default_rng(11)
    arrays = [r.standard_normal((b, s, h, hd), dtype=np.float32).astype(npdt)
              for _ in range(3)]
    ts = [tensor_from_numpy(a, "cpu") for a in arrays]
    got = flash_ref(*ts, causal=causal, valid_len=valid)
    assert got.shape == (b, s, h, hd) and got.dtype == ts[0].dtype
    sp = 256
    fold = [np.zeros((b, h, sp, hd), npdt) for _ in arrays]
    for f, a in zip(fold, arrays):
        f[:, :, :s] = a.transpose(0, 2, 1, 3)
    want = flash_attention_pallas(
        *(jnp.asarray(f.reshape(b * h, sp, hd)) for f in fold), group=1,
        causal=causal, valid_len=valid, interpret=True)
    want = np.asarray(want.astype(F32)).reshape(b, h, sp, hd)[
        :, :, :s].transpose(0, 2, 1, 3)
    tol = TOL[dtype] if dtype == "bfloat16" else 2e-5
    close(got.float(), want, tol)
    if valid == s:
        oracle = jax_attention_ref(*map(jnp.asarray, arrays), causal=causal)
        close(got.float(), oracle, tol)


# ---------------------------------------------------------------------------
# the port's pipeline against the port's ServeEngine, and the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def zamba():
    jcfg, cfg = _cfgs("bfloat16")
    jp = jax_params(jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    batch = make_batch(cfg, 3, PROMPT, seed=3)
    eng = ServeEngine(cfg, params, max_len=PROMPT + GEN, kv_block=8)
    want = eng.generate(batch, GEN)
    np.testing.assert_array_equal(
        eng.generate(batch, GEN, engine="reference"), want)
    return jcfg, jp, cfg, params, batch, want


def _pipe(cfg, params, cuts, wire_bits=0):
    plan = core.from_block_cuts(cfg, cuts, spare_nodes=(8, 9),
                                wire_bits=wire_bits)
    return PipelineServeEngine(cfg, params, plan, max_len=PROMPT + GEN,
                               kv_block=8)


# call sites a stage holds: [1, 3] -> 1 / 1 / 1 (the fixture's cell), [1, 2]
# -> 1 / 0 / 2, [3] -> 2 / 1, [1] -> 1 / 2; stages starting off a call site
# at 1 and 3
@pytest.mark.parametrize("cuts,kill", [
    ([1, 3], None), ([1, 2], None), ([3], None), ([1], None),
    ([1, 3], {"after_step": 3, "stage": 1}),
    ([1, 2], [{"after_step": 0, "stage": 2},
              {"after_step": 2, "stage": 1}]),
    ([3], {"after_step": 4, "stage": 1})])
def test_raw_wire_pipeline_equals_serve_engine(zamba, cuts, kill):
    _, _, cfg, params, batch, want = zamba
    eng = _pipe(cfg, params, cuts)
    np.testing.assert_array_equal(eng.generate(batch, GEN, kill=kill), want)
    n_kills = 0 if kill is None else len(kill) if isinstance(kill, list) \
        else 1
    restores = [m for _, m in eng.events if "restored from checkpoint" in m]
    assert len(restores) == n_kills
    for k, (lo, hi) in enumerate(eng.ranges):
        apps = staging._hybrid_apps(cfg, lo, hi)[1]
        assert ("shared_attn" in eng.stage_params[k]) == bool(apps)
        assert ("shared" in eng._fresh_caches(1)[k]) == bool(apps)
        if apps:
            assert eng._fresh_caches(1)[k]["shared"]["k"].shape[0] == apps


def test_restored_stage_brings_its_own_copy_of_the_shared_block(zamba):
    """Each stage with a call site checkpoints the shared block; a
    restored stage gets its copy back from that checkpoint."""
    _, _, cfg, params, batch, want = zamba
    eng = _pipe(cfg, params, [1, 2])
    names = [sorted(k for k in template_of(sp)) for sp in eng.stage_params]
    assert ["shared_attn" in n for n in names] == [True, False, True]
    eng.kill_stage(2)
    eng.restore_stage(2)
    restored = eng.stage_params[2]["shared_attn"]
    assert restored["attn"]["wq"].data_ptr() != \
        params["shared_attn"]["attn"]["wq"].data_ptr()
    for a, b in zip(tree_leaves(restored),
                    tree_leaves(params["shared_attn"])):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(eng.generate(batch, GEN), want)


def test_int8_wire_kill_equals_the_run_without_it(zamba):
    _, _, cfg, params, batch, raw = zamba
    eng = _pipe(cfg, params, [1, 3], wire_bits=8)
    clean = eng.generate(batch, GEN)
    killed = eng.generate(batch, GEN, kill={"after_step": 3, "stage": 1})
    np.testing.assert_array_equal(killed, clean)
    assert any("restored from checkpoint" in m for _, m in eng.events)
    assert clean.shape == raw.shape


def test_tokens_match_reference_pipeline(zamba):
    """The fixture's cut [1, 3]: the port's pipeline against the
    reference's.  Teacher-forced logits as accurate as the reference's
    against the exact run (see the module docstring: 3e-2 is missed
    here); greedy tokens equal wherever the reference's top-1/top-2 gap
    exceeds 2 x 3e-2, and the port's free-running pipeline follows the
    reference stream up to its first step with a smaller gap."""
    jcfg, jp, cfg, params, _, _ = zamba
    tol = TOL["bfloat16"]
    batch = make_batch(cfg, 2, PROMPT, seed=4)
    jbatch = {"tokens": jnp.asarray(batch["tokens"], jnp.int32)}
    jtoks = JaxPipelineServeEngine(
        jcfg, jp, jax_from_block_cuts(jcfg, [1, 3], spare_nodes=(9,)),
        max_len=PROMPT + GEN, kv_block=8).generate(jbatch, GEN)
    mono, jlogits = JaxServeEngine(jcfg, jp, max_len=PROMPT + GEN,
                                   kv_block=8).generate(
        jbatch, GEN, collect_logits=True)
    np.testing.assert_array_equal(mono, jtoks)
    _, esteps, _ = jax_run(jcfg.replace(param_dtype="float32"),
                           jax.tree.map(lambda a: a.astype(F32), jp),
                           batch["tokens"], np.asarray(jtoks), F32)

    cache = init_serve_cache(cfg, 2, PROMPT + GEN, device="cpu")
    with torch.inference_mode():
        logits, cache = prefill(cfg, params, {"tokens": torch.as_tensor(
            batch["tokens"])}, cache)
        steps = [logits]
        for i in range(GEN - 1):
            logits, cache = decode_step(
                cfg, params, torch.as_tensor(jtoks[:, i:i + 1]), cache)
            steps.append(logits)
    tlogits = torch.cat(steps, dim=1).numpy()
    jlogits = np.asarray(jlogits)
    as_accurate([tlogits[:, i] for i in range(GEN)],
                [jlogits[:, i] for i in range(GEN)],
                [esteps[i][:, 0] for i in range(GEN)])

    top2 = np.sort(jlogits, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    flips = [(r, t, float(gap[r, t])) for r, t in zip(*np.nonzero(
        tlogits.argmax(-1) != jtoks))]
    for r, t, g in flips:
        print(f"flip: row {r} step {t} reference top-1/top-2 gap {g:.4g}")
        assert g <= 2 * tol, (r, t, g)

    got = PipelineServeEngine(
        cfg, params, core.from_block_cuts(cfg, [1, 3], spare_nodes=(9,)),
        max_len=PROMPT + GEN, kv_block=8).generate(batch, GEN)
    for r in range(got.shape[0]):
        low = np.nonzero(gap[r] <= 2 * tol)[0]
        upto = low[0] if len(low) else GEN
        np.testing.assert_array_equal(got[r, :upto], jtoks[r, :upto])


def test_launcher_serves_zamba2_on_the_cpu(capsys):
    args = ["--arch", ARCH, "--device", "cpu", "--batch", "2",
            "--prompt-len", "20", "--gen-len", "4"]
    mono = launch_serve.main(args)
    np.testing.assert_array_equal(
        launch_serve.main(args + ["--cuts", "1,3"]), mono)
    assert launch_serve.main(args + ["--cuts", "3", "--wire-bits", "8"]
                             ).shape == mono.shape
    capsys.readouterr()
    streams = launch_serve.main(args + ["--stream", "3"])
    assert "[serve/stream-fast] zamba2-smoke on cpu: 3 requests x 4 " \
        "tokens over 2 slots" in capsys.readouterr().out
    assert [len(t) for t in streams] == [4, 4, 4]
