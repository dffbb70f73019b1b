"""The port's dense models against the reference models on the CPU.

Params come from the reference's ``init_params`` at the smoke configs of
the four dense archs (granite-3-2b cut to 4 layers; minicpm-2b, with its
tied head, deepseek-7b and llama3-405b at their own smoke depths) and cross
to torch through ``params_from_jax``; tokens come from a numpy seed.
Tolerances (``TOL``, on |port - ref| <= tol (1 + |ref|)):

* bfloat16 params — logits within 3e-2 for the tied heads (granite,
  minicpm; seen: 0.0125 in the forward, 0.0098 over prefill and 8
  teacher-forced decode steps; the two packages round bf16 products at
  different places).  The untied heads (deepseek,
  llama3) give logits of rms about 1, where both packages' bf16 runs are
  0.05 apart and as far from the exact run: they are held to the
  reference's own accuracy (``hold``), and each of their blocks to 2 bf16
  ulps of the reference's given the same input;
* float32 params — logits within 5e-6 (seen: 3.3e-6, llama3's forward),
  which pins the algorithm itself: masks, RoPE, GQA, the cache writes and
  the bucketed decode.  granite and deepseek decode through the bf16
  serving caches, as served; minicpm and llama3 through float32 caches
  (``F32_CACHE``).

A multi-token write into a cache that already holds rows (the reference's
``dynamic_update_slice_in_dim`` at ``lens[0]``) is held against the
reference's ``attention``, and a prompt prefilled in two parts against the
same prompt prefilled at once.
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
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro.models import prefill as jax_prefill
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import (decode_step, forward, init_params,
                                init_serve_cache, prefill)
from repro_torch.models import layers
from repro_torch.models.model import (apply_dense_block, layer_view,
                                     lm_logits)
from repro_torch.models.bridge import params_from_jax, tensor_from_numpy
from repro_torch.serve.engine import ServeEngine, make_batch

torch.set_num_threads(2)

TOL = {"bfloat16": 3e-2, "float32": 5e-6}
N_LAYERS = 4
STEPS = 8


DENSE = ["granite-3-2b", "minicpm-2b", "deepseek-7b", "llama3-405b"]
# float32 params whose bf16 serving cache turns the packages' last-ulp
# float32 k/v differences into whole bf16 steps (seen: 3.2e-5 in minicpm's
# decode logits, 1.5e-4 in llama3's); they decode through float32 caches
F32_CACHE = ("minicpm-2b", "llama3-405b")


def _cfgs(dtype, arch="granite-3-2b"):
    depth = {"n_layers": N_LAYERS} if arch == "granite-3-2b" else {}
    return (jax_get_config(arch, "smoke").replace(param_dtype=dtype,
                                                  **depth),
            get_config(arch, "smoke").replace(param_dtype=dtype, **depth))


@pytest.fixture(scope="module", params=[
    pytest.param((arch, dtype), id=dtype if arch == "granite-3-2b"
                 else f"{arch}-{dtype}")
    for arch in DENSE for dtype in ("bfloat16", "float32")])
def model(request):
    arch, dtype = request.param
    jcfg, cfg = _cfgs(dtype, arch)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return dtype, jcfg, jparams, cfg, params


def tokens(cfg, b=2, s=16, seed=0):
    return make_batch(cfg, b, s, seed)["tokens"]


def close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def exact_model(jcfg, jparams):
    """The reference's float32 run on the same (rounded) params."""
    return (jcfg.replace(param_dtype="float32"),
            jax.tree.map(lambda a: a.astype(jnp.float32), jparams))


def hold(got, want, exact, dtype, cfg):
    """Per-step logits (lists): within TOL of the reference — except bf16
    with an untied head, held to the reference's own accuracy (the port's
    largest distance from the reference's float32 run at most twice the
    reference's).  An untied head gives logits of rms about 1 (a tied one
    about 0.16), where both packages' bf16 runs are 0.05-0.06 off the exact
    logits and 0.05 from each other, while each block is within 2 bf16
    ulps of the reference's given the same input
    (``test_each_block_within_two_bf16_ulps_of_the_reference``)."""
    if dtype == "float32" or cfg.tie_embeddings:
        for g, w in zip(got, want):
            close(g, w, TOL[dtype])
        return
    port = max(float(np.abs(np.asarray(g) - np.asarray(e)).max())
               for g, e in zip(got, exact))
    ref = max(float(np.abs(np.asarray(w) - np.asarray(e)).max())
              for w, e in zip(want, exact))
    assert port <= 2 * ref, (port, ref)


def test_forward_logits(model):
    dtype, jcfg, jparams, cfg, params = model
    toks = tokens(cfg)
    want, _ = jax_forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    exact, _ = jax_forward(*exact_model(jcfg, jparams),
                           {"tokens": jnp.asarray(toks)})
    got, (h, _) = forward(cfg, params, {"tokens": torch.as_tensor(toks)})
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert h.dtype == getattr(torch, dtype)
    hold([got], [want], [exact], dtype, cfg)


def f32_cache(cache):
    """A dense serving cache with its bf16 k/v as float32 (``F32_CACHE``)."""
    if isinstance(cache["k"], torch.Tensor):
        def conv(a):
            return a.float()
    else:
        def conv(a):
            return a.astype(jnp.float32)
    return dict(cache, k=conv(cache["k"]), v=conv(cache["v"]))


def test_prefill_and_teacher_forced_decode(model):
    """Prefill logits, then 8 decode steps fed the reference's own greedy
    tokens (teacher forcing), with the port's length-aware bucket.  The
    archs of ``F32_CACHE`` run float32 params with float32 caches in both
    packages, the others on the bf16 serving caches; the exact run that
    ``hold`` reads is float32 throughout."""
    dtype, jcfg, jparams, cfg, params = model
    toks = tokens(cfg, seed=1)
    max_len = toks.shape[1] + STEPS + 8
    batch = {"tokens": jnp.asarray(toks)}
    wide = (dtype == "float32"
            and cfg.name.removesuffix("-smoke") in F32_CACHE)

    def jax_steps(jc, jp, fed=None, f32=wide):
        cache = jax_init_serve_cache(jc, 2, max_len)
        if f32:
            cache = f32_cache(cache)
        logits, cache = jax_prefill(jc, jp, batch, cache)
        out, toks_fed = [logits], []
        for step in range(STEPS):
            t = (jnp.argmax(logits, -1).astype(jnp.int32) if fed is None
                 else fed[step])
            toks_fed.append(t)
            logits, cache = jax_decode_step(jc, jp, t, cache)
            out.append(logits)
        return out, toks_fed, cache

    want, fed, jcache = jax_steps(jcfg, jparams)
    exact = (jax_steps(*exact_model(jcfg, jparams), fed, f32=True)[0]
             if dtype == "bfloat16" else want)
    cache = init_serve_cache(cfg, 2, max_len, device="cpu")
    if wide:
        cache = f32_cache(cache)
    got = []
    with torch.inference_mode():
        tl, cache = prefill(cfg, params, {"tokens": torch.as_tensor(toks)},
                            cache)
        got.append(tl)
        for step in range(STEPS):
            cur = toks.shape[1] + step + 1
            tl, cache = decode_step(cfg, params,
                                    torch.as_tensor(np.array(fed[step])),
                                    cache, kv_bucket=-(-cur // 8) * 8)
            got.append(tl)
    hold(got, want, exact, dtype, cfg)
    np.testing.assert_array_equal(cache["len"].numpy(),
                                  np.asarray(jcache["len"]))


def test_init_params_layout_matches_reference(model):
    """Leaf for leaf the same tree, shapes and dtypes (stacked blocks)."""
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


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("preset", ["full", "smoke"])
def test_param_count_matches_reference(arch, preset):
    """The copied ``ModelConfig.param_count`` against the reference's, tied
    (granite, minicpm, mamba2) and untied; a tied smoke model has no
    ``lm_head`` leaf."""
    cfg = get_config(arch, preset)
    assert cfg.param_count() == jax_get_config(arch, preset).param_count()
    if preset == "smoke":
        params = init_params(cfg, device="cpu")
        assert ("lm_head" in params) == (not cfg.tie_embeddings)


def test_fast_and_reference_loops_agree(model):
    _, _, _, cfg, params = model
    eng = ServeEngine(cfg, params, max_len=40, kv_block=8)
    batch = make_batch(cfg, 3, 12, seed=2)
    fast = eng.generate(batch, 10)
    np.testing.assert_array_equal(fast, eng.generate(batch, 10,
                                                     engine="reference"))
    assert fast.shape == (3, 10) and fast.dtype == np.int32


def bf16_ulps(want, got):
    """|got - want| at its largest, in bf16 ulps of want's largest
    magnitude (the output's scale)."""
    want = np.asarray(want, np.float32)
    ulp = 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)
    return float(np.abs(got.float().numpy() - want).max() / ulp)


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("arch", DENSE)
def test_each_block_within_two_bf16_ulps_of_the_reference(arch, seed):
    """The bf16 gap bisected by block: each block of the smoke model in
    bf16, fed the reference's own input (its residual stream before that
    block), and the head, fed the reference's last residual stream, give
    the reference's output within 2 bf16 ulps of the output's scale.  So
    the untied heads' end-to-end gap that ``hold`` allows is the model's
    own amplification of last-ulp differences, not a departure."""
    jcfg, cfg = _cfgs("bfloat16", arch)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    toks = tokens(cfg, seed=seed)
    b, s = toks.shape
    h = jp["embed"][jnp.asarray(toks)]
    jpos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
    pos = torch.arange(s)[None].expand(b, s)
    worst = {}
    with torch.inference_mode():
        for i in range(cfg.n_layers):
            want, _ = jax_model.apply_dense_block(
                jax.tree.map(lambda a: a[i], jp["blocks"]), h, jcfg, jpos)
            got = apply_dense_block(layer_view(params["blocks"], i),
                                    tensor_from_numpy(h, "cpu"), cfg, pos)
            worst[f"block {i}"] = bf16_ulps(want, got)
            h = want
        worst["head"] = bf16_ulps(
            jax_model.lm_logits(jp, jcfg, h),
            lm_logits(params, cfg, tensor_from_numpy(h, "cpu")))
    print(worst)
    assert max(worst.values()) <= 2.0, worst


# ---------------------------------------------------------------------------
# layers in float32: the same functions step for step
# ---------------------------------------------------------------------------

def _np(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


def test_rms_norm():
    x, w = _np(0, (2, 5, 64)), _np(1, (64,))
    close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
          jax_layers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5), 1e-6)


def test_rope():
    pos = np.arange(12, dtype=np.int32)[None].repeat(2, 0) + 5
    x = _np(2, (2, 12, 4, 16))
    jc, js = jax_layers.rope_tables(jnp.asarray(pos), 16, 10000.0)
    tc, ts = layers.rope_tables(torch.from_numpy(pos), 16, 10000.0)
    close(tc, jc, 1e-6)
    close(ts, js, 1e-6)
    close(layers.apply_rope(torch.from_numpy(x), tc, ts),
          jax_layers.apply_rope(jnp.asarray(x), jc, js), 1e-6)


def test_mlp():
    x = _np(3, (2, 5, 16))
    p = {k: _np(4 + i, s) for i, (k, s) in enumerate(
        [("wg", (16, 32)), ("wu", (16, 32)), ("wd", (32, 16))])}
    close(layers.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(x)),
          jax_layers.mlp({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("bucket", [None, 16])
def test_decode_attention_with_cache(bucket):
    """One decode step through a cache with rows at different lengths: the
    per-row write, the length mask and the bucket slice."""
    jcfg, cfg = _cfgs("float32")
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    p = {k: _np(10 + i, (d, n * hd)) / np.float32(np.sqrt(d))
         for i, (k, n) in enumerate(
        [("wq", cfg.n_heads), ("wk", cfg.n_kv_heads),
         ("wv", cfg.n_kv_heads)])}
    p["wo"] = _np(13, (cfg.n_heads * hd, d)) / np.float32(8.0)
    x = _np(14, (2, 1, cfg.d_model))
    kc = _np(15, (2, 24, cfg.n_kv_heads, hd))
    vc = _np(16, (2, 24, cfg.n_kv_heads, hd))
    lens = np.array([9, 14], np.int32)
    pos = lens[:, None]
    jax_layers.set_decode_kv_bucket(bucket)
    try:
        want, jcache = jax_layers.attention(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg,
            jnp.asarray(pos), cache={"k": jnp.asarray(kc),
                                     "v": jnp.asarray(vc),
                                     "len": jnp.asarray(lens)})
    finally:
        jax_layers.set_decode_kv_bucket(None)
    cache = {"k": tensor_from_numpy(kc, "cpu"),
             "v": tensor_from_numpy(vc, "cpu"),
             "len": tensor_from_numpy(lens, "cpu")}
    got = layers.attention({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), cfg, torch.from_numpy(pos),
                           cache=cache, kv_bucket=bucket)
    close(got, want, 1e-5)
    for key in ("k", "v"):                    # the new rows: 1-ulp matmuls
        close(cache[key].numpy(), jcache[key], 1e-5)
    np.testing.assert_array_equal(cache["len"].numpy(), [10, 15])
    np.testing.assert_array_equal(np.asarray(jcache["len"]), [10, 15])


def _attn_params(cfg, dtype, seed=20):
    hd, d = cfg.resolved_head_dim, cfg.d_model
    p = {k: _np(seed + i, (d, n * hd)) / np.float32(np.sqrt(d))
         for i, (k, n) in enumerate([("wq", cfg.n_heads),
                                     ("wk", cfg.n_kv_heads),
                                     ("wv", cfg.n_kv_heads)])}
    p["wo"] = _np(seed + 3, (cfg.n_heads * hd, d)) / np.float32(8.0)
    return {k: v.astype(jnp.bfloat16) if dtype == "bfloat16" else v
            for k, v in p.items()}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_multi_token_write_into_a_filled_cache(dtype):
    """A 5-token write into a cache whose rows hold 7 tokens: written at
    row 7 (the reference's ``lens[0]``), attending over the whole cache
    with the causal mask from position 7; rows of different lengths are
    refused."""
    jcfg, cfg = _cfgs(dtype)
    hd = cfg.resolved_head_dim
    p = _attn_params(cfg, dtype)
    x = _np(30, (2, 5, cfg.d_model))
    x = x.astype(jnp.bfloat16) if dtype == "bfloat16" else x
    kc = _np(31, (2, 24, cfg.n_kv_heads, hd)).astype(jnp.bfloat16)
    vc = _np(32, (2, 24, cfg.n_kv_heads, hd)).astype(jnp.bfloat16)
    lens = np.array([7, 7], np.int32)
    pos = 7 + np.arange(5, dtype=np.int32)[None].repeat(2, 0)
    want, jcache = jax_layers.attention(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg,
        jnp.asarray(pos), cache={"k": jnp.asarray(kc), "v": jnp.asarray(vc),
                                 "len": jnp.asarray(lens)})
    tp = {k: tensor_from_numpy(v, "cpu") for k, v in p.items()}
    cache = {"k": tensor_from_numpy(kc, "cpu"),
             "v": tensor_from_numpy(vc, "cpu"),
             "len": tensor_from_numpy(lens, "cpu")}
    with torch.inference_mode():
        got = layers.attention(tp, tensor_from_numpy(x, "cpu"), cfg,
                               torch.from_numpy(pos), cache=cache)
    close(got.float(), want, TOL[dtype])
    for key in ("k", "v"):
        close(cache[key].float().numpy(), jcache[key], TOL[dtype])
        np.testing.assert_array_equal(                 # rows 0..6 untouched
            cache[key][:, :7].float().numpy(),
            np.asarray(kc if key == "k" else vc, np.float32)[:, :7])
    np.testing.assert_array_equal(cache["len"].numpy(), [12, 12])
    cache["len"] = torch.tensor([7, 8], dtype=torch.int32)
    with pytest.raises(ValueError, match="one length"):
        layers.attention(tp, tensor_from_numpy(x, "cpu"), cfg,
                         torch.from_numpy(pos), cache=cache)
    cache["len"] = torch.tensor([20, 20], dtype=torch.int32)
    with pytest.raises(ValueError, match="does not fit"):
        layers.attention(tp, tensor_from_numpy(x, "cpu"), cfg,
                         torch.from_numpy(pos), cache=cache)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_prompt_prefilled_in_two_parts(dtype):
    """A 16-token prompt through a dense block in two parts (9 tokens into
    a fresh cache, through flash, then 7 into the filled cache, in plain
    ops) against the same prompt at once: outputs and caches within the
    dtype's tolerance, the lengths equal."""
    _, cfg = _cfgs(dtype)
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(0)
    block = layer_view(init_params(cfg, gen, device="cpu")["blocks"], 0)
    h = torch.from_numpy(_np(40, (2, 16, cfg.d_model))).to(dt)
    pos = torch.arange(16)[None].expand(2, 16)

    def fresh():
        return layer_view(init_serve_cache(cfg, 2, 24, device="cpu"), 0)

    with torch.inference_mode():
        whole_cache, parts_cache = fresh(), fresh()
        whole = apply_dense_block(block, h, cfg, pos, cache=whole_cache)
        first = apply_dense_block(block, h[:, :9], cfg, pos[:, :9],
                                  cache=parts_cache)
        second = apply_dense_block(block, h[:, 9:], cfg, pos[:, 9:],
                                   cache=parts_cache)
    close(torch.cat([first, second], 1).float(), whole.float(), TOL[dtype])
    for key in ("k", "v"):
        close(parts_cache[key].float(), whole_cache[key].float(),
              TOL["bfloat16"])              # bf16 caches in both dtypes
    np.testing.assert_array_equal(parts_cache["len"].numpy(), [16, 16])
    np.testing.assert_array_equal(whole_cache["len"].numpy(), [16, 16])


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    _, cfg = _cfgs("bfloat16")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_serve_cache(cfg, 1, 8)
