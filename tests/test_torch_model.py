"""The port's dense model against the reference model on the CPU.

Params come from the reference's ``init_params`` at the granite-3-2b smoke
config cut to 4 layers and cross to torch through ``params_from_jax``;
tokens come from a numpy seed.  Tolerances, measured on this config:

* bfloat16 params — logits within 3e-2 (the largest difference seen over
  forward, prefill and 8 teacher-forced decode steps is about 1e-2; the
  two packages round bf16 products at different places);
* float32 params — logits within 1e-5 (seen: under 1e-6), which pins the
  algorithm itself: masks, RoPE, GQA, the cache writes and the bucketed
  decode.
"""

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
from repro.models import prefill as jax_prefill
from repro_torch.configs import get_config
from repro_torch.models import (decode_step, forward, init_params,
                                init_serve_cache, prefill)
from repro_torch.models import layers
from repro_torch.models.bridge import params_from_jax, tensor_from_numpy
from repro_torch.serve.engine import ServeEngine, make_batch

torch.set_num_threads(2)

TOL = {"bfloat16": 3e-2, "float32": 1e-5}
N_LAYERS = 4
STEPS = 8


def _cfgs(dtype):
    return (jax_get_config("granite-3-2b", "smoke").replace(
                n_layers=N_LAYERS, param_dtype=dtype),
            get_config("granite-3-2b", "smoke").replace(
                n_layers=N_LAYERS, param_dtype=dtype))


@pytest.fixture(scope="module", params=["bfloat16", "float32"])
def model(request):
    dtype = request.param
    jcfg, cfg = _cfgs(dtype)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return dtype, jcfg, jparams, cfg, params


def tokens(cfg, b=2, s=16, seed=0):
    return make_batch(cfg, b, s, seed)["tokens"]


def close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def test_forward_logits(model):
    dtype, jcfg, jparams, cfg, params = model
    toks = tokens(cfg)
    want, _ = jax_forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    got, (h, _) = forward(cfg, params, {"tokens": torch.as_tensor(toks)})
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert h.dtype == getattr(torch, dtype)
    close(got, want, TOL[dtype])


def test_prefill_and_teacher_forced_decode(model):
    """Prefill logits, then 8 decode steps fed the reference's own greedy
    tokens (teacher forcing), with the port's length-aware bucket."""
    dtype, jcfg, jparams, cfg, params = model
    toks = tokens(cfg, seed=1)
    max_len = toks.shape[1] + STEPS + 8
    jcache = jax_init_serve_cache(jcfg, 2, max_len)
    jl, jcache = jax_prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                             jcache)
    cache = init_serve_cache(cfg, 2, max_len, device="cpu")
    with torch.inference_mode():
        tl, cache = prefill(cfg, params, {"tokens": torch.as_tensor(toks)},
                            cache)
        close(tl, jl, TOL[dtype])
        for step in range(STEPS):
            fed = jnp.argmax(jl, -1).astype(jnp.int32)
            jl, jcache = jax_decode_step(jcfg, jparams, fed, jcache)
            cur = toks.shape[1] + step + 1
            tl, cache = decode_step(cfg, params,
                                    torch.as_tensor(np.array(fed)), cache,
                                    kv_bucket=-(-cur // 8) * 8)
            close(tl, jl, TOL[dtype])
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


def test_fast_and_reference_loops_agree(model):
    _, _, _, cfg, params = model
    eng = ServeEngine(cfg, params, max_len=40, kv_block=8)
    batch = make_batch(cfg, 3, 12, seed=2)
    fast = eng.generate(batch, 10)
    np.testing.assert_array_equal(fast, eng.generate(batch, 10,
                                                     engine="reference"))
    assert fast.shape == (3, 10) and fast.dtype == np.int32


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


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    _, cfg = _cfgs("bfloat16")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_serve_cache(cfg, 1, 8)
