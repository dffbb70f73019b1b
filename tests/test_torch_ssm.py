"""The port's SSM family (mamba2) against the reference on the CPU.

Inputs come from numpy seeds; model params come from the reference's
``init_params`` at the mamba2-1.3b smoke config deepened to 4 layers (as
the serve-equivalence fixture deepens it) and cross to torch through
``params_from_jax``.  Tolerances:

* the SSD plain versions against the reference's ``ssd_ref``,
  ``ssd_chunked`` and ``ssd_scan`` (Pallas in interpret mode) — 2e-4, the
  reference's own kernel tolerance (``tests/test_kernels.py``);
* float32 params — logits and cache leaves within 1e-5 (seen: under
  2e-6), which pins the algorithm: the causal convolution and its buffer,
  the chunked scan across chunk boundaries, the decode recurrence;
* bfloat16 params — logits within 3e-2 (the largest difference seen over
  forward, prefill and 8 teacher-forced decode steps is about 1.4e-2: the
  two packages round bf16 products at different places); cache leaves
  within 5e-2 of the leaf's largest magnitude (seen up to 3.6e-2 over four
  prompts: the convolution buffer and the state hold projections of a
  residual that has already drifted by a few bf16 steps);
* pipelines: the raw wire bit-identical to the port's ``ServeEngine``
  across a stage kill, an int8-wire kill identical to the same run without
  it, and against the reference's ``PipelineServeEngine`` the matching rule
  of ``tests/test_torch_serve.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import from_block_cuts as jax_from_block_cuts
from repro.kernels.ssd.ops import ssd_scan as jax_ssd_scan
from repro.kernels.ssd.ref import ssd_ref as jax_ssd_ref
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import init_serve_cache as jax_init_serve_cache
from repro.models import prefill as jax_prefill
from repro.models import ssm as jax_ssm
from repro.serve import PipelineServeEngine as JaxPipelineServeEngine
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch import core
from repro_torch.configs import get_config
from repro_torch.kernels.silu.ref import causal_conv
from repro_torch.kernels.ssd import ref as ssd_ref_mod
from repro_torch.kernels.ssd.ops import ssd_scan
from repro_torch.launch import serve as launch_serve
from repro_torch.models import (decode_step, forward, init_params,
                                init_serve_cache, prefill)
from repro_torch.models import ssm
from repro_torch.models.bridge import params_from_jax
from repro_torch.serve.engine import ServeEngine, make_batch
from repro_torch.serve.pipeline import PipelineServeEngine

torch.set_num_threads(2)

SSD_TOL = 2e-4
TOL = {"bfloat16": 3e-2, "float32": 1e-5}
CACHE_TOL = {"bfloat16": 5e-2, "float32": 1e-5}    # of the leaf's max |.|
N_LAYERS = 4
STEPS = 8
PROMPT, GEN = 20, 8          # a prompt of one full and one ragged chunk


def close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def ssd_inputs(seed, b, s, h, p, n):
    """The reference sweep's input distribution, from a numpy seed."""
    r = np.random.default_rng(seed)
    f32 = np.float32
    xh = r.standard_normal((b, s, h, p), dtype=f32)
    dt = np.logaddexp(r.standard_normal((b, s, h), dtype=f32), f32(0))
    A = -np.exp(r.standard_normal(h, dtype=f32) * f32(0.3))
    Bm = r.standard_normal((b, s, n), dtype=f32) * f32(0.5)
    Cm = r.standard_normal((b, s, n), dtype=f32) * f32(0.5)
    return xh, dt, A, Bm, Cm


# ---------------------------------------------------------------------------
# the SSD plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [128, 200, 384])
@pytest.mark.parametrize("p,n", [(16, 32), (64, 128), (32, 16)])
def test_ssd_plain_versions_match_reference(s, p, n):
    """The wrapper on the CPU (the chunked plain version at the kernel's
    chunk of 128) against the reference kernel in interpret mode, and the
    sequential recurrences against each other."""
    ins = ssd_inputs(s + p + n, 2, s, 3, p, n)
    y, st = ssd_scan(*map(torch.from_numpy, ins), 128)
    jy, jst = jax_ssd_scan(*map(jnp.asarray, ins))
    close(y, jy, SSD_TOL)
    close(st, jst, SSD_TOL)
    ry, rst = ssd_ref_mod.ssd_ref(*map(torch.from_numpy, ins))
    jry, jrst = jax_ssd_ref(*map(jnp.asarray, ins))
    close(ry, jry, SSD_TOL)
    close(rst, jrst, SSD_TOL)
    close(y, ry, SSD_TOL)


@pytest.mark.parametrize("s,chunk", [(256, 128), (40, 16), (12, 16)])
def test_ssd_chunked_matches_model_chunked(s, chunk):
    """The chunked plain version against the reference model's
    ``ssd_chunked`` (the function the port's model runs), including a
    prompt shorter than the chunk."""
    ins = ssd_inputs(s, 1, s, 2, 16, 32)
    y, st = ssd_ref_mod.ssd_chunked(*map(torch.from_numpy, ins), chunk)
    jy, jst = jax_ssm.ssd_chunked(*map(jnp.asarray, ins), chunk)
    close(y, jy, SSD_TOL)
    close(st, jst, SSD_TOL)


# ---------------------------------------------------------------------------
# the bf16 kernel's precision design, emulated on the CPU
# ---------------------------------------------------------------------------

def _bf16(t):
    return t.to(torch.bfloat16).float()


def _terms(v, rounding):
    """A float32 operand as the kernel feeds it to the bf16 tensor cores:
    "split" into bf16 hi and lo (two products), "once" rounded to bf16, or
    "exact" (float32, the plain version's arithmetic)."""
    if rounding == "exact":
        return [v]
    hi = _bf16(v)
    return [hi, _bf16(v - hi)] if rounding == "split" else [hi]


def emulate_bf16_kernel(xh, dt, A, Bm, Cm, chunk, weights="split",
                        xw="split", state="split"):
    """The bf16 kernel's arithmetic (``csrc/ssd.cu``) in plain PyTorch: x,
    B and C exact bf16; every product with a float32 operand (the weights
    C B^T o L o dt, x o w with w = dt exp(cs_last - cs), the state) as
    bf16 terms of that operand times the exact bf16 one, summed in float32;
    y rounded to bf16 once at the end."""
    b, s, h, p = xh.shape
    n = Bm.shape[-1]
    xf, bf, cf = xh.float(), Bm.float(), Cm.float()
    y = torch.zeros(b, s, h, p)
    st = torch.zeros(b, h, p, n)
    for t0 in range(0, s, chunk):
        t1 = min(s, t0 + chunk)
        xc, bc, cc, dtc = xf[:, t0:t1], bf[:, t0:t1], cf[:, t0:t1], \
            dt[:, t0:t1]
        cs = torch.cumsum(dtc * A, dim=1).permute(0, 2, 1)      # (b,h,l)
        causal = torch.ones(t1 - t0, t1 - t0, dtype=torch.bool).tril()
        L = torch.exp(cs[..., :, None] - cs[..., None, :])
        W = (cc @ bc.transpose(1, 2))[:, None] * L.masked_fill(~causal, 0) \
            * dtc.permute(0, 2, 1)[:, :, None, :]               # (b,h,l,l)
        xt = xc.permute(0, 2, 1, 3)                             # (b,h,l,p)
        y_in = sum(t @ xt for t in _terms(W, weights))
        y_off = sum(cc[:, None] @ t.transpose(-1, -2)
                    for t in _terms(st, state)) * torch.exp(cs)[..., None]
        y[:, t0:t1] = (y_in + y_off).permute(0, 2, 1, 3)
        w = torch.exp(cs[..., -1:] - cs) * dtc.permute(0, 2, 1)  # (b,h,l)
        upd = sum(t.transpose(-1, -2) @ bc[:, None]
                  for t in _terms(xt * w[..., None], xw))
        st = st * torch.exp(cs[..., -1])[..., None, None] + upd
    return _bf16(y), st


def bf16_kernel_inputs(seed, b, s, h, p, n, dt_scale=1.0):
    """The card's input distribution (``tests/test_torch_cuda.py``): x, B
    and C in bf16, dt and A float32; ``dt_scale`` > 1 gives a state of large
    magnitude."""
    r = np.random.default_rng(seed)
    conv = r.standard_normal((b, s, h * p + 2 * n), dtype=np.float32)
    conv[..., h * p:] *= 0.5
    conv = torch.from_numpy(conv).bfloat16()
    dt = torch.nn.functional.softplus(
        torch.from_numpy(r.standard_normal((b, s, h), dtype=np.float32)))
    A = -torch.exp(torch.from_numpy(r.standard_normal(h, dtype=np.float32))
                   * 0.3)
    return (conv[..., :h * p].reshape(b, s, h, p), dt * dt_scale,
            A / dt_scale ** 2, conv[..., h * p:h * p + n],
            conv[..., h * p + n:])


def ssd_rel_errors(got, want):
    """max |got - want| / (1 + |want|) on y and on the state."""
    return tuple(((g.float() - w.float()).abs() / (1 + w.float().abs()))
                 .max().item() for g, w in zip(got, want))


# the card's tolerances, each times 1 + |plain|: bf16 y, the float32 state
CARD_TOL = (1e-2, 2e-4)
KERNEL_SHAPE = (1, 512, 4, 64, 128)          # B, S, H, P, N; Q = 128


def test_bf16_emulation_in_float32_is_the_plain_version():
    """With every operand left in float32 the emulation is the function
    ``ssd_chunked`` computes (so the tests below measure rounding only)."""
    ins = bf16_kernel_inputs(0, *KERNEL_SHAPE)
    got = emulate_bf16_kernel(*ins, 128, "exact", "exact", "exact")
    ey, es = ssd_rel_errors(got, ssd_ref_mod.ssd_chunked(*ins, 128))
    assert ey <= 2 ** -7 and es <= 1e-6, (ey, es)


@pytest.mark.parametrize("dt_scale", [1.0, 8.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_kernel_split_arithmetic_meets_card_tolerances(seed, dt_scale):
    """bf16 C, B and x, and the weights, x o w and the state each split
    into bf16 hi + lo, as the kernel does them: within the card's
    tolerances of the plain version at the mamba2 head shape (P = 64, N =
    128, Q = 128, S = 512), also with a state of large magnitude."""
    ins = bf16_kernel_inputs(seed, *KERNEL_SHAPE, dt_scale=dt_scale)
    ey, es = ssd_rel_errors(emulate_bf16_kernel(*ins, 128),
                            ssd_ref_mod.ssd_chunked(*ins, 128))
    assert ey <= CARD_TOL[0] and es <= CARD_TOL[1], (ey, es)


@pytest.mark.parametrize("operand,where", [
    ("weights", 0), ("xw", 1), ("state", 0)])
def test_one_bf16_rounding_misses_card_tolerances(operand, where):
    """Why each float32 operand is split: rounded to bf16 once, each of
    them alone puts y (``where`` 0) or the state (1) outside the card's
    tolerance on a state of large magnitude."""
    ins = bf16_kernel_inputs(0, *KERNEL_SHAPE, dt_scale=8.0)
    errs = ssd_rel_errors(emulate_bf16_kernel(*ins, 128, **{operand: "once"}),
                          ssd_ref_mod.ssd_chunked(*ins, 128))
    assert errs[where] > CARD_TOL[where], errs


# ---------------------------------------------------------------------------
# mamba_block and the model
# ---------------------------------------------------------------------------

def _cfgs(dtype):
    return (jax_get_config("mamba2-1.3b", "smoke").replace(
                n_layers=N_LAYERS, param_dtype=dtype),
            get_config("mamba2-1.3b", "smoke").replace(
                n_layers=N_LAYERS, param_dtype=dtype))


@pytest.fixture(scope="module", params=["bfloat16", "float32"])
def model(request):
    dtype = request.param
    jcfg, cfg = _cfgs(dtype)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return dtype, jcfg, jparams, cfg, params


def tokens(cfg, b=2, s=PROMPT, seed=0):
    return make_batch(cfg, b, s, seed)["tokens"]


def test_causal_conv():
    r = np.random.default_rng(0)
    x = r.standard_normal((2, 9, 12), dtype=np.float32)
    w = r.standard_normal((4, 12), dtype=np.float32)
    b = r.standard_normal(12, dtype=np.float32)
    close(causal_conv(*map(torch.from_numpy, (x, w, b))),
          jax_ssm._causal_conv(*map(jnp.asarray, (x, w, b))), 1e-6)


def test_mamba_block_cacheless_prefill_and_decode():
    """One float32 block, the three branches: no cache, prefill into a
    fresh cache, and a decode step from it."""
    jcfg, cfg = _cfgs("float32")
    bp = jax.tree.map(lambda a: a[1], jax_init_params(
        jcfg, jax.random.PRNGKey(1))["blocks"])
    tp = params_from_jax(jax.tree.map(np.asarray, bp), "cpu")
    r = np.random.default_rng(2)
    x = r.standard_normal((2, 19, cfg.d_model), dtype=np.float32)
    x1 = r.standard_normal((2, 1, cfg.d_model), dtype=np.float32)
    want, _ = jax_ssm.mamba_block(bp, jnp.asarray(x), jcfg)
    close(ssm.mamba_block(tp, torch.from_numpy(x), cfg), want, TOL["float32"])

    jc = jax_ssm.init_mamba_cache(jcfg, 2)
    want, jc = jax_ssm.mamba_block(bp, jnp.asarray(x), jcfg, cache=jc)
    c = {k: v[0] for k, v in ssm.init_mamba_cache(cfg, 1, 2,
                                                   device="cpu").items()}
    close(ssm.mamba_block(tp, torch.from_numpy(x), cfg, cache=c), want,
          TOL["float32"])
    want, jc = jax_ssm.mamba_block(bp, jnp.asarray(x1), jcfg, cache=jc)
    close(ssm.mamba_block(tp, torch.from_numpy(x1), cfg, cache=c), want,
          TOL["float32"])
    for k in ("conv_buf", "state"):
        close(c[k], jc[k], TOL["float32"])
    np.testing.assert_array_equal(c["len"].numpy(), [20, 20])


def test_forward_logits(model):
    dtype, jcfg, jparams, cfg, params = model
    toks = tokens(cfg)
    want, _ = jax_forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    got, (h, _) = forward(cfg, params, {"tokens": torch.as_tensor(toks)})
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert h.dtype == getattr(torch, dtype)
    close(got, want, TOL[dtype])


def test_prefill_cache_and_teacher_forced_decode(model):
    """Prefill logits and the cache it leaves (conv_buf in the activation
    dtype, as the reference's concatenate promotes it), then 8 decode steps
    fed the reference's own greedy tokens."""
    dtype, jcfg, jparams, cfg, params = model
    toks = tokens(cfg, seed=1)
    max_len = PROMPT + STEPS + 8
    jcache = jax_init_serve_cache(jcfg, 2, max_len)
    jl, jcache = jax_prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                             jcache)
    cache = init_serve_cache(cfg, 2, max_len, device="cpu")
    with torch.inference_mode():
        tl, cache = prefill(cfg, params, {"tokens": torch.as_tensor(toks)},
                            cache)
        close(tl, jl, TOL[dtype])
        for key in ("conv_buf", "state"):
            got, want = cache["mamba"][key], jcache["mamba"][key]
            assert str(got.dtype).replace("torch.", "") == str(want.dtype)
            assert tuple(got.shape) == tuple(want.shape)
            want = np.asarray(want, np.float32)
            scale = CACHE_TOL[dtype] * max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                       atol=scale)
        assert cache["mamba"]["conv_buf"].dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(cache["mamba"]["len"].numpy(),
                                      np.asarray(jcache["mamba"]["len"]))
        for step in range(STEPS):
            fed = jnp.argmax(jl, -1).astype(jnp.int32)
            jl, jcache = jax_decode_step(jcfg, jparams, fed, jcache)
            tl, cache = decode_step(cfg, params,
                                    torch.as_tensor(np.array(fed)), cache,
                                    kv_bucket=8)
            close(tl, jl, TOL[dtype])
    np.testing.assert_array_equal(cache["mamba"]["len"].numpy(),
                                  np.asarray(jcache["mamba"]["len"]))


def test_init_params_layout_matches_reference(model):
    """Leaf for leaf the same tree, shapes and dtypes (A_log, D and
    dt_bias float32 in a bf16 model)."""
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
# the port's pipeline against the port's ServeEngine, and the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba():
    jcfg, cfg = _cfgs("bfloat16")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    batch = make_batch(cfg, 3, PROMPT, seed=3)
    eng = ServeEngine(cfg, params, max_len=PROMPT + GEN, kv_block=8)
    return jcfg, jparams, cfg, params, batch, eng.generate(batch, GEN)


def _pipe(cfg, params, cuts, wire_bits=0):
    plan = core.from_block_cuts(cfg, cuts, spare_nodes=(8, 9),
                                wire_bits=wire_bits)
    return PipelineServeEngine(cfg, params, plan, max_len=PROMPT + GEN,
                               kv_block=8)


@pytest.mark.parametrize("cuts,kill", [
    ([1], None), ([2], None), ([3], None),
    ([2], {"after_step": 3, "stage": 1})])
def test_raw_wire_pipeline_equals_serve_engine(mamba, cuts, kill):
    _, _, cfg, params, batch, want = mamba
    eng = _pipe(cfg, params, cuts)
    np.testing.assert_array_equal(eng.generate(batch, GEN, kill=kill), want)
    restores = [m for _, m in eng.events if "restored from checkpoint" in m]
    assert len(restores) == (kill is not None)


def test_int8_wire_kill_equals_the_run_without_it(mamba):
    _, _, cfg, params, batch, raw = mamba
    eng = _pipe(cfg, params, [2], wire_bits=8)
    clean = eng.generate(batch, GEN)
    killed = eng.generate(batch, GEN, kill={"after_step": 3, "stage": 1})
    np.testing.assert_array_equal(killed, clean)
    assert any("restored from checkpoint" in m for _, m in eng.events)
    assert clean.shape == raw.shape


def test_tokens_match_reference_pipeline(mamba):
    """Teacher-forced logits within 3e-2 of the reference's; greedy tokens
    equal wherever the reference's top-1/top-2 gap exceeds twice that; the
    port's pipeline follows the reference stream up to its first step with
    a smaller gap."""
    jcfg, jparams, cfg, params, _, _ = mamba
    tol = TOL["bfloat16"]
    batch = make_batch(cfg, 2, PROMPT, seed=4)
    jbatch = {"tokens": jnp.asarray(batch["tokens"], jnp.int32)}
    jtoks = JaxPipelineServeEngine(
        jcfg, jparams, jax_from_block_cuts(jcfg, [2], spare_nodes=(9,)),
        max_len=PROMPT + GEN, kv_block=8).generate(jbatch, GEN)
    mono, jlogits = JaxServeEngine(jcfg, jparams, max_len=PROMPT + GEN,
                                   kv_block=8).generate(
        jbatch, GEN, collect_logits=True)
    np.testing.assert_array_equal(mono, jtoks)

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
    np.testing.assert_allclose(tlogits, jlogits, rtol=tol, atol=tol)

    top2 = np.sort(jlogits, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    flips = [(r, t, float(gap[r, t])) for r, t in zip(*np.nonzero(
        tlogits.argmax(-1) != jtoks))]
    for r, t, g in flips:
        print(f"flip: row {r} step {t} reference top-1/top-2 gap {g:.4g}")
        assert g <= 2 * tol, (r, t, g)

    got = PipelineServeEngine(
        cfg, params, core.from_block_cuts(cfg, [2], spare_nodes=(9,)),
        max_len=PROMPT + GEN, kv_block=8).generate(batch, GEN)
    for r in range(got.shape[0]):
        low = np.nonzero(gap[r] <= 2 * tol)[0]
        upto = low[0] + 1 if len(low) else GEN
        np.testing.assert_array_equal(got[r, :upto], jtoks[r, :upto])


def test_launcher_serves_mamba2_on_the_cpu():
    args = ["--arch", "mamba2-1.3b", "--device", "cpu", "--batch", "2",
            "--prompt-len", "20", "--gen-len", "4"]
    mono = launch_serve.main(args)
    np.testing.assert_array_equal(launch_serve.main(args + ["--cuts", "1"]),
                                  mono)
