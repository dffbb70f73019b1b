"""The fused passes around the mamba block and the norms, on the CPU.

The mamba block's conv pass (``kernels.silu.ops.conv_silu``: the causal
conv, its bias and SiLU, and the shift of ``conv_buf``), its tail
(``gated_rms_norm_rows``: the skip, the SiLU gate and the norm) and the
dense block's residual add before ``ln2`` (``residual_rms_norm_rows``) are
one kernel each on the card.  Their plain versions are the expressions the
model computed before, op for op, so on the CPU the model's bits do not
move: that is held here against those expressions written out as they
stood (``old_*``), in bf16 and float32 over several seeds, and the blocks
against the JAX package at the tolerances of ``tests/test_torch_decode.py``
(2e-5 in float32, 3e-2 in bfloat16).  The norm's plan is a function of D
and the type alone; an emulation of the kernel's arithmetic under it (a
thread's fmaf chain over its 16-byte units, the warp's xor tree, the
row's warps in order) stays within 3e-2 (1 + |plain|) of the plain version
in bf16.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.models import model as jax_model
from repro.models import ssm as jax_ssm
from repro_torch.configs import get_config
from repro_torch.kernels.decode import ops as dec_ops
from repro_torch.kernels.decode import ref as dec_ref
from repro_torch.kernels.silu import ops as silu_ops
from repro_torch.kernels.silu.ref import silu_ref
from repro_torch.models import model as port_model
from repro_torch.models import ssm as port_ssm
from repro_torch.models.bridge import (params_from_jax, tensor_from_numpy,
                                       tensor_to_numpy)

torch.set_num_threads(2)

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
DTYPES = ["float32", "bfloat16"]
SEEDS = range(3)


def arr(seed, *shape, scale=1.0, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * scale
    return x.astype(jnp.bfloat16) if dtype == "bfloat16" else x


def t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def same_bits(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(a.contiguous().view(-1).view(torch.uint8),
                       b.contiguous().view(-1).view(torch.uint8))


def close(got, want, dtype):
    np.testing.assert_allclose(
        np.asarray(tensor_to_numpy(got), np.float32),
        np.asarray(want, np.float32), rtol=TOL[dtype], atol=TOL[dtype])


# ---------------------------------------------------------------------------
# the model's code as it stood before the fused kernels
# ---------------------------------------------------------------------------

def old_rms_norm(x, w, eps):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def old_conv(conv_buf, conv_in, w, b):
    """``mamba_block``'s conv and its SiLU, both branches."""
    s = conv_in.shape[1]
    if conv_buf is None:
        k = w.shape[0]
        xp = F.pad(conv_in, (0, 0, k - 1, 0))
        conv = sum(xp[:, i:i + s, :] * w[i][None, None, :]
                   for i in range(k)) + b[None, None, :]
    else:
        kw = w.shape[0]
        buf = torch.cat([conv_buf, conv_in], dim=1)
        conv = sum(buf[:, i:i + s, :] * w[i][None, None, :]
                   for i in range(kw)) + b[None, None, :]
        conv_buf.copy_(buf[:, -(kw - 1):, :])
    return silu_ref(conv)


def old_tail(y, D, xh, z, w, eps, x_dtype):
    b, s, h, p = y.shape
    y = y + D[None, None, :, None].to(y.dtype) * xh.to(y.dtype)
    y = y.reshape(b, s, h * p).to(x_dtype)
    return old_rms_norm(y * silu_ref(z), w, eps)


def conv_case(seed, b, s, c, k, dtype, row_pad=7):
    """conv_in as a slice of a wider in_proj-like row, history, w, b."""
    row = t(arr(seed, b, s, c + 2 * row_pad, dtype=dtype))
    conv_in = row[..., row_pad:row_pad + c]
    hist = t(arr(seed + 1, b, k - 1, c, dtype=dtype))
    w = t(arr(seed + 2, k, c, scale=0.5, dtype=dtype))
    bias = t(arr(seed + 3, c, scale=0.1, dtype=dtype))
    return conv_in, hist, w, bias


def test_bf16_reciprocals_lie_far_from_bf16_midpoints():
    """The shared SiLU (``csrc/silu.cuh``) rounds ``rcp.approx(d)`` to bf16
    in place of the IEEE 1 / d.  d is a bf16 value, m 2^k with one of 128
    mantissas; each rn(1 / m) in float32 lies at least 129 bit patterns
    from a bf16 rounding midpoint, so a reciprocal within one ulp rounds to
    the same bf16."""
    m = 1 + np.arange(128, dtype=np.float32) / 128
    r = (np.float32(1) / m).astype(np.float32)
    low = (r.view(np.uint32) & 0xffff).astype(np.int64)
    assert np.abs(low - 0x8000).min() >= 129


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("s", [1, 2, 9])
@pytest.mark.parametrize("dtype", DTYPES)
def test_conv_silu_plain_is_the_old_chain(seed, s, dtype):
    """With a cache (the decode step at s = 1, a prefill at s > 1, also one
    shorter than the history) and without one: the output and the shifted
    conv_buf bit-equal to the old chain."""
    conv_in, hist, w, bias = conv_case(10 * seed, 3, s, 24, 4, dtype)
    new_buf, old_buf = hist.clone(), hist.clone()
    same_bits(silu_ops.conv_silu(new_buf, conv_in, w, bias),
              old_conv(old_buf, conv_in, w, bias))
    same_bits(new_buf, old_buf)
    same_bits(silu_ops.conv_silu(None, conv_in, w, bias),
              old_conv(None, conv_in, w, bias))


def test_conv_silu_sums_taps_from_zero():
    """Python's sum starts from 0: a -0 product (a zero input against a
    negative weight) leaves +0, which the kernel reproduces."""
    x = torch.zeros(1, 1, 8, dtype=torch.bfloat16)
    w = -torch.ones(4, 8, dtype=torch.bfloat16)
    out = silu_ops.conv_silu(None, x, w, torch.zeros(8, dtype=x.dtype))
    assert not torch.signbit(out.float()).any()
    assert torch.signbit((x[0, 0] * w[0]).float()).all()


def test_conv_silu_rejects_bad_shapes():
    conv_in, hist, w, bias = conv_case(0, 2, 3, 16, 4, "float32")
    with pytest.raises(ValueError, match="do not agree"):
        silu_ops.conv_silu(hist[:, :2], conv_in, w, bias)
    with pytest.raises(ValueError, match="do not agree"):
        silu_ops.conv_silu(hist, conv_in, w[:, :8], bias)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("s", [1, 5])
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_norm_plain_versions_are_the_old_expressions(seed, s, dtype):
    """The residual form returns the old ``h + delta`` and its norm; the
    gated form the old skip, gate and norm, with xh and z read from slices
    as the block hands them over."""
    b, h, p, n = 2, 4, 8, 16
    di = h * p
    w = t(arr(seed, di, scale=0.1, dtype=dtype)) + 1
    hh, delta = t(arr(seed + 1, b, s, di, dtype=dtype)), t(arr(
        seed + 2, b, s, di, dtype=dtype))
    got_h, got_x = dec_ops.residual_rms_norm_rows(hh, delta, w, 1e-5)
    old_h = hh + delta
    same_bits(got_h, old_h)
    same_bits(got_x, old_rms_norm(old_h, w, 1e-5))

    zx = t(arr(seed + 3, b, s, 2 * di + 2 * n + h, scale=3.0, dtype=dtype))
    conv = t(arr(seed + 4, b, s, di + 2 * n, dtype=dtype))
    z, xh = zx[..., :di], conv[..., :di].reshape(b, s, h, p)
    y = t(arr(seed + 5, b, s, h, p, dtype=dtype))
    D = t(np.random.default_rng(seed).uniform(0.5, 1.5, h).astype(
        np.float32))
    same_bits(dec_ops.gated_rms_norm_rows(y, D, xh, z, w, 1e-5),
              old_tail(y, D, xh, z, w, 1e-5, zx.dtype))


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b"])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_block_against_the_reference(arch, seed, dtype):
    """A smoke mamba block (mamba2's, zamba2's widths) through the fused
    passes against the reference's: cacheless, a prefill into a fresh cache
    and a decode step after it, output and every cache leaf."""
    jcfg = jax_get_config(arch, "smoke").replace(param_dtype=dtype)
    cfg = get_config(arch, "smoke").replace(param_dtype=dtype)
    with jax.threefry_partitionable(False):
        jp = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    jb = jax.tree.map(lambda a: a[0], jp["blocks"])
    tb = port_model.layer_view(params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu")["blocks"], 0)
    b, s = 2, 9
    x = arr(seed + 20, b, s, cfg.d_model, dtype=dtype)
    x1 = arr(seed + 21, b, 1, cfg.d_model, dtype=dtype)
    want, _ = jax_ssm.mamba_block(jb, jnp.asarray(x), jcfg)
    with torch.inference_mode():
        close(port_ssm.mamba_block(tb, t(x), cfg), want, dtype)
        jc = jax_ssm.init_mamba_cache(jcfg, b)
        cache = {k: v[0] for k, v in port_ssm.init_mamba_cache(
            cfg, 1, b, device="cpu").items()}
        for xs in (x, x1):
            want, jc = jax_ssm.mamba_block(jb, jnp.asarray(xs), jcfg,
                                           cache=jc)
            close(port_ssm.mamba_block(tb, t(xs), cfg, cache=cache), want,
                  dtype)
            close(cache["conv_buf"], jc["conv_buf"], dtype)
            np.testing.assert_allclose(cache["state"].numpy(),
                                       np.asarray(jc["state"]), rtol=2e-5,
                                       atol=2e-5)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_block_against_the_reference(seed, dtype):
    """granite's smoke dense block, its residual add and ln2 fused, against
    the reference's ``apply_dense_block`` (cacheless)."""
    jcfg = jax_get_config("granite-3-2b", "smoke").replace(param_dtype=dtype)
    cfg = get_config("granite-3-2b", "smoke").replace(param_dtype=dtype)
    with jax.threefry_partitionable(False):
        jp = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    jb = jax.tree.map(lambda a: a[0], jp["blocks"])
    tb = port_model.layer_view(params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu")["blocks"], 0)
    b, s = 2, 12
    h = arr(seed + 30, b, s, cfg.d_model, dtype=dtype)
    jpos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
    want, _ = jax_model.apply_dense_block(jb, jnp.asarray(h), jcfg, jpos)
    with torch.inference_mode():
        got = port_model.apply_dense_block(
            tb, t(h), cfg, torch.arange(s)[None].expand(b, s))
    close(got, want, dtype)


# ---------------------------------------------------------------------------
# the norm's plan and its arithmetic
# ---------------------------------------------------------------------------

WIDTHS = [64, 160, 1000, 2048, 2304, 3584, 4096, 7168, 16384]


def test_norm_plan_takes_no_row_count():
    assert list(inspect.signature(dec_ops.norm_plan).parameters) == [
        "d", "itemsize"]


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_norm_plan_covers_the_row(d, itemsize):
    tpr, upt, threads = dec_ops.norm_plan(d, itemsize)
    units = -(-d * itemsize // 16)
    assert tpr % 32 == 0 and 32 <= tpr <= dec_ops.NORM_MAX_THREADS
    assert 1 <= upt <= dec_ops.NORM_MAX_UNITS
    assert tpr * upt >= units > tpr * (upt - 1)
    assert threads % tpr == 0 and dec_ops.NORM_BLOCK <= threads <= 512


def test_norm_plan_refuses_rows_too_wide():
    with pytest.raises(ValueError, match="units a row"):
        dec_ops.norm_plan(16 * 4096 + 8, 2)


def emulate_norm(x, w, eps, plan):
    """The kernel's arithmetic on rows x (M, D), bf16, under ``plan``:
    thread t's fmaf chain over its units t, t + T, ... (elements in order),
    the warp's xor tree, the row's warps in order.  fmaf is taken in
    float64 and rounded once (v * v is exact there)."""
    tpr, upt, _ = plan
    m, d = x.shape
    v = 8
    units = -(-d // v)
    xf = F.pad(x.float(), (0, units * v - d)).view(m, units, v)
    ss = torch.zeros(m, tpr, dtype=torch.float32)
    for k in range(upt):
        for th in range(tpr):
            u = th + k * tpr
            if u >= units:
                continue
            for e in range(v):
                val = xf[:, u, e].double()
                ss[:, th] = (val * val + ss[:, th].double()).float()
    lanes = ss.view(m, tpr // 32, 32)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., torch.arange(32) ^ o]
    total = lanes[..., 0, 0]
    for q in range(1, tpr // 32):
        total = total + lanes[..., q, 0]
    r = torch.rsqrt(total / d + eps)
    return ((x.float() * r[:, None]) * w.float()).to(x.dtype)


@pytest.mark.parametrize("d", [160, 1000, 2048])
def test_norm_plan_arithmetic_near_the_plain_norm(d):
    x = t(arr(1, 6, d, scale=3.0, dtype="bfloat16"))
    w = t(arr(2, d, scale=0.1, dtype="bfloat16")) + 1
    plan = dec_ops.norm_plan(d, 2)
    got = emulate_norm(x, w, 1e-5, plan).float()
    want = dec_ref.rms_norm_ref(x, w, 1e-5).float()
    assert ((got - want).abs() <= 3e-2 * (1 + want.abs())).all()
    for r in range(6):                       # a row alone, the same bits
        same_bits(emulate_norm(x[r:r + 1], w, 1e-5, plan),
                  emulate_norm(x, w, 1e-5, plan)[r:r + 1])
