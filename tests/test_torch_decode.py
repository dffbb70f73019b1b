"""The row-invariant decode kernels' plain versions on the CPU.

On the CPU each wrapper of ``kernels/decode`` computes its plain version
(``ref.py``), which is the model's decode-step code as it was before the
kernels: the model computes the same bits through the wrappers as through
that code, written out here as it stood (``old_*``).  Against the JAX
package's ops, at the tolerances of ``tests/test_kernels.py`` (2e-5 in
float32, 3e-2 in bfloat16): ``rms_norm``, ``_sdpa`` with ``kv_len`` (decode
attention), the matmul, and the reference's Mamba2 decode step (the s == 1
branch of ``mamba_block``); and the SiLU kernel's plain version against
``jax.nn.silu`` (in bf16 bit for bit).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as jax_layers
from repro.models import ssm as jax_ssm
from repro.models.ssm import init_mamba_cache as jax_init_mamba_cache
from repro_torch.configs import get_config
from repro_torch.kernels.decode import ops, ref
from repro_torch.kernels.silu.ref import silu_ref
from repro_torch.models import layers, ssm
from repro_torch.models.bridge import tensor_from_numpy, tensor_to_numpy

torch.set_num_threads(2)

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
DTYPES = ["float32", "bfloat16"]


def arr(seed, *shape, scale=1.0, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * scale
    return x.astype(jnp.bfloat16) if dtype == "bfloat16" else x


def t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def close(got, want, dtype):
    np.testing.assert_allclose(
        np.asarray(tensor_to_numpy(got) if isinstance(got, torch.Tensor)
                   else got, np.float32),
        np.asarray(want, np.float32), rtol=TOL[dtype], atol=TOL[dtype])


def same_bits(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(a.contiguous().view(-1).view(torch.uint8),
                       b.contiguous().view(-1).view(torch.uint8))


# ---------------------------------------------------------------------------
# the model's decode code as it stood before the kernels
# ---------------------------------------------------------------------------

def old_rms_norm(x, w, eps):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def old_decode_sdpa(q, k, v, kv_len):
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, hd)
    k, v = k.to(q.dtype), v.to(q.dtype)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float()
    scores = scores / math.sqrt(hd)
    s_pos = torch.arange(skv)
    keep = (s_pos[None, :] < kv_len[:, None])[:, None, None, None, :]
    scores = scores.masked_fill(~keep, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(b, sq, h, v.shape[-1])


def old_ssm_step(st, xh, dt, A, b2, c2, out_dtype):
    """The s == 1 branch of ``mamba_block`` on (b, 1, ...) tensors."""
    dA = torch.exp(dt[:, 0] * A)
    dBx = torch.einsum("bh,bn,bhp->bhpn", dt[:, 0], b2[:, 0].float(),
                       xh[:, 0].float())
    st.copy_(st * dA[:, :, None, None] + dBx)
    y = torch.einsum("bn,bhpn->bhp", c2[:, 0].float(), st)
    return y[:, None].to(out_dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_versions_are_the_old_code_bit_for_bit(dtype):
    """Through the layers' dispatch, one token per sequence reaches the
    wrappers, and the wrappers' CPU path gives the old code's bits."""
    x = t(arr(0, 3, 1, 64, dtype=dtype))
    w = t(arr(1, 64, dtype=dtype))
    same_bits(layers.rms_norm(x, w, 1e-5), old_rms_norm(x, w, 1e-5))
    wk = t(arr(2, 64, 40, scale=0.125, dtype=dtype))
    same_bits(layers.linear(x, wk), x @ wk)
    emb = t(arr(3, 50, 64, scale=0.125, dtype=dtype))
    same_bits(layers.linear(x, emb.T), x @ emb.T)           # a tied head
    strided = t(arr(4, 3, 7, 64, dtype=dtype))[:, -1:]     # h[:, -1:]
    same_bits(layers.linear(strided, wk), strided @ wk)

    q = t(arr(5, 3, 1, 8, 16, dtype=dtype))
    kc = t(arr(6, 3, 24, 2, 16, dtype="bfloat16"))
    vc = t(arr(7, 3, 24, 2, 16, dtype="bfloat16"))
    lens = torch.tensor([1, 17, 24], dtype=torch.int32)
    same_bits(ops.decode_attention(q, kc[:, :24], vc[:, :24], lens),
              old_decode_sdpa(q, kc[:, :24], vc[:, :24], lens))

    b, h, p, n = 3, 4, 8, 16
    conv = t(arr(8, b, 1, h * p + 2 * n, dtype=dtype))
    xh = conv[..., :h * p].reshape(b, 1, h, p)
    b2, c2 = conv[..., h * p:h * p + n], conv[..., h * p + n:]
    dt = torch.nn.functional.softplus(t(arr(9, b, 1, h)))
    A = -torch.exp(t(arr(10, h)) * 0.3)
    st0 = t(arr(11, b, h, p, n))
    st_new, st_old = st0.clone(), st0.clone()
    y_new = ops.ssm_decode_step(st_new, xh[:, 0], dt[:, 0], A, b2[:, 0],
                                c2[:, 0])[:, None]
    same_bits(y_new, old_ssm_step(st_old, xh, dt, A, b2, c2, conv.dtype))
    same_bits(st_new, st_old)


@pytest.mark.parametrize("dtype", DTYPES)
def test_silu_plain_is_the_reference_silu(dtype):
    """The SiLU kernel's plain version gives ``jax.nn.silu``'s bits (bf16:
    each op rounded; ``F.silu`` rounds once and parts from it)."""
    x = arr(12, 4096, scale=4.0, dtype=dtype)
    want = np.asarray(jax.nn.silu(jnp.asarray(x)), np.float32)
    got = tensor_to_numpy(silu_ref(t(x))).astype(np.float32)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
        once = tensor_to_numpy(torch.nn.functional.silu(t(x))).astype(
            np.float32)
        assert (once != want).mean() > 0.2
    else:
        np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rows_matmul_against_jax(dtype):
    x, w = arr(0, 5, 96, dtype=dtype), arr(1, 96, 33, scale=0.1, dtype=dtype)
    close(ops.rows_matmul(t(x), t(w)), jnp.asarray(x) @ jnp.asarray(w), dtype)
    close(ops.rows_matmul(t(x), t(np.ascontiguousarray(w.T)).T),
          jnp.asarray(x) @ jnp.asarray(w), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm_rows_against_jax(dtype):
    x, w = arr(2, 6, 128, scale=3.0, dtype=dtype), arr(3, 128, dtype=dtype)
    close(ops.rms_norm_rows(t(x), t(w), 1e-5),
          jax_layers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5), dtype)


@pytest.mark.parametrize("h,kv", [(8, 2), (4, 4), (16, 1)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_against_jax_sdpa(h, kv, dtype):
    """The reference's ``_sdpa`` at Sq == 1 with ``kv_len``, over a cache
    cut to a bucket and over the whole cache."""
    b, s, hd = 4, 40, 16
    q = arr(4, b, 1, h, hd, dtype=dtype)
    k = arr(5, b, s, kv, hd, dtype=dtype)
    v = arr(6, b, s, kv, hd, dtype=dtype)
    lens = np.array([1, 9, 32, 30], np.int32)
    want = jax_layers._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            True, None, jnp.asarray(lens))
    for bucket in (s, 32):
        got = ops.decode_attention(t(q), t(k)[:, :bucket], t(v)[:, :bucket],
                                   torch.from_numpy(lens))
        close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_decode_step_against_the_reference_block(dtype):
    """The port's mamba block at s == 1 (the decode kernel's plain version
    inside it) against the reference's, from the same state: the output
    and every cache leaf."""
    jcfg = jax_get_config("mamba2-1.3b", "smoke").replace(param_dtype=dtype)
    cfg = get_config("mamba2-1.3b", "smoke").replace(param_dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    params = {k: v[0] for k, v in ssm.init_mamba_block(gen, cfg, 1).items()}
    jparams = {k: jnp.asarray(tensor_to_numpy(v)) for k, v in params.items()}
    b = 3
    x = arr(7, b, 1, cfg.d_model, dtype=dtype)
    cache = {k: v[0] for k, v in ssm.init_mamba_cache(cfg, 1, b,
                                                      device="cpu").items()}
    cache["state"].copy_(t(arr(8, *cache["state"].shape)))
    cache["conv_buf"].copy_(t(arr(9, *cache["conv_buf"].shape,
                                  dtype=dtype)))
    jcache = jax_init_mamba_cache(jcfg, b)
    jcache = {"conv_buf": jnp.asarray(tensor_to_numpy(cache["conv_buf"])),
              "state": jnp.asarray(tensor_to_numpy(cache["state"])),
              "len": jcache["len"]}
    want, jnew = jax_ssm.mamba_block(jparams, jnp.asarray(x), jcfg,
                                     cache=jcache)
    with torch.inference_mode():
        got = ssm.mamba_block(params, t(x), cfg, cache=cache)
    close(got, want, dtype)
    np.testing.assert_allclose(cache["state"].numpy(),
                               np.asarray(jnew["state"]), rtol=2e-5,
                               atol=2e-5)
    close(cache["conv_buf"], jnew["conv_buf"], dtype)
