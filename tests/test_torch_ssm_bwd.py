"""The plain backwards of the SSM training path against two oracles, on the
CPU: ``ssd_bwd_ref`` (the SSD scan), ``conv_silu_bwd_ref`` (the mamba
block's conv pass) and ``gated_rms_norm_bwd_ref`` (its skip, SiLU gate and
norm), each against torch autograd of its plain forward and against
``jax.vjp`` of the reference's own expression (``repro.models.ssm``'s
``ssd_chunked``, ``jax.nn.silu(_causal_conv(...))`` and ``rms_norm((y + D
xh) * silu(z))``), in float32 and bf16, S ragged against the chunk; and the
wrappers' autograd Functions on the CPU.

Inputs come from a numpy seed.  Errors are max |got - want| over the
largest |want| of each gradient.  Tolerances (measured worst in brackets):

* float32 — within 2e-5 of either oracle, the dense family's leaf limit
  (the scan's dA 5.0e-6 from the JAX oracle at S = 300; the conv pass
  2.7e-7; the gated norm 5.4e-7);
* bf16 — the ROADMAP's rule for bf16 parity: each gradient at most twice
  as far from the exact one (autograd of the float32 forward on the same
  bf16 values) as the nearer oracle is, or within 2e-5 of it (the float32
  limit) where that is more (the scan's float32 ddt and dA).  The
  packages round in other places: the conv pass and the gated norm here
  round du and dv once and take the rest in float32, where both oracles
  round every op in bf16 (worst ratios: the conv's dw 1.24, the gated
  norm's dD 1.34); the JAX scan rounds x's two cotangents separately and
  adds them in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jax_layers
from repro.models import ssm as jax_ssm
from repro_torch.kernels.decode import ops as dec_ops
from repro_torch.kernels.decode import ref as dec_ref
from repro_torch.kernels.silu import ops as silu_ops
from repro_torch.kernels.silu import ref as silu_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref

torch.set_num_threads(2)

F32_TOL = 2e-5
BF16_RATIO = 2.0
DTYPES = ["float32", "bfloat16"]
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def rng_arrays(seed, shapes):
    g = np.random.default_rng(seed)
    return [g.standard_normal(s).astype(np.float32) for s in shapes]


def as_torch(a, dtype, grad=False):
    return torch.from_numpy(a).to(TORCH[dtype]).requires_grad_(grad)


def torch_grads(fn, inputs, dy):
    """autograd of ``fn(*inputs)`` against ``dy``, inputs as given."""
    ins = [t.detach().requires_grad_() for t in inputs]
    out = fn(*ins)
    return torch.autograd.grad(out, ins, dy)


def jax_grads(fn, inputs, dy):
    _, vjp = jax.vjp(fn, *inputs)
    return vjp(dy)


def check(names, got, by_torch, by_jax, exact, dtype):
    """Hold each gradient of ``got`` to the two oracles (float32) or, in
    bf16, to the exact gradient by the nearer oracle's distance."""
    for name, a, wt, wj, ex in zip(names, got, by_torch, by_jax, exact):
        if dtype == "float32":
            e_t, e_j = rel(f32(a), f32(wt)), rel(f32(a), f32(wj))
            assert e_t <= F32_TOL and e_j <= F32_TOL, (name, e_t, e_j)
            continue
        ours = rel(f32(a), f32(ex))
        nearer = min(rel(f32(wt), f32(ex)), rel(f32(wj), f32(ex)))
        assert ours <= max(BF16_RATIO * nearer, F32_TOL), (name, ours,
                                                            nearer)


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------

SSD_CASES = [  # (b, s, h, p, n, chunk)
    (2, 40, 3, 8, 16, 16),      # ragged: 2 chunks and 8 tokens
    (1, 32, 2, 16, 8, 16),      # whole chunks
    (1, 300, 2, 8, 8, 128),     # ragged at the full configs' chunk
]


def ssd_inputs(seed, b, s, h, p, n, dtype):
    xh, bm, cm, dy, raw = rng_arrays(seed, [(b, s, h, p), (b, s, n),
                                            (b, s, n), (b, s, h, p),
                                            (b, s, h)])
    dt = np.logaddexp(raw - 2.0, 0.0).astype(np.float32)    # softplus
    a = -np.linspace(1.0, 4.0, h).astype(np.float32)
    ts = [as_torch(xh, dtype), torch.from_numpy(dt), torch.from_numpy(a),
          as_torch(bm, dtype), as_torch(cm, dtype)]
    return ts, as_torch(dy, dtype)


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_bwd_ref_against_autograd_and_jax(case, dtype):
    b, s, h, p, n, chunk = case
    ins, dy = ssd_inputs(sum(case), b, s, h, p, n, dtype)
    got = ssd_ref.ssd_bwd_ref(*ins, dy, chunk)
    assert [g.dtype for g in got] == [ins[0].dtype, torch.float32,
                                      torch.float32, ins[3].dtype,
                                      ins[4].dtype]
    assert [tuple(g.shape) for g in got] == [tuple(t.shape) for t in ins]
    by_torch = torch_grads(
        lambda *a: ssd_ref.ssd_chunked(*a, chunk)[0], ins, dy)
    j_ins = [jnp.asarray(f32(t)).astype(t_.dtype) for t, t_ in zip(
        ins, [JAX[dtype], jnp.float32, jnp.float32, JAX[dtype], JAX[dtype]])]
    by_jax = jax_grads(lambda *a: jax_ssm.ssd_chunked(*a, chunk)[0], j_ins,
                       jnp.asarray(f32(dy)).astype(JAX[dtype]))
    exact = torch_grads(lambda *a: ssd_ref.ssd_chunked(*a, chunk)[0],
                        [t.float() for t in ins], dy.float())
    check(("dxh", "ddt", "dA", "dBm", "dCm"), got, by_torch, by_jax, exact,
          dtype)


# ---------------------------------------------------------------------------
# the conv pass
# ---------------------------------------------------------------------------

CONV_CASES = [(2, 9, 24, 4), (1, 33, 16, 4), (2, 5, 8, 2)]   # (b, s, c, k)


def conv_inputs(seed, b, s, c, k, dtype):
    x, w, bias, g = rng_arrays(seed, [(b, s, c), (k, c), (c,), (b, s, c)])
    return ([as_torch(x, dtype), as_torch(0.5 * w, dtype),
             as_torch(0.1 * bias, dtype)], as_torch(g, dtype))


def _jax_conv(x, w, b):
    return jax.nn.silu(jax_ssm._causal_conv(x, w, b))


@pytest.mark.parametrize("case", CONV_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_conv_silu_bwd_ref_against_autograd_and_jax(case, dtype):
    ins, g = conv_inputs(sum(case), *case, dtype)
    got = silu_ref.conv_silu_bwd_ref(*ins, g)
    assert [t.dtype for t in got] == [TORCH[dtype]] * 3
    by_torch = torch_grads(
        lambda *a: silu_ref.conv_silu_ref(None, *a), ins, g)
    by_jax = jax_grads(_jax_conv, [jnp.asarray(f32(t)).astype(JAX[dtype])
                                   for t in ins],
                       jnp.asarray(f32(g)).astype(JAX[dtype]))
    exact = torch_grads(lambda *a: silu_ref.conv_silu_ref(None, *a),
                        [t.float() for t in ins], g.float())
    check(("dx", "dw", "db"), got, by_torch, by_jax, exact, dtype)


# ---------------------------------------------------------------------------
# the gated norm
# ---------------------------------------------------------------------------

GATED_CASES = [(2, 7, 3, 8), (1, 40, 4, 16)]      # (b, s, h, p)
EPS = 1e-5


def gated_inputs(seed, b, s, h, p, dtype):
    y, xh, z, w, d, g = rng_arrays(seed, [(b, s, h, p), (b, s, h, p),
                                          (b, s, h * p), (h * p,), (h,),
                                          (b, s, h * p)])
    return ([as_torch(y, dtype), torch.from_numpy(1.0 + 0.3 * d),
             as_torch(xh, dtype), as_torch(z, dtype),
             as_torch(1.0 + 0.1 * w, dtype)], as_torch(g, dtype))


def _jax_gated(y, D, xh, z, w):
    b, s, h, p = y.shape
    y2 = y + D[None, None, :, None].astype(y.dtype) * xh.astype(y.dtype)
    y2 = y2.reshape(b, s, h * p).astype(z.dtype)
    return jax_layers.rms_norm(y2 * jax.nn.silu(z), w, EPS)


@pytest.mark.parametrize("case", GATED_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_gated_rms_norm_bwd_ref_against_autograd_and_jax(case, dtype):
    ins, g = gated_inputs(sum(case), *case, dtype)
    got = dec_ref.gated_rms_norm_bwd_ref(*ins, EPS, g)
    assert [t.dtype for t in got] == [TORCH[dtype], torch.float32,
                                      TORCH[dtype], TORCH[dtype],
                                      TORCH[dtype]]
    plain = lambda *a: dec_ref.gated_rms_norm_ref(*a, EPS)   # noqa: E731
    by_torch = torch_grads(plain, ins, g)
    j_ins = [jnp.asarray(f32(t)).astype(jnp.float32 if i == 1
                                        else JAX[dtype])
             for i, t in enumerate(ins)]
    by_jax = jax_grads(_jax_gated, j_ins,
                       jnp.asarray(f32(g)).astype(JAX[dtype]))
    exact = torch_grads(plain, [t.float() for t in ins], g.float())
    check(("dy", "dD", "dxh", "dz", "dw"), got, by_torch, by_jax, exact,
          dtype)


# ---------------------------------------------------------------------------
# the wrappers' autograd Functions on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_scan_under_grad_takes_its_function(dtype):
    ins, dy = ssd_inputs(0, 2, 40, 3, 8, 16, dtype)
    live = [t.clone().requires_grad_() for t in ins]
    y, st = ssd_ops.ssd_scan(*live, 16)
    assert type(y.grad_fn).__name__ == "SsdScanFnBackward"
    assert not st.requires_grad
    with torch.no_grad():
        y0, st0 = ssd_ops.ssd_scan(*ins, 16)
    assert torch.equal(y.detach(), y0) and torch.equal(st, st0)
    got = torch.autograd.grad(y, live, dy)
    for a, b in zip(got, ssd_ref.ssd_bwd_ref(*ins, dy, 16)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv_silu_under_grad_takes_its_function(dtype):
    ins, g = conv_inputs(1, 2, 9, 24, 4, dtype)
    live = [t.clone().requires_grad_() for t in ins]
    out = silu_ops.conv_silu(None, *live)
    assert type(out.grad_fn).__name__ == "ConvSiluFnBackward"
    assert torch.equal(out.detach(), silu_ref.conv_silu_ref(None, *ins))
    got = torch.autograd.grad(out, live, g)
    for a, b in zip(got, silu_ref.conv_silu_bwd_ref(*ins, g)):
        assert torch.equal(a, b)
    buf = torch.zeros(2, 3, 24, dtype=TORCH[dtype])
    with pytest.raises(NotImplementedError, match="cacheless"):
        silu_ops.conv_silu(buf, *live)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gated_rms_norm_under_grad_takes_its_function(dtype):
    ins, g = gated_inputs(2, 2, 7, 3, 8, dtype)
    live = [t.clone().requires_grad_() for t in ins]
    out = dec_ops.gated_rms_norm_rows(*live, EPS)
    assert type(out.grad_fn).__name__ == "GatedRmsNormFnBackward"
    assert torch.equal(out.detach(), dec_ref.gated_rms_norm_ref(*ins, EPS))
    got = torch.autograd.grad(out, live, g)
    for a, b in zip(got, dec_ref.gated_rms_norm_bwd_ref(*ins, EPS, g)):
        assert torch.equal(a, b)


def test_backward_wrappers_check_their_shapes():
    ins, dy = ssd_inputs(0, 1, 16, 2, 8, 8, "float32")
    with pytest.raises(ValueError, match="dy"):
        ssd_ops.ssd_scan_bwd(*ins, dy[:, :8], 16)
    c_ins, g = conv_inputs(0, 1, 5, 8, 4, "float32")
    with pytest.raises(ValueError, match="do not agree"):
        silu_ops.conv_silu_bwd(*c_ins, g[:, :2])
    g_ins, gg = gated_inputs(0, 1, 3, 2, 8, "float32")
    with pytest.raises(ValueError, match="g "):
        dec_ops.gated_rms_norm_bwd(*g_ins, EPS, gg[:, :1])
