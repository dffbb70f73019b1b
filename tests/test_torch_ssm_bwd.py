"""The plain backwards of the SSM training path against two oracles, on the
CPU: ``ssd_bwd_ref`` (the SSD scan), ``conv_silu_bwd_ref`` (the mamba
block's conv pass) and ``gated_rms_norm_bwd_ref`` (its skip, SiLU gate and
norm), each against torch autograd of its plain forward and against
``jax.vjp`` of the reference's own expression (``repro.models.ssm``'s
``ssd_chunked``, ``jax.nn.silu(_causal_conv(...))`` and ``rms_norm((y + D
xh) * silu(z))``), in float32 and bf16, S ragged against the chunk; the
wrappers' autograd Functions on the CPU; and the bf16 backward kernel's
rounding points emulated (``emulate_bf16_bwd_kernel``): split float32
operands meet the card's limits, one bf16 rounding does not.

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


# ---------------------------------------------------------------------------
# the bf16 backward kernel's precision design, emulated on the CPU
# ---------------------------------------------------------------------------

def _bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)


def _split(v, rounding):
    """A float32 operand as the kernel feeds it to the bf16 tensor cores:
    "split" into bf16 (hi, lo), "once" rounded to bf16, "exact" float32."""
    if rounding == "exact":
        return v, torch.zeros_like(v)
    hi = _bf16(v)
    return (hi, _bf16(v - hi)) if rounding == "split" else (hi,
                                                            torch.zeros_like(v))


def _joined(v, rounding):
    """v through the kernel's one-sided split: hi + lo against an exact
    bf16 operand, two products summed in float32."""
    hi, lo = _split(v, rounding)
    return hi + lo


def _prod3(a, b, rounding):
    """a @ b with both operands float32, split: hi hi + hi lo + lo hi."""
    ah, al = _split(a, rounding)
    bh, bl = _split(b, rounding)
    return ah @ bh + ah @ bl + al @ bh


def emulate_bf16_bwd_kernel(xh, dt, A, Bm, Cm, dy, rounding="split",
                            scan=None):
    """The tensor-core backward's arithmetic (``csrc/ssd_bwd.cu``, Q =
    128) in plain PyTorch, float32: x, B, C and dy exact bf16; W, E, the
    states S and G (kept split in their scratch), x o w and dy o e^cs each
    a float32 operand split into bf16 hi + lo ("split"), rounded once
    ("once") or left exact; dB and dC summed over the heads; the
    chunk's cumsum of dt A by ``scan`` (default ``torch.cumsum``, which
    on the CPU accumulates float32 in float64, as the kernel's scan
    does).  Returns (dxh, ddt, dA, dBm, dCm) in the plain version's
    dtypes."""
    q = 128
    b, s, h, p = xh.shape
    n = Bm.shape[-1]
    nc = -(-s // q)
    pad = nc * q - s
    f = torch.float32
    x, g, bm, cm = (torch.nn.functional.pad(t.to(f), (0, 0) * (t.dim() - 2)
                                            + (0, pad))
                    for t in (xh, dy, Bm, Cm))
    dtp = torch.nn.functional.pad(dt.to(f), (0, 0, 0, pad))
    x = x.reshape(b, nc, q, h, p).permute(0, 1, 3, 2, 4)     # (b,c,h,q,p)
    g = g.reshape(b, nc, q, h, p).permute(0, 1, 3, 2, 4)
    bm = bm.reshape(b, nc, q, n)
    cm = cm.reshape(b, nc, q, n)
    dtc = dtp.reshape(b, nc, q, h).permute(0, 1, 3, 2)       # (b,c,h,q)
    cs = (scan or (lambda v: torch.cumsum(v, -1)))(dtc * A.to(f)[:, None])
    ec = torch.exp(cs)
    dec = torch.exp(cs[..., -1:] - cs)
    w = dec * dtc
    tri = torch.ones(q, q, dtype=torch.bool).tril()
    l = torch.where(tri, torch.exp(cs[..., :, None] - cs[..., None, :]),
                    0.0)                                  # (b,c,h,i,j)

    # the walks: float32 states, stored split
    S = torch.zeros(b, nc, h, p, n, dtype=f)
    G = torch.zeros(b, nc, h, p, n, dtype=f)
    st = torch.zeros(b, h, p, n, dtype=f)
    for c in range(nc - 1):
        st = st * ec[:, c, :, -1, None, None] + \
            _joined(x[:, c] * w[:, c, ..., None], rounding).transpose(-1, -2) \
            @ bm[:, c, None]
        S[:, c + 1] = st
    st = torch.zeros(b, h, p, n, dtype=f)
    for c in range(nc - 1, 0, -1):
        st = st * ec[:, c, :, -1, None, None] + \
            _joined(g[:, c] * ec[:, c, ..., None], rounding) \
            .transpose(-1, -2) @ cm[:, c, None]
        G[:, c - 1] = st
    Sj, Gj = _joined(S, rounding), _joined(G, rounding)

    # the chunk pass
    cb = (cm @ bm.transpose(-1, -2))[:, :, None]             # (b,c,1,i,j)
    dx_ = g @ x.transpose(-1, -2)                            # (dy_i . x_j)
    cbl = cb * l
    W = cbl * dtc[..., None, :]
    e = cbl * dx_
    bg = bm[:, :, None] @ Gj.transpose(-1, -2)               # (b,c,h,j,p)
    dx = _joined(W, rounding).transpose(-1, -2) @ g + w[..., None] * bg
    xgb = (x * bg).sum(-1)
    rr = ec * (g * (cm[:, :, None] @ Sj.transpose(-1, -2))).sum(-1)
    cold = e.sum(-2)
    rowt = (e * dtc[..., None, :]).sum(-1)
    v = w * xgb
    dcs = rowt - dtc * cold + rr - v
    gs = (Gj * Sj).sum((-1, -2))
    dcs[..., -1] += v.sum(-1) + ec[..., -1] * gs
    da = torch.flip(torch.cumsum(torch.flip(dcs, [-1]), -1), [-1])
    ddt = cold + dec * xgb + A.to(f)[:, None] * da
    dA = (dtc * da).sum((0, 1, 3))

    # dB and dC, the heads summed in registers
    E = l * dtc[..., None, :] * dx_
    Ej = _joined(E, rounding)
    dB = (Ej.transpose(-1, -2) @ cm[:, :, None]
          + _prod3(x * w[..., None], Gj, rounding)).sum(2)
    dC = (Ej @ bm[:, :, None]
          + _prod3(g * ec[..., None], Sj, rounding)).sum(2)

    def out(t, shape, dtype):
        return t.reshape(b, nc * q, *shape)[:, :s].to(dtype)
    return (out(dx.permute(0, 1, 3, 2, 4), (h, p), xh.dtype),
            out(ddt.permute(0, 1, 3, 2), (h,), f), dA,
            out(dB, (n,), Bm.dtype), out(dC, (n,), Cm.dtype))


def bf16_bwd_inputs(seed, b, s, h, p, n):
    """The card's input distribution (``chip_smoke.py``'s ``ssd_inputs``):
    x, B and C views of one bf16 row, dt softplus'd, A negative, dy bf16."""
    r = np.random.default_rng(seed)
    conv = r.standard_normal((b, s, h * p + 2 * n), dtype=np.float32)
    conv[..., h * p:] *= 0.5
    conv = torch.from_numpy(conv).bfloat16()
    dt = torch.nn.functional.softplus(
        torch.from_numpy(r.standard_normal((b, s, h), dtype=np.float32)))
    A = -torch.exp(torch.from_numpy(r.standard_normal(h, dtype=np.float32))
                   * 0.3)
    dy = torch.from_numpy(r.standard_normal((b, s, h, p),
                                            dtype=np.float32)).bfloat16()
    return (conv[..., :h * p].reshape(b, s, h, p), dt, A,
            conv[..., h * p:h * p + n], conv[..., h * p + n:], dy)


# the card's limits (chip_smoke.py): bf16 gradients per element 1e-2 (1 +
# |plain|), ddt 5e-4 (1 + |plain|), dA 1e-4 of its largest
BWD_LIMITS = {"dxh": (1e-2, "element"), "ddt": (5e-4, "element"),
              "dA": (1e-4, "largest"), "dBm": (1e-2, "element"),
              "dCm": (1e-2, "element")}
BWD_NAMES = ("dxh", "ddt", "dA", "dBm", "dCm")
BWD_SHAPE = (1, 384, 4, 64, 128)            # B, S, H, P, N; Q = 128


def bwd_limit_ratios(got, ins):
    """Each gradient's worst error over its card limit, against
    ``ssd_bwd_ref`` in float64 on the same (bf16-valued) inputs."""
    want = ssd_ref.ssd_bwd_ref(*(t.double() for t in ins[:5]),
                               ins[5].double(), 128)
    out = {}
    for name, a, w in zip(BWD_NAMES, got, want):
        tol, on = BWD_LIMITS[name]
        err = (a.double() - w).abs()
        scale = w.abs().max() if on == "largest" else 1 + w.abs()
        out[name] = float((err / (tol * scale)).max())
    return out


def test_bf16_bwd_emulation_unrounded_is_the_plain_version():
    """With no operand rounded the emulation is the function ``ssd_bwd_ref``
    computes (so the tests below measure rounding only): its bf16 outputs
    within a bf16 step, ddt and dA within 1e-4 (1 + |plain|), the two
    float32 versions summing in other orders (5.6e-5 seen on ddt, whose
    terms are far larger than it)."""
    ins = bf16_bwd_inputs(0, *BWD_SHAPE)
    got = emulate_bf16_bwd_kernel(*ins, rounding="exact")
    want = ssd_ref.ssd_bwd_ref(*ins, 128)
    for name, a, w in zip(BWD_NAMES, got, want):
        err = ((a.float() - w.float()).abs() / (1 + w.float().abs())).max()
        assert err <= (2 ** -7 if a.dtype == torch.bfloat16 else 1e-4), \
            (name, float(err))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_bwd_split_arithmetic_meets_card_limits(seed):
    """bf16 x, B, C and dy exact; W, E, the states and the weighted
    operands each split into bf16 hi + lo, dB and dC summed over the heads,
    as the kernel does them: every gradient within the card's limits of the
    plain version in float64 at a mamba2 head shape (P = 64, N = 128, Q =
    128, three chunks)."""
    ins = bf16_bwd_inputs(seed, *BWD_SHAPE)
    ratios = bwd_limit_ratios(emulate_bf16_bwd_kernel(*ins), ins)
    assert max(ratios.values()) <= 1, ratios


def _warp_scan_f32(v):
    """cumsum over the last dim (128) in float32 in a warp scan's order:
    lane l adds 4 tokens in order, then an inclusive scan over 32 lanes."""
    *lead, q = v.shape
    parts, run = [], torch.zeros(*lead, 32)
    for e in range(4):
        run = run + v.reshape(*lead, 32, 4)[..., e]
        parts.append(run)
    tot, off = run.clone(), 1
    while off < 32:
        up = torch.zeros_like(tot)
        up[..., off:] = tot[..., :-off]
        tot, off = tot + up, off * 2
    excl = torch.zeros_like(tot)
    excl[..., 1:] = tot[..., :-1]
    return torch.stack([p + excl for p in parts], -1).reshape(*lead, q)


def test_float32_cumsum_costs_ddt_its_margin():
    """Why the kernel takes the chunk's cumsum in float64: ddt rests on
    differences of cs across the chunk, and a float32 warp scan of dt A
    alone takes ddt several times further from the plain version than the
    split arithmetic does (the CPU's float32 cumsum accumulates in
    float64, as the kernel's scan does)."""
    ins = bf16_bwd_inputs(0, 2, 128, 16, 64, 128)
    base = bwd_limit_ratios(emulate_bf16_bwd_kernel(*ins), ins)["ddt"]
    f32 = bwd_limit_ratios(emulate_bf16_bwd_kernel(
        *ins, scan=_warp_scan_f32), ins)["ddt"]
    assert f32 > 2 * base, (f32, base)


def test_one_bf16_rounding_misses_card_limits():
    """Why each float32 operand is split: rounded to bf16 once, the same
    arithmetic puts a gradient outside the card's limits."""
    ins = bf16_bwd_inputs(0, *BWD_SHAPE)
    ratios = bwd_limit_ratios(emulate_bf16_bwd_kernel(*ins, rounding="once"),
                              ins)
    assert max(ratios.values()) > 1, ratios


# ---------------------------------------------------------------------------
# the conv pass's backward kernel: its plan, and the rounding of its sums
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,units", [
    (4, 512, 544), (4, 512, 912), (1, 512, 544), (4, 77, 544),
    (4, 4096, 544), (4, 512, 4352), (4, 9, 20), (3, 300, 9), (2, 1, 5)])
def test_conv_bwd_plan_covers_every_row_once(b, s, units):
    """The pass's runs, walked as the kernel walks them (block q's warp w
    takes run q W + w; run r is batch row r // runs from token (r % runs)
    run), cover every (b, t) row exactly once, each run inside one batch
    row; a block's runs cover at least ``CONV_BWD_SLICE`` rows where they
    are whole; and the plan takes the shortest run whose warps the card
    holds at once."""
    sms = 132
    run, warps = silu_ops.conv_bwd_plan(b, s, units, sms)
    assert run in silu_ops.CONV_BWD_RUNS and 1 <= warps <= 4
    assert run * warps >= silu_ops.CONV_BWD_SLICE
    runs = -(-s // run)
    slices = -(-b * runs // warps)
    seen = np.zeros((b, s), np.int64)
    for r in range(slices * warps):
        if r >= b * runs:
            continue
        t0 = (r % runs) * run
        seen[r // runs, t0:t0 + min(run, s - t0)] += 1
    assert (seen == 1).all()

    def fits(n):
        return -(-units // 32) * b * -(-s // n) <= sms * \
            silu_ops.CONV_BWD_WARPS_SM
    shorter = [n for n in silu_ops.CONV_BWD_RUNS if n < run]
    assert not any(fits(n) for n in shorter)
    assert fits(run) or run == silu_ops.CONV_BWD_RUNS[-1]


def _bf16_bits(f32):
    """bf16 bit patterns of float32 values that are bf16 values."""
    return (f32.view(np.uint32) >> 16).astype(np.uint16)


def _round_once_to_bf16(x):
    """Float64 values (exact sums) rounded once to bf16, to nearest even,
    with bf16's subnormals (a quantum of 2^-133) and overflow to inf."""
    _, e = np.frexp(x)                              # |x| < 2^e
    q = np.ldexp(1.0, np.maximum(e - 8, -133))      # the quantum at |x|
    with np.errstate(over="ignore"):
        return (np.round(x / q) * q).astype(np.float32)


def test_bf16_sums_round_once_through_float32():
    """The conv backward's bf16 taps are summed two at a time by
    ``add.rn.bf16x2``, which rounds the exact sum of two bf16 values once;
    the plain chain adds them in float32 and rounds the float32 sum to
    bf16.  The two agree (float32's 24 bits are at least 2 x 8 + 2: double
    rounding is innocuous; a sum within float32's subnormal range is a
    multiple of 2^-133, exact in float32): over 1.2 million random pairs,
    every exponent gap from 0 to 40, subnormal operands and sums, both
    signs, overflow, with ties among them, the float32 route's bits equal
    the exact sum rounded once (exact in float64: at most 49 bits)."""
    rng = np.random.default_rng(0)
    per_gap, gaps = 30000, 41
    n = per_gap * gaps

    def bf16(sign, exp, man):
        bits = (sign.astype(np.uint32) << 31) | (exp.astype(np.uint32) << 23) \
            | (man.astype(np.uint32) << 16)
        return bits.view(np.float32)

    ea = rng.integers(0, 255, n)                    # 0: subnormal
    ea[: n // 20] = rng.integers(0, 9, n // 20)     # near the subnormals
    gap = np.repeat(np.arange(gaps), per_gap)
    eb = np.maximum(ea - gap, 0)
    a = bf16(rng.integers(0, 2, n), ea, rng.integers(0, 128, n))
    b = bf16(rng.integers(0, 2, n), eb, rng.integers(0, 128, n))
    # pairs of subnormals, and of a subnormal and anything
    m = 100000
    a = np.concatenate([a, bf16(rng.integers(0, 2, m), np.zeros(m, int),
                                rng.integers(0, 128, m)),
                        bf16(rng.integers(0, 2, m), np.zeros(m, int),
                             rng.integers(0, 128, m))])
    b = np.concatenate([b, bf16(rng.integers(0, 2, m), np.zeros(m, int),
                                rng.integers(0, 128, m)),
                        bf16(rng.integers(0, 2, m), rng.integers(0, 255, m),
                             rng.integers(0, 128, m))])
    exact = a.astype(np.float64) + b.astype(np.float64)
    once = _round_once_to_bf16(exact)
    with np.errstate(over="ignore"):
        via32 = torch.from_numpy(a + b).to(torch.bfloat16).float().numpy()
    same = _bf16_bits(once) == _bf16_bits(via32)
    assert same.all(), (a[~same][:5], b[~same][:5])
    # what the pairs covered
    assert len(a) >= 10 ** 6
    assert set(np.unique(gap)) == set(range(gaps))
    sub = (np.abs(once) < 2.0 ** -126) & (once != 0)
    assert sub.sum() > 1000
    assert np.isinf(once).sum() > 0
    q = np.ldexp(1.0, np.maximum(np.frexp(exact)[1] - 8, -133))
    ties = np.abs(exact / q - np.floor(exact / q)) == 0.5
    assert ties.sum() > 1000
