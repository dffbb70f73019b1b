"""The port on the card: each CUDA kernel against its plain version, and the
serving path through the kernels against itself and against the CPU.

Every test here carries the ``cuda`` marker and skips, from a fixture, where
``torch.cuda.is_available()`` is False.  The file imports only torch, numpy
and the port, so it also runs where jax is not installed; there the
repository's conftest (which imports jax) is left out:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: flash attention 2e-5 (float32) and 3e-2 (bfloat16), quantize
and dequantize bit-equal; the SSD scan |kernel - plain| <= tol (1 +
|plain|) with tol 2e-4 on float32 outputs and the float32 state and 1e-2
on bfloat16 outputs (one bf16 rounding step is under 0.8% of the value);
the smoke models' logits on the card within 5e-2 of the CPU's
(teacher-forced; bf16 products rounded in other places), zamba2's as
accurate as the CPU's against its float32 run (see that test).
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.configs import get_config
from repro_torch.core import from_block_cuts
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention.ref import attention_ref, flash_ref
from repro_torch.kernels.decode import ops as dec_ops
from repro_torch.kernels.decode import ref as dec_ref
from repro_torch.kernels.quantize import ops as q_ops
from repro_torch.kernels.silu import ops as silu_ops
from repro_torch.kernels.silu import ref as silu_ref_mod
from repro_torch.kernels.silu.ref import conv_silu_ref, silu_ref
from repro_torch.kernels.quantize import ref as q_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.kernels.ssd.ref import ssd_chunked
from repro_torch.launch.steps import train_launches
from repro_torch.models import (decode_step, init_params, init_serve_cache,
                                prefill)
from repro_torch.serve.engine import ServeEngine, make_batch
from repro_torch.serve import scheduler
from repro_torch.serve.pipeline import PipelineServeEngine

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# the backward kernels against their plain versions, per element on
# 1 + |plain| (bf16 outputs: a bf16 step is under 0.8% of the value; float32
# outputs and sums: another order of float32 sums)
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def randn(cuda, seed, *shape, dtype=torch.float32):
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return torch.from_numpy(x).to(cuda).to(dtype)


def bits_equal(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


@pytest.mark.parametrize("s,causal,dtype", [
    (512, True, torch.bfloat16), (300, True, torch.bfloat16),
    (512, False, torch.bfloat16), (384, True, torch.float32),
    (200, False, torch.float32)])
def test_flash_kernel_vs_plain(cuda, s, causal, dtype):
    q = randn(cuda, 0, 2, s, 32, 64, dtype=dtype)
    k = randn(cuda, 1, 2, s, 8, 64, dtype=dtype)
    v = randn(cuda, 2, 2, s, 8, 64, dtype=dtype)
    before = attn_ops.flash_attention.launches
    out = attn_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert attn_ops.flash_attention.launches == before + 1
    ref = attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("hd", [8, 16, 32, 128])
def test_flash_kernel_head_dims(cuda, hd):
    q, k, v = (randn(cuda, i, 1, 130, 4, hd) for i in range(3))
    torch.testing.assert_close(attn_ops.flash_attention(q, k, v),
                               attention_ref(q, k, v), rtol=2e-5, atol=2e-5)


def test_flash_kernel_rejects_other_head_dims(cuda):
    q = randn(cuda, 0, 1, 128, 2, 48)
    with pytest.raises(ValueError, match="head dim"):
        attn_ops.flash_attention(q, q, q)


def flash_close(cuda, q, k, v, causal=True, valid_len=None):
    """One launch, a contiguous (B, S, H, hd) output in q's dtype, and the
    plain version's values at the dtype's tolerance."""
    before = attn_ops.flash_attention.launches
    out = attn_ops.flash_attention(q, k, v, causal=causal,
                                   valid_len=valid_len)
    torch.cuda.synchronize()
    assert attn_ops.flash_attention.launches == before + 1
    assert out.is_contiguous() and out.dtype == q.dtype
    assert out.shape == q.shape
    if valid_len is None:
        ref = attention_ref(q, k, v, causal=causal)
    else:
        ref = flash_ref(q, k, v, causal=causal, valid_len=valid_len)
    tol = TOL[q.dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("hd", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_bf16_head_dims(cuda, hd, causal):
    """The tensor-core path at every head dim (8 runs zero-padded to 16)."""
    q = randn(cuda, 10, 2, 200, 8, hd, dtype=torch.bfloat16)
    k, v = (randn(cuda, i, 2, 200, 2, hd, dtype=torch.bfloat16)
            for i in (11, 12))
    flash_close(cuda, q, k, v, causal)


@pytest.mark.parametrize("s", [130, 300, 511])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_ragged_s(cuda, s, causal, dtype):
    q = randn(cuda, 13, 2, s, 8, 64, dtype=dtype)
    k, v = (randn(cuda, i, 2, s, 2, 64, dtype=dtype) for i in (14, 15))
    flash_close(cuda, q, k, v, causal)


@pytest.mark.parametrize("h,kv", [(8, 8), (8, 2), (8, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_gqa_groups(cuda, h, kv, dtype):
    """Groups 1, 4 and 8: q head h reads kv head h // group."""
    q = randn(cuda, 16, 2, 256, h, 64, dtype=dtype)
    k, v = (randn(cuda, i, 2, 256, kv, 64, dtype=dtype) for i in (17, 18))
    flash_close(cuda, q, k, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_one_batch_row_and_mha(cuda, dtype):
    """B = 1 and H == KV."""
    q, k, v = (randn(cuda, i, 1, 320, 4, 64, dtype=dtype) for i in range(3))
    flash_close(cuda, q, k, v)
    flash_close(cuda, q, k, v, causal=False)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_valid_len(cuda, causal, dtype):
    """Keys at or past valid_len are masked for every query row."""
    q = randn(cuda, 19, 2, 256, 8, 32, dtype=dtype)
    k, v = (randn(cuda, i, 2, 256, 2, 32, dtype=dtype) for i in (20, 21))
    flash_close(cuda, q, k, v, causal, valid_len=150)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_reads_views_in_place(cuda, dtype):
    """q, k and v sliced out of one fused projection whose rows are wider
    than the heads, and q as a transposed (B, H, S, hd) tensor: read
    through their strides, with no copy."""
    b, s, h, kv, hd = 2, 200, 8, 2, 64
    fused = randn(cuda, 22, b, s, (h + 2 * kv) * hd + 64, dtype=dtype)
    q = fused[..., :h * hd].view(b, s, h, hd)
    k = fused[..., h * hd:(h + kv) * hd].view(b, s, kv, hd)
    v = fused[..., (h + kv) * hd:(h + 2 * kv) * hd].view(b, s, kv, hd)
    assert q.stride(1) == (h + 2 * kv) * hd + 64
    flash_close(cuda, q, k, v)
    qt = randn(cuda, 23, b, h, s, hd, dtype=dtype).transpose(1, 2)
    flash_close(cuda, qt, k, v, causal=False)


# zamba2's shared attention: head dim 112 (the bf16 path on the 128 tile
# with two zero chunks, float32 instantiated at 112), full MHA (group 1)
@pytest.mark.parametrize("b,s,h,kv,causal,valid_len", [
    (4, 512, 32, 32, True, None), (4, 512, 32, 32, False, None),
    (1, 300, 32, 32, True, None), (1, 130, 8, 8, False, None),
    (4, 200, 8, 8, True, 150), (1, 256, 8, 8, False, 100),
    (2, 256, 8, 2, True, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_head_dim_112(cuda, b, s, h, kv, causal, valid_len,
                                   dtype):
    q = randn(cuda, 28, b, s, h, 112, dtype=dtype)
    k, v = (randn(cuda, i, b, s, kv, 112, dtype=dtype) for i in (29, 30))
    flash_close(cuda, q, k, v, causal, valid_len)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_head_dim_112_reads_views_in_place(cuda, dtype):
    """q, k and v as views of one fused (B, S, 3 H 112) projection: rows of
    224 (bf16) or 448 bytes, read through their strides."""
    b, s, h, hd = 2, 200, 8, 112
    fused = randn(cuda, 31, b, s, 3 * h * hd, dtype=dtype)
    q, k, v = (fused[..., i * h * hd:(i + 1) * h * hd].view(b, s, h, hd)
               for i in range(3))
    assert not q.is_contiguous()
    flash_close(cuda, q, k, v)
    flash_close(cuda, q, k, v, causal=False, valid_len=123)


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    bf16 = torch.bfloat16
    wide = randn(cuda, 24, 1, 64, 2, 128, dtype=bf16)
    with pytest.raises(ValueError, match="dense"):
        attn_ops.flash_attention(wide[..., ::2], wide[..., ::2],
                                 wide[..., ::2])
    x = randn(cuda, 25, 1, 64, 2, 64, dtype=bf16)
    off = torch.zeros(x.numel() + 1, dtype=bf16, device=cuda)[1:]
    with pytest.raises(ValueError, match="16-byte boundary"):
        attn_ops.flash_attention(off.view(x.shape), x, x)
    rows = randn(cuda, 26, 1, 64, 2 * 64 + 4, dtype=bf16)
    with pytest.raises(ValueError, match="16-byte boundary"):
        attn_ops.flash_attention(x, rows[..., :128].view(1, 64, 2, 64), x)
    q48 = randn(cuda, 27, 1, 64, 2, 48, dtype=bf16)
    with pytest.raises(ValueError, match="head dim"):
        attn_ops.flash_attention(q48, q48, q48)


@pytest.mark.parametrize("shape,bm,bn", [((2048, 2048), 1, 2048),
                                         ((2048, 2048), 256, 256),
                                         ((300, 520), 256, 256),
                                         ((257, 129), 256, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_kernels_bit_equal(cuda, shape, bm, bn, dtype):
    x = randn(cuda, 3, *shape, dtype=dtype)
    q, s = q_ops.quantize(x, bm, bn)
    qr, sr = q_ref.quantize_ref(x, bm, bn)
    bits_equal(q, qr)
    bits_equal(s, sr)
    bits_equal(q_ops.dequantize(q, s, bm, bn, dtype),
               q_ref.dequantize_ref(q, s, bm, bn, dtype))


@pytest.mark.parametrize("m,n,bm,bn,rowwise", [
    (2048, 2048, 1, 2048, True), (301, 4096, 1, 4096, True),
    (7, 16, 1, 16, True), (300, 520, 1, 520, True), (64, 8, 1, 64, True),
    (300, 1028, 1, 1028, False), (40, 8192, 1, 8192, True),
    (300, 520, 256, 256, False), (2048, 2048, 2, 2048, False),
    (2048, 1280, 1, 1280, True), (4, 1280, 1, 1280, True),
    (2048, 7168, 1, 7168, True), (4, 7168, 1, 7168, True),
    (2048, 8192, 1, 8192, True), (4, 16384, 1, 16384, True),
    (301, 16384, 1, 16384, True), (5, 16392, 1, 16392, False),
    (37, 5128, 1, 5128, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_rowwise_path_bit_equal(cuda, m, n, bm, bn, rowwise, dtype):
    """Tiles one row tall and as wide as the row take the row path (the
    row held in registers, one read of each element; several warps a row
    past 4096 bf16) up to 16384 wide; other widths and tiles the general
    one; both give the plain version's bits."""
    x = randn(cuda, 7, m, n, dtype=dtype) * 3
    x[0] = 0                          # an all-zero row: scale 1
    assert q_ops.rowwise_path(x, bm, bn) == rowwise
    before = q_ops.quantize.launches
    rows = q_ops.quantize.row_launches
    q, s = q_ops.quantize(x, bm, bn)
    torch.cuda.synchronize()
    assert q_ops.quantize.launches == before + 1
    assert q_ops.quantize.row_launches == rows + rowwise
    qr, sr = q_ref.quantize_ref(x, bm, bn)
    bits_equal(q, qr)
    bits_equal(s, sr)
    bits_equal(q_ops.dequantize(q, s, bm, bn, dtype),
               q_ref.dequantize_ref(q, s, bm, bn, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_row_path_ties_and_misaligned_view(cuda, dtype):
    """Half-way ties round to even on the row path, as on the CPU; a view
    that starts off a 16-byte boundary takes the general path, with the
    same bits."""
    row = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5] * 2,
                       device=cuda).to(dtype)
    x = torch.cat([row, -row]).repeat(3, 256)         # (3, 8192)
    assert q_ops.rowwise_path(x, 1, x.shape[1])
    q, s = q_ops.quantize(x, 1, x.shape[1])
    qr, sr = q_ref.quantize_ref(x, 1, x.shape[1])
    bits_equal(q, qr)
    bits_equal(s, sr)
    assert q[0, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 4]
    flat = randn(cuda, 8, 3 * 7168 + 1, dtype=dtype)
    view = flat[1:].view(3, 7168)
    assert not q_ops.rowwise_path(view, 1, 7168)
    q, s = q_ops.quantize(view, 1, 7168)
    qr, sr = q_ref.quantize_ref(view, 1, 7168)
    bits_equal(q, qr)
    bits_equal(s, sr)


@pytest.mark.parametrize("m,n,bm,bn,vec", [
    (2048, 2048, 256, 256, True), (512, 1024, 256, 256, True),
    (300, 520, 256, 256, True), (2048, 7168, 1, 7168, True),
    (4, 8192, 1, 8192, True), (3, 16384, 1, 16384, True),
    (7, 520, 1, 520, True), (257, 129, 256, 256, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dequantize_vectorised_bit_equal(cuda, m, n, bm, bn, vec, dtype):
    """Dequantize through the vectorised kernel (units of 8 int8 for bf16,
    4 for float32: one 16-byte store each) at (256, 256) tiles, ragged
    ones and the wire's (1, D), and through the scalar one at a width that
    is no multiple of 4, bit-equal to the plain version, one launch a
    call."""
    x = randn(cuda, 9, m, n) * 3
    q, s = q_ref.quantize_ref(x, bm, bn)
    assert q_ops.dequantize_vectorised(q, bm, bn, dtype) == vec
    before = q_ops.dequantize.launches
    vecs = q_ops.dequantize.vec_launches
    out = q_ops.dequantize(q, s, bm, bn, dtype)
    torch.cuda.synchronize()
    assert q_ops.dequantize.launches == before + 1
    assert q_ops.dequantize.vec_launches == vecs + vec
    bits_equal(out, q_ref.dequantize_ref(q, s, bm, bn, dtype))


def test_dequantize_misaligned_q_takes_the_scalar_kernel(cuda):
    flat = torch.randint(-127, 128, (3 * 2048 + 1,), dtype=torch.int8,
                         device=cuda)
    q = flat[1:].view(3, 2048)
    s = torch.rand(3, 1, device=cuda)
    assert not q_ops.dequantize_vectorised(q, 1, 2048, torch.bfloat16)
    vecs = q_ops.dequantize.vec_launches
    bits_equal(q_ops.dequantize(q, s, 1, 2048),
               q_ref.dequantize_ref(q, s, 1, 2048))
    assert q_ops.dequantize.vec_launches == vecs


def test_rowwise_wire_bit_equal(cuda):
    x = randn(cuda, 4, 4, 512, 2048, dtype=torch.bfloat16)
    q, s = q_ops.rowwise_quantize(x)
    qr, sr = q_ref.rowwise_quantize(x)
    bits_equal(q, qr)
    bits_equal(s, sr)
    bits_equal(q_ops.rowwise_dequantize(q, s),
               (qr.float() * sr).to(torch.bfloat16))


def ssd_inputs(cuda, seed, b, s, h, p, n, dtype, dt_scale=1.0):
    """x, B and C as views of one (B, S, H*P + 2N) tensor, as the model
    hands them over; dt and A as the reference's kernel tests draw them.
    ``dt_scale`` > 1 multiplies dt and divides A by its square, so steps
    weigh more and decay less: a state of large magnitude."""
    conv = randn(cuda, seed, b, s, h * p + 2 * n)
    conv[..., h * p:] *= 0.5
    conv = conv.to(dtype)
    dt = torch.nn.functional.softplus(randn(cuda, seed + 1, b, s, h))
    A = -torch.exp(randn(cuda, seed + 2, h) * 0.3)
    return (conv[..., :h * p].reshape(b, s, h, p), dt * dt_scale,
            A / dt_scale ** 2, conv[..., h * p:h * p + n],
            conv[..., h * p + n:])


def assert_ssd_close(got, want, tol):
    assert got.shape == want.shape and got.dtype == want.dtype
    err = (got.float() - want.float()).abs()
    assert bool((err <= tol * (1 + want.float().abs())).all()), \
        err.max().item()


SSD_SHAPES = [  # (S, H, P, N, Q)
    (512, 8, 64, 128, 128), (300, 8, 64, 128, 128), (40, 8, 16, 16, 16),
    (200, 4, 64, 64, 128), (77, 3, 16, 32, 16), (130, 2, 128, 128, 128),
    (200, 3, 32, 16, 128), (1, 4, 16, 16, 16), (77, 3, 32, 24, 16),
    (300, 112, 64, 64, 128)]
# bf16 on the tensor cores: P within, across and at the edges of the
# kernel's 32-column blocks, large and small grids, B = 1, a long S, a
# state of large magnitude
SSD_BF16_CASES = [  # (B, S, H, P, N, Q, dt_scale)
    (2, 256, 4, 8, 64, 128, 1.0), (2, 256, 4, 24, 128, 128, 1.0),
    (2, 256, 4, 40, 128, 128, 1.0), (2, 256, 4, 48, 64, 128, 1.0),
    (2, 200, 4, 96, 128, 128, 1.0), (2, 100, 4, 120, 72, 16, 1.0),
    (4, 256, 64, 64, 128, 128, 1.0), (4, 130, 66, 24, 128, 128, 1.0),
    (4, 130, 64, 40, 64, 128, 1.0), (4, 100, 32, 120, 72, 16, 1.0),
    (1, 512, 64, 64, 128, 128, 1.0), (1, 300, 8, 128, 128, 128, 1.0),
    (1, 2048, 8, 64, 128, 128, 1.0), (2, 2048, 4, 32, 128, 16, 1.0),
    (2, 512, 8, 64, 128, 128, 8.0), (1, 2048, 4, 64, 128, 128, 8.0),
    # zamba2-7b: 112 heads of 64, state 64
    (4, 512, 112, 64, 64, 128, 1.0), (1, 300, 112, 64, 64, 128, 1.0),
    (2, 512, 112, 64, 64, 128, 8.0)]


@pytest.mark.parametrize("b,s,h,p,n,q,dtype,dt_scale", [
    *((2, *shape, dtype, 1.0) for shape in SSD_SHAPES
      for dtype in (torch.float32, torch.bfloat16)),
    *((b, s, h, p, n, q, torch.bfloat16, k)
      for b, s, h, p, n, q, k in SSD_BF16_CASES)])
def test_ssd_kernel_vs_plain(cuda, b, s, h, p, n, q, dtype, dt_scale):
    ins = ssd_inputs(cuda, 5, b, s, h, p, n, dtype, dt_scale)
    before = ssd_ops.ssd_scan.launches
    y, st = ssd_ops.ssd_scan(*ins, q)
    torch.cuda.synchronize()
    assert ssd_ops.ssd_scan.launches == before + 1
    yr, sr = ssd_chunked(*ins, q)
    assert_ssd_close(y, yr, 2e-4 if dtype == torch.float32 else 1e-2)
    assert_ssd_close(st, sr, 2e-4)


def test_ssd_kernel_rejects_what_it_does_not_take(cuda):
    x, dt, A, Bm, Cm = ssd_inputs(cuda, 6, 1, 32, 2, 16, 16, torch.float32)
    with pytest.raises(ValueError, match="do not agree"):
        ssd_ops.ssd_scan(x, dt[:, :16], A, Bm, Cm, 16)
    with pytest.raises(ValueError, match="chunk"):
        ssd_ops.ssd_scan(x, dt, A, Bm, Cm, 48)
    with pytest.raises(TypeError, match="float32"):
        ssd_ops.ssd_scan(x, dt.bfloat16(), A, Bm, Cm, 16)
    strided = torch.zeros(*x.shape[:3], 2 * x.shape[3], device=cuda)
    with pytest.raises(ValueError, match="dense"):
        ssd_ops.ssd_scan(strided[..., ::2], dt, A, Bm, Cm, 16)
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        ssd_ops.ssd_scan(x[..., :6], dt, A, Bm, Cm, 16)
    off = torch.zeros(Bm.numel() + 1, device=cuda)[1:].view(Bm.shape)
    with pytest.raises(ValueError, match="16-byte boundary"):
        ssd_ops.ssd_scan(x, dt, A, off, Cm, 16)


# ---------------------------------------------------------------------------
# the row-invariant decode kernels
# ---------------------------------------------------------------------------

def weight(cuda, seed, k, n, dtype):
    """A (K, N) weight scaled as the model's (1 / sqrt(K))."""
    return (randn(cuda, seed, k, n) / k ** 0.5).to(dtype)


def check_rows(a, b, dtype):
    tol = TOL[dtype]
    torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("m", [1, 2, 4, 8, 16, 20])
@pytest.mark.parametrize("k,n,layout", [
    (64, 96, "kn"), (2048, 512, "kn"), (256, 4099, "kn"), (300, 1000, "kn"),
    (8192, 2048, "kn"), (2048, 8512, "kn"), (16384, 1024, "kn"),
    (256, 1002, "kn"), (1280, 51866, "kn"), (2048, 1000, "kn4"),
    (2048, 1000, "nk"), (64, 256, "nk")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_matmul_vs_plain_and_row_invariant(cuda, m, k, n, layout,
                                                 dtype):
    """Against x @ w; every row's bits the same alone.  The (K, N) shapes
    take K-slices (2048 x 512, 8192 x 2048, 16384 x 1024 with slices above
    16384 / 32 rows) or a ragged wave (2048 x 8512) in the plan.  Weights
    off the 16-byte grid take the narrow copies: N = 1002 (N % 8 == 2 in
    bf16), whisper's head (1280 x 51866) and "kn4", a (K, N) view whose
    rows start 4 bytes off a 16-byte boundary; bf16 N = 4099 takes the
    element path."""
    x = randn(cuda, 1, m, k, dtype=dtype)
    if layout == "kn":
        w = weight(cuda, 2, k, n, dtype)
    elif layout == "kn4":
        size = x.element_size()
        e = 4 // size
        w = weight(cuda, 2, k, n + 8, dtype)[:, e:e + n]
        assert dec_ops.weight_copy(w.data_ptr(), w.stride(0) * size,
                                   n * size) == 4
    else:
        w = weight(cuda, 2, n, k, dtype).T
    before = dec_ops.rows_matmul.launches
    out = dec_ops.rows_matmul(x, w)
    torch.cuda.synchronize()
    assert dec_ops.rows_matmul.launches == before + 1
    assert out.shape == (m, n) and out.dtype == dtype
    check_rows(out, x @ w, dtype)
    for r in range(m):
        bits_equal(dec_ops.rows_matmul(x[r:r + 1], w)[0], out[r])


@pytest.mark.parametrize("d", [64, 2048, 3584, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_rows_vs_plain_and_row_invariant(cuda, d, dtype):
    x = randn(cuda, 3, 8, d, dtype=dtype) * 3
    w = (1 + 0.1 * randn(cuda, 4, d)).to(dtype)
    out = dec_ops.rms_norm_rows(x, w, 1e-5)
    check_rows(out, dec_ref.rms_norm_ref(x, w, 1e-5), dtype)
    for m in (1, 2, 4):
        bits_equal(dec_ops.rms_norm_rows(x[:m], w, 1e-5), out[:m])
    bits_equal(dec_ops.rms_norm_rows(x[5:6], w, 1e-5), out[5:6])


def attn_case(cuda, b, s, h, kv, hd, qdt, kvdt):
    q = randn(cuda, 5, b, 1, h, hd, dtype=qdt)
    k = randn(cuda, 6, b, s, kv, hd, dtype=kvdt)
    v = randn(cuda, 7, b, s, kv, hd, dtype=kvdt)
    lens = torch.tensor([1, s, s // 3, 65, 64, 128, 7, s - 1][:b],
                        dtype=torch.int32, device=cuda).clamp(1, s)
    return q, k, v, lens


@pytest.mark.parametrize("h,kv,hd", [(32, 8, 64), (32, 32, 112),
                                     (128, 8, 128), (8, 2, 8), (4, 4, 16),
                                     (36, 36, 64)])
@pytest.mark.parametrize("qdt,kvdt", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
    (torch.float32, torch.float32)])
def test_decode_attention_vs_plain_and_invariant(cuda, h, kv, hd, qdt, kvdt):
    """Against the plain version over the whole cache; the same bits for a
    row alone, in a batch, and against a cache cut to a bucket."""
    b, s = 8, 300
    q, k, v, lens = attn_case(cuda, b, s, h, kv, hd, qdt, kvdt)
    before = dec_ops.decode_attention.launches
    out = dec_ops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert dec_ops.decode_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == qdt
    check_rows(out, dec_ref.decode_attention_ref(q, k, v, lens), qdt)
    for r in range(b):
        n = int(lens[r])
        bucket = -(-n // 32) * 32
        alone = dec_ops.decode_attention(q[r:r + 1], k[r:r + 1, :bucket],
                                         v[r:r + 1, :bucket], lens[r:r + 1])
        bits_equal(alone, out[r:r + 1])
    for m in (2, 4):
        bits_equal(dec_ops.decode_attention(q[:m], k[:m], v[:m], lens[:m]),
                   out[:m])


@pytest.mark.parametrize("h,kv,hd", [(32, 8, 64), (32, 32, 112),
                                     (128, 8, 128)])
@pytest.mark.parametrize("qdt,kvdt", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
    (torch.float32, torch.float32)])
def test_decode_attention_at_split_edges(cuda, h, kv, hd, qdt, kvdt):
    """Lengths around a split of SPLIT keys, 1 and the whole cache (more
    splits than a cluster has blocks), against the plain version; each row
    alone, and over a bucket that ends inside a split, with the bits of the
    batch over the whole cache."""
    sp, s = dec_ops.SPLIT, 600
    q = randn(cuda, 5, 5, 1, h, hd, dtype=qdt)
    k = randn(cuda, 6, 5, s, kv, hd, dtype=kvdt)
    v = randn(cuda, 7, 5, s, kv, hd, dtype=kvdt)
    lens = torch.tensor([sp - 1, sp, sp + 1, 1, s], dtype=torch.int32,
                        device=cuda)
    out = dec_ops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    check_rows(out, dec_ref.decode_attention_ref(q, k, v, lens), qdt)
    for r in range(5):
        bits_equal(dec_ops.decode_attention(q[r:r + 1], k[r:r + 1],
                                            v[r:r + 1], lens[r:r + 1]),
                   out[r:r + 1])
    cut = 2 * sp + 7                         # inside the third split
    short = lens.clamp(max=cut)
    bits_equal(dec_ops.decode_attention(q, k[:, :cut], v[:, :cut], short),
               dec_ops.decode_attention(q, k, v, short))


def test_decode_kernels_leave_their_counters_at_zero(cuda):
    """rows_matmul's merging block resets its ticket counter: two calls in
    a row give the same bits (attention's too), and every counter is zero
    after them."""
    x = randn(cuda, 1, 4, 8192, dtype=torch.bfloat16)
    w = weight(cuda, 2, 8192, 2048, torch.bfloat16)
    _, ks = dec_ops.rows_plan(8192, 2048, 2, dec_ops._sms(x.device.index))
    assert ks < 8192                          # the plan splits K
    q, k, v, lens = attn_case(cuda, 8, 300, 32, 8, 64, torch.bfloat16,
                              torch.bfloat16)
    first = (dec_ops.rows_matmul(x, w), dec_ops.decode_attention(q, k, v,
                                                                 lens))
    second = (dec_ops.rows_matmul(x, w), dec_ops.decode_attention(q, k, v,
                                                                  lens))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        bits_equal(a, b)
    assert int(dec_ops._counters(x.device, 1).abs().sum()) == 0


@pytest.mark.parametrize("h,p,n", [(64, 64, 128), (112, 64, 64),
                                   (8, 16, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_decode_step_vs_plain_and_invariant(cuda, h, p, n, dtype):
    b = 8
    conv = randn(cuda, 8, b, 1, h * p + 2 * n, dtype=dtype)
    x = conv[:, 0, :h * p].reshape(b, h, p)
    Bm, Cm = conv[:, 0, h * p:h * p + n], conv[:, 0, h * p + n:]
    dt = torch.nn.functional.softplus(randn(cuda, 9, b, h))
    A = -torch.exp(randn(cuda, 10, h) * 0.3)
    state0 = randn(cuda, 11, b, h, p, n)
    st_k, st_p = state0.clone(), state0.clone()
    before = dec_ops.ssm_decode_step.launches
    y = dec_ops.ssm_decode_step(st_k, x, dt, A, Bm, Cm)
    torch.cuda.synchronize()
    assert dec_ops.ssm_decode_step.launches == before + 1
    yr = dec_ref.ssm_decode_ref(st_p, x, dt, A, Bm, Cm)
    check_rows(y, yr, dtype)
    torch.testing.assert_close(st_k, st_p, rtol=2e-5, atol=2e-5)
    for m in (1, 2, 4):
        st = state0[:m].clone()
        bits_equal(dec_ops.ssm_decode_step(st, x[:m], dt[:m], A, Bm[:m],
                                           Cm[:m]), y[:m])
        bits_equal(st, st_k[:m])


@pytest.mark.parametrize("shape,cut", [((3, 5, 160), None),
                                       ((4, 512, 8192), None),
                                       ((2, 7, 296), 128), ((1, 8), None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_silu_kernel_bit_equal(cuda, shape, cut, dtype):
    """One pass with the plain version's four roundings: the same bits, on
    a contiguous tensor and on a last-dim slice read in place."""
    x = randn(cuda, 12, *shape, dtype=dtype) * 4
    if cut is not None:
        x = x[..., :cut]
    before = silu_ops.silu.launches
    y = silu_ops.silu(x)
    torch.cuda.synchronize()
    assert silu_ops.silu.launches == before + 1 and y.is_contiguous()
    bits_equal(y, silu_ref(x))


def test_silu_every_bf16_input(cuda):
    """The shared SiLU (approximate exp and reciprocal, the exact chain
    where a rounding could differ) against the plain version over all
    65536 bf16 inputs, NaNs and infinities included."""
    x = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16) \
        .view(torch.bfloat16).to(cuda)
    bits_equal(silu_ops.silu(x), silu_ref(x))


@pytest.mark.parametrize("c,s,off,k", [
    (4352, 1, 16, 4), (4352, 512, 16, 4), (7296, 1, 16, 4),
    (7296, 512, 16, 4), (160, 9, 16, 4), (160, 20, 1, 4), (36, 3, 1, 4),
    (36, 1, 0, 4), (160, 9, 16, 3), (160, 1, 16, 2), (36, 5, 1, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_silu_bit_equal(cuda, c, s, off, k, dtype):
    """The conv pass against the plain chain, bit for bit: output and the
    shifted conv_buf, with a cache and without, conv_in read in place from
    a wider row (16-byte units at an offset of 16 elements, single
    elements otherwise), zero inputs against negative weights included
    (the chain's sum from 0 turns their -0 products into +0); conv widths
    4 (the models'), 3 and 2."""
    b = 4
    row = randn(cuda, 1, b, s, c + 40, dtype=dtype) * 2
    row[..., ::5] = 0
    conv_in = row[..., off:off + c]
    w = randn(cuda, 2, k, c, dtype=dtype) * 0.5
    bias = randn(cuda, 3, c, dtype=dtype) * 0.1
    bias[::3] = 0
    hist = randn(cuda, 4, b, k - 1, c, dtype=dtype)
    before = silu_ops.conv_silu.launches
    hk, hp = hist.clone(), hist.clone()
    bits_equal(silu_ops.conv_silu(hk, conv_in, w, bias),
               conv_silu_ref(hp, conv_in, w, bias))
    bits_equal(hk, hp)
    bits_equal(silu_ops.conv_silu(None, conv_in, w, bias),
               conv_silu_ref(None, conv_in, w, bias))
    assert silu_ops.conv_silu.launches == before + 2


@pytest.mark.parametrize("d", [2048, 2304, 3584, 4096, 16384])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_rows_at_model_widths(cuda, d, dtype):
    """Within 3e-2 (1 + |plain|) (bf16; float32 2e-5) of the plain float32
    chain over a prefill's 2048 rows, and a row's bits the same alone, in
    a batch of 4 and among the 2048."""
    x = randn(cuda, 3, 2048, d, dtype=dtype) * 3
    w = (1 + 0.1 * randn(cuda, 4, d)).to(dtype)
    out = dec_ops.rms_norm_rows(x, w, 1e-5)
    want = dec_ref.rms_norm_ref(x, w, 1e-5).float()
    assert ((out.float() - want).abs()
            <= TOL[dtype] * (1 + want.abs())).all()
    bits_equal(dec_ops.rms_norm_rows(x[:4], w, 1e-5), out[:4])
    for r in (0, 3, 1000, 2047):
        bits_equal(dec_ops.rms_norm_rows(x[r:r + 1], w, 1e-5), out[r:r + 1])


@pytest.mark.parametrize("d", [64, 1000, 2048, 3584, 16384])
@pytest.mark.parametrize("m", [1, 4, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_residual_norm_moves_no_bit(cuda, d, m, dtype):
    """h + delta and its norm in one launch: h' bit-equal to the plain add,
    the normed rows bit-equal to the norm kernel on h'."""
    h = randn(cuda, 5, m, d, dtype=dtype) * 3
    delta = randn(cuda, 6, m, d, dtype=dtype)
    w = (1 + 0.1 * randn(cuda, 7, d)).to(dtype)
    before = dec_ops.residual_rms_norm_rows.launches
    hk, xk = dec_ops.residual_rms_norm_rows(h, delta, w, 1e-5)
    assert dec_ops.residual_rms_norm_rows.launches == before + 1
    bits_equal(hk, h + delta)
    bits_equal(xk, dec_ops.rms_norm_rows(h + delta, w, 1e-5))


@pytest.mark.parametrize("h,p,n,s", [(64, 64, 128, 1), (64, 64, 128, 512),
                                     (112, 64, 64, 1), (112, 64, 64, 512),
                                     (8, 16, 16, 9), (6, 12, 16, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gated_norm_moves_no_bit(cuda, h, p, n, s, dtype):
    """The mamba block's tail in one launch, bit-equal to the norm kernel on
    the plain skip and gate; z and xh read in place from their slices
    (head sizes of whole 16-byte units, and not)."""
    b, di = 4, h * p
    zx = randn(cuda, 8, b, s, 2 * di + 2 * n + h, dtype=dtype) * 3
    conv = randn(cuda, 9, b, s, di + 2 * n, dtype=dtype)
    z, xh = zx[..., :di], conv[..., :di].reshape(b, s, h, p)
    y = randn(cuda, 10, b, s, h, p, dtype=dtype)
    D = 1 + 0.5 * randn(cuda, 11, h)
    w = (1 + 0.1 * randn(cuda, 12, di)).to(dtype)
    got = dec_ops.gated_rms_norm_rows(y, D, xh, z, w, 1e-5)
    g = (y + D[None, None, :, None].to(dtype) * xh).reshape(z.shape) \
        * silu_ref(z)
    bits_equal(got, dec_ops.rms_norm_rows(g, w, 1e-5))
    bits_equal(dec_ops.gated_rms_norm_rows(y[:1], D, xh[:1], z[:1], w, 1e-5),
               got[:1])


def test_decode_kernels_refuse_what_they_do_not_take(cuda):
    x = randn(cuda, 0, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="dtypes"):
        dec_ops.rows_matmul(x, randn(cuda, 1, 64, 8))
    with pytest.raises(ValueError, match="strides"):
        dec_ops.rows_matmul(x, randn(cuda, 1, 64, 16, dtype=torch.bfloat16)
                            [:, ::2])
    q, k, v, lens = attn_case(cuda, 2, 40, 8, 2, 16, torch.bfloat16,
                              torch.bfloat16)
    with pytest.raises(TypeError, match="int32"):
        dec_ops.decode_attention(q, k, v, lens.long())
    with pytest.raises(TypeError, match="not taken"):
        dec_ops.decode_attention(q, k.float(), v.float(), lens)
    q, k, v, lens = attn_case(cuda, 2, 40, 64, 2, 16, torch.bfloat16,
                              torch.bfloat16)
    with pytest.raises(ValueError, match="group"):
        dec_ops.decode_attention(q, k, v, lens)


# ---------------------------------------------------------------------------
# the serving path at the smoke config, through the kernels
# ---------------------------------------------------------------------------

PROMPT, GEN = 40, 8


@pytest.fixture(params=["granite-3-2b", "mamba2-1.3b", "zamba2-7b"])
def smoke(cuda, request):
    cfg = get_config(request.param, "smoke").replace(n_layers=4)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    cpu = init_params(cfg, gen, device="cpu")
    return cfg, cpu, tree_map(lambda t: t.to(cuda), cpu)


def test_model_on_card_matches_cpu(smoke):
    """Teacher-forced logits: prefill (the flash or SSD kernel, or both)
    and 6 decode steps on the card against the same model on the CPU.
    zamba2's bf16 logits move by more than 5e-2 wherever its products round
    differently (on the CPU its bf16 run is 0.12 off its float32 run), so
    there the card is held to the CPU's own accuracy: no further from the
    float32 run on the CPU than twice the CPU's bf16 run is."""
    cfg, cpu, gpu = smoke
    tokens = make_batch(cfg, 2, PROMPT, seed=1)["tokens"]
    models = [(cfg, cpu), (cfg, gpu)]
    if cfg.family == "hybrid":
        models.append((cfg.replace(param_dtype="float32"),
                       tree_map(lambda t: t.float(), cpu)))
    runs, forced = [], None             # the CPU's greedy tokens
    with torch.inference_mode():
        for mcfg, params in models:
            dev = params["embed"].device
            cache = init_serve_cache(mcfg, 2, PROMPT + GEN, device=dev)
            logits, cache = prefill(
                mcfg, params, {"tokens": torch.as_tensor(tokens,
                                                         device=dev)},
                cache)
            out, fed = [logits.float().cpu()], []
            for i in range(6):
                t = out[-1].argmax(-1) if forced is None else forced[i]
                fed.append(t)
                logits, cache = decode_step(mcfg, params, t.int().to(dev),
                                            cache, kv_bucket=PROMPT + GEN)
                out.append(logits.float().cpu())
            runs.append(out)
            forced = forced or fed
    if cfg.family == "hybrid":
        on_cpu, on_card, exact = (torch.stack(r) for r in runs)
        assert (on_card - exact).abs().max() <= \
            2 * (on_cpu - exact).abs().max()
        return
    for a, b in zip(*runs):
        torch.testing.assert_close(b, a, rtol=5e-2, atol=5e-2)


def test_pipelines_on_card(smoke):
    """Raw wire: bit-identical to ServeEngine, across a kill; int8 wire: a
    kill changes nothing; and the kernels were launched."""
    cfg, _, gpu = smoke
    batch = make_batch(cfg, 3, PROMPT, seed=2)
    kernels.reset_launch_counts()
    mono = ServeEngine(cfg, gpu, max_len=PROMPT + GEN, kv_block=8).generate(
        batch, GEN)
    kill = {"after_step": 2, "stage": 1}
    raw = PipelineServeEngine(cfg, gpu, from_block_cuts(cfg, [2],
                                                        spare_nodes=(9,)),
                              max_len=PROMPT + GEN, kv_block=8)
    np.testing.assert_array_equal(raw.generate(batch, GEN), mono)
    np.testing.assert_array_equal(raw.generate(batch, GEN, kill=kill), mono)
    i8 = PipelineServeEngine(cfg, gpu, from_block_cuts(
        cfg, [1, 3], spare_nodes=(9,), wire_bits=8), max_len=PROMPT + GEN,
        kv_block=8)
    clean = i8.generate(batch, GEN)
    np.testing.assert_array_equal(i8.generate(batch, GEN, kill=kill), clean)
    counts = kernels.launch_counts()
    attn = {"flash_attention", "decode_attention", "residual_rms_norm_rows"}
    mamba = {"ssd", "ssm_decode_step", "conv_silu", "gated_rms_norm_rows"}
    mixers = {"dense": attn, "ssm": mamba,
              "hybrid": attn | mamba}[cfg.family]
    assert {n for n, c in counts.items() if c} == mixers | {
        "quantize", "dequantize", "rows_matmul", "rms_norm_rows"}, counts


def test_decode_step_ops_row_invariant_on_card(smoke, monkeypatch):
    """The hunt, op by op: every row kernel call of one decode step of the
    smoke model at 4 rows is replayed on each row alone (and decode
    attention also over a bucket of the cache): the kernel's rows keep
    their bits, and the plain versions that differ are printed (the ops
    the kernels replace for that reason)."""
    cfg, _, gpu = smoke
    from repro_torch.models import layers, ssm
    calls = []
    for mod, name in ((layers, "rows_matmul"), (layers, "rms_norm_rows"),
                      (layers, "decode_attention"),
                      (ssm, "ssm_decode_step")):
        fn = getattr(mod, name)

        def rec(*args, _fn=fn, _name=name):
            calls.append((_name, [a.clone() if isinstance(a, torch.Tensor)
                                  else a for a in args]))
            return _fn(*args)
        monkeypatch.setattr(mod, name, rec)
    tokens = make_batch(cfg, 4, PROMPT, seed=4)["tokens"]
    with torch.inference_mode():
        cache = init_serve_cache(cfg, 4, PROMPT + GEN, device=gpu["embed"]
                                 .device)
        logits, cache = prefill(cfg, gpu, {"tokens": torch.as_tensor(
            tokens, device=gpu["embed"].device)}, cache)
        calls.clear()
        decode_step(cfg, gpu, logits.argmax(-1).int(), cache)
    assert calls
    plain = {"rows_matmul": dec_ref.rows_matmul_ref,
             "rms_norm_rows": dec_ref.rms_norm_ref,
             "decode_attention": dec_ref.decode_attention_ref,
             "ssm_decode_step": dec_ref.ssm_decode_ref}
    kernel = {n: getattr(dec_ops, n) for n in plain}
    batched = {"rows_matmul": (0,), "rms_norm_rows": (0,),
               "decode_attention": (0, 1, 2, 3),
               "ssm_decode_step": (0, 1, 2, 4, 5)}
    differ = set()
    with torch.inference_mode():
        for name, args in calls:
            def rows(r, a=args, name=name):
                return [x[r] if i in batched[name] else x
                        for i, x in enumerate(a)]

            def run(fn, a):
                a = [x.clone() if isinstance(x, torch.Tensor) else x
                     for x in a]
                return fn(*a)
            for which, fn in (("kernel", kernel[name]),
                              ("plain", plain[name])):
                whole = run(fn, args)
                for r in range(4):
                    alone = run(fn, rows(slice(r, r + 1)))
                    if not torch.equal(alone.view(torch.uint8),
                                       whole[r:r + 1].contiguous()
                                       .view(torch.uint8)):
                        assert which == "plain", (name, r)
                        differ.add(f"{name} (rows)")
            if name == "decode_attention":
                q, k, v, lens = args
                cut = -(-int(lens.max()) // 8) * 8
                for which, fn in (("kernel", kernel[name]),
                                  ("plain", plain[name])):
                    same = torch.equal(fn(q, k[:, :cut], v[:, :cut], lens)
                                       .view(torch.uint8),
                                       fn(q, k, v, lens).view(torch.uint8))
                    if not same:
                        assert which == "plain", "the kernel's bucket"
                        differ.add(f"{name} (bucket)")
    print(f"{cfg.name}: plain ops whose row bits depend on the batch or "
          f"the bucket: {sorted(differ) or 'none'}")


def test_loops_bit_identical_on_card(smoke):
    """The fast loop (decode attention over a kv bucket) and the reference
    loop (over the whole cache) give the same logits, bit for bit."""
    cfg, _, gpu = smoke
    eng = ServeEngine(cfg, gpu, max_len=PROMPT + GEN, kv_block=8)
    batch = make_batch(cfg, 3, PROMPT, seed=3)
    fast = eng.generate(batch, GEN, collect_logits=True)
    ref = eng.generate(batch, GEN, engine="reference", collect_logits=True)
    np.testing.assert_array_equal(fast[0], ref[0])
    assert fast[1].tobytes() == ref[1].tobytes()


def slot_schedule(requests, slots):
    """Slot -> request id at each batched decode step, as
    ``SlotScheduler.run`` admits (arrival order, lowest free slot) and
    evicts."""
    free, active, nxt, maps = list(range(slots)), {}, 0, []
    while nxt < len(requests) or active:
        while free and nxt < len(requests):
            r = requests[nxt]
            nxt += 1
            slot = free.pop(0)
            if r.gen_len > 1:
                active[slot] = [r, 1]
            else:
                free.append(slot)
                free.sort()
        if not active:
            continue
        maps.append({slot: st[0].rid for slot, st in active.items()})
        for slot in list(active):
            active[slot][1] += 1
            if active[slot][1] >= active[slot][0].gen_len:
                del active[slot]
                free.append(slot)
        free.sort()
    return maps


def test_stream_bit_identical_to_solo_on_card(smoke, monkeypatch):
    """Each request of a SlotScheduler stream (4 slots, staggered) gets the
    tokens and, at every decode step, the logits bits of the same request
    served alone by the reference loop."""
    cfg, _, gpu = smoke
    eng = ServeEngine(cfg, gpu, max_len=PROMPT + GEN, kv_block=8)
    reqs = [scheduler.Request(i, make_batch(cfg, 1, pl, seed=40 + i)[
        "tokens"], gl) for i, (pl, gl) in enumerate(
            [(24, 6), (24, 4), (36, 7), (24, 5), (40, 3), (24, 6)])]
    recorded, decode = [], scheduler.decode_step

    def recording(*args, **kw):
        logits, cache = decode(*args, **kw)
        recorded.append(logits[:, 0].cpu())
        return logits, cache

    monkeypatch.setattr(scheduler, "decode_step", recording)
    streams, _ = scheduler.SlotScheduler(eng, 4).run(reqs)
    maps = slot_schedule(reqs, 4)
    assert len(maps) == len(recorded)
    for r, got in zip(reqs, streams):
        toks, logits = eng.generate({"tokens": r.tokens}, r.gen_len,
                                    engine="reference", collect_logits=True)
        np.testing.assert_array_equal(got, toks[0])
        steps = torch.stack([recorded[i][slot] for i, m in enumerate(maps)
                             for slot, rid in m.items() if rid == r.rid])
        assert steps.numpy().tobytes() == logits[0, 1:].tobytes()


# ---------------------------------------------------------------------------
# the encoder-decoder and the VLM: the new shapes and the smoke models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1500, 333])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_non_causal_encoder(cuda, s, dtype):
    """The whisper encoder's self-attention: non-causal, H = KV = 20 heads
    of 64, S ragged against every tile."""
    q = randn(cuda, 20, 2, s, 20, 64, dtype=dtype)
    k = randn(cuda, 21, 2, s, 20, 64, dtype=dtype)
    v = randn(cuda, 22, 2, s, 20, 64, dtype=dtype)
    out = attn_ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(),
                               flash_ref(q, k, v, causal=False).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("h,kv,hd,s", [(20, 20, 64, 1500),
                                       (64, 8, 128, 640)])
@pytest.mark.parametrize("qdt", [torch.bfloat16, torch.float32])
def test_decode_attention_over_a_cross_cache(cuda, h, kv, hd, s, qdt):
    """Cross-attention at decode: every row reads the whole fixed cache
    (``kv_len`` = its length); within 3e-2 (1 + |plain|) of the plain
    version, and a row's bits the same alone and in batches of 2, 4 and
    8."""
    q = randn(cuda, 23, 8, 1, h, hd, dtype=qdt)
    k = randn(cuda, 24, 8, s, kv, hd, dtype=torch.bfloat16)
    v = randn(cuda, 25, 8, s, kv, hd, dtype=torch.bfloat16)
    lens = torch.full((8,), s, dtype=torch.int32, device=cuda)
    out = dec_ops.decode_attention(q, k, v, lens)
    check_rows(out, dec_ref.decode_attention_ref(q, k, v, lens), qdt)
    for m in (1, 2, 4):
        for r in range(0, 8, m):
            bits_equal(dec_ops.decode_attention(q[r:r + m], k[r:r + m],
                                                v[r:r + m], lens[r:r + m]),
                       out[r:r + m])


def side_launches(cfg, prefills, steps):
    """Kernel launches of ``prefills`` prefills and ``steps`` decode steps
    of the VLM or the encoder-decoder (``chip_smoke.expected_launches``):
    flash once a self-attention layer and an encoder layer a prefill, none
    for cross-attention; a decode step's self layers 7 ``rows_matmul`` and
    one ``decode_attention``, the VLM's cross blocks 5 and one, the
    decoder blocks 9 and two; norms as in the dense block (the decoder
    block has two residual norms), the encoder's once a prefill with its
    final norm; the head's ``rows_matmul`` a step and a prefill."""
    want = dict.fromkeys(kernels.WRAPPERS, 0)
    n, enc = cfg.n_layers, cfg.n_enc_layers
    if cfg.family == "vlm":
        cross = n // (cfg.cross_attn_every + 1)
        selfs, dec, enc = n - cross, 0, 0
    else:
        selfs, cross, dec = 0, 0, n
    passes = prefills + steps
    want["flash_attention"] = (selfs + dec + enc) * prefills
    want["decode_attention"] = (selfs + cross + 2 * dec) * steps
    want["rows_matmul"] = (7 * selfs + 5 * cross + 9 * dec + 1) * steps \
        + prefills
    want["rms_norm_rows"] = (selfs + cross + dec + 1) * passes \
        + (enc + (dec > 0)) * prefills
    want["residual_rms_norm_rows"] = (selfs + cross + 2 * dec) * passes \
        + enc * prefills
    return want


@pytest.fixture(params=["whisper-large-v3", "llama-3.2-vision-90b"])
def side_smoke(cuda, request):
    cfg = get_config(request.param, "smoke")
    if cfg.family == "vlm":
        cfg = cfg.replace(n_layers=10)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    cpu = init_params(cfg, gen, device="cpu")
    return cfg, cpu, tree_map(lambda t: t.to(cuda), cpu)


def test_side_input_models_on_card(side_smoke, monkeypatch):
    """Both loops bit-identical with exact launch counts; the raw-wire
    pipeline equal to ServeEngine across a kill; a stream (each request
    with its own side input) bit-identical, tokens and every step's
    logits, to each request served alone."""
    cfg, _, gpu = side_smoke
    eng = ServeEngine(cfg, gpu, max_len=PROMPT + GEN, kv_block=8)
    batch = make_batch(cfg, 3, PROMPT, seed=3, frames_len=50)
    kernels.reset_launch_counts()
    fast = eng.generate(batch, GEN, collect_logits=True)
    assert kernels.launch_counts() == side_launches(cfg, 1, GEN - 1)
    ref = eng.generate(batch, GEN, engine="reference", collect_logits=True)
    np.testing.assert_array_equal(fast[0], ref[0])
    assert fast[1].tobytes() == ref[1].tobytes()
    cut = [5] if cfg.family == "vlm" else [1]
    raw = PipelineServeEngine(cfg, gpu, from_block_cuts(
        cfg, cut, spare_nodes=(9,)), max_len=PROMPT + GEN, kv_block=8)
    np.testing.assert_array_equal(
        raw.generate(batch, GEN, kill={"after_step": 2, "stage": 1}),
        fast[0])

    reqs = []
    for i, (pl, gl) in enumerate([(24, 6), (24, 4), (36, 7), (24, 5),
                                  (40, 3), (24, 6)]):
        one = make_batch(cfg, 1, pl, seed=40 + i, frames_len=50)
        reqs.append(scheduler.Request(i, one.pop("tokens"), gl, extras=one))
    recorded, decode = [], scheduler.decode_step

    def recording(*args, **kw):
        logits, cache = decode(*args, **kw)
        recorded.append(logits[:, 0].cpu())
        return logits, cache

    monkeypatch.setattr(scheduler, "decode_step", recording)
    kernels.reset_launch_counts()
    streams, stats = scheduler.SlotScheduler(eng, 4).run(reqs)
    assert kernels.launch_counts() == side_launches(
        cfg, len(reqs), stats["decode_steps"])
    maps = slot_schedule(reqs, 4)
    for r, got in zip(reqs, streams):
        toks, logits = eng.generate({"tokens": r.tokens, **r.extras},
                                    r.gen_len, engine="reference",
                                    collect_logits=True)
        np.testing.assert_array_equal(got, toks[0])
        steps = torch.stack([recorded[i][slot] for i, m in enumerate(maps)
                             for slot, rid in m.items() if rid == r.rid])
        assert steps.numpy().tobytes() == logits[0, 1:].tobytes()


# ---------------------------------------------------------------------------
# the MoE family (deepseek-v3 with MLA, llama4-maverick) at the smoke config
# ---------------------------------------------------------------------------

def moe_launches(cfg, prefills, steps):
    """Kernel launches of ``prefills`` prefills and ``steps`` decode steps
    of a MoE model (``chip_smoke.expected_launches``): llama4's GQA blocks
    (dense and MoE alike) flash once a prefill and one
    ``decode_attention`` a step, MLA neither (plain attention); a decode
    step's block 7 ``rows_matmul`` (q/k/v/o or MLA's wdq, wuq, wdkv, wo,
    and the shared expert's three; the router and the experts are plain
    matmuls) and the head's, a prefill's head one; a pass's block one
    ``rms_norm_rows`` (ln1) and, for MLA, two more (q_norm, kv_norm), one
    ``residual_rms_norm_rows`` (ln2), and the final norm."""
    want = dict.fromkeys(kernels.WRAPPERS, 0)
    n, passes = cfg.n_layers, prefills + steps
    attn = 0 if cfg.use_mla else n
    want["flash_attention"] = attn * prefills
    want["decode_attention"] = attn * steps
    want["rows_matmul"] = (7 * n + 1) * steps + prefills
    want["rms_norm_rows"] = ((3 if cfg.use_mla else 1) * n + 1) * passes
    want["residual_rms_norm_rows"] = n * passes
    return want


@pytest.fixture(params=["deepseek-v3-671b", "llama4-maverick-400b-a17b"])
def moe_smoke(cuda, request):
    cfg = get_config(request.param, "smoke")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    cpu = init_params(cfg, gen, device="cpu")
    return cfg, cpu, tree_map(lambda t: t.to(cuda), cpu)


def test_moe_models_on_card(moe_smoke):
    """Both loops bit-identical in tokens and every step's logits, with
    exact launch counts (MLA ignores the bucket and reads the whole cache
    in both); the raw-wire pipeline over a group-aligned cut equal to
    ServeEngine, across a kill too; the int8 wire's kill changes
    nothing."""
    cfg, _, gpu = moe_smoke
    eng = ServeEngine(cfg, gpu, max_len=PROMPT + GEN, kv_block=8)
    batch = make_batch(cfg, 3, PROMPT, seed=3)
    kernels.reset_launch_counts()
    fast = eng.generate(batch, GEN, collect_logits=True)
    assert kernels.launch_counts() == moe_launches(cfg, 1, GEN - 1)
    ref = eng.generate(batch, GEN, engine="reference", collect_logits=True)
    np.testing.assert_array_equal(fast[0], ref[0])
    assert fast[1].tobytes() == ref[1].tobytes()
    kill = {"after_step": 2, "stage": 1}
    cut = [cfg.moe_interleave]
    raw = PipelineServeEngine(cfg, gpu, from_block_cuts(
        cfg, cut, spare_nodes=(9,)), max_len=PROMPT + GEN, kv_block=8)
    np.testing.assert_array_equal(raw.generate(batch, GEN), fast[0])
    np.testing.assert_array_equal(raw.generate(batch, GEN, kill=kill),
                                  fast[0])
    i8 = PipelineServeEngine(cfg, gpu, from_block_cuts(
        cfg, cut, spare_nodes=(9,), wire_bits=8), max_len=PROMPT + GEN,
        kv_block=8)
    np.testing.assert_array_equal(i8.generate(batch, GEN, kill=kill),
                                  i8.generate(batch, GEN))


@pytest.mark.parametrize("rows", [(4, 1), (3, PROMPT)])
def test_moe_ffn_repeats_bit_for_bit_on_card(moe_smoke, rows):
    """Two runs of ``moe_ffn`` on the same input give the same bits (the
    combine gathers: no atomics), at a decode step's rows and a prefill's;
    and within 5e-2 of the CPU's where no token's routing differs."""
    from repro_torch.models import layers, model
    cfg, cpu, gpu = moe_smoke
    x = randn(gpu["embed"].device, 30, *rows, cfg.d_model,
              dtype=torch.bfloat16)
    p = model.layer_view(gpu["groups"]["moe"]["moe"], 0)
    with torch.inference_mode():
        a, aux_a = layers.moe_ffn(p, x, cfg)
        b, aux_b = layers.moe_ffn(p, x, cfg)
        bits_equal(a, b)
        assert torch.equal(aux_a, aux_b)
        pc = model.layer_view(cpu["groups"]["moe"]["moe"], 0)
        xc = x.cpu()
        on_cpu, _ = layers.moe_ffn(pc, xc, cfg)
        k = cfg.experts_per_tok
        same = (layers._route(p, x.reshape(-1, cfg.d_model), k)[2].cpu()
                == layers._route(pc, xc.reshape(-1, cfg.d_model), k)[2])
    if bool(same.all()):
        torch.testing.assert_close(a.cpu().float(), on_cpu.float(),
                                   rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("s,causal", [(512, True), (300, True),
                                      (200, False)])
@pytest.mark.parametrize("h,kv", [(10, 2), (40, 8)])
def test_flash_kernel_group_of_five(cuda, s, causal, h, kv):
    """llama4's prefill attention: q heads in groups of 5 over kv heads of
    128 (40 over 8 at full width), within the bf16 flash tolerance."""
    q = randn(cuda, 31, 2, s, h, 128, dtype=torch.bfloat16)
    k = randn(cuda, 32, 2, s, kv, 128, dtype=torch.bfloat16)
    v = randn(cuda, 33, 2, s, kv, 128, dtype=torch.bfloat16)
    out = attn_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref = flash_ref(q, k, v, causal=causal)
    assert (out.float() - ref.float()).abs().max().item() <= \
        TOL[torch.bfloat16]


# ---------------------------------------------------------------------------
# the fault surface on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("int8", [False, True])
def test_transport_round_trip_on_card(cuda, int8):
    """A bf16 payload, or the wire kernels' (q, scale), through a faulty
    transport: delivered on the card bit for bit, with the CRC32 of the
    same payload on the CPU."""
    from repro_torch.serve import transport
    x = randn(cuda, 41, 2, 12, 2048, dtype=torch.bfloat16)
    payload = q_ops.rowwise_quantize(x) if int8 else x
    leaves = payload if int8 else (payload,)
    tr = transport.BoundaryTransport(
        1, faults=transport.parse_wire_faults(
            [["drop", 0, 0], ["corrupt", 0, 0, 77], ["dup", 0, 0]]),
        sleep=lambda s: None)
    frame, _ = tr._to_frame(0, payload)
    cpu = tuple(t.cpu() for t in leaves)
    cpu_frame, _ = tr._to_frame(0, cpu if int8 else cpu[0])
    assert frame.crc == cpu_frame.crc
    out = tr.send(0, payload)
    got = out if int8 else (out,)
    for a, b in zip(got, leaves):
        assert a.device.type == "cuda"
        bits_equal(a, b)
    assert tr.exactly_once() and tr.stats[0].retransmits == 2


def test_fault_surface_on_card(cuda):
    """The granite smoke pipeline on the card through a faulty wire, then
    with a silent kill found by the heartbeat monitor: the tokens of the
    undisturbed run."""
    from repro_torch.serve import retry, transport
    cfg = get_config("granite-3-2b", "smoke").replace(n_layers=4)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    gpu = tree_map(lambda t: t.to(cuda), init_params(cfg, gen, device="cpu"))
    batch = make_batch(cfg, 2, PROMPT, seed=4)
    for bits in (0, 8):
        eng = PipelineServeEngine(cfg, gpu, from_block_cuts(
            cfg, [1, 3], spare_nodes=(9,), wire_bits=bits),
            max_len=PROMPT + GEN, kv_block=8)
        calm = eng.generate(batch, GEN)
        clk = transport.FakeWireClock()
        mon = transport.HeartbeatMonitor(3, clock=clk, sleep=clk.sleep)
        tr = transport.BoundaryTransport(
            2, faults=transport.seeded_wire_faults(0, 2, GEN, rate=0.3),
            policy=retry.RetryPolicy(attempts=6, base_delay_s=0.05),
            monitor=mon, clock=clk, sleep=clk.sleep)
        eng.attach_wire(tr, mon)
        np.testing.assert_array_equal(eng.generate(batch, GEN), calm)
        assert tr.exactly_once() and tr.total("retransmits")
        toks = eng.generate(batch, GEN, kill={"after_step": 2, "stage": 1,
                                              "silent": True})
        np.testing.assert_array_equal(toks, calm)
        assert len(eng.detections) == 1 and eng.node_of_stage[1] == 9


# ---------------------------------------------------------------------------
# the overlapped executor's fused chain (CUDA graphs) and pipelined streams
# ---------------------------------------------------------------------------

@pytest.fixture
def granite_card(cuda):
    cfg = get_config("granite-3-2b", "smoke").replace(n_layers=4)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    return cfg, tree_map(lambda t: t.to(cuda),
                         init_params(cfg, gen, device="cpu"))


@pytest.mark.parametrize("wire_bits", [0, 8])
def test_fused_graphs_bit_identical_to_staged(granite_card, tmp_path,
                                              wire_bits):
    """The fused chain (one CUDA graph a micro-batch, replayed) against
    the staged eager schedule (per-stage devices given): the same tokens
    and every step's logits bit for bit, also each micro-batch against the
    sequential chain serving its rows alone; a second generate replays
    the same graphs (no new capture).  The kernel launch counts are the
    launches that ran: a fused run (eager first steps, then replays; the
    capture counts nothing) counts what the staged run counts."""
    cfg, gpu = granite_card
    plan = from_block_cuts(cfg, [1, 2, 3], spare_nodes=(90, 91),
                           wire_bits=wire_bits)
    batch = make_batch(cfg, 4, PROMPT, seed=5)
    fused, staged = (PipelineServeEngine(
        cfg, gpu, plan, max_len=PROMPT + GEN, kv_block=8, overlap=True,
        micro_batches=2, devices=dev, ckpt_dir=tmp_path / str(i))
        for i, dev in enumerate((None, ["cuda:0"] * 4)))

    def counted(eng):
        kernels.reset_launch_counts()
        out = eng.generate(batch, GEN, collect_logits=True)
        return out, kernels.launch_counts()

    (ft, fl), f_counts = counted(fused)
    n = fused.graph_captures
    assert n >= 2 and fused._fused_ok() and not staged._fused_ok()
    (st, sl), s_counts = counted(staged)
    np.testing.assert_array_equal(ft, st)
    assert fl.tobytes() == sl.tobytes()
    assert f_counts == s_counts and f_counts["rows_matmul"] > 0
    (again, al), again_counts = counted(fused)
    assert fused.graph_captures == n and again_counts == s_counts
    np.testing.assert_array_equal(again, ft)
    assert al.tobytes() == fl.tobytes()
    seq = PipelineServeEngine(cfg, gpu, plan, max_len=PROMPT + GEN,
                              kv_block=8)
    for rows in (slice(0, 2), slice(2, 4)):
        t, lg = seq.generate({"tokens": batch["tokens"][rows]}, GEN,
                             collect_logits=True)
        np.testing.assert_array_equal(ft[rows], t)
        assert fl[rows].tobytes() == lg.tobytes()


def test_fused_graphs_recaptured_after_kill_and_migration(granite_card,
                                                          tmp_path):
    """A kill and restore, then a live migration, each swap a stage's
    params: the graphs captured over the old params are dropped and
    captured again, and the tokens stay the undisturbed run's."""
    cfg, gpu = granite_card
    eng = PipelineServeEngine(
        cfg, gpu, from_block_cuts(cfg, [1, 2, 3], spare_nodes=(90, 91)),
        max_len=PROMPT + GEN, kv_block=8, overlap=True, micro_batches=2,
        ckpt_dir=tmp_path / "c")
    batch = make_batch(cfg, 4, PROMPT, seed=6)
    want = eng.generate(batch, GEN)
    n = eng.graph_captures
    toks = eng.generate(batch, GEN, kill={"after_step": 3, "stage": 1})
    np.testing.assert_array_equal(toks, want)
    assert eng.graph_captures == 2 * n
    eng.migrate_stage(2)
    assert not eng._graphs
    np.testing.assert_array_equal(eng.generate(batch, GEN), want)
    assert eng.graph_captures == 3 * n


def test_pipelined_stream_bit_identical_on_card(granite_card):
    """A stream through the pipeline engine's banks (4 slots, staggered,
    a stage kill after step 3): each request's tokens and every decode
    step's logits equal the monolithic stream's, bit for bit."""
    cfg, gpu = granite_card
    reqs = [scheduler.Request(i, make_batch(cfg, 1, pl, seed=40 + i)[
        "tokens"], gl) for i, (pl, gl) in enumerate(
            [(24, 6), (24, 4), (36, 7), (24, 5), (40, 3), (24, 6)])]
    mono = ServeEngine(cfg, gpu, max_len=PROMPT + GEN, kv_block=8)
    recorded, decode = [], scheduler.decode_step

    def recording(*args, **kw):
        logits, cache = decode(*args, **kw)
        recorded.append(logits[:, 0].cpu())
        return logits, cache

    scheduler.decode_step = recording
    try:
        want, _ = scheduler.SlotScheduler(mono, 4).run(reqs)
    finally:
        scheduler.decode_step = decode
    eng = PipelineServeEngine(cfg, gpu, from_block_cuts(
        cfg, [2], spare_nodes=(9,)), max_len=PROMPT + GEN, kv_block=8)
    got_logits, step = [], eng.bank_step

    def stepped(*args):
        toks, logits, caches = step(*args)
        got_logits.append(logits[:, 0].cpu())
        return toks, logits, caches

    eng.bank_step = stepped
    streams, _ = scheduler.SlotScheduler(eng, 4).run(reqs)
    for a, b in zip(want, streams):
        np.testing.assert_array_equal(a, b)
    assert torch.stack(got_logits).numpy().tobytes() == \
        torch.stack(recorded).numpy().tobytes()
    del eng.bank_step
    killed, _ = scheduler.SlotScheduler(eng, 4).run(
        reqs, kill={"after_step": 3, "stage": 1})
    for a, b in zip(want, killed):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the chaos campaign's serving half
# ---------------------------------------------------------------------------

def test_chaos_harness_on_card(granite_card, tmp_path):
    """The chaos harness at smoke width on the card, on the params of the
    port's CPU harness: the same baseline tokens, two campaign cases and an
    overlapped one holding every invariant through the kernels, and the
    overlapped engine's fused chain captured for its baseline."""
    from repro_torch.chaos import ChaosHarness, generate_campaign
    cfg, gpu = granite_card
    host = ChaosHarness(params=tree_map(lambda t: t.cpu(), gpu),
                        device="cpu", ckpt_dir=tmp_path / "cpu")
    card = ChaosHarness(params=gpu, device="cuda", ckpt_dir=tmp_path / "card")
    assert card.baseline == host.baseline
    kernels.reset_launch_counts()
    for case in generate_campaign(0, 2):
        assert card.run_case(case) == [], case.cid
    counts = kernels.launch_counts()
    assert all(counts[k] for k in ("flash_attention", "rows_matmul",
                                   "decode_attention")), counts
    ov = ChaosHarness(params=gpu, device="cuda", overlap=True,
                      ckpt_dir=tmp_path / "overlap")
    assert ov.baseline == host.baseline
    assert ov.eng.graph_captures > 0
    assert ov.run_case(generate_campaign(0, 1)[0]) == []



# ---------------------------------------------------------------------------
# training: the flash backward kernel, the norms' gradients, the wrappers
# without a backward, one train step against the CPU's
# ---------------------------------------------------------------------------

def grads_close(got, want, name):
    """A backward kernel's bf16 output against its plain version: within
    1e-2 (1 + |plain|) per element and within 2^-6 of the largest |plain|
    (one bf16 rounding of P or dS may differ by an ulp, and the output is
    rounded once)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    assert torch.isfinite(got).all(), name
    assert (err <= 1e-2 * (1 + want.abs())).all(), (name, err.max().item())
    assert err.max() <= 2 ** -6 * want.abs().max(), (name, err.max().item())


BWD_SHAPES = [  # (B, S, H, KV, hd): granite, llama3-405b, minicpm, ragged
    (4, 512, 32, 8, 64), (1, 512, 128, 8, 128), (1, 512, 36, 36, 64),
    (2, 300, 32, 8, 64), (2, 200, 16, 8, 128),
    # S off the 64-key and 32- or 64-query tiles, and groups split into
    # chunks of heads (8 and 16 heads a kv head)
    (2, 330, 8, 1, 64), (1, 1000, 16, 2, 128), (1, 77, 4, 4, 128)]


@pytest.mark.parametrize("b,s,h,kv,hd", BWD_SHAPES)
def test_flash_bwd_kernel_vs_plain(cuda, b, s, h, kv, hd):
    """The backward kernel against ``flash_bwd_ref`` on the same (o, lse)
    from the forward kernel, and bit-identical across two runs."""
    from repro_torch.kernels.attention.ref import flash_bwd_ref
    bf = torch.bfloat16
    q = randn(cuda, 0, b, s, h, hd, dtype=bf)
    k = randn(cuda, 1, b, s, kv, hd, dtype=bf)
    v = randn(cuda, 2, b, s, kv, hd, dtype=bf)
    do = randn(cuda, 3, b, s, h, hd, dtype=bf)
    o, lse = attn_ops._launch(q, k, v, True, s, with_lse=True)
    before = attn_ops.flash_attention_bwd.launches
    got = attn_ops.flash_attention_bwd(q, k, v, o, lse, do)
    again = attn_ops.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert attn_ops.flash_attention_bwd.launches == before + 2
    want = flash_bwd_ref(q, k, v, o, lse, do)
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        assert g.shape == w.shape and g.dtype == bf and g.is_contiguous()
        bits_equal(g, a)
        grads_close(g, w, name)


@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 64),
                                      (torch.bfloat16, 128),
                                      (torch.bfloat16, 16),
                                      (torch.float32, 64)])
def test_flash_lse_matches_plain_and_leaves_output(cuda, dtype, hd):
    q = randn(cuda, 0, 2, 300, 8, hd, dtype=dtype)
    k = randn(cuda, 1, 2, 300, 2, hd, dtype=dtype)
    v = randn(cuda, 2, 2, 300, 2, hd, dtype=dtype)
    o = attn_ops._launch(q, k, v, True, 300)
    o2, lse = attn_ops._launch(q, k, v, True, 300, with_lse=True)
    bits_equal(o, o2)
    _, want = flash_ref(q, k, v, True, with_lse=True)
    assert lse.shape == (2, 8, 300) and lse.dtype == torch.float32
    assert ((lse - want).abs() <= 1e-4 * (1 + want.abs())).all(), \
        (lse - want).abs().max().item()


def test_flash_grad_through_autograd(cuda):
    """flash_attention under grad: FlashAttentionFn's gradients are the
    backward kernel's, one forward and one backward launch; without grad
    the same output bits as the serving path."""
    bf = torch.bfloat16
    q, k, v = (randn(cuda, i, 2, 256, h, 64, dtype=bf).requires_grad_()
               for i, h in ((0, 8), (1, 2), (2, 2)))
    do = randn(cuda, 3, 2, 256, 8, 64, dtype=bf)
    kernels.reset_launch_counts()
    o = attn_ops.flash_attention(q, k, v)
    assert o.grad_fn is not None
    g = torch.autograd.grad(o, (q, k, v), do)
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == 1
    assert counts["flash_attention_bwd"] == 1
    with torch.no_grad():
        bits_equal(o.detach(), attn_ops.flash_attention(q, k, v))
        o2, lse = attn_ops._launch(q, k, v, True, 256, with_lse=True)
        want = attn_ops.flash_attention_bwd(q, k, v, o2, lse, do)
    for a, b in zip(g, want):
        bits_equal(a, b)


def test_flash_grad_refuses_what_the_backward_does_not_take(cuda):
    """float32, a head dim off ``BWD_HEAD_DIMS`` or keys past ``valid_len``
    raise before the forward runs, causal or not."""
    for dtype, hd, causal, valid in ((torch.float32, 64, True, 64),
                                     (torch.bfloat16, 32, True, 64),
                                     (torch.bfloat16, 64, False, 40),
                                     (torch.float32, 64, False, 64)):
        q = randn(cuda, 0, 1, 64, 2, hd, dtype=dtype).requires_grad_()
        k = randn(cuda, 1, 1, 64, 2, hd, dtype=dtype)
        before = attn_ops.flash_attention.launches
        with pytest.raises(NotImplementedError, match="flash_attention_bwd"):
            attn_ops.flash_attention(q, k, k, causal=causal, valid_len=valid)
        assert attn_ops.flash_attention.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_gradients_vs_plain(cuda, dtype):
    """The norms' autograd gradients on the card against autograd through
    their plain versions on the same inputs."""
    tol = TOL[dtype]
    x = randn(cuda, 0, 4, 64, 2048, dtype=dtype).requires_grad_()
    d = randn(cuda, 1, 4, 64, 2048, dtype=dtype).requires_grad_()
    w = (1 + 0.1 * randn(cuda, 2, 2048)).to(dtype).requires_grad_()
    g1 = randn(cuda, 3, 4, 64, 2048, dtype=dtype)
    g2 = randn(cuda, 4, 4, 64, 2048, dtype=dtype)
    kernels.reset_launch_counts()
    y = dec_ops.rms_norm_rows(x, w, 1e-5)
    hs, n = dec_ops.residual_rms_norm_rows(x, d, w, 1e-5)
    got = torch.autograd.grad((y * g1).sum() + (hs * g2).sum()
                              + (n * g1).sum(), (x, d, w))
    counts = kernels.launch_counts()
    assert counts["rms_norm_rows"] == 1
    assert counts["residual_rms_norm_rows"] == 1
    y = dec_ref.rms_norm_ref(x, w, 1e-5)
    hs, n = dec_ref.residual_rms_norm_ref(x, d, w, 1e-5)
    want = torch.autograd.grad((y * g1).sum() + (hs * g2).sum()
                               + (n * g1).sum(), (x, d, w))
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        assert ((a - b).abs() <= tol * (1 + b.abs())).all(), \
            (a - b).abs().max().item()


def test_wrappers_without_a_backward_raise_under_grad(cuda):
    """Every kernel without a backward raises when grad mode is on and an
    input requires grad, naming the kernel, rather than return a tensor
    without a grad_fn (the SSD scan, the cacheless conv pass and the gated
    norm have backwards: ``test_ssm_wrappers_under_grad``)."""
    bf = torch.bfloat16

    def req(*shape, dtype=bf):
        return randn(cuda, 0, *shape, dtype=dtype).requires_grad_()

    calls = {
        "rows_matmul": lambda: dec_ops.rows_matmul(req(2, 64), req(64, 64)),
        "decode_attention": lambda: dec_ops.decode_attention(
            req(2, 1, 4, 64), req(2, 16, 2, 64), req(2, 16, 2, 64),
            torch.full((2,), 8, dtype=torch.int32, device=cuda)),
        "ssm_decode_step": lambda: dec_ops.ssm_decode_step(
            torch.zeros(2, 2, 64, 16, device=cuda), req(2, 2, 64),
            torch.ones(2, 2, device=cuda), -torch.ones(2, device=cuda),
            req(2, 16), req(2, 16)),
        "silu": lambda: silu_ops.silu(req(4, 64)),
        "quantize": lambda: q_ops.quantize(req(4, 64), 1, 64),
        "dequantize": lambda: q_ops.dequantize(
            torch.ones(4, 64, dtype=torch.int8, device=cuda),
            req(4, 1, dtype=torch.float32), 1, 64),
    }
    calls["rowwise"] = lambda: q_ops.rowwise_quantize(req(4, 64))
    for name, fn in calls.items():
        with pytest.raises(NotImplementedError, match="no backward"):
            fn()
        with torch.no_grad():
            fn()                   # serving: nothing requires grad
    torch.cuda.synchronize()


def test_train_step_on_card_vs_cpu(cuda):
    """One train step of a granite smoke model widened to head dim 64 (the
    backward kernel's), bf16, on the card against the same step on the CPU
    from the same params: the loss within 2e-3, every gradient
    leaf within 3e-2 of the CPU leaf's largest value, finite and not zero;
    the step goes through the kernels' forwards and backwards."""
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.optim import adamw_init
    cfg = get_config("granite-3-2b", "smoke").replace(
        d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, remat=True)
    gen = torch.Generator().manual_seed(0)
    host = init_params(cfg, gen, device="cpu")
    card = tree_map(lambda t: t.to(cuda), host)
    tokens = torch.from_numpy(SyntheticTokens(cfg.vocab, 64, 2).batch(0)
                              ["tokens"])
    kernels.reset_launch_counts()
    m_card, g_card = loss_and_grads(cfg, card, {"tokens": tokens.to(cuda)})
    counts = kernels.launch_counts()
    m_host, g_host = loss_and_grads(cfg, host, {"tokens": tokens})
    assert counts == train_launches(cfg)    # forward and remat, backward
    loss_c, loss_h = m_card["loss"].item(), m_host["loss"].item()
    assert abs(loss_c - loss_h) <= 2e-3
    for gc, gh in zip(tree_leaves(g_card), tree_leaves(g_host)):
        gc, gh = gc.float().cpu(), gh.float()
        assert torch.isfinite(gc).all() and gc.abs().max() > 0
        assert (gc - gh).abs().max() <= 3e-2 * gh.abs().max()
    step = make_train_step(cfg)
    _, opt, metrics = step(card, adamw_init(card), {"tokens":
                                                    tokens.to(cuda)})
    assert int(opt.step) == 1 and torch.isfinite(metrics["grad_norm"])


# ---------------------------------------------------------------------------
# training the SSM family: the backward kernels and a train step
# ---------------------------------------------------------------------------

# the gated norm's bf16 gradients pass through a chain of roundings (dv,
# then dy = r(dv silu(z)), then dxh = r(dy D)): where the two versions'
# float32 sums round dv to neighbouring bf16 values, dxh moves by up to
# two bf16 steps (1.14x the 1e-2 bound at zamba2's width on an H100)
GATED_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


# the SSD backward's ddt and dA are float32 outputs of float32 arithmetic
# in the kernel and in its plain version alike, whatever the inputs' type,
# so they are held to float32 limits: ddt per element, at 5e-4 (1 +
# |plain|), since each element ends a reverse sum over the chunk of row
# and column sums of T whose terms are far larger than it (read on an
# H100: 1.5e-4 and 2.6e-4 at mamba2's and zamba2's training shapes); dA
# on its largest |plain| (a sum over the batch and the sequence whose
# terms cancel: 1e-5 of the largest at mamba2's shape)
SSD_F32_LIMITS = {"ddt": (5e-4, "element"), "dA": (1e-4, "largest")}


def assert_bwd_close(got, want, dtype, name, tol=BWD_TOL):
    """Each gradient within ``tol`` of its type times (1 + |plain|) per
    element and within 2^-6 of its largest |plain|; the SSD scan's ddt and
    dA within ``SSD_F32_LIMITS``."""
    g, w = got.float(), want.float()
    assert got.shape == want.shape and got.dtype == want.dtype, name
    err = (g - w).abs()
    assert torch.isfinite(g).all(), name
    t, on = SSD_F32_LIMITS.get(name, (tol[dtype], "element"))
    scale = w.abs().max() if on == "largest" else 1 + w.abs()
    assert bool((err <= t * scale).all()), \
        (name, err.max().item(), (err / (t * scale)).max().item())
    assert err.max().item() <= 2 ** -6 * w.abs().max().item(), \
        (name, err.max().item(), w.abs().max().item())


SSD_BWD_CASES = [  # (B, S, H, P, N, Q, dtype)
    (4, 512, 64, 64, 128, 128, torch.bfloat16),     # mamba2-1.3b training
    (4, 512, 112, 64, 64, 128, torch.bfloat16),     # zamba2-7b
    (1, 300, 8, 64, 128, 128, torch.bfloat16),      # ragged S
    (2, 40, 8, 16, 16, 16, torch.bfloat16),         # the smoke chunk
    (2, 77, 3, 32, 24, 16, torch.float32),
    (1, 200, 4, 64, 64, 128, torch.float32),
    # the tensor-core design's edges: head counts off its group of 8 (one
    # short group, a ragged last group), N 64 and 128, a ragged last chunk,
    # B = 1, one chunk, P 32 and N off 64
    (1, 300, 3, 64, 128, 128, torch.bfloat16),
    (2, 200, 7, 64, 64, 128, torch.bfloat16),
    (1, 512, 20, 64, 128, 128, torch.bfloat16),
    (3, 100, 9, 32, 40, 128, torch.bfloat16),
    (1, 128, 2, 64, 64, 128, torch.bfloat16),
    (1, 384, 5, 128, 64, 128, torch.bfloat16)]      # P 128: first design


@pytest.mark.parametrize("b,s,h,p,n,q,dtype", SSD_BWD_CASES)
def test_ssd_scan_bwd_vs_plain(cuda, b, s, h, p, n, q, dtype):
    """The SSD backward kernel against ``ssd_bwd_ref`` on the same inputs
    (x, B, C read in place from one row), two runs bit-identical."""
    ins = ssd_inputs(cuda, 15, b, s, h, p, n, dtype)
    dy = randn(cuda, 16, b, s, h, p, dtype=dtype)
    before = ssd_ops.ssd_scan_bwd.launches
    got = ssd_ops.ssd_scan_bwd(*ins, dy, q)
    again = ssd_ops.ssd_scan_bwd(*ins, dy, q)
    torch.cuda.synchronize()
    assert ssd_ops.ssd_scan_bwd.launches == before + 2
    want = ssd_ref.ssd_bwd_ref(*ins, dy, q)
    for name, a, c, w in zip(("dxh", "ddt", "dA", "dBm", "dCm"), got, again,
                             want):
        bits_equal(a, c)
        assert_bwd_close(a, w, dtype, name)


def conv_bwd_vs_plain(cuda, b, c, s, off, k, dtype):
    """``conv_silu_bwd`` twice against ``conv_silu_bwd_ref``: conv_in read
    in place from a wider row at channel offset ``off``, the two runs
    bit-identical, one count a call."""
    row = randn(cuda, 21, b, s, c + 40, dtype=dtype) * 2
    conv_in = row[..., off:off + c]
    w = randn(cuda, 22, k, c, dtype=dtype) * 0.5
    bias = randn(cuda, 23, c, dtype=dtype) * 0.1
    g = randn(cuda, 24, b, s, c, dtype=dtype)
    before = silu_ops.conv_silu_bwd.launches
    got = silu_ops.conv_silu_bwd(conv_in, w, bias, g)
    again = silu_ops.conv_silu_bwd(conv_in, w, bias, g)
    torch.cuda.synchronize()
    assert silu_ops.conv_silu_bwd.launches == before + 2
    want = silu_ref_mod.conv_silu_bwd_ref(conv_in, w, bias, g)
    for name, a, a2, ww in zip(("dconv_in", "dw", "db"), got, again, want):
        bits_equal(a, a2)
        assert_bwd_close(a, ww, dtype, name)


@pytest.mark.parametrize("c,s,off,k", [
    (4352, 512, 16, 4), (7296, 512, 16, 4), (160, 9, 1, 4), (36, 300, 0, 3),
    # the pass's edges: runs and slices ending off the block's rows, a
    # slice across batch rows (S = 77), the longest runs (S = 4096), K = 2,
    # a served width off the 16-byte grid (the element path)
    (4352, 77, 16, 4), (4352, 4096, 16, 4), (160, 100, 0, 2),
    (4352, 512, 1, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_silu_bwd_vs_plain(cuda, c, s, off, k, dtype):
    """The conv pass's backward kernel against ``conv_silu_bwd_ref`` at
    batch 4 (``conv_bwd_vs_plain``)."""
    conv_bwd_vs_plain(cuda, 4, c, s, off, k, dtype)


@pytest.mark.parametrize("c,s,off,k", [(4352, 512, 16, 4), (7296, 77, 16, 3),
                                       (4352, 512, 1, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_silu_bwd_one_row(cuda, c, s, off, k, dtype):
    """The same at batch 1 (``conv_bwd_vs_plain``)."""
    conv_bwd_vs_plain(cuda, 1, c, s, off, k, dtype)


@pytest.mark.parametrize("h,p,s", [(64, 64, 512), (112, 64, 512), (6, 12, 9),
                                   (8, 16, 33), (64, 64, 77), (112, 64, 45)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gated_rms_norm_bwd_vs_plain(cuda, h, p, s, dtype):
    """The gated norm's backward kernel against ``gated_rms_norm_bwd_ref``,
    xh and z read in place from their slices, two runs bit-identical, one
    count a call; rows off the pass's slices at both served widths (4 x 77
    and 4 x 45 rows)."""
    b, di, n = 4, h * p, 16
    zx = randn(cuda, 31, b, s, 2 * di + 2 * n + h, dtype=dtype) * 3
    conv = randn(cuda, 32, b, s, di + 2 * n, dtype=dtype)
    z, xh = zx[..., :di], conv[..., :di].reshape(b, s, h, p)
    y = randn(cuda, 33, b, s, h, p, dtype=dtype)
    D = 1 + 0.5 * randn(cuda, 34, h)
    w = (1 + 0.1 * randn(cuda, 35, di)).to(dtype)
    g = randn(cuda, 36, b, s, di, dtype=dtype)
    before = dec_ops.gated_rms_norm_bwd.launches
    got = dec_ops.gated_rms_norm_bwd(y, D, xh, z, w, 1e-5, g)
    again = dec_ops.gated_rms_norm_bwd(y, D, xh, z, w, 1e-5, g)
    assert dec_ops.gated_rms_norm_bwd.launches == before + 2
    want = dec_ref.gated_rms_norm_bwd_ref(y, D, xh, z, w, 1e-5, g)
    for name, a, a2, ww in zip(("dy", "dD", "dxh", "dz", "dw"), got, again,
                               want):
        bits_equal(a, a2)
        assert_bwd_close(a, ww, dtype, name, GATED_BWD_TOL)


@pytest.mark.parametrize("b,s,h,kv", [(4, 512, 32, 32), (2, 300, 8, 8),
                                      (1, 330, 8, 2)])
def test_flash_bwd_head_dim_112(cuda, b, s, h, kv):
    """The flash backward at zamba2's head dim 112 (the 128 tile, its last
    16 columns zero) against ``flash_bwd_ref``, two runs bit-identical."""
    from repro_torch.kernels.attention.ref import flash_bwd_ref
    bf = torch.bfloat16
    q = randn(cuda, 41, b, s, h, 112, dtype=bf)
    k, v = (randn(cuda, i, b, s, kv, 112, dtype=bf) for i in (42, 43))
    do = randn(cuda, 44, b, s, h, 112, dtype=bf)
    o, lse = attn_ops._launch(q, k, v, True, s, with_lse=True)
    got = attn_ops.flash_attention_bwd(q, k, v, o, lse, do)
    again = attn_ops.flash_attention_bwd(q, k, v, o, lse, do)
    want = flash_bwd_ref(q, k, v, o, lse, do)
    for name, a, a2, w in zip(("dq", "dk", "dv"), got, again, want):
        bits_equal(a, a2)
        assert_bwd_close(a, w, bf, name)


def test_ssm_wrappers_under_grad(cuda):
    """Under grad the scan, the cacheless conv pass and the gated norm go
    through their Functions, one forward and one backward launch each;
    outside the kernels' scope they raise before the forward runs: a conv
    pass with a cache, a chunk the kernels do not take, a gated norm in
    float16, flash at a head dim without a backward."""
    bf = torch.bfloat16

    def req(*shape, dtype=bf, seed=0):
        return randn(cuda, seed, *shape, dtype=dtype).requires_grad_()

    kernels.reset_launch_counts()
    xh, bm, cm = req(1, 32, 2, 64), req(1, 32, 64, seed=1), \
        req(1, 32, 64, seed=2)
    y, st = ssd_ops.ssd_scan(xh, torch.ones(1, 32, 2, device=cuda),
                             -torch.ones(2, device=cuda), bm, cm, 16)
    assert not st.requires_grad
    y.float().sum().backward()
    x = req(1, 8, 64)
    silu_ops.conv_silu(None, x, req(4, 64, seed=3),
                       req(64, seed=4)).float().sum().backward()
    dec_ops.gated_rms_norm_rows(
        req(1, 4, 2, 64), torch.ones(2, device=cuda), req(1, 4, 2, 64),
        req(1, 4, 128), req(128), 1e-5).float().sum().backward()
    counts = kernels.launch_counts()
    for fwd, bwd in (("ssd", "ssd_scan_bwd"), ("conv_silu", "conv_silu_bwd"),
                     ("gated_rms_norm_rows", "gated_rms_norm_bwd")):
        assert counts[fwd] == 1 and counts[bwd] == 1, counts
    assert xh.grad is not None and x.grad is not None
    with pytest.raises(NotImplementedError, match="cacheless"):
        silu_ops.conv_silu(torch.zeros(1, 3, 64, dtype=bf, device=cuda),
                           req(1, 8, 64), req(4, 64), req(64))
    with pytest.raises(ValueError, match="chunk"):
        ssd_ops.ssd_scan(req(1, 32, 2, 64), torch.ones(1, 32, 2, device=cuda),
                         -torch.ones(2, device=cuda), req(1, 32, 64),
                         req(1, 32, 64), 64)
    with pytest.raises(TypeError, match="gated_rms_norm_bwd"):
        h16 = torch.float16
        dec_ops.gated_rms_norm_rows(
            req(1, 4, 2, 64, dtype=h16), torch.ones(2, device=cuda),
            req(1, 4, 2, 64, dtype=h16), req(1, 4, 128, dtype=h16),
            req(128, dtype=h16), 1e-5)
    with pytest.raises(NotImplementedError, match="flash_attention_bwd"):
        q = req(1, 64, 2, 32)
        attn_ops.flash_attention(q, q, q)
    assert kernels.launch_counts() == counts


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("arch,widen", [
    ("mamba2-1.3b", dict(d_model=256)),
    ("zamba2-7b", dict(d_model=256, n_heads=4, n_kv_heads=4, d_ff=512))])
def test_ssm_train_step_on_card_vs_cpu(cuda, arch, widen, seed):
    """One train step of a mamba2 and a zamba2 smoke model widened to the
    kernels' shapes (zamba2's shared block at head dim 64), bf16, remat,
    seeds 0-5, on the card against the same step on the CPU from the same
    params: the loss within 2e-3, every gradient leaf within 3e-2 of the
    CPU leaf's largest value, finite and not zero; the launches exactly
    ``train_launches``.  mamba2 meets that with room (on an H100, seeds
    0-5: the losses 1.5e-5 to 1.4e-4 apart, no leaf over 3e-2).  zamba2's
    bf16 shared block does not: its card and CPU runs are two bf16
    roundings of the float32 run about as far from it as each other (the
    losses 0.24e-3 to 4.1e-3 and 1.1e-3 to 3.5e-3 from the float32 loss,
    up to 4.4e-3 apart; most leaves 3-9% of their largest apart), so a
    hybrid is held to the CPU's float32 run instead: the loss within
    max(5e-3, twice the CPU's bf16 distance) of it (read: at most 0.65 of
    that), and a leaf over 3e-2 no further from the float32 leaf, in norm,
    than twice the CPU's bf16 leaf is (read: 0.81 to 1.38 times; at the
    largest element it is up to 1.99, too ragged a statistic to hold)."""
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.optim import adamw_init
    cfg = get_config(arch, "smoke").replace(remat=True, **widen)
    gen = torch.Generator().manual_seed(seed)
    host = init_params(cfg, gen, device="cpu")
    card = tree_map(lambda t: t.to(cuda), host)
    tokens = torch.from_numpy(SyntheticTokens(cfg.vocab, 64, 2).batch(seed)
                              ["tokens"])
    kernels.reset_launch_counts()
    m_card, g_card = loss_and_grads(cfg, card, {"tokens": tokens.to(cuda)})
    assert kernels.launch_counts() == train_launches(cfg)
    m_host, g_host = loss_and_grads(cfg, host, {"tokens": tokens})
    m_x, g_x = loss_and_grads(cfg.replace(param_dtype="float32"),
                              tree_map(lambda t: t.float(), host),
                              {"tokens": tokens})
    loss_c, loss_h = m_card["loss"].item(), m_host["loss"].item()
    loss_x = m_x["loss"].item()
    over = []
    for i, (gc, gh, gx) in enumerate(zip(tree_leaves(g_card),
                                         tree_leaves(g_host),
                                         tree_leaves(g_x))):
        gc, gh = gc.float().cpu(), gh.float()
        err = (gc - gh).abs().max() / gh.abs().max()
        if err > 3e-2:
            over.append((i, round(err.item(), 4), round(
                ((gc - gx).abs().max() / (gh - gx).abs().max()).item(), 3),
                round(((gc - gx).norm() / (gh - gx).norm()).item(), 3)))
    print(f"[ssm step gaps] {arch} seed {seed}: loss card {loss_c:.7f}, "
          f"cpu {loss_h:.7f}, float32 {loss_x:.7f}; |card - cpu| "
          f"{abs(loss_c - loss_h):.3g}, |card - float32| "
          f"{abs(loss_c - loss_x):.3g}, |cpu - float32| "
          f"{abs(loss_h - loss_x):.3g}; leaves over 3e-2 (index, of the "
          f"largest, |card - float32| over |cpu - float32| at its largest "
          f"and in norm): {over}",
          flush=True)
    if cfg.family == "hybrid":
        assert abs(loss_c - loss_h) <= 2e-3 or abs(loss_c - loss_x) <= max(
            5e-3, 2 * abs(loss_h - loss_x)), (loss_c, loss_h, loss_x)
    else:
        assert abs(loss_c - loss_h) <= 2e-3, (loss_c, loss_h)
    for i, (gc, gh) in enumerate(zip(tree_leaves(g_card),
                                     tree_leaves(g_host))):
        gc, gh = gc.float().cpu(), gh.float()
        assert torch.isfinite(gc).all() and gc.abs().max() > 0
        err = (gc - gh).abs().max()
        if err <= 3e-2 * gh.abs().max():
            continue
        assert cfg.family == "hybrid", (i, err)
        gx = tree_leaves(g_x)[i]
        assert (gc - gx).norm() <= 2 * (gh - gx).norm(), (i, err)
    step = make_train_step(cfg)
    _, opt, metrics = step(card, adamw_init(card), {"tokens":
                                                    tokens.to(cuda)})
    assert int(opt.step) == 1 and torch.isfinite(metrics["grad_norm"])


def test_checkpoint_pieces_from_the_card(cuda, tmp_path, monkeypatch):
    """A leaf on the card goes to its file in pieces through the ring of
    pinned buffers (4 KiB pieces: more pieces than buffers, a short last
    one): the bytes, shape, dtype name and CRC of ``np.save`` of its host
    copy, bf16 and a non-contiguous float32 view alike."""
    from repro_torch.checkpoint import store
    monkeypatch.setattr(store, "_PIECE", 4096)
    t = randn(cuda, 51, 1000, 77, dtype=torch.bfloat16)
    for leaf in (t, t.float()[:, 3:60]):
        got = store._write_leaf(tmp_path / "pieces.npy", leaf)
        arr, logical = store._to_host(leaf)
        np.save(tmp_path / "whole.npy", arr)
        assert (tmp_path / "pieces.npy").read_bytes() == \
            (tmp_path / "whole.npy").read_bytes()
        assert got == (list(arr.shape), logical, store._leaf_crc(arr))


def test_ssm_train_step_bit_identical_twice(cuda):
    """Two train steps of the widened mamba2 smoke model from the same
    params give the same bits: every backward sum has one owner."""
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.steps import loss_and_grads
    cfg = get_config("mamba2-1.3b", "smoke").replace(remat=True,
                                                      d_model=256)
    card = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = tree_map(lambda t: t.to(cuda), card)
    batch = {"tokens": torch.from_numpy(SyntheticTokens(cfg.vocab, 64, 2)
                                        .batch(0)["tokens"]).to(cuda)}
    m1, g1 = loss_and_grads(cfg, card, batch)
    m2, g2 = loss_and_grads(cfg, card, batch)
    bits_equal(m1["loss"].reshape(1), m2["loss"].reshape(1))
    for a, b in zip(tree_leaves(g1), tree_leaves(g2)):
        bits_equal(a, b)


# ---------------------------------------------------------------------------
# the non-causal flash backward (whisper's encoder), the cross-attention
# families' train step, and the MoE family's streams
# ---------------------------------------------------------------------------

NONCAUSAL_BWD_SHAPES = [  # (B, S, H, KV, hd)
    (4, 512, 20, 20, 64),     # whisper's encoder at the training shape
    (4, 1500, 20, 20, 64),    # its 1500 frames: the last key tile of 28
    (2, 200, 16, 4, 128),     # ragged, group 4 at hd 128
    (2, 330, 8, 1, 64)]       # ragged, a group of 8 in two head chunks


@pytest.mark.parametrize("b,s,h,kv,hd", NONCAUSAL_BWD_SHAPES)
def test_flash_bwd_non_causal_vs_plain(cuda, b, s, h, kv, hd):
    """The non-causal backward kernel against ``flash_bwd_ref(...,
    causal=False)`` on the same (o, lse) from the non-causal forward,
    bit-identical across two runs, each counted as non-causal; keys of a
    ragged last tile past S (zeros, not -inf, from the copies) add nothing
    to dq."""
    from repro_torch.kernels.attention.ref import flash_bwd_ref
    bf = torch.bfloat16
    q = randn(cuda, 0, b, s, h, hd, dtype=bf)
    k = randn(cuda, 1, b, s, kv, hd, dtype=bf)
    v = randn(cuda, 2, b, s, kv, hd, dtype=bf)
    do = randn(cuda, 3, b, s, h, hd, dtype=bf)
    o, lse = attn_ops._launch(q, k, v, False, s, with_lse=True)
    kernels.reset_launch_counts()
    got = attn_ops.flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    again = attn_ops.flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    torch.cuda.synchronize()
    assert attn_ops.flash_attention_bwd.launches == 2
    assert attn_ops.flash_attention_bwd.noncausal_launches == 2
    want = flash_bwd_ref(q, k, v, o, lse, do, causal=False)
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        assert g.shape == w.shape and g.dtype == bf and g.is_contiguous()
        bits_equal(g, a)
        grads_close(g, w, name)


def test_flash_grad_non_causal_through_autograd(cuda):
    """The encoder's flash attention under grad: one non-causal forward
    and one non-causal backward launch, the backward kernel's gradients."""
    bf = torch.bfloat16
    q, k, v = (randn(cuda, i, 2, 200, 4, 64, dtype=bf).requires_grad_()
               for i in range(3))
    do = randn(cuda, 3, 2, 200, 4, 64, dtype=bf)
    kernels.reset_launch_counts()
    g = torch.autograd.grad(attn_ops.flash_attention(q, k, v, causal=False),
                            (q, k, v), do)
    assert kernels.launch_counts()["flash_attention"] == 1
    assert attn_ops.flash_attention_bwd.noncausal_launches == 1
    with torch.no_grad():
        o, lse = attn_ops._launch(q, k, v, False, 200, with_lse=True)
        want = attn_ops.flash_attention_bwd(q, k, v, o, lse, do, False)
    for a, b in zip(g, want):
        bits_equal(a, b)


@pytest.mark.parametrize("seed", range(4))
def test_whisper_train_step_on_card_vs_cpu(cuda, seed):
    """One train step of whisper at its full width (d_model 1280, 20 heads
    of 64) and 2 encoder and 2 decoder layers, bf16, with its frames,
    seeds 0-3, on the card against the same step on the CPU from the same
    params: every gradient leaf within 3e-2 of the CPU leaf's largest
    value, finite and not zero; the launches ``train_launches`` (the
    encoder's two through the non-causal backward).  The loss within 2e-3
    of the CPU's or, as a hybrid's (``test_ssm_train_step_on_card_vs_cpu``),
    within max(5e-3, twice the CPU's bf16 distance) of the CPU's float32
    run: here the CPU's bf16 loss is the further one (on an H100, seeds
    0-3: the card's 2e-5 to 1.15e-3 from the float32 loss, the CPU's 2.4e-4
    to 2.9e-3, the two 1.4e-3 to 2.3e-3 apart; the worst leaf 0.0192 to
    0.0217 of its largest)."""
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.steps import loss_and_grads
    cfg = get_config("whisper-large-v3", "full").replace(
        n_layers=2, n_enc_layers=2)
    gen = torch.Generator().manual_seed(seed)
    host = init_params(cfg, gen, device="cpu")
    card = tree_map(lambda t: t.to(cuda), host)
    batch = {"tokens": torch.from_numpy(SyntheticTokens(cfg.vocab, 128, 1)
                                        .batch(seed)["tokens"]),
             "frames": torch.randn(1, 128, cfg.d_model,
                                   generator=gen).bfloat16()}
    kernels.reset_launch_counts()
    m_card, g_card = loss_and_grads(cfg, card, {k: v.to(cuda)
                                                for k, v in batch.items()})
    counts = kernels.launch_counts()
    noncausal = attn_ops.flash_attention_bwd.noncausal_launches
    m_host, g_host = loss_and_grads(cfg, host, batch)
    m_x, _ = loss_and_grads(cfg.replace(param_dtype="float32"),
                            tree_map(lambda t: t.float(), host), batch)
    assert counts == train_launches(cfg) and noncausal == 2
    loss_c, loss_h = m_card["loss"].item(), m_host["loss"].item()
    loss_x = m_x["loss"].item()
    print(f"[whisper step] seed {seed}: loss card {loss_c:.7f}, cpu "
          f"{loss_h:.7f}, float32 {loss_x:.7f}", flush=True)
    assert abs(loss_c - loss_h) <= 2e-3 or abs(loss_c - loss_x) <= max(
        5e-3, 2 * abs(loss_h - loss_x)), (loss_c, loss_h, loss_x)
    for gc, gh in zip(tree_leaves(g_card), tree_leaves(g_host)):
        gc, gh = gc.float().cpu(), gh.float()
        assert torch.isfinite(gc).all() and gc.abs().max() > 0
        assert (gc - gh).abs().max() <= 3e-2 * gh.abs().max()


@pytest.mark.parametrize("arch", ["deepseek-v3-671b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_stream_bit_identical_twice_on_card(cuda, arch):
    """A MoE smoke model's stream (3 slots; slot 0 idles from its first
    step past ``max_len`` 16, its writes dropped) twice on the card: the
    same tokens and every batched step's logits, bit for bit."""
    cfg = get_config(arch, "smoke")
    gen = torch.Generator(device=cuda).manual_seed(0)
    eng = ServeEngine(cfg, init_params(cfg, gen, device=cuda), max_len=16,
                      kv_block=8)
    reqs = [scheduler.Request(i, make_batch(cfg, 1, pl, seed=70 + i)[
        "tokens"], gl) for i, (pl, gl) in enumerate([(8, 2), (2, 15),
                                                      (2, 4)])]
    runs = []
    for _ in range(2):
        recorded, decode = [], scheduler.decode_step

        def recording(*args, **kw):
            logits, cache = decode(*args, **kw)
            recorded.append(logits[:, 0].cpu())
            return logits, cache

        scheduler.decode_step = recording
        try:
            streams, stats = scheduler.SlotScheduler(eng, 3).run(reqs)
        finally:
            scheduler.decode_step = decode
        runs.append((streams, recorded))
    assert stats["decode_steps"] == 14 == len(runs[0][1])
    for a, b in zip(runs[0][0], runs[1][0]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(runs[0][1], runs[1][1]):
        bits_equal(a, b)
