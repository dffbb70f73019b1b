"""The port's kernel wrappers and plain versions against the reference.

Inputs come from a numpy seed and go through both packages: the reference's
ops (Pallas in interpret mode, the default on the CPU) and its ``ref.py``
oracles, and the port's wrappers (which take their plain versions for CPU
tensors) and ``ref.py``.  Tolerances are those of ``tests/test_kernels.py``:
quantize bit-equal, attention 2e-5 in float32 and 3e-2 in bfloat16.

The CUDA kernels themselves are held against their plain versions on the
card by ``tests/test_torch_cuda.py``.
"""

import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.attention.kernel import flash_attention_pallas
from repro.kernels.attention.ops import flash_attention as jax_flash
from repro.kernels.attention.ref import attention_ref as jax_attention_ref
from repro.kernels.quantize.ops import dequantize as jax_dequantize
from repro.kernels.quantize.ops import quantize as jax_quantize
from repro.kernels.quantize.ref import dequantize_ref as jax_dequantize_ref
from repro.kernels.quantize.ref import quantize_ref as jax_quantize_ref
from repro.kernels.quantize.ref import rowwise_quantize as jax_rowwise
from repro_torch import kernels
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention.ref import attention_ref, flash_ref
from repro_torch.kernels.quantize import ops as q_ops
from repro_torch.kernels.quantize import ref as q_ref
from repro_torch.kernels.ssd.ops import ssd_scan
from repro_torch.models.bridge import tensor_from_numpy, tensor_to_numpy

torch.set_num_threads(2)

BF16 = np.dtype(ml_dtypes.bfloat16)
DTYPES = {"float32": np.float32, "bfloat16": BF16}


def normal(seed, shape, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return x.astype(DTYPES[dtype])


def both(x):
    """The same numpy array as a jax array and a CPU torch tensor."""
    return jnp.asarray(x), tensor_from_numpy(x, "cpu")


def as_np(t):
    return tensor_to_numpy(t) if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def bits_equal(a, b):
    a, b = as_np(a), as_np(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def close(a, b, tol):
    np.testing.assert_allclose(as_np(a).astype(np.float32),
                               as_np(b).astype(np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# quantize / dequantize: bit-equal
# ---------------------------------------------------------------------------

QSHAPES = [(256, 256), (300, 520), (64, 1024), (1024, 64), (257, 129)]


class TestQuantize:
    @pytest.mark.parametrize("shape", QSHAPES)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_reference_ops_and_ref(self, shape, dtype):
        xj, xt = both(normal(0, shape, dtype))
        q, s = q_ops.quantize(xt)
        for qj, sj in (jax_quantize(xj), jax_quantize_ref(xj)):
            bits_equal(q, qj)
            bits_equal(s, sj)
        qr, sr = q_ref.quantize_ref(xt)
        bits_equal(q, qr)
        bits_equal(s, sr)

    @pytest.mark.parametrize("shape", [(300, 520), (257, 129)])
    @pytest.mark.parametrize("out", ["float32", "bfloat16"])
    def test_dequantize_matches_reference(self, shape, out):
        xj, xt = both(normal(1, shape))
        q, s = q_ops.quantize(xt)
        odt = getattr(torch, out)
        x = q_ops.dequantize(q, s, out_dtype=odt)
        qj, sj = jax_quantize_ref(xj)
        bits_equal(x, jax_dequantize(qj, sj, out_dtype=jnp.dtype(out)))
        bits_equal(x, jax_dequantize_ref(qj, sj, out_dtype=jnp.dtype(out)))
        bits_equal(x, q_ref.dequantize_ref(q, s, out_dtype=odt))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_rowwise_matches_reference(self, dtype):
        x = normal(2, (2, 5, 64), dtype)
        x[0, 1] = 0.0                       # an all-zero row: scale 1
        xj, xt = both(x)
        q, s = q_ops.rowwise_quantize(xt)
        qj, sj = jax_rowwise(xj)
        bits_equal(q, qj)
        bits_equal(s, sj)
        qr, sr = q_ref.rowwise_quantize(xt)
        bits_equal(q, qr)
        bits_equal(s, sr)
        # the pipeline's _wire_in: (q * scale) cast to the param dtype
        back = q_ops.rowwise_dequantize(q, s, torch.bfloat16)
        bits_equal(back, (qj.astype(jnp.float32) * sj).astype(jnp.bfloat16))

    def test_half_way_ties_round_to_even(self):
        # absmax 127 gives scale 1 (exactly 127 * f32(1/127)); x.5 ties
        # then decide round() by the half-to-even rule
        row = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]],
                       np.float32)
        xj, xt = both(row)
        q, s = q_ops.quantize(xt, 1, row.shape[1])
        qj, sj = jax_quantize_ref(xj, 1, row.shape[1])
        bits_equal(q, qj)
        bits_equal(s, sj)

    def test_zero_tile_safe(self):
        q, s = q_ops.quantize(torch.zeros(256, 256))
        assert float(s) == 1.0
        assert float(q_ops.dequantize(q, s).abs().max()) == 0.0

    @pytest.mark.parametrize("n,bm,bn,aligned,rowwise", [
        (2048, 1, 2048, True, True), (4096, 1, 4096, True, True),
        (16, 1, 16, True, True), (520, 1, 520, True, True),
        (8, 1, 64, True, True), (1028, 1, 1028, True, False),
        (8192, 1, 8192, True, True), (520, 256, 256, True, False),
        (2048, 2, 2048, True, False), (2048, 1, 1024, True, False),
        (2048, 1, 2048, False, False), (7168, 1, 7168, True, True),
        (16384, 1, 16384, True, True), (16392, 1, 16392, True, False),
        (8192, 1, 8192, False, False)])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_which_tiles_take_the_rowwise_path(self, n, bm, bn, aligned,
                                               rowwise, dtype):
        """A tile one row tall and as wide as the row, of at most ROW_MAX
        (16384) elements in 8-element units on a 16-byte boundary, takes
        the kernel's row path; every other tile the general one."""
        x = torch.zeros(3 * n + 1, dtype=dtype)
        x = (x[:3 * n] if aligned else x[1:]).view(3, n)
        assert q_ops.rowwise_path(x, bm, bn) == rowwise

    @pytest.mark.parametrize("arch", ARCH_IDS)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_row_plan_covers_every_wire_width(self, arch, dtype):
        """Every served model's wire row (its d_model) takes the row path,
        and the plan holds the whole row in registers at 128 bytes of x a
        lane where ROW_WARPS warps suffice, never past the kernel's
        ROW_PAIRS pairs a lane or its 256 threads a block."""
        d = get_config(arch, "full").d_model
        x = torch.zeros(4, d, dtype=dtype)
        assert q_ops.rowwise_path(x, 1, d)
        item = x.element_size()
        warps, ppl, rows = q_ops.row_plan(d, item)
        assert warps & (warps - 1) == 0 and rows >= 1
        assert 32 * warps * ppl * 16 >= d             # the row is covered
        aim = 128 // (16 * item)
        assert ppl <= aim or warps == q_ops.ROW_WARPS
        assert ppl <= q_ops.ROW_PAIRS                   # an instance exists
        assert 32 * warps * rows <= 256
        if warps > 1:                 # the fewest warps that hold the row
            assert (warps // 2) * 32 * aim * 16 < d

    def test_row_plan_has_no_m(self):
        """The plan is a function of the width and the element size alone,
        so a row's bits are the same at 4 rows as at 2048."""
        assert list(inspect.signature(
            q_ops.row_plan.__wrapped__).parameters) == ["n", "itemsize"]
        assert q_ops.row_plan(2048, 2)[0] == 1    # one warp up to 2048 bf16
        assert q_ops.row_plan(7168, 2)[0] > 1     # several past it
        assert q_ops.row_plan(q_ops.ROW_MAX, 4) == (q_ops.ROW_WARPS,
                                                    q_ops.ROW_PAIRS, 1)

    @pytest.mark.parametrize("itemsize", [2, 4])
    def test_row_plan_stays_within_the_kernels_instances(self, itemsize):
        """ROW_PAIRS is the kernel's kRowPairs, the most pairs a lane it is
        built for, and the plan asks for no more at any width the row path
        takes, up to ROW_MAX (16384)."""
        src = (Path(q_ops.__file__).parents[1] / "csrc"
               / "quantize.cu").read_text()
        pairs = re.search(r"constexpr int kRowPairs = (\d+);", src)
        assert int(pairs.group(1)) == q_ops.ROW_PAIRS
        assert q_ops.ROW_MAX == 16384
        for n in range(8, q_ops.ROW_MAX + 1, 8):
            warps, ppl, rows = q_ops.row_plan(n, itemsize)
            assert 1 <= ppl <= q_ops.ROW_PAIRS
            assert 32 * warps * ppl * 16 >= n
            assert warps <= q_ops.ROW_WARPS and 32 * warps * rows <= 256

    def test_reset_zeroes_the_wire_path_counts(self):
        """reset_launch_counts zeroes the wire's path counts with the
        launch counts; a CPU call adds to none of them."""
        q_ops.quantize.row_launches = q_ops.dequantize.vec_launches = 5
        kernels.reset_launch_counts()
        q, s = q_ops.rowwise_quantize(torch.ones(2, 16))
        q_ops.rowwise_dequantize(q, s)
        assert (q_ops.quantize.row_launches, q_ops.dequantize.vec_launches,
                q_ops.quantize.launches, q_ops.dequantize.launches) == \
            (0, 0, 0, 0)

    def test_adder_rounding_is_rint_and_clip(self):
        """The row path's rounding, emulated in float32: p + 1.5 * 2^23,
        clipped to within 127 of 1.5 * 2^23, its low byte as the int8,
        equals the general path's int8(clip(rint(p), -127, 127)) for every
        float32 whose low 12 bits are zero (each sign, exponent, inf and
        NaN), every half-way tie up to 300, their neighbours and a million
        random products."""
        big = np.float32(12582912.0)
        pats = (np.arange(1 << 20, dtype=np.uint64) << 12).astype(np.uint32)
        ties = (np.arange(-600, 601) / 2).astype(np.float32)
        rand = np.random.default_rng(11).uniform(-140, 140, 1 << 20)
        p = np.concatenate([pats.view(np.float32), ties,
                            np.nextafter(ties, np.float32(np.inf)),
                            np.nextafter(ties, np.float32(-np.inf)),
                            rand.astype(np.float32)])
        with np.errstate(invalid="ignore", over="ignore"):
            t = np.fmin(np.fmax(p + big, big - np.float32(127)),
                        big + np.float32(127))
            got = (t.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)
            want = np.fmin(np.fmax(np.rint(p), np.float32(-127)),
                           np.float32(127)).astype(np.int8)
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("d", [1280, 7168, 8192, 16384])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_rowwise_matches_reference_at_wire_widths(self, d, dtype):
        """The wire at the served widths: q, the scales and the dequantized
        rows bit-equal to the JAX package's, an all-zero row and a row of
        half-way ties among them."""
        x = normal(12, (3, d), dtype)
        x[1] = 0.0
        x[2, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]
        x[2, 8:] = 0.25
        xj, xt = both(x)
        q, s = q_ops.rowwise_quantize(xt)
        qj, sj = jax_rowwise(xj)
        bits_equal(q, qj)
        bits_equal(s, sj)
        for out in ("bfloat16", "float32"):
            back = q_ops.rowwise_dequantize(q, s, getattr(torch, out))
            bits_equal(back, jax_dequantize_ref(qj, sj, 1, d,
                                                out_dtype=jnp.dtype(out)))

    @pytest.mark.parametrize("m,n,bm,bn,offset,bf16,f32", [
        (2048, 2048, 1, 2048, 0, True, True),
        (4, 7168, 1, 7168, 0, True, True),
        (2048, 2048, 256, 256, 0, True, True),
        (300, 520, 256, 256, 0, True, True),
        (3, 1028, 1, 1028, 0, False, True),
        (257, 129, 256, 256, 0, False, False),
        (64, 1024, 1, 100, 0, False, True),
        (64, 1024, 1, 98, 0, False, False),
        (3, 2048, 1, 2048, 8, True, True),
        (3, 2048, 1, 2048, 4, False, True),
        (3, 2048, 1, 2048, 1, False, False)])
    def test_which_tiles_take_the_vectorised_dequantize(self, m, n, bm, bn,
                                                        offset, bf16, f32):
        """Units of as many int8 as fill a 16-byte store of the output (8
        for bf16, 4 for float32) that each lie in one row and one tile, q
        starting on such a boundary, go to the vectorised kernel; other
        widths, tiles and views to the scalar one."""
        q = torch.zeros(m * n + 16, dtype=torch.int8)
        q = q[offset:offset + m * n].view(m, n)
        for dtype, vec in ((torch.bfloat16, bf16), (torch.float32, f32)):
            assert q_ops.dequantize_vectorised(q, bm, bn, dtype) == vec


# ---------------------------------------------------------------------------
# flash attention: 2e-5 (float32), 3e-2 (bfloat16)
# ---------------------------------------------------------------------------

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def fold_pad(a, sp):
    """(B, S, N, hd) -> (B*N, sp, hd), rows past S zero: the reference
    kernel's folded, padded layout."""
    b, s, n, hd = a.shape
    f = np.zeros((b, n, sp, hd), a.dtype)
    f[:, :, :s] = a.transpose(0, 2, 1, 3)
    return f.reshape(b * n, sp, hd)


def qkv(seed, b, s, h, kv, hd, dtype="float32"):
    return (normal(seed, (b, s, h, hd), dtype),
            normal(seed + 1, (b, s, kv, hd), dtype),
            normal(seed + 2, (b, s, kv, hd), dtype))


class TestFlashAttention:
    @pytest.mark.parametrize("s", [128, 200, 384])
    @pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (8, 1)])
    @pytest.mark.parametrize("hd", [32, 64])
    def test_causal_sweep_vs_reference_oracle(self, s, h, kv, hd):
        arrays = qkv(3, 2, s, h, kv, hd)
        ref = jax_attention_ref(*map(jnp.asarray, arrays), causal=True)
        ts = [tensor_from_numpy(a, "cpu") for a in arrays]
        close(attn_ops.flash_attention(*ts, causal=True), ref, 2e-5)
        close(attention_ref(*ts, causal=True), ref, 2e-5)

    @pytest.mark.parametrize("s,causal", [(256, True), (200, True),
                                          (256, False), (129, False)])
    def test_matches_reference_pallas_op(self, s, causal):
        arrays = qkv(4, 1, s, 4, 2, 32)
        want = jax_flash(*map(jnp.asarray, arrays), causal=causal)
        ts = [tensor_from_numpy(a, "cpu") for a in arrays]
        close(attn_ops.flash_attention(*ts, causal=causal), want, 2e-5)
        close(attention_ref(*ts, causal=causal), want, 2e-5)

    @pytest.mark.parametrize("causal", [True, False])
    def test_bfloat16(self, causal):
        arrays = qkv(5, 1, 128, 2, 2, 64, "bfloat16")
        ref = jax_attention_ref(*map(jnp.asarray, arrays), causal=causal)
        ts = [tensor_from_numpy(a, "cpu") for a in arrays]
        out = attn_ops.flash_attention(*ts, causal=causal)
        assert out.dtype == torch.bfloat16
        close(out, ref, 3e-2)
        close(attention_ref(*ts, causal=causal), ref, 3e-2)

    def test_fold_and_pad_shapes(self):
        arrays = qkv(6, 1, 129, 8, 2, 16)
        ts = [tensor_from_numpy(a, "cpu") for a in arrays]
        out = attn_ops.flash_attention(*ts, causal=True)
        assert out.shape == (1, 129, 8, 16)
        close(out, attention_ref(*ts, causal=True), 2e-5)

    @pytest.mark.parametrize("b,s,h,kv,hd,causal,valid", [
        (1, 129, 4, 2, 8, True, 129), (1, 129, 4, 2, 8, False, 129),
        (2, 200, 4, 1, 32, True, 150), (1, 256, 2, 2, 16, False, 100),
        (1, 128, 8, 2, 64, True, 128)])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_plain_contract_vs_reference_pallas(self, b, s, h, kv, hd,
                                                causal, valid, dtype):
        """The kernel's contract (model layout, ragged S, valid length)
        against the reference's Pallas kernel on its folded, padded layout,
        rows past S sliced off."""
        arrays = qkv(8, b, s, h, kv, hd, dtype)
        sp = -(-s // 128) * 128
        want = flash_attention_pallas(
            *(jnp.asarray(fold_pad(a, sp)) for a in arrays), group=h // kv,
            causal=causal, valid_len=valid, interpret=True)
        want = np.asarray(want.astype(jnp.float32)).reshape(
            b, h, sp, hd)[:, :, :s].transpose(0, 2, 1, 3)
        ts = [tensor_from_numpy(a, "cpu") for a in arrays]
        got = flash_ref(*ts, causal=causal, valid_len=valid)
        assert got.dtype == ts[0].dtype and got.shape == (b, s, h, hd)
        close(got, want, TOL[dtype])
        out = attn_ops.flash_attention(*ts, causal=causal, valid_len=valid)
        assert torch.equal(out, got)

    @pytest.mark.parametrize("s,h,kv,hd", [(129, 8, 2, 8), (200, 4, 4, 64),
                                           (77, 8, 1, 16)])
    @pytest.mark.parametrize("causal", [True, False])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_plain_contract_vs_reference_oracle(self, s, h, kv, hd, causal,
                                                dtype):
        arrays = qkv(9, 2, s, h, kv, hd, dtype)
        want = jax_attention_ref(*map(jnp.asarray, arrays), causal=causal)
        ts = [tensor_from_numpy(a, "cpu") for a in arrays]
        close(flash_ref(*ts, causal=causal), want, TOL[dtype])

    def test_plain_rounds_p_to_bfloat16(self):
        """bf16 inputs: P is rounded to bf16 before it multiplies v, as the
        kernel's tensor-core product takes it; float32 accumulation."""
        arrays = qkv(10, 1, 96, 2, 2, 32, "bfloat16")
        q, k, v = (a.astype(np.float32) for a in arrays)
        sc = np.einsum("bqhd,bkhd->bhqk", q, k) * np.float32(1 / np.sqrt(32))
        sc = np.where(np.tri(96, dtype=bool), sc, -1e30)
        p = np.exp(sc - sc.max(-1, keepdims=True))
        p = (p / p.sum(-1, keepdims=True)).astype(BF16).astype(np.float32)
        want = np.einsum("bhqk,bkhd->bqhd", p, v)
        got = flash_ref(*[tensor_from_numpy(a, "cpu") for a in arrays])
        # the float32 sums differ in order only: within one bf16 step (a
        # relative 2**-7 at most); P left in float32 misses this
        np.testing.assert_allclose(as_np(got).astype(np.float32),
                                   want.astype(BF16).astype(np.float32),
                                   rtol=2.0 ** -7, atol=0)

    def test_reads_views_in_model_layout(self):
        """q, k and v sliced out of one fused projection (rows wider than
        the heads) and a transposed (B, H, S, hd) tensor: the same output
        as their contiguous copies, contiguous, so that merging the heads
        is a view."""
        b, s, h, kv, hd = 2, 100, 4, 2, 16
        fused = tensor_from_numpy(normal(11, (b, s, (h + 2 * kv) * hd + 8)),
                                  "cpu")
        q = fused[..., :h * hd].view(b, s, h, hd)
        k = fused[..., h * hd:(h + kv) * hd].view(b, s, kv, hd)
        v = fused[..., (h + kv) * hd:(h + 2 * kv) * hd].view(b, s, kv, hd)
        for qq in (q, q.transpose(1, 2).contiguous().transpose(1, 2)):
            out = attn_ops.flash_attention(qq, k, v)
            assert out.is_contiguous() and out.shape == (b, s, h, hd)
            assert torch.equal(out, flash_ref(q.contiguous(), k.contiguous(),
                                              v.contiguous()))

    def test_refuses_what_it_does_not_take(self):
        q, k, v = (tensor_from_numpy(a, "cpu")
                   for a in qkv(12, 1, 64, 4, 2, 16))
        with pytest.raises(ValueError, match="do not agree"):
            attn_ops.flash_attention(q, k[:, :32], v[:, :32])
        with pytest.raises(ValueError, match="multiple"):
            attn_ops.flash_attention(q[:, :, :3], k, v)
        with pytest.raises(ValueError, match="valid_len"):
            attn_ops.flash_attention(q, k, v, valid_len=0)
        with pytest.raises(ValueError, match="valid_len"):
            attn_ops.flash_attention(q, k, v, valid_len=65)

    def test_cpu_path_launches_nothing(self):
        kernels.reset_launch_counts()
        arrays = qkv(7, 1, 128, 2, 2, 8)
        attn_ops.flash_attention(*[tensor_from_numpy(a, "cpu")
                                   for a in arrays])
        q_ops.quantize(torch.ones(4, 4))
        ssd_scan(torch.ones(1, 4, 2, 8), torch.ones(1, 4, 2), -torch.ones(2),
                 torch.ones(1, 4, 8), torch.ones(1, 4, 8), 16)
        kernels.rows_matmul(torch.ones(2, 8), torch.ones(8, 4))
        kernels.silu(torch.ones(2, 8))
        kernels.conv_silu(torch.ones(2, 3, 8), torch.ones(2, 5, 8),
                          torch.ones(4, 8), torch.ones(8))
        kernels.rms_norm_rows(torch.ones(2, 8), torch.ones(8), 1e-5)
        kernels.residual_rms_norm_rows(torch.ones(2, 8), torch.ones(2, 8),
                                       torch.ones(8), 1e-5)
        kernels.gated_rms_norm_rows(torch.ones(2, 1, 2, 4), torch.ones(2),
                                    torch.ones(2, 1, 2, 4),
                                    torch.ones(2, 1, 8), torch.ones(8), 1e-5)
        kernels.decode_attention(torch.ones(2, 1, 4, 8),
                                 torch.ones(2, 6, 2, 8),
                                 torch.ones(2, 6, 2, 8),
                                 torch.tensor([3, 6], dtype=torch.int32))
        kernels.ssm_decode_step(torch.ones(2, 3, 4, 8), torch.ones(2, 3, 4),
                                torch.ones(2, 3), -torch.ones(3),
                                torch.ones(2, 8), torch.ones(2, 8))
        q = torch.ones(1, 4, 2, 8)
        kernels.flash_attention_bwd(q, q, q, q, torch.zeros(1, 2, 4), q)
        kernels.ssd_scan_bwd(torch.ones(1, 4, 2, 8), torch.ones(1, 4, 2),
                             -torch.ones(2), torch.ones(1, 4, 8),
                             torch.ones(1, 4, 8), torch.ones(1, 4, 2, 8), 16)
        kernels.conv_silu_bwd(torch.ones(2, 5, 8), torch.ones(4, 8),
                              torch.ones(8), torch.ones(2, 5, 8))
        kernels.gated_rms_norm_bwd(torch.ones(2, 1, 2, 4), torch.ones(2),
                                   torch.ones(2, 1, 2, 4),
                                   torch.ones(2, 1, 8), torch.ones(8), 1e-5,
                                   torch.ones(2, 1, 8))
        assert kernels.launch_counts() == {"flash_attention": 0,
                                           "flash_attention_bwd": 0,
                                           "quantize": 0, "dequantize": 0,
                                           "ssd": 0, "rows_matmul": 0,
                                           "rms_norm_rows": 0,
                                           "residual_rms_norm_rows": 0,
                                           "gated_rms_norm_rows": 0,
                                           "decode_attention": 0,
                                           "ssm_decode_step": 0, "silu": 0,
                                           "conv_silu": 0,
                                           "ssd_scan_bwd": 0,
                                           "conv_silu_bwd": 0,
                                           "gated_rms_norm_bwd": 0}
