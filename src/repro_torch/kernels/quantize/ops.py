"""Wrappers of the int8 quantize kernels (``csrc/quantize.cu``).

For a tensor on the CPU a wrapper computes the plain version (``ref.py``);
for a CUDA tensor it launches the kernel, or raises: there is no fallback.
Each wrapper counts its kernel launches in ``.launches``, and of them
``quantize.row_launches`` those on the row path and
``dequantize.vec_launches`` those of the vectorised kernel.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from .. import _build
from ..decode.ops import no_backward
from . import ref
from .ref import BM, BN

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROW_WARPS = 8                  # warps a row at most
ROW_PAIRS = 4                  # pairs of units a lane at most (kRowPairs)
ROW_MAX = 16 * 32 * ROW_WARPS * ROW_PAIRS   # 16384: the widest row path


@lru_cache(maxsize=None)
def row_plan(n: int, itemsize: int) -> tuple[int, int, int]:
    """The plan of quantize's row path for rows of ``n`` elements of
    ``itemsize`` bytes: ``(warps a row, pairs a lane, rows a block)``.

    A lane holds pairs of adjacent 8-element units (16 elements, whose 16
    int8 leave in one 16-byte store), round-robin over the row's lanes, in
    registers.  A row takes the fewest warps (a power of two, at most
    ``ROW_WARPS``) that hold it at 128 bytes of x a lane: one up to 2048
    bf16 elements, two to 4096, four to 8192, eight at 16384; float32 rows
    past 8192 take up to ``ROW_PAIRS`` pairs (256 bytes) a lane, which
    does not spill.  A block holds 128 threads or one row, whichever is
    more.  There is no M: a row gets the same bits alone, in a decode
    batch or among a prefill's rows."""
    pairs = -(-n // 16)
    aim = 128 // (16 * itemsize)
    warps = 1
    while warps < ROW_WARPS and warps * 32 * aim < pairs:
        warps *= 2
    return warps, -(-pairs // (32 * warps)), max(1, 4 // warps)


def rowwise_path(x, bm: int, bn: int) -> bool:
    """Whether ``quantize`` takes the kernel's row path for ``x`` (M, N)
    with a (bm, bn) tile: a tile one row tall and as wide as the row, the
    row a whole number of 8-element units of at most ``ROW_MAX`` elements
    (every wire width the zoo serves, 1280 to 16384), starting on a
    16-byte boundary.  Every other tile (the blockwise (256, 256) API,
    ragged or misaligned rows, rows past ``ROW_MAX``) takes the general
    path; both give the same bits."""
    n = x.shape[-1]
    return (bm == 1 and bn >= n and 0 < n <= ROW_MAX and n % 8 == 0
            and x.data_ptr() % 16 == 0)


def dequantize_vectorised(q, bm: int, bn: int,
                          out_dtype=torch.bfloat16) -> bool:
    """Whether ``dequantize`` of ``q`` (M, N) with a (bm, bn) tile takes the
    vectorised kernel: units of as many int8 as fill one 16-byte store of
    ``out_dtype`` (8 for bf16, 4 for float32), each in one row and one tile
    (N and bn multiples of a unit, or a tile as wide as the row), q
    starting on a unit's boundary: the wire's (1, D) and the blockwise
    (256, 256).  Every other width takes the scalar kernel."""
    n = q.shape[1]
    vec = 128 // torch.finfo(out_dtype).bits
    return (n % vec == 0 and (bn % vec == 0 or bn >= n)
            and q.data_ptr() % vec == 0)


def _check(t, name, dtypes):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got "
                         f"{t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {list(dtypes)}")
    if t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous 2-d tensor, got "
                         f"shape {tuple(t.shape)} strides {t.stride()}")


def quantize(x, bm: int = BM, bn: int = BN):
    """x (M, N) float32/bfloat16 -> (q int8 (M, N), scales float32
    (ceil(M/bm), ceil(N/bn))); ragged edge tiles are handled in-kernel."""
    if x.device.type == "cpu":
        return ref.quantize_ref(x, bm, bn)
    _check(x, "quantize", _DTYPES)
    no_backward("quantize", x)
    m, n = x.shape
    q = torch.empty((m, n), dtype=torch.int8, device=x.device)
    s = torch.empty((-(-m // bm), -(-n // bn)), dtype=torch.float32,
                    device=x.device)
    lib = _build.load("quantize")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if rowwise_path(x, bm, bn):
            fn = "quantize_rows_launch"
            err = lib.quantize_rows_launch(x.data_ptr(), q.data_ptr(),
                                           s.data_ptr(), m, n,
                                           *row_plan(n, x.element_size()),
                                           _DTYPES[x.dtype], stream)
        else:
            fn = "quantize_launch"
            err = lib.quantize_launch(x.data_ptr(), q.data_ptr(),
                                      s.data_ptr(), m, n, bm, bn,
                                      _DTYPES[x.dtype], stream)
    _build.check("quantize", fn, err)
    quantize.launches += 1
    quantize.row_launches += fn == "quantize_rows_launch"
    return q, s


def dequantize(q, scales, bm: int = BM, bn: int = BN,
               out_dtype=torch.bfloat16):
    """q int8 (M, N) and its tile scales -> x (M, N) in ``out_dtype``."""
    if q.device.type == "cpu":
        return ref.dequantize_ref(q, scales, bm, bn, out_dtype)
    _check(q, "dequantize", (torch.int8,))
    _check(scales, "dequantize scales", (torch.float32,))
    no_backward("dequantize", q, scales)
    m, n = q.shape
    if tuple(scales.shape) != (-(-m // bm), -(-n // bn)):
        raise ValueError(f"dequantize: scales {tuple(scales.shape)} do not "
                         f"tile ({m}, {n}) by ({bm}, {bn})")
    if out_dtype not in _DTYPES:
        raise TypeError(f"dequantize: out_dtype {out_dtype} not in "
                        f"{list(_DTYPES)}")
    x = torch.empty((m, n), dtype=out_dtype, device=q.device)
    vec = dequantize_vectorised(q, bm, bn, out_dtype)
    lib = _build.load("quantize")
    with torch.cuda.device(q.device):
        err = lib.dequantize_launch(
            q.data_ptr(), scales.data_ptr(), x.data_ptr(), m, n, bm, bn,
            int(vec), _DTYPES[out_dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("quantize", "dequantize_launch", err)
    dequantize.launches += 1
    dequantize.vec_launches += vec
    return x


# launches, and of them those on the row path and the vectorised kernel
quantize.launches = quantize.row_launches = 0
dequantize.launches = dequantize.vec_launches = 0


def rowwise_quantize(x):
    """Per-row int8 of ``x`` (..., D): the blockwise kernel with a (1, D)
    tile.  Returns (q int8 (..., D), scale float32 (..., 1))."""
    d = x.shape[-1]
    q, s = quantize(x.reshape(-1, d), 1, d)
    return q.reshape(x.shape), s.reshape(*x.shape[:-1], 1)


def rowwise_dequantize(q, scale, out_dtype=torch.bfloat16):
    """Inverse of :func:`rowwise_quantize` (the dequantize kernel with a
    (1, D) tile)."""
    d = q.shape[-1]
    x = dequantize(q.reshape(-1, d), scale.reshape(-1, 1), 1, d, out_dtype)
    return x.reshape(q.shape)
