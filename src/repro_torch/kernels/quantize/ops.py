"""Wrappers of the int8 quantize kernels (``csrc/quantize.cu``).

For a tensor on the CPU a wrapper computes the plain version (``ref.py``);
for a CUDA tensor it launches the kernel, or raises: there is no fallback.
Each wrapper counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

import torch

from .. import _build
from . import ref
from .ref import BM, BN

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROW_MAX = 4096                 # widest row the rowwise path holds in registers


def rowwise_path(x, bm: int, bn: int) -> bool:
    """Whether ``quantize`` takes the kernel's rowwise path for ``x`` (M, N)
    with a (bm, bn) tile: a tile one row tall and as wide as the row, the
    row a whole number of 8-element units of at most ``ROW_MAX`` elements,
    starting on a 16-byte boundary.  Every other tile takes the general
    path; both give the same bits."""
    n = x.shape[-1]
    return (bm == 1 and bn >= n and 0 < n <= ROW_MAX and n % 8 == 0
            and x.data_ptr() % 16 == 0)


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
                                           _DTYPES[x.dtype], stream)
        else:
            fn = "quantize_launch"
            err = lib.quantize_launch(x.data_ptr(), q.data_ptr(),
                                      s.data_ptr(), m, n, bm, bn,
                                      _DTYPES[x.dtype], stream)
    _build.check("quantize", fn, err)
    quantize.launches += 1
    return q, s


def dequantize(q, scales, bm: int = BM, bn: int = BN,
               out_dtype=torch.bfloat16):
    """q int8 (M, N) and its tile scales -> x (M, N) in ``out_dtype``."""
    if q.device.type == "cpu":
        return ref.dequantize_ref(q, scales, bm, bn, out_dtype)
    _check(q, "dequantize", (torch.int8,))
    _check(scales, "dequantize scales", (torch.float32,))
    m, n = q.shape
    if tuple(scales.shape) != (-(-m // bm), -(-n // bn)):
        raise ValueError(f"dequantize: scales {tuple(scales.shape)} do not "
                         f"tile ({m}, {n}) by ({bm}, {bn})")
    if out_dtype not in _DTYPES:
        raise TypeError(f"dequantize: out_dtype {out_dtype} not in "
                        f"{list(_DTYPES)}")
    x = torch.empty((m, n), dtype=out_dtype, device=q.device)
    lib = _build.load("quantize")
    with torch.cuda.device(q.device):
        err = lib.dequantize_launch(
            q.data_ptr(), scales.data_ptr(), x.data_ptr(), m, n, bm, bn,
            _DTYPES[out_dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("quantize", "dequantize_launch", err)
    dequantize.launches += 1
    return x


quantize.launches = 0
dequantize.launches = 0


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
