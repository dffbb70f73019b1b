"""Wrappers of the kernels of ``csrc/silu.cu``: SiLU, and the mamba block's
conv pass with its SiLU.

For tensors on the CPU each computes its plain version (``ref.py``); for
CUDA tensors it launches its kernel or raises: there is no fallback.
``.launches`` on each counts its kernel launches.
"""

from __future__ import annotations

import torch

from .. import _build
from ..decode.ops import no_backward
from .ref import conv_silu_ref, silu_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CONV_WIDTHS = (2, 3, 4)         # the conv widths K the kernel takes
_INT_MAX = 2 ** 31 - 1


def silu(x):
    """x * sigmoid(x) in x's dtype, rounded as XLA on the CPU rounds the
    reference's, in one pass.  ``x`` is any tensor whose last dim is dense and whose
    leading dims flatten to rows at one stride (a last-dim slice of a wider
    tensor is read in place); rows and row stride whole 16-byte units.
    Returns a contiguous tensor of x's shape."""
    if x.device.type == "cpu":
        return silu_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"silu: unsupported device {x.device}")
    no_backward("silu", x)
    if x.dtype not in _DTYPES:
        raise TypeError(f"silu: dtype {x.dtype} not in {list(_DTYPES)}")
    d = x.shape[-1]
    try:
        rows = x.view(-1, d)
    except RuntimeError as e:
        raise ValueError(f"silu: strides {x.stride()} do not flatten to "
                         f"rows") from e
    unit = 16 // x.element_size()
    if rows.stride(-1) != 1 or d % unit or rows.stride(0) % unit \
            or x.data_ptr() % 16:
        raise ValueError("silu: rows must be dense, whole 16-byte units, "
                         "on a 16-byte boundary")
    if rows.shape[0] > _INT_MAX:
        raise ValueError(f"silu: {rows.shape[0]} rows above {_INT_MAX}")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    lib = _build.load("silu")
    with torch.cuda.device(x.device):
        err = lib.silu_launch(x.data_ptr(), rows.stride(0), out.data_ptr(),
                              rows.shape[0], d, _DTYPES[x.dtype],
                              torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("silu", "silu_launch", err)
    silu.launches += 1
    return out


def conv_silu(conv_buf, conv_in, w, b):
    """The mamba block's conv pass in one launch: SiLU of the depthwise
    causal conv of ``conv_in`` (B, S, C) with ``w`` (K, C) and bias ``b``
    (C,) over the K-1 tokens of history before it, rounded where the plain
    chain rounds.  ``conv_buf`` (B, K-1, C) is the history, shifted in place
    to the last K-1 tokens; None means zeros (the cacheless forward).
    ``conv_in`` is read in place through its strides (a slice of the
    in_proj output): its channel dim must be dense.  Returns (B, S, C),
    contiguous."""
    if conv_in.dim() != 3 or w.dim() != 2 or b.shape != (conv_in.shape[2],) \
            or w.shape[1] != conv_in.shape[2] or (
                conv_buf is not None and tuple(conv_buf.shape) != (
                    conv_in.shape[0], w.shape[0] - 1, conv_in.shape[2])):
        raise ValueError(
            f"conv_silu: shapes conv_buf "
            f"{None if conv_buf is None else tuple(conv_buf.shape)}, conv_in "
            f"{tuple(conv_in.shape)}, w {tuple(w.shape)}, b "
            f"{tuple(b.shape)} do not agree")
    if conv_in.device.type == "cpu":
        return conv_silu_ref(conv_buf, conv_in, w, b)
    ts = [conv_in, w, b] + ([] if conv_buf is None else [conv_buf])
    if conv_in.device.type != "cuda" or any(t.device != conv_in.device
                                            for t in ts):
        raise ValueError(f"conv_silu: expected CPU or CUDA tensors on one "
                         f"device, got {[str(t.device) for t in ts]}")
    if conv_in.dtype not in _DTYPES or any(t.dtype != conv_in.dtype
                                           for t in ts):
        raise TypeError(f"conv_silu: dtypes {[t.dtype for t in ts]}; need "
                        f"one of {list(_DTYPES)} for all")
    no_backward("conv_silu", *ts)
    bsz, s, c = conv_in.shape
    k = w.shape[0]
    if k not in CONV_WIDTHS:
        raise ValueError(f"conv_silu: conv width {k} not in {CONV_WIDTHS}")
    if conv_in.stride(2) != 1 or not w.is_contiguous() \
            or not b.is_contiguous() or (conv_buf is not None
                                         and not conv_buf.is_contiguous()):
        raise ValueError("conv_silu: conv_in's channel dim must be dense, w, "
                         "b and conv_buf contiguous")
    if bsz > 65535:
        raise ValueError(f"conv_silu: batch {bsz} above 65535")
    out = torch.empty((bsz, s, c), dtype=conv_in.dtype, device=conv_in.device)
    lib = _build.load("silu")
    with torch.cuda.device(conv_in.device):
        err = lib.conv_silu_launch(
            None if conv_buf is None else conv_buf.data_ptr(),
            conv_in.data_ptr(), conv_in.stride(0), conv_in.stride(1),
            w.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, s, c, k,
            _DTYPES[conv_in.dtype],
            torch.cuda.current_stream(conv_in.device).cuda_stream)
    _build.check("silu", "conv_silu_launch", err)
    conv_silu.launches += 1
    return out


silu.launches = 0
conv_silu.launches = 0
