"""Wrappers of the kernels of ``csrc/silu.cu``: SiLU, and the mamba block's
conv pass with its SiLU.

For tensors on the CPU each computes its plain version (``ref.py``); for
CUDA tensors it launches its kernel or raises: there is no fallback.
``.launches`` on each counts its kernel launches.

Gradients: the cacheless ``conv_silu`` (``conv_buf`` None, the training
forward) goes through :class:`ConvSiluFn` under grad, whose backward is
``conv_silu_bwd`` (the kernel on the card, ``ref.conv_silu_bwd_ref`` on the
CPU); with a cache under grad it raises on both devices.  ``silu`` has no
backward and raises under grad on the card (``decode.ops.no_backward``).
"""

from __future__ import annotations

import torch

from .. import _build
from ..decode.ops import _sms, no_backward, wants_grad
from .ref import conv_silu_bwd_ref, conv_silu_ref, silu_ref

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


def _conv_check(name, conv_buf, conv_in, w, b):
    """Raise unless the conv kernels take these tensors on the card."""
    ts = [conv_in, w, b] + ([] if conv_buf is None else [conv_buf])
    if conv_in.device.type != "cuda" or any(t.device != conv_in.device
                                            for t in ts):
        raise ValueError(f"{name}: expected CPU or CUDA tensors on one "
                         f"device, got {[str(t.device) for t in ts]}")
    if conv_in.dtype not in _DTYPES or any(t.dtype != conv_in.dtype
                                           for t in ts):
        raise TypeError(f"{name}: dtypes {[t.dtype for t in ts]}; need "
                        f"one of {list(_DTYPES)} for all")
    if w.shape[0] not in CONV_WIDTHS:
        raise ValueError(f"{name}: conv width {w.shape[0]} not in "
                         f"{CONV_WIDTHS}")
    if conv_in.stride(2) != 1 or not w.is_contiguous() \
            or not b.is_contiguous() or (conv_buf is not None
                                         and not conv_buf.is_contiguous()):
        raise ValueError(f"{name}: conv_in's channel dim must be dense, w, "
                         "b and conv_buf contiguous")
    if conv_in.shape[0] > 65535:
        raise ValueError(f"{name}: batch {conv_in.shape[0]} above 65535")


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
    if wants_grad(conv_in, w, b):
        if conv_buf is not None:
            raise NotImplementedError(
                "conv_silu: only the cacheless pass (conv_buf None) takes a "
                "gradient; run a cached pass under torch.no_grad()")
        if conv_in.device.type == "cuda":
            _conv_check("conv_silu", None, conv_in, w, b)
        return ConvSiluFn.apply(conv_in, w, b)
    return _conv_silu(conv_buf, conv_in, w, b)


def _conv_silu(conv_buf, conv_in, w, b):
    if conv_in.device.type == "cpu":
        return conv_silu_ref(conv_buf, conv_in, w, b)
    _conv_check("conv_silu", conv_buf, conv_in, w, b)
    if conv_buf is not None:
        no_backward("conv_silu", conv_buf)
    bsz, s, c = conv_in.shape
    k = w.shape[0]
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


CONV_BWD_SLICE = 64             # (b, t) rows a partial of dw and db sums
CONV_BWD_RUNS = (16, 24, 32, 48, 64)    # tokens a thread may walk
CONV_BWD_WARPS_SM = 12          # warps of the pass an SM holds


def conv_bwd_plan(b, s, units, sms):
    """``(run, warps)`` of ``conv_silu_bwd``'s pass over ``b`` batch rows of
    ``s`` tokens and ``units`` channel units (16 bytes each, or channels off
    the 16-byte grid) on a card of ``sms`` SMs: a thread walks ``run``
    tokens of one batch row, and a block's ``warps`` warps take consecutive
    runs of the same 32 units, at least ``CONV_BWD_SLICE`` rows together,
    and leave one partial of dw and db.  The run is the shortest of
    ``CONV_BWD_RUNS`` whose warps all fit on the card at once (a run
    recomputes K - 1 positions past its end, so a shorter run costs
    arithmetic; more warps than the card holds leave a partial second
    wave); past the longest, the longest."""
    groups = -(-units // 32)
    for run in CONV_BWD_RUNS:
        if groups * b * -(-s // run) <= sms * CONV_BWD_WARPS_SM:
            break
    return run, -(-CONV_BWD_SLICE // run)


def conv_silu_bwd(conv_in, w, b, g):
    """The gradients ``(dconv_in, dw, db)`` of the cacheless ``conv_silu``
    against ``g`` (B, S, C), each contiguous in its input's dtype.  On the
    CPU the plain version (``ref.conv_silu_bwd_ref``); on the card the
    kernel: two launches, one count.  The first is one pass over the rows
    in runs of tokens (``conv_bwd_plan``) that writes dconv_in and leaves a
    float32 partial of dw and db a slice of at least ``CONV_BWD_SLICE``
    rows; the second sums the slices in order.  ``conv_in`` is read in
    place through its strides, 16 bytes at a time where its channel count,
    strides and pointers allow it, else a channel at a time."""
    if conv_in.dim() != 3 or w.dim() != 2 or b.shape != (conv_in.shape[2],) \
            or w.shape[1] != conv_in.shape[2] or g.shape != conv_in.shape:
        raise ValueError(
            f"conv_silu_bwd: shapes conv_in {tuple(conv_in.shape)}, w "
            f"{tuple(w.shape)}, b {tuple(b.shape)}, g {tuple(g.shape)} do "
            "not agree")
    if conv_in.device.type == "cpu":
        return conv_silu_bwd_ref(conv_in, w, b, g)
    _conv_check("conv_silu_bwd", None, conv_in, w, b)
    if g.device != conv_in.device or g.dtype != conv_in.dtype:
        raise TypeError(f"conv_silu_bwd: g {g.dtype} on {g.device}; need "
                        f"{conv_in.dtype} on {conv_in.device}")
    bsz, s, c = conv_in.shape
    k = w.shape[0]
    g = g.contiguous()
    dev, dt = conv_in.device, conv_in.dtype
    dx = torch.empty((bsz, s, c), dtype=dt, device=dev)
    if bsz * s == 0:
        return (dx, torch.zeros((k, c), dtype=dt, device=dev),
                torch.zeros((c,), dtype=dt, device=dev))
    dw = torch.empty((k, c), dtype=dt, device=dev)
    db = torch.empty((c,), dtype=dt, device=dev)
    unit = 16 // conv_in.element_size()
    vec = c % unit == 0 and conv_in.stride(0) % unit == 0 \
        and conv_in.stride(1) % unit == 0 \
        and all(t.data_ptr() % 16 == 0 for t in (conv_in, w, b, g, dx))
    run, warps = conv_bwd_plan(bsz, s, c // unit if vec else c,
                               _sms(dev.index))
    slices = -(-bsz * -(-s // run) // warps)
    part = torch.empty((slices, k + 1, c), dtype=torch.float32, device=dev)
    lib = _build.load("silu")
    with torch.cuda.device(dev):
        err = lib.conv_silu_bwd_launch(
            conv_in.data_ptr(), conv_in.stride(0), conv_in.stride(1),
            w.data_ptr(), b.data_ptr(), g.data_ptr(), dx.data_ptr(),
            part.data_ptr(), dw.data_ptr(), db.data_ptr(), bsz, s, c, k, run,
            warps, int(vec), _DTYPES[dt],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check("silu", "conv_silu_bwd_launch", err)
    conv_silu_bwd.launches += 1
    return dx, dw, db


class ConvSiluFn(torch.autograd.Function):
    """The cacheless ``conv_silu`` with its gradient: the forward kernel
    (the plain version on the CPU), saving its inputs; the backward
    ``conv_silu_bwd``."""

    @staticmethod
    def forward(ctx, conv_in, w, b):
        ctx.save_for_backward(conv_in, w, b)
        return _conv_silu(None, conv_in, w, b)

    @staticmethod
    def backward(ctx, g):
        return conv_silu_bwd(*ctx.saved_tensors, g)


silu.launches = 0
conv_silu.launches = 0
conv_silu_bwd.launches = 0
