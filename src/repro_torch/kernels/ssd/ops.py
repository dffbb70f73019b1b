"""SSD chunk-scan wrapper (``csrc/ssd.cu``).

For tensors on the CPU it computes the kernel's function in plain PyTorch
(``ref.ssd_chunked``); for CUDA tensors it launches the kernel or raises:
there is no fallback.  ``ssd_scan.launches`` counts kernel launches.

The kernel reads x, dt, B and C in place through their strides, so the
model's views of its convolution output go in without a copy.  It reads
and writes x, B, C and y 16 bytes at a time: each last dimension must be
dense, and every row of x, B and C must start on a 16-byte boundary.

Gradients: when grad mode is on and an input requires grad, ``ssd_scan``
goes through :class:`SsdScanFn` on both devices: the forward as without
grad, and as backward ``ssd_scan_bwd`` (``csrc/ssd_bwd.cu`` on the card,
``ref.ssd_bwd_ref`` on the CPU), for y only: the final state comes back
detached (training never reads it).  The backward kernel takes every call
the forward kernel takes; on the card the forward's checks run before it.
Without grad the call keeps its path, its launches and its bits.
``ssd_scan_bwd.launches`` counts the backward's calls on the card (four
launches each).  The bf16 calls at a chunk of 128 and a head dim of at
most 64 (the SSM family's training calls) take the tensor-core design:
the chunk-state walks (with C B^T), the chunk pass, dB and dC summed over
groups of ``BWD_GROUP`` heads, the sums over the groups and chunks; the
others the first design: the chunk states, their gradients, the chunk
pass, the sums over heads and chunks (``csrc/ssd_bwd.cu``).
"""

from __future__ import annotations

import torch

from .. import _build
from ..decode.ops import wants_grad
from .ref import ssd_bwd_ref, ssd_chunked

CHUNKS = (16, 128)             # the configs' chunk lengths (a template)
MAX_DIM = 128                  # largest head dim P and state size N
BWD_GROUP = 8                  # heads a dB/dC partial of the backward sums
BWD_TC_MAX_P = 64              # largest P of the backward's bf16 design
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(xh, dt, A, Bm, Cm, chunk: int):
    """Raise unless the kernels take this call (the forward's and the
    backward's scope is the same)."""
    if xh.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 3 \
            or Cm.dim() != 3:
        raise ValueError("ssd_scan: need xh (B,S,H,P), dt (B,S,H), A (H,), "
                         "Bm/Cm (B,S,N)")
    b, s, h, p = xh.shape
    n = Bm.shape[-1]
    if tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,) \
            or tuple(Bm.shape) != (b, s, n) or tuple(Cm.shape) != (b, s, n):
        raise ValueError(
            f"ssd_scan: shapes xh {tuple(xh.shape)}, dt {tuple(dt.shape)}, "
            f"A {tuple(A.shape)}, Bm {tuple(Bm.shape)}, Cm "
            f"{tuple(Cm.shape)} do not agree")
    if chunk not in CHUNKS:
        raise ValueError(f"ssd_scan: chunk {chunk} not in {CHUNKS}")
    if not (1 <= p <= MAX_DIM and 1 <= n <= MAX_DIM):
        raise ValueError(f"ssd_scan: head dim {p} and state {n} must lie in "
                         f"[1, {MAX_DIM}]")
    if b > 65535:
        raise ValueError(f"ssd_scan: batch {b} exceeds the grid's 65535")
    if xh.dtype not in _DTYPES or Bm.dtype != xh.dtype \
            or Cm.dtype != xh.dtype:
        raise TypeError(f"ssd_scan: xh/Bm/Cm dtypes {xh.dtype}, {Bm.dtype}, "
                        f"{Cm.dtype}; need one of {list(_DTYPES)} for all")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan: dt and A must be float32, got {dt.dtype} "
                        f"and {A.dtype}")
    if len({t.device for t in (xh, dt, A, Bm, Cm)}) != 1:
        raise ValueError("ssd_scan: inputs on different devices")
    if xh.stride(3) != 1 or Bm.stride(2) != 1 or Cm.stride(2) != 1:
        raise ValueError("ssd_scan: the last dimension of xh, Bm and Cm "
                         "must be dense")
    e = 16 // xh.element_size()
    if p % e or n % e:
        raise ValueError(f"ssd_scan: head dim {p} and state {n} must be "
                         f"multiples of 16 bytes ({e} elements)")
    if any(t.data_ptr() % 16 for t in (xh, Bm, Cm)) \
            or any(st % e for st in (*xh.stride()[:3], *Bm.stride()[:2],
                                     *Cm.stride()[:2])):
        raise ValueError("ssd_scan: every row of xh, Bm and Cm must start "
                         "on a 16-byte boundary")


def _launch(xh, dt, A, Bm, Cm, chunk: int):
    _check(xh, dt, A, Bm, Cm, chunk)
    b, s, h, p = xh.shape
    n = Bm.shape[-1]
    A = A.contiguous()
    y = torch.empty((b, s, h, p), dtype=xh.dtype, device=xh.device)
    st = torch.empty((b, h, p, n), dtype=torch.float32, device=xh.device)
    lib = _build.load("ssd")
    with torch.cuda.device(xh.device):
        err = lib.ssd_scan_launch(
            xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), st.data_ptr(), b, s, h, p, n, chunk,
            *xh.stride()[:3], *dt.stride(), *Bm.stride()[:2],
            *Cm.stride()[:2], _DTYPES[xh.dtype],
            torch.cuda.current_stream(xh.device).cuda_stream)
    _build.check("ssd", "ssd_scan_launch", err)
    ssd_scan.launches += 1
    return y, st


def bwd_tensor_cores(dtype, chunk: int, p: int) -> bool:
    """Whether the backward takes the tensor-core design (bf16, chunk 128,
    P <= ``BWD_TC_MAX_P``) rather than the first design."""
    return dtype == torch.bfloat16 and chunk == 128 and p <= BWD_TC_MAX_P


def ssd_scan_bwd(xh, dt, A, Bm, Cm, dy, chunk: int):
    """The gradients ``(dxh, ddt, dA, dBm, dCm)`` of ``ssd_scan``'s y
    against ``dy`` (B,S,H,P): dxh, dBm and dCm in their inputs' dtypes, ddt
    (B,S,H) and dA (H,) float32, contiguous.  On the CPU the plain version
    (``ref.ssd_bwd_ref``); on the card the kernel, or a raise for a call
    the kernels do not take."""
    if tuple(dy.shape) != tuple(xh.shape):
        raise ValueError(f"ssd_scan_bwd: dy {tuple(dy.shape)} is not xh's "
                         f"{tuple(xh.shape)}")
    if xh.device.type == "cpu":
        return ssd_bwd_ref(xh, dt, A, Bm, Cm, dy, chunk)
    if xh.device.type != "cuda":
        raise ValueError(f"ssd_scan_bwd: unsupported device {xh.device}")
    _check(xh, dt, A, Bm, Cm, chunk)
    if dy.dtype != xh.dtype or dy.device != xh.device:
        raise TypeError(f"ssd_scan_bwd: dy {dy.dtype} on {dy.device}; need "
                        f"{xh.dtype} on {xh.device}")
    b, s, h, p = xh.shape
    n = Bm.shape[-1]
    nc = -(-s // chunk)
    dev = xh.device
    f32 = torch.float32
    dy = dy.contiguous()
    A = A.contiguous()
    dx = torch.empty((b, s, h, p), dtype=xh.dtype, device=dev)
    ddt = torch.empty((b, s, h), dtype=f32, device=dev)
    dA = torch.empty((h,), dtype=f32, device=dev)
    dB = torch.empty((b, s, n), dtype=Bm.dtype, device=dev)
    dC = torch.empty((b, s, n), dtype=Cm.dtype, device=dev)
    # scratch: the chunk-start states and the chunk-end states' gradients
    # (b, h, nc, p, n) float32 (the tensor-core design keeps them as bf16
    # hi and lo planes, the same bytes), the head groups' terms of dB and dC
    # (2, b, groups, s, n: groups of BWD_GROUP heads on the tensor-core
    # design, one a head on the first), the chunks' terms of dA (b, nc, h)
    # and the tensor-core design's C B^T (36 causal 16 x 16 tiles a chunk)
    tc = bwd_tensor_cores(xh.dtype, chunk, p)
    groups = -(-h // BWD_GROUP) if tc else h
    states = torch.empty((2, b, h, nc, p, n), dtype=f32, device=dev)
    part = torch.empty((2, b, groups, s, n), dtype=f32, device=dev)
    part_a = torch.empty((b, nc, h), dtype=f32, device=dev)
    cb = torch.empty((b, nc, 36, 256), dtype=f32, device=dev) if tc else None
    lib = _build.load("ssd_bwd")
    with torch.cuda.device(dev):
        err = lib.ssd_scan_bwd_launch(
            xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
            dA.data_ptr(), dB.data_ptr(), dC.data_ptr(), states.data_ptr(),
            part.data_ptr(), part_a.data_ptr(),
            None if cb is None else cb.data_ptr(), b, s, h, p, n, chunk,
            groups, *xh.stride()[:3], *dt.stride(), *Bm.stride()[:2],
            *Cm.stride()[:2], _DTYPES[xh.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check("ssd_bwd", "ssd_scan_bwd_launch", err)
    ssd_scan_bwd.launches += 1
    return dx, ddt, dA, dB, dC


class SsdScanFn(torch.autograd.Function):
    """``ssd_scan`` with its gradient for y: the forward as without grad
    (the kernel on the card, ``ssd_chunked`` on the CPU), saving the
    inputs; the backward ``ssd_scan_bwd``.  The final state is returned
    detached."""

    @staticmethod
    def forward(ctx, xh, dt, A, Bm, Cm, chunk):
        if xh.device.type == "cpu":
            y, st = ssd_chunked(xh, dt, A, Bm, Cm, chunk)
        else:
            y, st = _launch(xh, dt, A, Bm, Cm, chunk)
        ctx.save_for_backward(xh, dt, A, Bm, Cm)
        ctx.chunk = chunk
        ctx.mark_non_differentiable(st)
        return y, st

    @staticmethod
    def backward(ctx, dy, _dst):
        xh, dt, A, Bm, Cm = ctx.saved_tensors
        return (*ssd_scan_bwd(xh, dt, A, Bm, Cm, dy, ctx.chunk), None)


def ssd_scan(xh, dt, A, Bm, Cm, chunk: int):
    """xh (B,S,H,P); dt (B,S,H) float32, softplus'd; A (H,) float32;
    Bm/Cm (B,S,N) -> (y (B,S,H,P) in xh's dtype, final state (B,H,P,N)
    float32), from a zero state, in chunks of ``chunk`` tokens (the
    kernel masks a ragged last chunk; the plain version pads it).  Under
    grad it goes through :class:`SsdScanFn`."""
    if xh.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan: unsupported device {xh.device}")
    if wants_grad(xh, dt, A, Bm, Cm):
        if xh.device.type == "cuda":
            _check(xh, dt, A, Bm, Cm, chunk)
        return SsdScanFn.apply(xh, dt, A, Bm, Cm, chunk)
    if xh.device.type == "cpu":
        return ssd_chunked(xh, dt, A, Bm, Cm, chunk)
    return _launch(xh, dt, A, Bm, Cm, chunk)


ssd_scan.launches = 0
ssd_scan_bwd.launches = 0
