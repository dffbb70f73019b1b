"""SSD chunk-scan wrapper (``csrc/ssd.cu``).

For tensors on the CPU it computes the kernel's function in plain PyTorch
(``ref.ssd_chunked``); for CUDA tensors it launches the kernel or raises:
there is no fallback.  ``ssd_scan.launches`` counts kernel launches.

The kernel reads x, dt, B and C in place through their strides, so the
model's views of its convolution output go in without a copy.  It reads
and writes x, B, C and y 16 bytes at a time: each last dimension must be
dense, and every row of x, B and C must start on a 16-byte boundary.
"""

from __future__ import annotations

import torch

from .. import _build
from ..decode.ops import no_backward
from .ref import ssd_chunked

CHUNKS = (16, 128)             # the configs' chunk lengths (a template)
MAX_DIM = 128                  # largest head dim P and state size N
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _launch(xh, dt, A, Bm, Cm, chunk: int):
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


def ssd_scan(xh, dt, A, Bm, Cm, chunk: int):
    """xh (B,S,H,P); dt (B,S,H) float32, softplus'd; A (H,) float32;
    Bm/Cm (B,S,N) -> (y (B,S,H,P) in xh's dtype, final state (B,H,P,N)
    float32), from a zero state, in chunks of ``chunk`` tokens (the
    kernel masks a ragged last chunk; the plain version pads it)."""
    if xh.device.type == "cpu":
        return ssd_chunked(xh, dt, A, Bm, Cm, chunk)
    if xh.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {xh.device}")
    no_backward("ssd_scan", xh, dt, A, Bm, Cm)
    return _launch(xh, dt, A, Bm, Cm, chunk)


ssd_scan.launches = 0
