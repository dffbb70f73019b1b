"""Wrapper of the SiLU kernel (``csrc/silu.cu``).

For a tensor on the CPU it computes the plain version (``ref.silu_ref``);
for a CUDA tensor it launches the kernel or raises: there is no fallback.
``silu.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .. import _build
from .ref import silu_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    lib = _build.load("silu")
    with torch.cuda.device(x.device):
        err = lib.silu_launch(x.data_ptr(), rows.stride(0), out.data_ptr(),
                              rows.shape[0], d, _DTYPES[x.dtype],
                              torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("silu", "silu_launch", err)
    silu.launches += 1
    return out


silu.launches = 0
