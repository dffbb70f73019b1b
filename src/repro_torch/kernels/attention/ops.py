"""Flash-attention wrapper: hands the kernel the model's own layout.

q (B, S, H, hd) and k/v (B, S, KV, hd) go to ``csrc/flash_attention.cu``
in place, through their batch, row and head strides; q head h reads kv
head h // (H // KV), so k/v are never repeated.  The kernel masks a ragged
S itself and writes a contiguous (B, S, H, hd) output, so nothing is
padded, transposed or copied on either side.  Each row of hd elements must
be dense and start on a 16-byte boundary; the wrapper raises otherwise.

For tensors on the CPU it computes the kernel's function in plain PyTorch
(``ref.flash_ref``); for CUDA tensors it launches the kernel or raises:
there is no fallback.  ``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import math

import torch

from .. import _build
from .ref import flash_ref

HEAD_DIMS = (8, 16, 32, 64, 112, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _launch(q, k, v, causal: bool, valid_len: int):
    b, s, h, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q/k/v dtypes {q.dtype}, "
                        f"{k.dtype}, {v.dtype}; need one of "
                        f"{list(_DTYPES)}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v on different devices")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the last dimension of q, k and v "
                         "must be dense")
    # a dimension of size 1 is never stepped over: its stride is moot
    strides = [[t.stride(i) if t.shape[i] > 1 else 0 for i in range(3)]
               for t in (q, k, v)]
    e = 16 // q.element_size()
    if any(t.data_ptr() % 16 for t in (q, k, v)) \
            or any(st % e for row in strides for st in row):
        raise ValueError("flash_attention: every row of q, k and v must "
                         "start on a 16-byte boundary")
    o = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, h,
            k.shape[2], hd, *strides[0], *strides[1], *strides[2],
            int(causal), valid_len, 1.0 / math.sqrt(hd), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention", "flash_attention_launch", err)
    flash_attention.launches += 1
    return o


def flash_attention(q, k, v, causal: bool = True,
                    valid_len: int | None = None):
    """q (B,S,H,hd); k/v (B,S,KV,hd) -> contiguous (B,S,H,hd) in q's dtype.

    Keys at or past ``valid_len`` (default S) and, when causal, keys after
    the query are masked; softmax and accumulation in float32."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not agree")
    s, h, kv = q.shape[1], q.shape[2], k.shape[2]
    if h % kv:
        raise ValueError(f"flash_attention: {h} q heads not a multiple of "
                         f"{kv} kv heads")
    valid_len = s if valid_len is None else valid_len
    if not 1 <= valid_len <= s:
        raise ValueError(f"flash_attention: valid_len {valid_len} not in "
                         f"[1, {s}]")
    if q.device.type == "cpu":
        return flash_ref(q, k, v, causal, valid_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch(q, k, v, causal, valid_len)


flash_attention.launches = 0
