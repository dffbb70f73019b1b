"""Flash-attention wrapper: folds GQA into the kernel's row map, pads S.

For a tensor on the CPU it computes the kernel's contract in plain PyTorch
(``ref.flash_fold_ref``); for a CUDA tensor it launches
``csrc/flash_attention.cu`` or raises: there is no fallback.
``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import _build
from .ref import flash_fold_ref

BQ = 128                       # the kernel's query tile; S is padded to it
HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _launch(qf, kf, vf, group: int, causal: bool, valid_len: int):
    bh, s, hd = qf.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    if qf.dtype not in _DTYPES or kf.dtype != qf.dtype \
            or vf.dtype != qf.dtype:
        raise TypeError(f"flash_attention: q/k/v dtypes {qf.dtype}, "
                        f"{kf.dtype}, {vf.dtype}; need one of "
                        f"{list(_DTYPES)}")
    if not (qf.device == kf.device == vf.device):
        raise ValueError("flash_attention: q, k and v on different devices")
    if bh > 65535:
        raise ValueError(f"flash_attention: {bh} (batch x heads) rows exceed "
                         "the grid's 65535")
    o = torch.empty_like(qf)
    lib = _build.load("flash_attention")
    with torch.cuda.device(qf.device):
        err = lib.flash_attention_launch(
            qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), o.data_ptr(), bh, s,
            hd, group, int(causal), valid_len, 1.0 / math.sqrt(hd),
            _DTYPES[qf.dtype], torch.cuda.current_stream(qf.device).cuda_stream)
    _build.check("flash_attention", "flash_attention_launch", err)
    flash_attention.launches += 1
    return o


def flash_attention(q, k, v, causal: bool = True):
    """q (B,S,H,hd); k/v (B,S,KV,hd) -> (B,S,H,hd).

    Heads fold into rows: q becomes (B*H, S, hd) and k/v (B*KV, S, hd), and
    q row ``b`` reads kv row ``b // group``, so k/v are never repeated.
    Ragged S is zero-padded to the 128-row query tile; padded keys are
    masked inside the kernel (exact for causal and non-causal), padded
    query rows are sliced off."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    if h % kv:
        raise ValueError(f"flash_attention: {h} q heads not a multiple of "
                         f"{kv} kv heads")
    g = h // kv
    pad = (-s) % BQ
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    sp = s + pad
    # reshape may return a strided view (B == 1 or H == 1); the kernel
    # indexes dense rows, so make them contiguous
    qf = q.transpose(1, 2).reshape(b * h, sp, hd).contiguous()
    kf = k.transpose(1, 2).reshape(b * kv, sp, hd).contiguous()
    vf = v.transpose(1, 2).reshape(b * kv, sp, hd).contiguous()
    if q.device.type == "cpu":
        out = flash_fold_ref(qf, kf, vf, g, causal, s)
    elif q.device.type == "cuda":
        out = _launch(qf, kf, vf, g, causal, s)
    else:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return out.reshape(b, h, sp, hd).transpose(1, 2)[:, :s]


flash_attention.launches = 0
