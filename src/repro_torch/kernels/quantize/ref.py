"""Plain PyTorch versions of the int8 quantize kernels (the lambda analogue).

Blocks are (BM, BN) tiles with one float32 absmax scale each; payload int8.
These are the functions ``csrc/quantize.cu`` must reproduce bit for bit;
the wrappers in ``ops.py`` call them for tensors on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

BM, BN = 256, 256
# the float32 nearest to 1/127, as the kernel's (float)(1.0/127.0)
INV127 = float(np.float32(1.0 / 127.0))


def _pad_to(x, bm, bn):
    m, n = x.shape
    pm, pn = (-m) % bm, (-n) % bn
    if pm or pn:
        x = F.pad(x, (0, pn, 0, pm))
    return x


def _scale_of(absmax):
    return torch.where(absmax > 0, absmax * INV127, torch.ones_like(absmax))


def quantize_ref(x, bm: int = BM, bn: int = BN):
    """x (M, N) float -> (q int8 (M, N), scales f32 (ceil(M/bm), ceil(N/bn)))."""
    m, n = x.shape
    xp = _pad_to(x.float(), bm, bn)
    mp, np_ = xp.shape
    t = xp.reshape(mp // bm, bm, np_ // bn, bn).permute(0, 2, 1, 3)
    scale = _scale_of(t.abs().amax(dim=(2, 3)))
    q = torch.clamp(torch.round(t * torch.reciprocal(scale)[:, :, None, None]),
                    -127, 127)
    q = q.permute(0, 2, 1, 3).reshape(mp, np_)[:m, :n].to(torch.int8)
    return q, scale


def dequantize_ref(q, scales, bm: int = BM, bn: int = BN,
                   out_dtype=torch.bfloat16):
    m, n = q.shape
    qp = _pad_to(q.float(), bm, bn)
    mp, np_ = qp.shape
    t = qp.reshape(mp // bm, bm, np_ // bn, bn).permute(0, 2, 1, 3)
    x = t * scales[:, :, None, None]
    return x.permute(0, 2, 1, 3).reshape(mp, np_)[:m, :n].to(out_dtype)


def rowwise_quantize(x):
    """Per-row int8 quantization for the pipeline's wire: the blockwise
    scheme with a tile one row tall and as wide as the row."""
    xf = x.float()
    scale = _scale_of(xf.abs().amax(dim=-1, keepdim=True))
    q = torch.clamp(torch.round(xf * torch.reciprocal(scale)), -127, 127)
    return q.to(torch.int8), scale


def fake_quantize(x, bits: int = 8):
    """Quantize-dequantize round trip of any tensor with one per-tensor
    scale: the train step's gradient compression (the reference's
    ``fake_quantize``, plain there too).  Same bits as the reference's."""
    levels = 2.0 ** (bits - 1) - 1
    xf = x.float()
    absmax = xf.abs().max()
    scale = torch.where(absmax > 0, absmax / levels,
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(xf / scale), -levels, levels)
    return (q * scale).to(x.dtype)
