"""Plain PyTorch versions of the kernels of ``csrc/silu.cu``.

The reference's ``jax.nn.silu`` is x * (1 / (1 + exp(-x))), and XLA on the
CPU rounds every op to x's dtype (it computes each bf16 op in float32 and
rounds its result; on the TPU it fuses them and may keep float32 between
them, so these are the CPU reference's bits, not the TPU's); ``F.silu``
rounds once, and in bf16 the two part by an ulp on a third of the
elements.  Each torch op on a bf16 tensor rounds its result, so this
expression gives the CPU reference's bits.

``conv_silu_ref`` is the mamba block's conv and SiLU as the model computed
them before the fused kernel, op for op (``causal_conv`` for the cacheless
forward, the cached branch for a prefill into a cache and a decode step):
on the CPU the port computes the same bits as before.

``conv_silu_bwd_ref`` is the gradient of the cacheless ``conv_silu_ref``,
the backward kernel's plain version (``csrc/silu.cu``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def silu_ref(x):
    return x * (1.0 / (1.0 + (-x).exp()))


def causal_conv(x, w, b):
    """Depthwise causal conv: x (B,S,C), w (K,C).  Returns (B,S,C)."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + s, :] * w[i][None, None, :] for i in range(k))
    return out + b[None, None, :]


def conv_silu_ref(conv_buf, conv_in, w, b):
    """SiLU of the depthwise causal conv of ``conv_in`` (B,S,C) with w (K,C)
    and bias b (C,), over the history ``conv_buf`` (B,K-1,C), which is
    shifted in place to the last K-1 tokens, or over zeros when it is
    None."""
    if conv_buf is None:
        return silu_ref(causal_conv(conv_in, w, b))
    kw, s = w.shape[0], conv_in.shape[1]
    buf = torch.cat([conv_buf, conv_in], dim=1)           # (B,K-1+s,C)
    conv = sum(buf[:, i:i + s, :] * w[i][None, None, :]
               for i in range(kw)) + b[None, None, :]
    conv_buf.copy_(buf[:, -(kw - 1):, :])
    return silu_ref(conv)


def silu_grad(u):
    """d silu / du at u, in float32: s (1 + u (1 - s)), s = sigmoid(u)."""
    u = u.float()
    s = 1.0 / (1.0 + torch.exp(-u))
    return s * (1.0 + u * (1.0 - s))


def conv_silu_bwd_ref(conv_in, w, b, g):
    """The gradients ``(dconv_in, dw, db)`` of ``conv_silu_ref(None,
    conv_in, w, b)`` against ``g`` (B,S,C), each in its input's dtype.

    The pre-activation u is recomputed with the forward's roundings; the
    gradient at it, du = g silu'(u), is taken in float32 and rounded to the
    dtype, where the reference's cotangent of the conv output is rounded
    (its SiLU's backward rounds each of its ops in bf16 before that, this
    one only at du).  Then, in float32 and rounded once: dconv_in, the
    anti-causal depthwise conv of du (dconv_in[t] = sum_i du[t + K - 1 -
    i] w[i]), and dw[i] = sum over (b, t) of du[t] conv_in[t + i - K + 1],
    db = sum over (b, t) of du."""
    k, s = w.shape[0], conv_in.shape[1]
    f32 = torch.float32
    du = (g.float() * silu_grad(causal_conv(conv_in, w, b))).to(g.dtype)
    du = du.to(f32)
    dp = F.pad(du, (0, 0, 0, k - 1))                      # (B,S+K-1,C)
    wf = w.to(f32)
    dx = sum(dp[:, k - 1 - i:k - 1 - i + s, :] * wf[i][None, None, :]
             for i in range(k))
    xp = F.pad(conv_in.to(f32), (0, 0, k - 1, 0))
    dw = torch.stack([(du * xp[:, i:i + s, :]).sum((0, 1))
                      for i in range(k)])
    return (dx.to(conv_in.dtype), dw.to(w.dtype),
            du.sum((0, 1)).to(b.dtype))
