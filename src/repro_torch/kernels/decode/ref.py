"""Plain PyTorch versions of the decode kernels (``csrc/decode.cu``) and
the RMSNorm with its fused prologues (``csrc/norm.cu``).

They are the model's code as it was before the kernels, moved here
unchanged: on the CPU the port computes the same bits as before.  On
the card they are the yardstick each kernel is held to, and they are what
the kernels replace there: a library matmul, torch's row reductions and a
masked softmax over the kv bucket choose their summation order by the row
count and the padded length.
"""

from __future__ import annotations

import math

import torch

from ..silu.ref import silu_grad, silu_ref

NEG = -1e30


def rows_matmul_ref(x, w):
    """x (M, K) @ w (K, N) in x's dtype."""
    return x @ w


def rms_norm_ref(x, w, eps):
    """RMSNorm over the last dim, computed in float32 and cast back."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def residual_rms_norm_ref(h, delta, w, eps):
    """The dense block's residual add and the norm after it: (h + delta,
    its RMSNorm)."""
    h = h + delta
    return h, rms_norm_ref(h, w, eps)


def gated_rms_norm_ref(y, D, xh, z, w, eps):
    """The mamba block's tail before out_proj: the skip D xh (D (H,)
    float32, cast to y's dtype) added to y (B,S,H,P), gated by SiLU of z
    (B,S,H*P), then the RMSNorm."""
    y = y + D[None, None, :, None].to(y.dtype) * xh.to(y.dtype)
    y = y.reshape(z.shape).to(z.dtype)
    return rms_norm_ref(y * silu_ref(z), w, eps)


def gated_rms_norm_bwd_ref(y, D, xh, z, w, eps, g):
    """The gradients ``(dy, dD, dxh, dz, dw)`` of ``gated_rms_norm_ref``
    against ``g`` (z's shape): dD float32, the others in their inputs'
    dtypes.

    The norm's input v = (y + D xh) silu(z) is recomputed with the
    forward's roundings, the norm differentiated in float32 (dv = r (dn -
    n mean(dn n)), n = v r, dn = g w) and dv rounded to the dtype, where
    the reference's cotangent of the bf16 input is; from there each
    gradient rounds where the reference's bf16 products do: dy = r(dv
    silu(z)), dxh = r(dy r(D)), and the gate's r(dv (y + D xh)) times
    silu'(z) in float32, rounded once (the reference's SiLU backward
    rounds each op).  dw and dD are float32 sums over the rows (dD of dy
    xh over each head's elements), dw rounded to its dtype."""
    dt = z.dtype
    f32 = torch.float32
    yy = y + D[None, None, :, None].to(y.dtype) * xh.to(y.dtype)
    yy = yy.reshape(z.shape).to(dt)
    sz = silu_ref(z)
    v = (yy * sz).float()
    r = torch.rsqrt((v * v).mean(dim=-1, keepdim=True) + eps)
    n = v * r
    dn = g.float() * w.float()
    dv = (r * (dn - n * (dn * n).mean(dim=-1, keepdim=True))).to(dt)
    dyy = dv * sz
    dz = ((dv * yy).float() * silu_grad(z)).to(dt)
    d_y = dyy.reshape(y.shape)
    dxh = (d_y * D[None, None, :, None].to(dt)).to(xh.dtype)
    dD = (d_y.float() * xh.float()).sum((0, 1, 3))
    dw = (g.float() * n).reshape(-1, w.shape[0]).sum(0).to(w.dtype)
    return d_y.to(y.dtype), dD, dxh, dz, dw


def decode_attention_ref(q, k, v, kv_len):
    """One query token per sequence: q (B,1,H,hd) against k/v (B,S,KV,hd),
    keys at or past ``kv_len`` (B,) masked.  Scores in q's dtype, softmax in
    float32, probabilities back in q's dtype (the reference's ``_sdpa``)."""
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    group = h // kv
    qg = q.reshape(b, sq, kv, group, hd)
    k, v = k.to(q.dtype), v.to(q.dtype)     # a bf16 cache under f32 params
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float()
    scores = scores / math.sqrt(hd)
    s_pos = torch.arange(skv, device=q.device)
    keep = (s_pos[None, :] < kv_len[:, None])[:, None, None, None, :]
    scores = scores.masked_fill(~keep, NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(b, sq, h, v.shape[-1])


def ssm_decode_ref(state, x, dt, A, Bm, Cm):
    """One Mamba2 recurrence step.  state (B,H,P,N) float32, updated in
    place; x (B,H,P); dt (B,H) float32 (softplus'd); A (H,) float32; Bm/Cm
    (B,N).  Returns y = C . state (B,H,P) in x's dtype."""
    dA = torch.exp(dt * A)
    dBx = torch.einsum("bh,bn,bhp->bhpn", dt, Bm.float(), x.float())
    state.copy_(state * dA[:, :, None, None] + dBx)
    y = torch.einsum("bn,bhpn->bhp", Cm.float(), state)
    return y.to(x.dtype)
