"""Plain PyTorch versions of flash attention (GQA, optional causal)."""

from __future__ import annotations

import math

import torch

NEG = -1e30


def attention_ref(q, k, v, causal: bool = True):
    """q (B,S,H,hd); k/v (B,S,KV,hd); returns (B,S,H,hd).  The oracle: the
    reference package's ``attention_ref`` step for step."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, s, kv, g, hd)
    sc = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float()
    sc = sc / math.sqrt(hd)
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        sc = sc.masked_fill(~mask, NEG)
    p = torch.softmax(sc, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v)
    return out.reshape(b, s, h, hd)


def _keep(s, causal, valid_len, device):
    """(S, S) bool: query i reads key j."""
    pos = torch.arange(s, device=device)
    keep = (pos < valid_len)[None, :]
    if causal:
        keep = keep & (pos[None, :] <= pos[:, None])
    return keep


def flash_ref(q, k, v, causal: bool = True, valid_len: int | None = None,
              *, with_lse: bool = False):
    """The kernel's contract in plain PyTorch, on the model's layout: q
    (B,S,H,hd), k/v (B,S,KV,hd), any strides, q head h reading kv head
    h // (H // KV); keys at or past ``valid_len`` (default S) and, when
    causal, keys after the query are masked; scores and softmax in float32.
    With bfloat16 inputs P is rounded to bfloat16 before it multiplies v,
    as the kernel feeds P to the tensor cores in bfloat16; the product is
    accumulated in float32.  Returns a contiguous (B,S,H,hd) in q's
    dtype, and with ``with_lse`` also each row's natural-log sum of
    exp(scores) over its unmasked keys, float32 (B,H,S): what the kernel
    writes for the backward (``flash_bwd_ref``)."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    valid_len = s if valid_len is None else valid_len
    qg = q.float().reshape(b, s, kv, h // kv, hd)
    sc = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    sc = sc * (1.0 / math.sqrt(hd))
    sc = sc.masked_fill(~_keep(s, causal, valid_len, q.device), NEG)
    p = torch.softmax(sc, dim=-1)
    if q.dtype == torch.bfloat16:
        p = p.bfloat16().float()
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    out = out.reshape(b, s, h, hd).to(q.dtype)
    if not with_lse:
        return out
    return out, torch.logsumexp(sc, dim=-1).reshape(b, h, s)


def flash_bwd_ref(q, k, v, o, lse, do, causal: bool = True,
                  valid_len: int | None = None):
    """The backward kernel's contract in plain PyTorch: the gradients (dq,
    dk, dv) of ``flash_ref(q, k, v, causal, valid_len)`` given the output
    ``o``, its ``lse`` (B,H,S) and the output's gradient ``do`` (B,S,H,hd);
    keys at or past ``valid_len`` (default S) are masked as in the
    forward.  The arithmetic of the reference's flash-style VJP
    (``_blocked_bwd_rule``) in float32: P = exp(scale s - lse), delta =
    rowsum(do o), dS = P (dP - delta) scale; with bfloat16 inputs P is
    rounded to bfloat16 before it multiplies do (dv) and dS before it
    multiplies k (dq) and q (dk), as the kernel feeds them to the tensor
    cores; every product is accumulated in float32 and rounded once to the
    inputs' dtype.  dk and dv (B,S,KV,hd) sum over the q heads of each kv
    head."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(b, s, kv, g, hd)
    dof = do.float().reshape(b, s, kv, g, hd)
    kf, vf = k.float(), v.float()
    valid_len = s if valid_len is None else valid_len
    keep = _keep(s, causal, valid_len, q.device)
    sc = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * scale
    p = torch.exp(sc - lse.float().reshape(b, kv, g, s)[..., None])
    p = p.masked_fill(~keep, 0.0)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    delta = (dof * o.float().reshape(b, s, kv, g, hd)).sum(-1)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None]) * scale
    if q.dtype == torch.bfloat16:
        p, ds = p.bfloat16().float(), ds.bfloat16().float()
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf).reshape(b, s, h, hd)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
