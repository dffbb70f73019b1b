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


def flash_ref(q, k, v, causal: bool = True, valid_len: int | None = None):
    """The kernel's contract in plain PyTorch, on the model's layout: q
    (B,S,H,hd), k/v (B,S,KV,hd), any strides, q head h reading kv head
    h // (H // KV); keys at or past ``valid_len`` (default S) and, when
    causal, keys after the query are masked; scores and softmax in float32.
    With bfloat16 inputs P is rounded to bfloat16 before it multiplies v,
    as the kernel feeds P to the tensor cores in bfloat16; the product is
    accumulated in float32.  Returns a contiguous (B,S,H,hd) in q's
    dtype."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    valid_len = s if valid_len is None else valid_len
    qg = q.float().reshape(b, s, kv, h // kv, hd)
    sc = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    sc = sc * (1.0 / math.sqrt(hd))
    pos = torch.arange(s, device=q.device)
    keep = (pos < valid_len)[None, :]
    if causal:
        keep = keep & (pos[None, :] <= pos[:, None])
    p = torch.softmax(sc.masked_fill(~keep, NEG), dim=-1)
    if q.dtype == torch.bfloat16:
        p = p.bfloat16().float()
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)
