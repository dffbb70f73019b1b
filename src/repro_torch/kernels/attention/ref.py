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


def flash_fold_ref(qf, kf, vf, group: int, causal: bool, valid_len: int):
    """The kernel's contract in plain PyTorch: q (BH, S, hd), k/v
    (BH // group, S, hd) with q row b reading kv row b // group; keys at or
    past ``valid_len`` and (causal) after the query are masked; float32
    softmax and accumulation; output in q's dtype."""
    bh, s, hd = qf.shape
    kx = kf.float().repeat_interleave(group, dim=0)
    vx = vf.float().repeat_interleave(group, dim=0)
    sc = torch.einsum("bqh,bkh->bqk", qf.float(), kx) * (1.0 / math.sqrt(hd))
    pos = torch.arange(s, device=qf.device)
    keep = (pos < valid_len)[None, :]
    if causal:
        keep = keep & (pos[None, :] <= pos[:, None])
    sc = sc.masked_fill(~keep, NEG)
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bqk,bkh->bqh", p, vx).to(qf.dtype)
