"""Plain PyTorch versions of the Mamba2 SSD scan (arXiv:2405.21060).

``ssd_ref`` is the sequential recurrence, the oracle; ``ssd_chunked`` is
the chunked form the SSD kernel computes (``csrc/ssd.cu``), op for op the
reference model's ``ssd_chunked``.  The wrapper in ``ops.py`` calls
``ssd_chunked`` for tensors on the CPU.

Shapes: xh (B, S, H, P) per-head input; dt (B, S, H) softplus'd timestep
(> 0); A (H,) negative decay rate; Bm/Cm (B, S, N) input and output
projections, shared by all heads.  Both start from a zero state and return
(y (B, S, H, P) in xh's dtype, final state (B, H, P, N) float32).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_ref(xh, dt, A, Bm, Cm):
    """The O(S) sequential recurrence, one token at a time."""
    b, s, h, p = xh.shape
    n = Bm.shape[-1]
    f32 = torch.float32
    st = torch.zeros((b, h, p, n), dtype=f32, device=xh.device)
    ys = []
    for t in range(s):
        dtt = dt[:, t].to(f32)
        dA = torch.exp(dtt * A)
        dBx = torch.einsum("bh,bn,bhp->bhpn", dtt, Bm[:, t].to(f32),
                           xh[:, t].to(f32))
        st = st * dA[:, :, None, None] + dBx
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t].to(f32), st))
    return torch.stack(ys, dim=1).to(xh.dtype), st


def _segsum(x):
    """x (..., q) -> L[..., i, j] = sum_{j < m <= i} x_m for i >= j, -inf
    above the diagonal."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int):
    """The chunked scan with chunks of ``min(chunk, S)`` tokens.  Ragged S
    is zero-padded: dt = 0 there, so a padded step decays by 1 and adds
    nothing to the state."""
    b, s, h, p = xh.shape
    n = Bm.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    s_orig, s = s, s + pad
    nc = s // q
    f32 = torch.float32

    xc = xh.reshape(b, nc, q, h, p).to(f32)
    dtc = dt.reshape(b, nc, q, h).to(f32)
    Bc = Bm.reshape(b, nc, q, n).to(f32)
    Cc = Cm.reshape(b, nc, q, n).to(f32)
    dA = dtc * A[None, None, None, :]                    # (b,nc,q,h)

    # intra-chunk term: (C B^T o L o dt_j) x
    L = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))       # (b,nc,h,q,q)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)     # (b,nc,q,q)
    M = scores[:, :, None] * L * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_diag = torch.einsum("bchij,bcjhp->bcihp", M, xc)

    # chunk-final states, then the recurrence across chunks
    cum = torch.cumsum(dA, dim=2)                        # (b,nc,q,h)
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)
    xw = xc * (decay_out * dtc)[..., None]
    chunk_states = torch.einsum("bcjn,bcjhp->bchpn", Bc, xw)
    chunk_decay = torch.exp(cum[:, :, -1, :])            # (b,nc,h)
    st = torch.zeros((b, h, p, n), dtype=f32, device=xh.device)
    prev = []
    for c in range(nc):
        prev.append(st)                                  # state *before* c
        st = st * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    prev_states = torch.stack(prev, dim=1)               # (b,nc,h,p,n)

    y_off = torch.einsum("bcin,bchpn->bcihp", Cc, prev_states) \
        * torch.exp(cum)[..., None]
    y = (y_diag + y_off).reshape(b, s, h, p)[:, :s_orig]
    return y.to(xh.dtype), st
