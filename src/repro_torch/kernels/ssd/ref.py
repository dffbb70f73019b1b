"""Plain PyTorch versions of the Mamba2 SSD scan (arXiv:2405.21060).

``ssd_ref`` is the sequential recurrence, the oracle; ``ssd_chunked`` is
the chunked form the SSD kernel computes (``csrc/ssd.cu``), op for op the
reference model's ``ssd_chunked``.  The wrapper in ``ops.py`` calls
``ssd_chunked`` for tensors on the CPU.  ``ssd_bwd_ref`` is the backward of
``ssd_chunked`` for y, written out chunk by chunk as the backward kernel
(``csrc/ssd_bwd.cu``) computes it.

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


def ssd_bwd_ref(xh, dt, A, Bm, Cm, dy, chunk: int):
    """The gradients ``(dxh, ddt, dA, dBm, dCm)`` of ``ssd_chunked``'s y
    against ``dy`` (B,S,H,P), from a zero state (the final state takes no
    gradient: training never reads it).  dxh, dBm and dCm come back in
    their inputs' dtypes, ddt (B,S,H) and dA (H,) in float32; everything
    between is float32.

    Per chunk of Q tokens, with a = dt A, cs its cumsum in the chunk, l_ij
    = exp(cs_i - cs_j) for j <= i, w_j = exp(cs_last - cs_j) dt_j, S_c the
    state before chunk c and G the gradient of the state after it:

    * the chunk states S_c, recomputed by the forward recurrence, and G by
      the reverse one: G = 0 after the last chunk, and the gradient before
      chunk c is exp(cs_last) G + sum_i exp(cs_i) dy_i C_i^T;
    * the intra-chunk term as an attention backward with a decay mask: W_ij
      = (C_i . B_j) l_ij dt_j and E_ij = l_ij dt_j (dy_i . x_j), then dx_j =
      sum_i W_ij dy_i, dB_j = sum_i E_ij C_i, dC_i = sum_j E_ij B_j (B and
      C summed over the heads);
    * the state terms: dx_j += w_j G B_j, dB_j += w_j x_j^T G, dC_i +=
      exp(cs_i) dy_i^T S_c;
    * ddt and dA through the cumsum: the gradient of cs_k is T's row sum
      at k less its column sum at k (T_ij = W_ij (dy_i . x_j)), plus R_k =
      exp(cs_k) dy_k^T S_c C_k, less V_k = w_k x_k^T G B_k, and at the last
      token sum_j V_j + exp(cs_last) <G, S_c>; the gradient of a_t is the
      sum of those from t to the chunk's end, ddt_t = the direct terms +
      A da_t, and dA = sum over (b, t) of dt_t da_t.

    A ragged S is zero-padded as in the forward (dt = 0 there)."""
    b, s, h, p = xh.shape
    n = Bm.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    f32 = torch.float32
    if pad:
        xh, dy = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xh, dy))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm, Cm = (F.pad(t, (0, 0, 0, pad)) for t in (Bm, Cm))
    nc = (s + pad) // q
    x = xh.reshape(b, nc, q, h, p).to(f32)
    g = dy.reshape(b, nc, q, h, p).to(f32)
    dtc = dt.reshape(b, nc, q, h).to(f32)
    Bc = Bm.reshape(b, nc, q, n).to(f32)
    Cc = Cm.reshape(b, nc, q, n).to(f32)
    A = A.to(f32)

    cs = torch.cumsum(dtc * A, dim=2)                    # (b,nc,q,h)
    ec = torch.exp(cs)
    decay = ec[:, :, -1]                                 # (b,nc,h)
    w = torch.exp(cs[:, :, -1:] - cs) * dtc

    # the chunk-start states S_c and the gradients G of the chunk-end ones
    U = torch.einsum("bcjhp,bcjn->bchpn", x * w[..., None], Bc)
    V = torch.einsum("bcihp,bcin->bchpn", g * ec[..., None], Cc)
    zero = torch.zeros((b, h, p, n), dtype=f32, device=xh.device)
    S, G = [zero], [zero]
    for c in range(nc - 1):
        S.append(S[-1] * decay[:, c, :, None, None] + U[:, c])
    for c in range(nc - 1, 0, -1):
        G.append(G[-1] * decay[:, c, :, None, None] + V[:, c])
    S = torch.stack(S, dim=1)                            # before chunk c
    G = torch.stack(G[::-1], dim=1)                      # after chunk c

    # the intra-chunk term
    csh = cs.permute(0, 1, 3, 2)                         # (b,nc,h,q)
    dth = dtc.permute(0, 1, 3, 2)
    tri = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    l = torch.exp((csh[..., :, None] - csh[..., None, :])
                  .masked_fill(~tri, float("-inf")))     # (b,nc,h,i,j)
    cbl = torch.einsum("bcin,bcjn->bcij", Cc, Bc)[:, :, None] * l
    qm = torch.einsum("bcihp,bcjhp->bchij", g, x)
    W = cbl * dth[..., None, :]
    E = l * dth[..., None, :] * qm
    T = W * qm

    BG = torch.einsum("bcjn,bchpn->bcjhp", Bc, G)        # G B_j
    dx = torch.einsum("bchij,bcihp->bcjhp", W, g) + w[..., None] * BG
    dB = torch.einsum("bchij,bcin->bcjn", E, Cc) \
        + torch.einsum("bcjhp,bchpn->bcjn", x * w[..., None], G)
    dC = torch.einsum("bchij,bcjn->bcin", E, Bc) \
        + torch.einsum("bcihp,bchpn->bcin", g * ec[..., None], S)

    # dt and A through the cumsum
    xGB = (x * BG).sum(-1)                               # x_j^T G B_j
    Vj = w * xGB
    R = ec * (g * torch.einsum("bcin,bchpn->bcihp", Cc, S)).sum(-1)
    dcs = (T.sum(-1) - T.sum(-2)).permute(0, 1, 3, 2) + R - Vj
    dcs[:, :, -1] += Vj.sum(2) + decay * (G * S).sum((-1, -2))
    da = torch.flip(torch.cumsum(torch.flip(dcs, [2]), dim=2), [2])
    ddt = (cbl * qm).sum(-2).permute(0, 1, 3, 2) \
        + torch.exp(cs[:, :, -1:] - cs) * xGB + A * da
    dA = (dtc * da).sum((0, 1, 2))

    def out(t, shape, dtype):
        return t.reshape(b, s + pad, *shape)[:, :s].to(dtype)
    return (out(dx, (h, p), xh.dtype), out(ddt, (h,), f32), dA,
            out(dB, (n,), Bm.dtype), out(dC, (n,), Cm.dtype))
