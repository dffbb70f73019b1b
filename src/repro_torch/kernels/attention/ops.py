"""Flash-attention wrapper: hands the kernel the model's own layout.

q (B, S, H, hd) and k/v (B, S, KV, hd) go to ``csrc/flash_attention.cu``
in place, through their batch, row and head strides; q head h reads kv
head h // (H // KV), so k/v are never repeated.  The kernel masks a ragged
S itself and writes a contiguous (B, S, H, hd) output, so nothing is
padded, transposed or copied on either side.  Each row of hd elements must
be dense and start on a 16-byte boundary; the wrapper raises otherwise.

For tensors on the CPU it computes the kernel's function in plain PyTorch
(``ref.flash_ref``); for CUDA tensors it launches the kernel or raises:
there is no fallback.  ``flash_attention.launches`` counts kernel launches
(``flash_attention_bwd.launches`` the backward's, and of them
``noncausal_launches`` the non-causal ones).

Gradients: when grad mode is on and q, k or v requires grad,
``flash_attention`` goes through :class:`FlashAttentionFn`, whose forward
asks the kernel for each row's log-sum-exp as well and whose backward is
``flash_attention_bwd`` (``csrc/flash_attention_bwd.cu``; on the CPU its
plain version ``ref.flash_bwd_ref``).  The backward kernel takes bf16 at
head dims ``BWD_HEAD_DIMS``, causal or not (the encoder's blocks), every
key valid; on the card anything else raises before the forward runs.  Head dim 112 (zamba2's) runs on the
128 tile (``bwd_tile``): the kernel's copies fill columns 112-127 with
zeros, which add nothing to any product, and its stores skip them.  Without grad the call takes the path
it always took, with the same launches and bits.
"""

from __future__ import annotations

import math

import torch

from .. import _build
from ..decode.ops import _counters, wants_grad
from .ref import flash_bwd_ref, flash_ref

HEAD_DIMS = (8, 16, 32, 64, 112, 128)
BWD_HEAD_DIMS = (64, 112, 128)
BWD_KEYS = 64              # keys a dk/dv tile, queries a dq tile
BWD_HEADS = 4              # q heads a dk/dv block at most
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _strides(name, *ts):
    """The (batch, row, head) strides of each of ``ts`` (B, S, heads, hd),
    checked: same device, each row of hd elements dense and on a 16-byte
    boundary."""
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"{name}: inputs on different devices")
    if any(t.stride(3) != 1 for t in ts):
        raise ValueError(f"{name}: the last dimension of every input must "
                         "be dense")
    # a dimension of size 1 is never stepped over: its stride is moot
    strides = [[t.stride(i) if t.shape[i] > 1 else 0 for i in range(3)]
               for t in ts]
    e = 16 // ts[0].element_size()
    if any(t.data_ptr() % 16 for t in ts) \
            or any(st % e for row in strides for st in row):
        raise ValueError(f"{name}: every row of every input must start on "
                         "a 16-byte boundary")
    return [st for row in strides for st in row]


def _launch(q, k, v, causal: bool, valid_len: int, with_lse: bool = False):
    b, s, h, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q/k/v dtypes {q.dtype}, "
                        f"{k.dtype}, {v.dtype}; need one of "
                        f"{list(_DTYPES)}")
    strides = _strides("flash_attention", q, k, v)
    o = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), b, s, h, k.shape[2], hd,
            *strides, int(causal), valid_len, 1.0 / math.sqrt(hd),
            _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention", "flash_attention_launch", err)
    flash_attention.launches += 1
    return (o, lse) if with_lse else o


def _bwd_scope(q, valid_len: int):
    """Raise unless the backward kernel takes this call (causal or not)."""
    missing = []
    if q.dtype != torch.bfloat16:
        missing.append(f"dtype {q.dtype} (bf16 only)")
    if q.shape[3] not in BWD_HEAD_DIMS:
        missing.append(f"head dim {q.shape[3]} (only {BWD_HEAD_DIMS})")
    if valid_len != q.shape[1]:
        missing.append(f"valid_len {valid_len} < S {q.shape[1]}")
    if missing:
        raise NotImplementedError(
            "flash_attention_bwd: the backward kernel has no path for "
            + ", ".join(missing))


def bwd_tile(hd: int) -> int:
    """The head dim of the tiles the backward kernel runs ``hd`` on: 112
    on the 128 tile, its last 16 columns zero."""
    if hd not in BWD_HEAD_DIMS:
        raise ValueError(f"bwd_tile: head dim {hd} not in {BWD_HEAD_DIMS}")
    return 128 if hd == 112 else hd


def bwd_plan(s: int, h: int, kv: int, hd: int,
             causal: bool = True) -> tuple[int, int, int, int]:
    """The dk/dv pass's grid: ``(bq, heads, chunks, units)``.  A block
    owns one of ``units`` units of ``BWD_KEYS``-key tiles and ``heads`` of
    a kv head's q heads, the largest divisor of the group up to
    ``BWD_HEADS``; the group's ``chunks`` of heads add their float32
    partials in chunk order.  Causal, a unit is a pair of key tiles (i and
    n - 1 - i, so every pair walks n + 1 query tiles a head); non-causal,
    every key tile walks every query tile, so a unit is one tile.  Query
    tiles are ``bq`` rows: 64 at hd 64, 32 on the 128 tile (hd 112 and
    128).  There is no batch size: every sum's order follows from S, the
    group, hd and the mask alone."""
    hd = bwd_tile(hd)
    group = h // kv
    heads = max(d for d in range(1, BWD_HEADS + 1) if group % d == 0)
    n = -(-s // BWD_KEYS)
    return (64 if hd == 64 else 32, heads, group // heads,
            -(-n // 2) if causal else n)


def bwd_blocks(b: int, s: int, h: int, kv: int, hd: int,
               causal: bool = True):
    """The dk/dv blocks in launch order, as the kernel derives them from
    its block index: ``(batch, kv head, key tiles, q heads)``, a block's
    key tiles in the order it walks them."""
    _, heads, chunks, units = bwd_plan(s, h, kv, hd, causal)
    n = -(-s // BWD_KEYS)
    group = h // kv
    out = []
    for bi in range(b):
        for kvh in range(kv):
            for p in range(units):
                tiles = (p,) if p == n - 1 - p or not causal \
                    else (p, n - 1 - p)
                for c in range(chunks):
                    h0 = kvh * group + c * heads
                    out.append((bi, kvh, tiles, tuple(range(h0, h0 + heads))))
    return out


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        valid_len: int | None = None):
    """The gradients (dq, dk, dv) of flash attention: q, o, do
    (B,S,H,hd), k/v (B,S,KV,hd) read in place through their strides, lse
    (B,H,S) float32 from the forward.  dq is (B,S,H,hd) and dk, dv
    (B,S,KV,hd), contiguous in q's dtype, dk and dv summed over each kv
    head's q heads; keys at or past ``valid_len`` (default S) masked as in
    the forward.  On the CPU the plain version (``ref.flash_bwd_ref``); on
    the card the kernel (two launches, dq with delta and then dk/dv; one
    count), or a raise: the kernel takes bf16 calls, causal or not, with
    every key valid at head dims ``BWD_HEAD_DIMS``."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or o.shape != q.shape or do.shape != q.shape \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3] \
            or tuple(lse.shape) != (q.shape[0], q.shape[2], q.shape[1]):
        raise ValueError(f"flash_attention_bwd: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, o "
                         f"{tuple(o.shape)}, lse {tuple(lse.shape)}, do "
                         f"{tuple(do.shape)} do not agree")
    b, s, h, hd = q.shape
    kv = k.shape[2]
    if h % kv:
        raise ValueError(f"flash_attention_bwd: {h} q heads not a multiple "
                         f"of {kv} kv heads")
    valid_len = s if valid_len is None else valid_len
    if not 1 <= valid_len <= s:
        raise ValueError(f"flash_attention_bwd: valid_len {valid_len} not "
                         f"in [1, {s}]")
    if q.device.type == "cpu":
        return flash_bwd_ref(q, k, v, o, lse, do, causal, valid_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    _bwd_scope(q, valid_len)
    if any(t.dtype != q.dtype for t in (k, v, o, do)):
        raise TypeError("flash_attention_bwd: q, k, v, o and do must share "
                        "one dtype")
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise TypeError("flash_attention_bwd: lse must be contiguous "
                        "float32")
    strides = _strides("flash_attention_bwd", q, k, v, o, do)
    if lse.device != q.device:
        raise ValueError("flash_attention_bwd: inputs on different devices")
    _, heads, chunks, units = bwd_plan(s, h, kv, hd, causal)
    s64 = -(-s // BWD_KEYS) * BWD_KEYS
    # (lse log2 e, delta) a row, written by the dq pass for the dk/dv pass
    stats = torch.empty((b, h, s64, 2), dtype=torch.float32, device=q.device)
    part = ctr = None
    if chunks > 1:
        tiles = b * kv * units * 2
        part = torch.empty((tiles, chunks, 2 * BWD_KEYS * bwd_tile(hd)),
                           dtype=torch.float32, device=q.device)
        ctr = _counters(q.device, tiles)
    dq = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, s, kv, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, s, kv, hd), dtype=q.dtype, device=q.device)
    lib = _build.load("flash_attention_bwd")
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), stats.data_ptr(),
            None if part is None else part.data_ptr(),
            None if ctr is None else ctr.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, s, h, kv, hd, *strides,
            1.0 / math.sqrt(hd), heads, int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention_bwd", "flash_attention_bwd_launch", err)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.noncausal_launches += not causal
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its gradient: the forward kernel with its
    log-sum-exp, saving (q, k, v, o, lse); the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, valid_len):
        if q.device.type == "cpu":
            o, lse = flash_ref(q, k, v, causal, valid_len, with_lse=True)
        else:
            o, lse = _launch(q, k, v, causal, valid_len, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.valid_len = causal, valid_len
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.causal, ctx.valid_len)
        return dq, dk, dv, None, None


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
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if wants_grad(q, k, v):
        if q.device.type == "cuda":
            _bwd_scope(q, valid_len)
        return FlashAttentionFn.apply(q, k, v, causal, valid_len)
    if q.device.type == "cpu":
        return flash_ref(q, k, v, causal, valid_len)
    return _launch(q, k, v, causal, valid_len)


flash_attention.launches = 0
flash_attention_bwd.launches = 0
flash_attention_bwd.noncausal_launches = 0
