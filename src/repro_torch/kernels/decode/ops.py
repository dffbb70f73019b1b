"""Wrappers of the row-invariant decode kernels (``csrc/decode.cu``) and of
the RMSNorm with its fused prologues (``csrc/norm.cu``).

For tensors on the CPU each wrapper computes its plain version
(``ref.py``, the model's code as it was); for CUDA tensors it launches the
kernel or raises: there is no fallback.  Each wrapper counts its kernel
launches in ``.launches``.

On the card every output of a row is summed in a fixed order that depends
on neither the number of rows nor the length the cache was padded to, so
a request decoded in a batch gets the bits it gets alone.

Both kernels that carry most of a decode step's bytes split their work
across blocks, and the way they split it never looks at M or the bucket:

* ``rows_matmul`` over a (K, N) weight runs the grid :func:`rows_plan`
  picks from K, N, the type and the card's SM count: a column tile of 64,
  128 or 256 columns and K-slices of a multiple of 16 rows, so that the
  blocks keep every SM busy in one wave however narrow N is.  Several
  slices leave float32 partials in a workspace this wrapper allocates; the
  tile's last block to finish, elected by a ticket on a per-device int32
  counter that the kernel leaves at zero (:func:`_counters`, allocated
  once and grown), sums them in slice order.
* ``decode_attention`` gives each (row, kv head) a cluster of C blocks
  (:func:`attention_cluster`); block r takes the runs r, r + C, ... of
  ``SPLIT`` keys from key 0 below the row's length, and the cluster merges
  its blocks in order through their shared memory.  The grid does not
  depend on the bucket.

Both kernels are bound by bytes (the weight, the cache): the plan spreads
the weight over the SMs, and the kernel keeps three 16 KB stages of it in
flight a block; attention's blocks are short, on the tensor cores in bf16.

``rms_norm_rows`` takes any number of rows (a decode step's, a prefill's):
its plan (:func:`norm_plan`) comes from D and the type alone.  Its fused
forms save a launch and an intermediate tensor each:
``residual_rms_norm_rows`` adds the residual first (the dense block's
``h + attention`` before ``ln2``), ``gated_rms_norm_rows`` computes the
mamba block's skip and SiLU gate first.

Gradients: ``rms_norm_rows`` and ``residual_rms_norm_rows`` have them
(:class:`RmsNormFn`, :class:`ResidualRmsNormFn`: the kernel forward, the
norm recomputed and differentiated in float32 plain PyTorch from the saved
inputs; no backward kernel yet).  ``gated_rms_norm_rows`` goes through
:class:`GatedRmsNormFn`, whose backward is the kernel
``gated_rms_norm_bwd`` (``csrc/norm.cu``; on the CPU
``ref.gated_rms_norm_bwd_ref``).  Every other wrapper here and in the
other kernel packages without a backward raises on the card when grad mode
is on and an input requires grad (:func:`no_backward`), rather than return
a tensor without a ``grad_fn``.
"""

from __future__ import annotations

import functools
import math

import torch

from .. import _build
from . import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP = 16                 # q heads a kv head in decode_attention
MAX_HEAD_DIM = 128
MAX_STATE = 128                # ssm_decode_step's N
SPLIT = 64                     # keys a decode_attention run
TILES = (64, 128, 256)         # rows_matmul's column tiles
SLICE = 16                     # rows_matmul's K-slices are multiples of it
RESIDENT = 2                   # rows_matmul blocks an SM holds at once
FILL = 0.9                     # the share of the SMs a plan keeps busy
BLOCK_BYTES = 32768            # the least weight a block streams: 2 stages
NORM_UNITS = 2                 # 16-byte units a norm thread aims at
NORM_MAX_THREADS = 512         # threads a row
NORM_MAX_UNITS = 8             # units a thread at most
NORM_BLOCK = 256               # threads a norm block holds at least


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_card(name, *ts):
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got {dev}")
    if any(t.device != dev for t in ts):
        raise ValueError(f"{name}: inputs on different devices")


def wants_grad(*ts) -> bool:
    """Whether a call on ``ts`` is recorded by autograd: grad mode on and
    an input that requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def no_backward(name, *ts):
    """Raise when grad mode is on and one of ``ts`` requires grad: the
    kernel ``name`` has no backward yet, and its output would carry no
    ``grad_fn``, silently cutting the gradient behind it.  Every CUDA path
    of a kernel without a backward calls it (serving's tensors never
    require grad)."""
    if wants_grad(*ts):
        raise NotImplementedError(
            f"{name}: the kernel has no backward yet, and an input "
            "requires grad; run it under torch.no_grad() or on tensors "
            "that do not require grad")


def _dtype(name, *ts):
    dt = ts[0].dtype
    if dt not in _DTYPES or any(t.dtype != dt for t in ts):
        raise TypeError(f"{name}: dtypes {[t.dtype for t in ts]}; need one "
                        f"of {list(_DTYPES)} for all")
    return _DTYPES[dt]


def _aligned(t, elems):
    """Every row of ``t`` (2-d, dense last dim) on a 16-byte boundary."""
    return t.data_ptr() % 16 == 0 and t.stride(0) % elems == 0


@functools.lru_cache(maxsize=None)
def rows_plan(k: int, n: int, itemsize: int, sms: int) -> tuple[int, int]:
    """The grid of ``rows_matmul`` over a (K, N) weight: ``(tn, ks)``, a
    column tile of ``tn`` columns (one of ``TILES``) and K-slices of ``ks``
    rows (a multiple of ``SLICE``; the last slice may be shorter), one
    block a (tile, slice).

    The kernel streams a block's slice at a rate of its own, so the plan
    wants every SM busy in one wave: ``ceil(n / tn) * ceil(k / ks)`` blocks
    from ``FILL * sms`` to ``RESIDENT * sms`` (all resident at once), with
    the fewest slices (each adds a partial sum to merge), then the
    narrowest tile.  A weight too wide for one wave takes one slice and
    the tile whose last wave is fullest; one too small to give that many
    blocks ``BLOCK_BYTES`` each takes the most blocks that it can.  There
    is no M: a row's sums follow from the plan alone."""
    best = None
    wave = RESIDENT * sms
    fill = min(FILL * sms, k * n * itemsize / BLOCK_BYTES)
    for tn in TILES:
        tiles = -(-n // tn)
        seen = set()
        for want in range(1, -(-k // SLICE) + 1):
            ks = -(-(-(-k // want)) // SLICE) * SLICE
            splits = -(-k // ks)
            if splits in seen:
                continue
            seen.add(splits)
            blocks = tiles * splits
            if blocks > wave:
                waves = -(-blocks // wave)
                key = (2, splits, 1 - blocks / (waves * wave), tn)
            elif blocks >= fill:
                key = (0, splits, tn)
            else:
                key = (1, -blocks, splits, tn)
            if best is None or key < best[0]:
                best = (key, tn, ks)
            if blocks > wave:
                break
    return best[1], best[2]


def weight_copy(addr: int, row_bytes: int, n_bytes: int) -> int:
    """How ``rows_matmul`` copies a (K, N) weight's stages, from its
    address, the bytes from one row to the next and the bytes of N: 16
    (16-byte copies: every row on the 16-byte grid and N whole 16-byte
    vectors), 8 or 4 (every row's start divisible by it and N by 4: a warp
    copies a row in units of the widest size, 16, 8 or 4 bytes, that the
    row's own address allows), or 0 (element by element: an odd N in bf16,
    or rows off the 4-byte grid)."""
    if addr % 16 == 0 and row_bytes % 16 == 0 and n_bytes % 16 == 0:
        return 16
    if n_bytes % 4:
        return 0
    for width in (8, 4):
        if addr % width == 0 and row_bytes % width == 0:
            return width
    return 0


def attention_cluster(kvh: int) -> int:
    """Blocks of ``decode_attention`` a (row, kv head): 8 for up to 8 kv
    heads, 4 for more (zamba2's 32), so that a batch of 4 rows still fits
    the card in about one wave (``sweep.py`` times each size).  A model
    constant, never the batch or the bucket: a row's sums follow from it
    and the row's length."""
    return 8 if kvh <= 8 else 4


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_COUNTERS: dict[int, torch.Tensor] = {}
_RETIRED: list[torch.Tensor] = []


def _counters(dev, n: int) -> torch.Tensor:
    """At least ``n`` int32 ticket counters on ``dev``, all zero between
    launches (``rows_matmul``'s K-slices and the flash backward's head
    chunks take their tickets here): allocated once per device and grown
    by doubling (a grown-out
    buffer is kept alive, since a captured CUDA graph may still point at
    it).  The kernels that use them run in stream order.  They never grow
    inside a CUDA graph capture, which would record the zeroing as a node
    that runs only at replay: a captured step runs once eagerly first."""
    buf = _COUNTERS.get(dev.index)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"{n} ticket counters needed inside a CUDA graph capture, "
                "more than were allocated: run the captured step once "
                "eagerly first")
        if buf is not None:
            _RETIRED.append(buf)
        size = max(n, 16384, 2 * buf.numel() if buf is not None else 0)
        buf = _COUNTERS[dev.index] = torch.zeros(size, dtype=torch.int32,
                                                 device=dev)
    return buf


def rows_matmul(x, w):
    """x (..., K) @ w -> (..., N) in x's dtype, float32 sums: the rows of x
    are its leading dims flattened.  ``w`` is (K, N) with its last dim
    dense, or the transposed view of a dense (N, K) matrix (a tied head's
    ``embed.T``), read in place either way."""
    if x.dim() < 1 or w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"rows_matmul: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} do not agree")
    if x.device.type == "cpu":
        return ref.rows_matmul_ref(x, w)
    _on_card("rows_matmul", x, w)
    no_backward("rows_matmul", x, w)
    code = _dtype("rows_matmul", x, w)
    lead, k, n = x.shape[:-1], x.shape[-1], w.shape[1]
    x = x.reshape(-1, k)
    m = x.shape[0]
    if x.stride(1) != 1 and k > 1:
        raise ValueError("rows_matmul: the last dim of x must be dense")
    if w.stride(1) != 1 and w.stride(0) != 1:
        raise ValueError(f"rows_matmul: w strides {w.stride()}: need a dense "
                         "(K, N) or the transpose of a dense (N, K)")
    if w.stride(1) != 1:
        e = 16 // x.element_size()
        if k % e or not _aligned(x, e) or not _aligned(w.t(), e):
            raise ValueError("rows_matmul: with a transposed w, K must be a "
                             f"multiple of {e} and every row of x and of "
                             "w.T must start on a 16-byte boundary")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    tn = ks = copy = 0
    part = ctr = None
    if w.stride(1) == 1:
        size = x.element_size()
        tn, ks = rows_plan(k, n, size, _sms(x.device.index))
        copy = weight_copy(w.data_ptr(), w.stride(0) * size, n * size)
        splits = -(-k // ks)
        if splits > 1:
            part = torch.empty((splits, m, n), dtype=torch.float32,
                               device=x.device)
            ctr = _counters(x.device, -(-n // tn) * -(-m // 16))
    lib = _build.load("decode")
    with torch.cuda.device(x.device):
        err = lib.rows_matmul_launch(
            x.data_ptr(), x.stride(0), w.data_ptr(), w.stride(0),
            w.stride(1), out.data_ptr(), n,
            None if part is None else part.data_ptr(),
            None if ctr is None else ctr.data_ptr(), m, k, n, tn, ks, copy,
            code, _stream(x))
    _build.check("decode", "rows_matmul_launch", err)
    rows_matmul.launches += 1
    return out.view(*lead, n)


@functools.lru_cache(maxsize=None)
def norm_plan(d: int, itemsize: int) -> tuple[int, int, int]:
    """The plan of ``rms_norm_rows`` and its fused forms for rows of ``d``
    elements of ``itemsize`` bytes: ``(threads a row, 16-byte units a
    thread at most, threads a block)``.  A row's units go to its threads
    round-robin, about ``NORM_UNITS`` each, held in registers; a block
    holds ``NORM_BLOCK`` threads or one row, whichever is more.  There is
    no M: a row's sum of squares follows from the plan, so a row gets the
    same bits alone, in a decode batch or among a prefill's rows."""
    units = -(-d * itemsize // 16)
    tpr = 32
    while tpr < NORM_MAX_THREADS and tpr * NORM_UNITS < units:
        tpr *= 2
    upt = -(-units // tpr)
    if upt > NORM_MAX_UNITS:
        raise ValueError(f"rms_norm_rows: rows of {d} elements above the "
                         f"{NORM_MAX_THREADS * NORM_MAX_UNITS} 16-byte "
                         f"units a row")
    return tpr, upt, max(tpr, NORM_BLOCK)


def _norm(mode, x, a, z, dv, p, w, eps, hout):
    """Launch the norm kernel in ``mode`` over the rows of x (M, D)."""
    m, d = x.shape
    tpr, upt, threads = norm_plan(d, x.element_size())
    out = torch.empty((m, d), dtype=x.dtype, device=x.device)
    lib = _build.load("norm")
    with torch.cuda.device(x.device):
        err = lib.rms_norm_rows_launch(
            mode, x.data_ptr(), x.stride(0),
            None if a is None else a.data_ptr(),
            0 if a is None else a.stride(0),
            None if z is None else z.data_ptr(),
            0 if z is None else z.stride(0),
            None if dv is None else dv.data_ptr(), p, w.data_ptr(),
            out.data_ptr(), None if hout is None else hout.data_ptr(), m, d,
            tpr, upt, threads, float(eps), _DTYPES[x.dtype], _stream(x))
    _build.check("norm", "rms_norm_rows_launch", err)
    return out


def _rows(name, t, d):
    """t (..., d) as (M, d) rows at one stride, its last dim dense."""
    try:
        r = t.view(-1, d)
    except RuntimeError as e:
        raise ValueError(f"{name}: strides {tuple(t.stride())} do not "
                         f"flatten to rows") from e
    if r.stride(1) != 1 and d > 1:
        raise ValueError(f"{name}: the last dim must be dense")
    return r


def _norm_weight(name, x, w):
    if x.dim() < 1 or w.dim() != 1 or w.shape[0] != x.shape[-1]:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} do not agree")


def _norm_grads(x, w, eps, g, need):
    """(dx, dw) of ``ref.rms_norm_ref(x, w, eps)`` against the output's
    gradient ``g``: the norm recomputed in float32 in plain PyTorch from
    the saved inputs, and differentiated (None where ``need`` says no)."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(need[0])
        w = w.detach().requires_grad_(need[1])
        out = ref.rms_norm_ref(x, w, eps)
        wrt = [t for t, n in zip((x, w), need) if n]
        got = iter(torch.autograd.grad(out, wrt, g) if wrt else ())
    return tuple(next(got) if n else None for n in need)


class RmsNormFn(torch.autograd.Function):
    """``rms_norm_rows`` with its gradient: the kernel forward (the plain
    version on the CPU), a plain float32 backward (no kernel yet)."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _rms_norm_rows(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return (*_norm_grads(x, w, ctx.eps, g, ctx.needs_input_grad[:2]),
                None)


class ResidualRmsNormFn(torch.autograd.Function):
    """``residual_rms_norm_rows`` with its gradient: the kernel forward,
    then from the saved sum ``h + delta`` a plain float32 backward; the sum
    passes its gradient to both h and delta."""

    @staticmethod
    def forward(ctx, h, delta, w, eps):
        hout, out = _residual_rms_norm_rows(h, delta, w, eps)
        ctx.save_for_backward(hout, w)
        ctx.eps = eps
        return hout, out

    @staticmethod
    def backward(ctx, g_h, g_out):
        hout, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dw = _norm_grads(hout, w, ctx.eps, g_out,
                             (need[0] or need[1], need[2]))
        dsum = None if dx is None else g_h + dx
        return (dsum if need[0] else None, dsum if need[1] else None, dw,
                None)


def rms_norm_rows(x, w, eps: float):
    """RMSNorm of each row of x (..., D) with weight w (D,), in float32,
    cast back to x's dtype; any number of rows.  Under grad it goes through
    :class:`RmsNormFn`."""
    _norm_weight("rms_norm_rows", x, w)
    if wants_grad(x, w):
        return RmsNormFn.apply(x, w, eps)
    return _rms_norm_rows(x, w, eps)


def _rms_norm_rows(x, w, eps):
    if x.device.type == "cpu":
        return ref.rms_norm_ref(x, w, eps)
    _on_card("rms_norm_rows", x, w)
    _dtype("rms_norm_rows", x, w)
    d = x.shape[-1]
    out = _norm(0, _rows("rms_norm_rows", x, d), None, None,
                None, 0, _rows("rms_norm_rows", w, d), eps, None)
    rms_norm_rows.launches += 1
    return out.view(x.shape)


def residual_rms_norm_rows(h, delta, w, eps: float):
    """``h + delta`` and its RMSNorm in one launch: returns (h + delta, the
    norm of it), both of h's shape, as ``ref.residual_rms_norm_ref``.
    Under grad it goes through :class:`ResidualRmsNormFn`."""
    _norm_weight("residual_rms_norm_rows", h, w)
    if delta.shape != h.shape:
        raise ValueError(f"residual_rms_norm_rows: h {tuple(h.shape)} and "
                         f"delta {tuple(delta.shape)} differ")
    if wants_grad(h, delta, w):
        return ResidualRmsNormFn.apply(h, delta, w, eps)
    return _residual_rms_norm_rows(h, delta, w, eps)


def _residual_rms_norm_rows(h, delta, w, eps):
    if h.device.type == "cpu":
        return ref.residual_rms_norm_ref(h, delta, w, eps)
    name = "residual_rms_norm_rows"
    _on_card(name, h, delta, w)
    _dtype(name, h, delta, w)
    d = h.shape[-1]
    hr = _rows(name, h, d)
    hout = torch.empty(hr.shape, dtype=h.dtype, device=h.device)
    out = _norm(1, hr, _rows(name, delta, d), None, None, 0,
                _rows(name, w, d), eps, hout)
    residual_rms_norm_rows.launches += 1
    return hout.view(h.shape), out.view(h.shape)


def _gated_check(y, D, xh, z, w):
    name = "gated_rms_norm_rows"
    _norm_weight(name, z, w)
    if y.dim() != 4 or xh.shape != y.shape or D.shape != (y.shape[2],) \
            or tuple(z.shape) != (*y.shape[:2], y.shape[2] * y.shape[3]):
        raise ValueError(f"{name}: shapes y {tuple(y.shape)}, D "
                         f"{tuple(D.shape)}, xh {tuple(xh.shape)}, z "
                         f"{tuple(z.shape)} do not agree")


def _gated_card(name, y, D, xh, z, w):
    """Raise unless the gated norm's kernels take these tensors; return
    their rows (y, xh, z as (M, d))."""
    _on_card(name, y, D, xh, z, w)
    _dtype(name, y, xh, z, w)
    if D.dtype != torch.float32 or not D.is_contiguous():
        raise TypeError(f"{name}: D must be contiguous float32")
    d = z.shape[-1]
    return (_rows(name, y, d), _rows(name, xh, d), _rows(name, z, d),
            _rows(name, w, d))


def gated_rms_norm_rows(y, D, xh, z, w, eps: float):
    """The mamba block's tail in one launch: RMSNorm of (y + D xh) * silu(z)
    with the plain chain's roundings (``ref.gated_rms_norm_ref``).  y and xh
    (B, S, H, P), D (H,) float32, z (B, S, H*P); xh and z are read in place
    (slices of the conv output and of in_proj's).  Returns z's shape.
    Under grad it goes through :class:`GatedRmsNormFn`."""
    _gated_check(y, D, xh, z, w)
    if wants_grad(y, D, xh, z, w):
        if y.device.type == "cuda":
            _gated_card("gated_rms_norm_bwd", y, D, xh, z, w)
        return GatedRmsNormFn.apply(y, D, xh, z, w, eps)
    return _gated_rms_norm_rows(y, D, xh, z, w, eps)


def _gated_rms_norm_rows(y, D, xh, z, w, eps):
    if y.device.type == "cpu":
        return ref.gated_rms_norm_ref(y, D, xh, z, w, eps)
    name = "gated_rms_norm_rows"
    yr, xr, zr, wr = _gated_card(name, y, D, xh, z, w)
    out = _norm(2, yr, xr, zr, D, y.shape[3], wr, eps, None)
    gated_rms_norm_rows.launches += 1
    return out.view(z.shape)


GATED_BWD_ROWS = 16     # rows a block of the backward's pass owns


def gated_rms_norm_bwd(y, D, xh, z, w, eps, g):
    """The gradients ``(dy, dD, dxh, dz, dw)`` of ``gated_rms_norm_rows``
    against ``g`` (z's shape): dD (H,) float32, the others contiguous in
    their inputs' dtypes and shapes.  On the CPU the plain version
    (``ref.gated_rms_norm_bwd_ref``); on the card the kernel (two
    launches: one pass over the rows, a block a slice of
    ``GATED_BWD_ROWS`` rows, writing dy, dxh and dz and each slice's column
    partials of dw and dD; their sums in order; one count); it takes every
    call the forward kernel takes."""
    _gated_check(y, D, xh, z, w)
    if g.shape != z.shape:
        raise ValueError(f"gated_rms_norm_bwd: g {tuple(g.shape)} is not "
                         f"z's {tuple(z.shape)}")
    if y.device.type == "cpu":
        return ref.gated_rms_norm_bwd_ref(y, D, xh, z, w, eps, g)
    name = "gated_rms_norm_bwd"
    yr, xr, zr, wr = _gated_card(name, y, D, xh, z, w)
    _on_card(name, y, g)
    _dtype(name, y, g)
    m, d = zr.shape
    tpr, upt, _ = norm_plan(d, y.element_size())
    gr = g.contiguous().view(m, d)
    dev, dt = y.device, y.dtype
    slices = -(-m // GATED_BWD_ROWS)
    dy = torch.empty(y.shape, dtype=dt, device=dev)
    dxh = torch.empty(y.shape, dtype=dt, device=dev)
    dz = torch.empty(z.shape, dtype=dt, device=dev)
    dw = torch.empty((d,), dtype=dt, device=dev)
    dD = torch.empty((y.shape[2],), dtype=torch.float32, device=dev)
    part = torch.empty((slices, 2, d), dtype=torch.float32, device=dev)
    lib = _build.load("norm")
    with torch.cuda.device(dev):
        err = lib.gated_rms_norm_bwd_launch(
            yr.data_ptr(), yr.stride(0), xr.data_ptr(), xr.stride(0),
            zr.data_ptr(), zr.stride(0), D.data_ptr(), y.shape[3],
            wr.data_ptr(), gr.data_ptr(), dy.data_ptr(), dxh.data_ptr(),
            dz.data_ptr(), part.data_ptr(), dw.data_ptr(), dD.data_ptr(), m,
            d, tpr, upt, GATED_BWD_ROWS, float(eps), _DTYPES[dt],
            _stream(y))
    _build.check("norm", "gated_rms_norm_bwd_launch", err)
    gated_rms_norm_bwd.launches += 1
    return dy, dD, dxh, dz, dw


class GatedRmsNormFn(torch.autograd.Function):
    """``gated_rms_norm_rows`` with its gradient: the kernel forward (the
    plain version on the CPU), saving its inputs; the backward
    ``gated_rms_norm_bwd``."""

    @staticmethod
    def forward(ctx, y, D, xh, z, w, eps):
        ctx.save_for_backward(y, D, xh, z, w)
        ctx.eps = eps
        return _gated_rms_norm_rows(y, D, xh, z, w, eps)

    @staticmethod
    def backward(ctx, g):
        y, D, xh, z, w = ctx.saved_tensors
        return (*gated_rms_norm_bwd(y, D, xh, z, w, ctx.eps, g), None)


def decode_attention(q, k, v, kv_len):
    """q (B,1,H,hd) against k/v (B,S,KV,hd): each row attends to its keys
    ``[0, kv_len[b])`` (int32 (B,), on the device; lengths past S read S
    keys).  Returns (B,1,H,hd) in q's dtype.  k/v may be a bucket of the
    cache or the whole of it: the kernel reads the same keys either way."""
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or tuple(kv_len.shape) != (q.shape[0],):
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, kv_len "
                         f"{tuple(kv_len.shape)} do not agree")
    b, _, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    if h % kvh:
        raise ValueError(f"decode_attention: {h} q heads not a multiple of "
                         f"{kvh} kv heads")
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, kv_len)
    _on_card("decode_attention", q, k, v, kv_len)
    no_backward("decode_attention", q, k, v)
    pair = (q.dtype, k.dtype)
    if pair not in ((torch.bfloat16, torch.bfloat16),
                    (torch.float32, torch.bfloat16),
                    (torch.float32, torch.float32)) or v.dtype != k.dtype:
        raise TypeError(f"decode_attention: q {q.dtype} with k/v {k.dtype}, "
                        f"{v.dtype} not taken")
    if kv_len.dtype != torch.int32:
        raise TypeError(f"decode_attention: kv_len must be int32, got "
                        f"{kv_len.dtype}")
    if h // kvh > MAX_GROUP or hd > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: group {h // kvh} and head dim "
                         f"{hd} must be at most {MAX_GROUP} and "
                         f"{MAX_HEAD_DIM}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("decode_attention: the last dim of q, k and v must "
                         "be dense")
    e = 16 // k.element_size()
    if hd % e or any(t.data_ptr() % 16 or any(st % e for st in t.stride()[:3])
                     for t in (k, v)):
        raise ValueError("decode_attention: every row of k and v must start "
                         "on a 16-byte boundary and hold a whole number of "
                         "16-byte units")
    kv_len = kv_len.contiguous()
    out = torch.empty((b, 1, h, hd), dtype=q.dtype, device=q.device)
    lib = _build.load("decode")
    with torch.cuda.device(q.device):
        err = lib.decode_attention_launch(
            q.data_ptr(), q.stride(0), q.stride(2), k.data_ptr(),
            v.data_ptr(), k.stride(0), k.stride(1), k.stride(2), v.stride(0),
            v.stride(1), v.stride(2), kv_len.data_ptr(), out.data_ptr(), b,
            s, h, kvh, hd, attention_cluster(kvh), 1.0 / math.sqrt(hd),
            _DTYPES[q.dtype], _DTYPES[k.dtype], _stream(q))
    _build.check("decode", "decode_attention_launch", err)
    decode_attention.launches += 1
    return out


def ssm_decode_step(state, x, dt, A, Bm, Cm):
    """One Mamba2 recurrence step: state (B,H,P,N) float32, updated in
    place; x (B,H,P); dt (B,H) float32, softplus'd; A (H,) float32; Bm/Cm
    (B,N) in x's dtype.  Returns y = C . state (B,H,P) in x's dtype."""
    if state.dim() != 4 or x.dim() != 3 or dt.dim() != 2 or A.dim() != 1 \
            or Bm.dim() != 2 or Cm.dim() != 2:
        raise ValueError("ssm_decode_step: need state (B,H,P,N), x (B,H,P), "
                         "dt (B,H), A (H,), Bm/Cm (B,N)")
    b, h, p, n = state.shape
    if tuple(x.shape) != (b, h, p) or tuple(dt.shape) != (b, h) \
            or tuple(A.shape) != (h,) or tuple(Bm.shape) != (b, n) \
            or tuple(Cm.shape) != (b, n):
        raise ValueError(
            f"ssm_decode_step: shapes state {tuple(state.shape)}, x "
            f"{tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
            f"Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)} do not agree")
    if x.device.type == "cpu":
        return ref.ssm_decode_ref(state, x, dt, A, Bm, Cm)
    _on_card("ssm_decode_step", state, x, dt, A, Bm, Cm)
    no_backward("ssm_decode_step", state, x, dt, A, Bm, Cm)
    code = _dtype("ssm_decode_step", x, Bm, Cm)
    if any(t.dtype != torch.float32 for t in (state, dt, A)):
        raise TypeError("ssm_decode_step: state, dt and A must be float32")
    if not state.is_contiguous() or x.stride(2) != 1 or dt.stride(1) != 1 \
            or A.stride(0) != 1 or Bm.stride(1) != 1 or Cm.stride(1) != 1:
        raise ValueError("ssm_decode_step: state must be contiguous, and the "
                         "last dim of x, dt, A, Bm and Cm dense")
    if n > MAX_STATE:
        raise ValueError(f"ssm_decode_step: state size {n} above "
                         f"{MAX_STATE}")
    y = torch.empty((b, h, p), dtype=x.dtype, device=x.device)
    lib = _build.load("decode")
    with torch.cuda.device(x.device):
        err = lib.ssm_decode_launch(
            state.data_ptr(), x.data_ptr(), x.stride(0), x.stride(1),
            dt.data_ptr(), dt.stride(0), A.data_ptr(), Bm.data_ptr(),
            Bm.stride(0), Cm.data_ptr(), Cm.stride(0), y.data_ptr(), b, h, p,
            n, code, _stream(x))
    _build.check("decode", "ssm_decode_launch", err)
    ssm_decode_step.launches += 1
    return y


rows_matmul.launches = 0
rms_norm_rows.launches = 0
residual_rms_norm_rows.launches = 0
gated_rms_norm_rows.launches = 0
gated_rms_norm_bwd.launches = 0
decode_attention.launches = 0
ssm_decode_step.launches = 0
