"""Mamba2 blocks via SSD, state-space duality (arXiv:2405.21060).

Counterpart of ``repro/models/ssm.py``.  A block projects to (z, x, B, C,
dt), runs a depthwise causal convolution over (x, B, C), scans with the
SSD recurrence (B and C shared by all heads) and gates the output with z.

The scan from a zero state, which is the cacheless forward and the prefill
into a fresh cache, goes through the SSD kernel (``kernels.ssd.ops``);
decode at s == 1 is the O(1) recurrence, through the row-invariant
``ssm_decode_step`` kernel, with the block's projections and norms through
the other decode kernels (``layers.linear``, ``layers.rms_norm``).  Two
fused kernels take the element-wise chains around the scan, at any s: the
conv with its bias and SiLU, shifting the cache's conv_buf in place
(``conv_silu``), and the skip, the SiLU gate and the norm
(``gated_rms_norm_rows``).  Their SiLU rounds each of its four ops as the
reference's ``jax.nn.silu`` does under XLA on the CPU (torch's one
rounding put these blocks over 2 bf16 ulps off the reference).  Caches are
updated in place.

Training makes the same calls under grad: the wrappers route the
cacheless scan, conv pass and gated norm through their autograd Functions
(``SsdScanFn``, ``ConvSiluFn``, ``GatedRmsNormFn``), whose backwards are
the hand-written kernels ``ssd_scan_bwd``, ``conv_silu_bwd`` and
``gated_rms_norm_bwd`` on the card and their plain versions on the CPU.
The projections are library matmuls and the softplus of dt and the decay
``-exp(A_log)`` plain torch, differentiated by autograd; the float32
leaves ``A_log``, ``D`` and ``dt_bias`` get float32 gradients.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.decode.ops import (gated_rms_norm_rows,
                                            ssm_decode_step)
from repro_torch.kernels.silu.ops import conv_silu
from repro_torch.kernels.ssd.ops import ssd_scan

from .config import ModelConfig
from .layers import dtype_of, linear, ninit


def init_mamba_block(gen: torch.Generator, cfg: ModelConfig, n_layers: int):
    """``n_layers`` blocks stacked on a leading layer axis.  A_log, D and
    dt_bias stay float32 whatever the param dtype."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dt = dtype_of(cfg)
    dev = gen.device
    conv_ch = di + 2 * n
    f32 = torch.float32

    def full(shape, value, dtype):
        return torch.full((n_layers, *shape), value, dtype=dtype, device=dev)

    a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=f32, device=dev))
    return {
        "pre_norm": full((d,), 1.0, dt),
        "in_proj": ninit(gen, (n_layers, d, 2 * di + 2 * n + h), dt,
                         fan_in=d),
        "conv_w": ninit(gen, (n_layers, cfg.ssm_conv, conv_ch), dt,
                        scale=0.5),
        "conv_b": full((conv_ch,), 0.0, dt),
        "A_log": a_log.expand(n_layers, h).clone(),
        "D": full((h,), 1.0, f32),
        "dt_bias": full((h,), math.log(math.expm1(0.005)), f32),
        "norm_w": full((di,), 1.0, dt),
        "out_proj": ninit(gen, (n_layers, di, d), dt, fan_in=di),
    }


def _softplus(x):
    """The reference's ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def mamba_block(params, x, cfg: ModelConfig, cache=None):
    """Full Mamba2 block -> output (B, S, D).

    cache: None (a scan from a zero state), or dict(conv_buf (B, K-1, C),
    state (B, H, P, N) float32, len (B,)), updated in place: a prefill
    (s > 1) fills a fresh cache, a decode step (s == 1) advances it."""
    b, s, _ = x.shape
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    p = cfg.ssm_head_dim
    zxbcdt = linear(x, params["in_proj"])
    z = zxbcdt[..., :di]
    conv_in = zxbcdt[..., di:2 * di + 2 * n]          # x, B, C
    dt = zxbcdt[..., 2 * di + 2 * n:]

    conv = conv_silu(None if cache is None else cache["conv_buf"], conv_in,
                     params["conv_w"], params["conv_b"])

    xh = conv[..., :di].reshape(b, s, h, p)
    b2 = conv[..., di:di + n]
    c2 = conv[..., di + n:]
    dt = _softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])

    if cache is not None and s == 1:
        y = ssm_decode_step(cache["state"], xh[:, 0], dt[:, 0], A,
                            b2[:, 0], c2[:, 0])[:, None]      # (b,1,h,p)
    else:
        y, st = ssd_scan(xh, dt, A, b2, c2, cfg.ssm_chunk)
        if cache is not None:
            cache["state"].copy_(st)
    if cache is not None:
        cache["len"] += s

    y = gated_rms_norm_rows(y, params["D"], xh, z, params["norm_w"],
                            cfg.norm_eps)
    return linear(y, params["out_proj"])


def init_mamba_cache(cfg: ModelConfig, n_layers: int, batch: int, *,
                     device):
    """Stacked per-layer caches: conv_buf (L, B, K-1, C) in the activation
    dtype (the reference's bf16 buffer is promoted to it by the first
    prefill), state (L, B, H, P, N) float32, len (L, B)."""
    di, n = cfg.d_inner, cfg.ssm_state
    return {
        "conv_buf": torch.zeros((n_layers, batch, cfg.ssm_conv - 1,
                                 di + 2 * n), dtype=dtype_of(cfg),
                                device=device),
        "state": torch.zeros((n_layers, batch, cfg.ssm_heads,
                              cfg.ssm_head_dim, n), dtype=torch.float32,
                             device=device),
        "len": torch.zeros((n_layers, batch), dtype=torch.int32,
                           device=device),
    }
