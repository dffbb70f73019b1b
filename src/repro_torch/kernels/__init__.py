"""Hand-written Hopper kernels of the port and their plain versions.

``csrc/`` holds the CUDA sources; ``_build`` compiles them at first use.
Each wrapper counts its launches; :func:`launch_counts` reads them all and
:func:`reset_launch_counts` zeroes them (and the path counts: the
wire's ``quantize.row_launches`` and ``dequantize.vec_launches``, and the
flash backward's non-causal launches, ``flash_attention_bwd
.noncausal_launches``).  A CUDA graph's
capture launches nothing and its replays call no wrapper, so the code that
captures one takes what the capture recorded with :func:`recorded_launches`
(which leaves every count as it was) and adds it at each replay with
:func:`add_launches`.
"""

from __future__ import annotations

from .attention.ops import flash_attention, flash_attention_bwd
from .decode.ops import (decode_attention, gated_rms_norm_bwd,
                         gated_rms_norm_rows, residual_rms_norm_rows,
                         rms_norm_rows, rows_matmul, ssm_decode_step)
from .quantize.ops import dequantize, quantize
from .silu.ops import conv_silu, conv_silu_bwd, silu
from .ssd.ops import ssd_scan, ssd_scan_bwd

WRAPPERS = {"flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_bwd, "quantize": quantize,
            "dequantize": dequantize, "ssd": ssd_scan,
            "rows_matmul": rows_matmul, "rms_norm_rows": rms_norm_rows,
            "residual_rms_norm_rows": residual_rms_norm_rows,
            "gated_rms_norm_rows": gated_rms_norm_rows,
            "decode_attention": decode_attention,
            "ssm_decode_step": ssm_decode_step, "silu": silu,
            "conv_silu": conv_silu, "ssd_scan_bwd": ssd_scan_bwd,
            "conv_silu_bwd": conv_silu_bwd,
            "gated_rms_norm_bwd": gated_rms_norm_bwd}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


# every count: each wrapper's launches and the wire's path counts
_COUNTS = tuple((name, "launches") for name in WRAPPERS) + (
    ("quantize", "row_launches"), ("dequantize", "vec_launches"),
    ("flash_attention_bwd", "noncausal_launches"))


def _counts() -> dict:
    return {(n, a): getattr(WRAPPERS[n], a) for n, a in _COUNTS}


def reset_launch_counts() -> None:
    for n, a in _COUNTS:
        setattr(WRAPPERS[n], a, 0)


def add_launches(delta: dict) -> None:
    """Add ``delta`` (from :func:`recorded_launches`) to the counts."""
    for (n, a), v in delta.items():
        setattr(WRAPPERS[n], a, getattr(WRAPPERS[n], a) + v)


def recorded_launches(fn):
    """Run ``fn`` (a CUDA graph's capture) and return (its result, the
    counts it added), the counts left as they were before it."""
    before = _counts()
    try:
        out = fn()
    finally:
        after = _counts()
        reset_launch_counts()
        add_launches(before)
    return out, {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}
