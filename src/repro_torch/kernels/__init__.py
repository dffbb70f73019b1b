"""Hand-written Hopper kernels of the port and their plain versions.

``csrc/`` holds the CUDA sources; ``_build`` compiles them at first use.
Each wrapper counts its launches; :func:`launch_counts` reads them all and
:func:`reset_launch_counts` zeroes them (and the wire's path counts,
``quantize.row_launches`` and ``dequantize.vec_launches``).
"""

from __future__ import annotations

from .attention.ops import flash_attention
from .decode.ops import (decode_attention, gated_rms_norm_rows,
                         residual_rms_norm_rows, rms_norm_rows, rows_matmul,
                         ssm_decode_step)
from .quantize.ops import dequantize, quantize
from .silu.ops import conv_silu, silu
from .ssd.ops import ssd_scan

WRAPPERS = {"flash_attention": flash_attention, "quantize": quantize,
            "dequantize": dequantize, "ssd": ssd_scan,
            "rows_matmul": rows_matmul, "rms_norm_rows": rms_norm_rows,
            "residual_rms_norm_rows": residual_rms_norm_rows,
            "gated_rms_norm_rows": gated_rms_norm_rows,
            "decode_attention": decode_attention,
            "ssm_decode_step": ssm_decode_step, "silu": silu,
            "conv_silu": conv_silu}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    WRAPPERS["quantize"].row_launches = 0
    WRAPPERS["dequantize"].vec_launches = 0
