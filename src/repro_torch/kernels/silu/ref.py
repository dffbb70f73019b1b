"""Plain PyTorch version of the SiLU kernel (``csrc/silu.cu``).

The reference's ``jax.nn.silu`` is x * (1 / (1 + exp(-x))), and XLA on the
CPU rounds every op to x's dtype (it computes each bf16 op in float32 and
rounds its result; on the TPU it fuses them and may keep float32 between
them, so these are the CPU reference's bits, not the TPU's); ``F.silu``
rounds once, and in bf16 the two part by an ulp on a third of the
elements.  Each torch op on a bf16 tensor rounds its result, so this
expression gives the CPU reference's bits.
"""

from __future__ import annotations


def silu_ref(x):
    return x * (1.0 / (1.0 + (-x).exp()))
