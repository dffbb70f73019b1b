"""PyTorch/CUDA port of the SEIFER reproduction (the JAX package ``repro``
is the reference).  Imports torch and numpy, never jax or ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no explicit CPU request they raise instead of falling back.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
