"""Move param trees between the reference's numpy leaves and torch.

``params_from_jax`` takes the reference's param tree already converted to
numpy (``jax.tree.map(np.asarray, params)``) and returns the same nested
dict of torch tensors; ``params_to_jax`` is its inverse (numpy leaves).
bfloat16 crosses as a ``uint16`` view, so every leaf round-trips byte for
byte; ``torch.from_numpy`` rejects ``ml_dtypes.bfloat16`` itself.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_map


def _is_bf16(dtype) -> bool:
    return np.dtype(dtype).name == "bfloat16"


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:      # torch tensors may be written in place
        a = a.copy()
    if _is_bf16(a.dtype):
        t = torch.from_numpy(a.view(np.uint16).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(resolve_device(device))


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes   # only the numpy side needs a bfloat16 dtype
        return t.view(torch.int16).numpy().view(np.dtype(ml_dtypes.bfloat16))
    return t.numpy()


def params_from_jax(tree, device=None):
    """Nested dict of numpy arrays -> the same dict of torch tensors."""
    dev = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(a, dev), tree)


def params_to_jax(tree):
    """Nested dict of torch tensors -> the same dict of numpy arrays (bf16
    as ``ml_dtypes.bfloat16``, ready for ``jnp.asarray``)."""
    return tree_map(tensor_to_numpy, tree)
