"""AdamW with a configurable state dtype (bf16 states for the 400B+
configs) and global-norm gradient clipping: the reference's
``repro/optim/adamw.py`` on trees of tensors.

The math is float32, as the reference's, and params and states go back to
their storage dtypes.  The update is elementwise and runs as plain tensor
ops under ``torch.no_grad()`` (the reference leaves it to XLA: no Pallas
kernel), one leaf at a time, and a leaf of more than ``SLICE_ELEMS``
elements in runs of its leading dim (an index at a time where one index
holds more), so that no more than ``SLICE_ELEMS`` elements' float32
temporaries are alive at once (zamba2-7b's in_proj at 42 layers is 2.2 G
elements: four float32 temporaries of the whole leaf would be 35 GB).
The arithmetic of every element is the same either way.  It writes the
params and states in place (the port may update in place where
it saves memory: a second copy of granite-3-2b's float32 states alone
would be 20 GB) and returns the same trees.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch._tree import tree_leaves, tree_map


class OptState(NamedTuple):
    """``step`` an int32 scalar tensor; ``m`` and ``v`` trees shaped like
    the params.  A checkpoint flattens it in field order, as JAX flattens
    the reference's NamedTuple."""
    step: torch.Tensor
    m: Any
    v: Any


def adamw_init(params, state_dtype=torch.float32) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=state_dtype, device=p.device)
    dev = tree_leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares
    (a float32 scalar)."""
    total = None
    for x in tree_leaves(tree):
        part = torch.sum(torch.square(x.float()))
        total = part if total is None else total + part
    return torch.sqrt(total)


SLICE_ELEMS = 1 << 26      # a leaf above this is updated in runs of rows


def _slices(p, g, m, v):
    """The (p, g, m, v) pieces one update takes: the leaf whole, or, when
    it is large, runs of its leading dim (a stacked leaf's layers, an
    embedding's rows) of at most ``SLICE_ELEMS`` elements (at least one
    index); where one index of the leading dim is itself larger (the
    VLM's (groups, blocks, 8192, 28672) MLP leaves), each index is sliced
    the same way in turn."""
    if p.dim() < 1 or p.numel() <= SLICE_ELEMS:
        return ((p, g, m, v),)
    per = p.numel() // p.shape[0]
    if per > SLICE_ELEMS and p.dim() > 1:
        return (piece for i in range(p.shape[0])
                for piece in _slices(p[i], g[i], m[i], v[i]))
    run = max(1, SLICE_ELEMS // per)
    return zip(*(t.split(run) for t in (p, g, m, v)))


def _f32(t):
    """``t`` itself when float32 (to be updated in place), else a float32
    copy."""
    return t if t.dtype == torch.float32 else t.float()


@torch.no_grad()
def adamw_update(params, grads, opt: OptState, lr, *, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, clip_norm=1.0):
    """Returns (params, opt, metrics) as the reference's, ``params`` and
    ``opt``'s trees updated in place.  ``lr`` is a float32 scalar tensor
    (or a number)."""
    step = opt.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / (gnorm + 1e-9), max=1.0)
    sf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=sf.device), sf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=sf.device), sf)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=sf.device)
    for leaf in zip(tree_leaves(params), tree_leaves(grads),
                    tree_leaves(opt.m), tree_leaves(opt.v)):
        for p, g, m, v in _slices(*leaf):
            _update(p, g, m, v, scale, bc1, bc2, lr, b1, b2, eps,
                    weight_decay)
    return params, OptState(step, opt.m, opt.v), {"grad_norm": gnorm}


def _update(p, g, m, v, scale, bc1, bc2, lr, b1, b2, eps, weight_decay):
    """One piece of a leaf, in place: the reference's expressions, each
    rounding in the same place, as in-place steps on a float32 state or
    param itself, else on its float32 copy, cast back at the end."""
    g = g.float() * scale
    m32 = _f32(m).mul_(b1)
    m32 += (1 - b1) * g
    v32 = _f32(v).mul_(b2)
    v32 += (1 - b2) * g * g
    del g
    update = m32 / bc1
    den = torch.sqrt(v32 / bc2)
    den += eps
    update /= den
    del den
    step_ = p.float() * weight_decay
    step_ += update                 # update + weight_decay * p32
    del update
    step_ *= lr
    p32 = _f32(p)
    p32 -= step_
    del step_
    for t, t32 in ((p, p32), (m, m32), (v, v32)):
        if t32 is not t:
            t.copy_(t32)
