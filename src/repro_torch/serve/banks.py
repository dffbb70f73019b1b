"""Slot-bank cache helpers shared by ``SlotScheduler`` and the pipeline
engine's per-stage banks, and the kill-spec normaliser both take.

A bank is a serving cache of ``slots`` rows.  Each leaf has one batch axis
(found from two caches built on the meta device), a request is admitted
by scattering its batch-1 cache into its slot.
"""

from __future__ import annotations

import numpy as np

from repro_torch._tree import tree_map


def kill_specs(kill) -> list:
    """``kill`` (None, one spec, or a list of specs) as a list."""
    return [] if kill is None else [kill] if isinstance(kill, dict) \
        else list(kill)


def leaf_batch_axes(shapes):
    """Per-leaf batch-axis index from a ``shapes(batch_size)`` callable
    returning a cache tree: the one axis where a batch-1 and a batch-2
    cache disagree."""
    return tree_map(
        lambda a, b: int(np.argmax(np.array(a.shape) != np.array(b.shape))),
        shapes(1), shapes(2))


def insert_slot(bank, one, slot, axes):
    """Scatter the batch-1 cache ``one`` into slot ``slot`` of ``bank``
    (``axes``: each leaf's batch axis), in place: each leaf's full extent
    at offset 0 on every axis except the batch axis (kv rows [0, S1), and
    per-slot state, conv buffers and length counters whole)."""
    def put(full, o, b_ax):
        src = o.select(b_ax, 0)
        full.select(b_ax, slot)[tuple(slice(0, n) for n in src.shape)] \
            .copy_(src)

    tree_map(put, bank, one, axes)
