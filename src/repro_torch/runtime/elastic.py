"""Elastic rescale planning: map a training job onto a changed device set.

A copy of ``repro/runtime/elastic.py`` (numpy and the standard library only).


On failure of one or more hosts, pick the largest (data, model) mesh that
(a) fits the surviving device count, (b) keeps the model axis unchanged if
possible (params reshard only along data/FSDP — cheap, since the checkpoint
is mesh-agnostic), and (c) keeps global batch divisible.  Combined with the
stateless data pipeline and the resharding checkpoint restore, a rescale is:
stop -> plan_rescale -> restore -> continue at the same step.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ElasticPlan:
    n_devices: int
    mesh_shape: tuple
    axis_names: tuple
    global_batch: int
    note: str = ""


def plan_rescale(n_alive: int, *, prefer_model: int, global_batch: int,
                 multi_pod: bool = False) -> ElasticPlan:
    """Largest usable mesh from ``n_alive`` devices.

    prefer_model: the current TP width (kept if divisible — changing TP
    width forces param-layout-aware resharding; changing only the data
    axis is a pure re-balance)."""
    model = prefer_model
    while model > 1 and n_alive % model:
        model //= 2
    data = n_alive // model
    # keep the global batch divisible by the data axis (drop ranks if needed)
    while data > 1 and global_batch % data:
        data -= 1
    used = data * model
    note = (f"using {used}/{n_alive} devices "
            f"(model={model} kept)" if model == prefer_model else
            f"using {used}/{n_alive} devices (model shrunk "
            f"{prefer_model}->{model}: full reshard)")
    if multi_pod and used % 2 == 0 and data % 2 == 0:
        return ElasticPlan(used, (2, data // 2, model),
                           ("pod", "data", "model"), global_batch, note)
    return ElasticPlan(used, (data, model), ("data", "model"),
                       global_batch, note)
