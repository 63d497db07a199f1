"""Elastic rescale: move a training run between fleet sizes (the port's
copy of ``repro.ft.elastic``).

The checkpoint is mesh-agnostic (host numpy); rescaling = rebuild the mesh
with the surviving device count, regenerate sharding specs, and place
every array with its new placements (``reshard_state``).  Data-pipeline
state is a step counter, so the stream continues exactly where it
stopped; the batch is re-split over the new data-parallel ways.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.common.config import ParallelConfig


@dataclass
class RescalePlan:
    old_devices: int
    new_devices: int
    new_dp: int
    new_tp: int
    reason: str = ""

    @property
    def shrink(self) -> bool:
        return self.new_devices < self.old_devices


def plan_rescale(old: ParallelConfig, available_devices: int,
                 min_tp: int = 1, reason: str = "") -> RescalePlan:
    """Choose a new (dp, tp) for the surviving device count.

    Keeps tp if it still divides the device count (weights keep their TP
    layout => cheapest reshard); otherwise falls back to the largest
    power-of-two tp <= old tp that fits, floored at ``min_tp`` (a model
    that does not fit on fewer than min_tp devices must not be sharded
    thinner, even if that leaves survivor devices idle).  Raises when no
    plan can satisfy the floor on the surviving devices."""
    old_devices = old.dp * old.tp * old.pods
    if available_devices < 1:
        raise ValueError("no surviving devices to rescale onto")
    if min_tp > available_devices:
        raise ValueError(
            f"min_tp={min_tp} exceeds the {available_devices} surviving "
            "device(s): the model cannot be placed — restore capacity "
            "instead of sharding below its memory floor")
    tp = old.tp
    while tp > min_tp and available_devices % tp:
        tp //= 2
    # halving from an odd tp (e.g. 6 -> 3 -> 1) can tunnel past the floor
    tp = max(tp, min_tp)
    dp = max(available_devices // tp, 1)
    return RescalePlan(old_devices, dp * tp, dp, tp, reason)


def reshard_leaf(path: str, x, mesh, spec_fn: Callable[[str], Any]):
    """One leaf of a host tree (a numpy array or a CPU tensor) as a DTensor
    on ``mesh``, placed by ``spec_fn(path)``; every rank passes the same
    leaf."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.sharding.specs import placements

    t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
    return distribute_tensor(t.to(mesh.device_type), mesh,
                             placements(mesh, spec_fn(path)))


def reshard_state(state, mesh, spec_fn: Callable[[str], Any]):
    """Every leaf of a host tree (e.g. a restored checkpoint) as a DTensor
    on the (new) ``DeviceMesh``, placed by ``spec_fn(path)``
    (``reshard_leaf``); every rank passes the same tree."""
    from repro_torch.common.tree import tree_paths, unflatten

    return unflatten({p: reshard_leaf(p, x, mesh, spec_fn)
                      for p, x in tree_paths(state)})
