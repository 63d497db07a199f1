"""A device mesh for one process: a grid of ``torch.device``s with named
axes, standing in for ``jax.sharding.Mesh`` / ``jax.make_mesh``, which the
reference takes from its library.

The port's serving mesh is single-controller, as the reference is: one
process holds one ``Replica`` and drives every device of the mesh, and the
mesh only decides where each shard of the decode step's KV cache lives and
runs (``repro_torch.serving.spmd_decode``).  A device may appear more than
once: ``make_mesh((1, 4), ("data", "model"), [torch.device("cuda", 0)] *
4)`` puts four sequence shards on one card, and the CPU tests use
``["cpu"] * 8``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """``devices``: a numpy object array of ``torch.device``s, one axis per
    name in ``axis_names``.  ``shape`` maps each axis name to its size."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names) or \
                len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh: devices of shape {devices.shape} for "
                             f"axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              devices.shape))

    def distinct_devices(self) -> list:
        """Each device of the mesh once, in grid order."""
        seen = []
        for d in self.devices.flat:
            if d not in seen:
                seen.append(d)
        return seen

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.distinct_devices()})"


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``Mesh`` of ``shape`` with ``axis_names``.  ``devices`` (any
    ``torch.device`` or device string, repeats allowed) fills the grid in
    row-major order; by default the first ∏shape CUDA devices, and
    ``RuntimeError`` when there are fewer."""
    n = math.prod(shape)
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(f"make_mesh: {n} CUDA devices wanted, {have} "
                               "present (pass devices=..., repeats allowed)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"make_mesh: {len(devices)} devices for shape "
                         f"{tuple(shape)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(tuple(shape)), axis_names)
