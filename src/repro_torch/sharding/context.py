"""Serving-mesh context: lets the decode path opt into explicitly
distributed (shard_map) attention when lowered under a mesh.

GSPMD auto-partitioning handles train/prefill well, but the decode step's
cache update + attend pattern defeats it (it falls back to full cache
rematerialization — a multi-GB all-gather per layer).  When a serving mesh
is registered here, ``blocks.apply_block_decode`` routes attention through
``repro_torch.serving.spmd_decode`` — a hand-written split-S flash-decode with a
two-scalar psum combine (§Perf iteration 2).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

_state = threading.local()


def set_serving_mesh(mesh, *, batch_axis: Optional[str] = "data",
                     seq_axis: str = "model") -> None:
    _state.mesh = mesh
    _state.batch_axis = batch_axis
    _state.seq_axis = seq_axis


def clear_serving_mesh() -> None:
    _state.mesh = None


def get_serving_mesh():
    mesh = getattr(_state, "mesh", None)
    if mesh is None:
        return None
    return mesh, getattr(_state, "batch_axis", "data"), \
        getattr(_state, "seq_axis", "model")


@contextlib.contextmanager
def serving_mesh(mesh, *, batch_axis: Optional[str] = "data",
                 seq_axis: str = "model"):
    set_serving_mesh(mesh, batch_axis=batch_axis, seq_axis=seq_axis)
    try:
        yield
    finally:
        clear_serving_mesh()


# --------------------------------------------------------------- activations
# Training/prefill hint: lets attention constrain its head dim onto the TP
# axis even when head counts don't divide it (GSPMD pads unevenly-sharded
# INTERMEDIATES, while jit *arguments* must divide — so weights stay
# replicated but the S^2 attention compute still splits 16 ways).
def set_activation_mesh(mesh, *, tp_axis: str = "model") -> None:
    _state.act_mesh = mesh
    _state.tp_axis = tp_axis


def clear_activation_mesh() -> None:
    _state.act_mesh = None


def get_activation_mesh():
    mesh = getattr(_state, "act_mesh", None)
    if mesh is None:
        return None
    return mesh, getattr(_state, "tp_axis", "model")


@contextlib.contextmanager
def activation_mesh(mesh, *, tp_axis: str = "model"):
    set_activation_mesh(mesh, tp_axis=tp_axis)
    try:
        yield
    finally:
        clear_activation_mesh()
