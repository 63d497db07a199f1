"""RG-LRU linear recurrence (Griffin) from a zero state.

Kernel: ``csrc/rglru_scan.cu`` (CUDA C++ for ``sm_90a``), replacing the TPU
kernel ``repro/kernels/rglru_scan.py::rglru`` (``_rglru_kernel``).  CUDA
rather than Triton: the work is a dependent chain along time per channel,
which a loop over time in registers expresses directly, while Triton's
``tl.associative_scan`` would hold a block's whole time axis.  A block owns
32 channels, one a lane, and walks time in tiles of ``segs`` segments of
``per`` steps, one segment a warp: one tile straight into registers for a
serving chunk, tiles of 256 steps through a ring of shared-memory stages
for a prompt (``plan``; the source's header has the design).  Each input
is read once; ``a``, ``beta`` and ``b`` are computed once, in float32, and
``h`` is written in x's dtype.

``rglru`` launches the kernel on CUDA tensors; ``rglru_plain`` is the same
function in plain PyTorch (``ref.rglru_chunked``), which the CPU path runs
and the kernel is held against.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build, ref

launches = 0                 # kernel launches (plain-version calls excluded)
_count_lock = threading.Lock()

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

ONE_TILE_SEGS = 16   # most warps of a one-tile launch
STEPS = 8            # most steps a segment
SEGS = 32            # warps of a staged tile (tiles of SEGS * STEPS steps)


def plan(s: int, staged: bool = None):
    """The launch's cut of time, (segs, per): one tile of at most 16 warps
    of ``per`` steps where ``s`` fits 128 steps, else tiles of 32 warps of 8
    steps through the staged pipeline.  ``staged`` forces either path
    (the staged one takes any ``s``; the one-tile one up to 128)."""
    if staged is None:
        staged = s > ONE_TILE_SEGS * STEPS
    if staged:
        return SEGS, STEPS
    if s > ONE_TILE_SEGS * STEPS:
        raise ValueError(f"rglru: {s} steps do not fit one tile")
    per = -(-s // ONE_TILE_SEGS)
    return -(-s // per), per


def _counted() -> None:
    global launches
    with _count_lock:
        launches += 1


def rglru(x, log_a, gate_x, staged: bool = None):
    """Launch the Hopper kernel.  x, log_a (<= 0) and gate_x: (B,S,D), one
    dtype, contiguous.  Returns the hidden states (B,S,D) in x's dtype.
    ``staged`` forces a path (``plan``).  CUDA tensors only."""
    if x.device.type != "cuda":
        raise RuntimeError("rglru kernel needs CUDA tensors; use rglru_plain "
                           "on the CPU")
    if x.dim() != 3 or log_a.shape != x.shape or gate_x.shape != x.shape:
        raise ValueError(f"rglru: shapes {tuple(x.shape)}, "
                         f"{tuple(log_a.shape)}, {tuple(gate_x.shape)}")
    if x.dtype not in _DTYPES or log_a.dtype != x.dtype \
            or gate_x.dtype != x.dtype:
        raise TypeError(f"rglru: dtypes {x.dtype}, {log_a.dtype}, "
                        f"{gate_x.dtype}")
    for t in (x, log_a, gate_x):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("rglru: tensors must be contiguous and on one "
                             "device")
    b, s, d = x.shape
    segs, per = plan(s, staged)
    y = torch.empty_like(x)
    fn = build.library("rglru_scan", _ARGTYPES).rglru_scan_launch
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), log_a.data_ptr(), gate_x.data_ptr(),
                 y.data_ptr(), b, s, d, segs, per, _DTYPES[x.dtype],
                 build.current_stream(x.device))
    if err:
        raise RuntimeError(f"rglru launch failed: CUDA error {err}")
    _counted()
    return y


def rglru_plain(x, log_a, gate_x):
    """The same function in plain PyTorch (the CPU path and the oracle)."""
    return ref.rglru_chunked(x, log_a, gate_x)
