"""Mamba2 SSD chunked scan from a zero state.

Kernel: ``csrc/ssd_scan.cu`` (CUDA C++ for ``sm_90a``), replacing the TPU
kernel ``repro/kernels/ssd_scan.py::ssd`` (``_ssd_kernel``).  In bf16 it
computes what ``ref.ssd_chunked`` computes chunk-parallel on the tensor
cores: one launch for a single chunk (the serving path's 32-token chunk:
no state is formed), otherwise three: every chunk's state in parallel, a
short sequential pass over chunks for each chunk's incoming state (f32, in
a workspace this wrapper allocates), and every chunk's output in parallel.
``dt`` is folded into the score and the state weights, so each product has
one exact bf16 operand, and the f32 operand is split into bf16 hi + lo.
C·Bᵀ is formed once per block of two heads.  f32 inputs take a CUDA-core
body of the same function, selected by dtype (the identity checks run
f32): the chunk loop inside one block per (16 columns of P, head, batch
row), the (N x P) state in shared memory; both routes launch or raise.
``+ d_skip x`` is added in float32 before the one rounding to x's dtype,
as ``ref.ssd_chunked`` does.  The final state is not an output: the model
recomputes it (``models.ssm._final_ssd_state``).

``ssd`` launches the kernel on CUDA tensors; ``ssd_plain`` is the same
function in plain PyTorch (``ref.ssd_chunked``), which the CPU path runs
and the kernel is held against.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build, ref

launches = 0                 # kernel launches (plain-version calls excluded)
_count_lock = threading.Lock()

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 128
P_BLOCK = 16                 # f32: head-dim columns per block (P a multiple)
TC_HEAD_DIMS = (16, 32, 64)  # bf16: the head dims of the tensor-core route
TC_MAX_STATE = 128           # bf16: state widths, multiples of 16 up to this


def _counted() -> None:
    global launches
    with _count_lock:
        launches += 1


def _check(x, dt, a_log, b_mat, c_mat, d_skip, chunk):
    if x.dim() != 4:
        raise ValueError(f"ssd: x {tuple(x.shape)} is not (B, S, H, P)")
    b, s, h, p = x.shape
    n = b_mat.shape[-1]
    if dt.shape != (b, s, h) or a_log.shape != (h,) \
            or b_mat.shape != (b, s, n) or c_mat.shape != (b, s, n) \
            or (d_skip is not None and d_skip.shape != (h,)):
        raise ValueError(f"ssd: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a_log {tuple(a_log.shape)}, "
                         f"b {tuple(b_mat.shape)}, c {tuple(c_mat.shape)}")
    if p % P_BLOCK or n > 512:
        raise ValueError(f"ssd: head dim {p} must be a multiple of {P_BLOCK} "
                         f"and the state {n} at most 512")
    if x.dtype == torch.bfloat16 and (p not in TC_HEAD_DIMS or n % 16
                                      or n > TC_MAX_STATE):
        raise ValueError(f"ssd: the bf16 kernel takes head dims "
                         f"{TC_HEAD_DIMS} and states of a multiple of 16 up "
                         f"to {TC_MAX_STATE}, not P {p}, N {n}")
    if not 1 <= chunk <= MAX_CHUNK or s % chunk:
        raise ValueError(f"ssd: seq {s} not a multiple of chunk {chunk} "
                         f"(1 <= chunk <= {MAX_CHUNK})")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype
                                     for t in (dt, b_mat, c_mat)):
        raise TypeError(f"ssd: dtypes {x.dtype}, {dt.dtype}, {b_mat.dtype}, "
                        f"{c_mat.dtype}")
    for t in (x, dt, b_mat, c_mat, a_log) + (() if d_skip is None
                                             else (d_skip,)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("ssd: tensors must be contiguous and on one "
                             "device")
    if x.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (x, b_mat, c_mat)):
        raise ValueError("ssd: bf16 x, B and C must be 16-byte aligned "
                         "(rows are vector copies)")


def ssd(x, dt, a_log, b_mat, c_mat, d_skip=None, *, chunk=128):
    """Launch the Hopper kernel.  x (B,S,H,P); dt (B,S,H) post-softplus;
    a_log (H,); b_mat/c_mat (B,S,N); d_skip (H,) or None; ``chunk`` (at most
    S) must divide S.  Returns (B,S,H,P) in x's dtype.  CUDA tensors
    only."""
    if x.device.type != "cuda":
        raise RuntimeError("ssd kernel needs CUDA tensors; use ssd_plain on "
                           "the CPU")
    chunk = min(int(chunk), x.shape[1])
    a_log = a_log.to(torch.float32).contiguous()
    d_skip = None if d_skip is None else d_skip.to(torch.float32).contiguous()
    _check(x, dt, a_log, b_mat, c_mat, d_skip, chunk)
    b, s, h, p = x.shape
    n, nc = b_mat.shape[-1], s // chunk
    y = torch.empty_like(x)
    # bf16 over several chunks: each chunk's f32 state, its incoming state
    # as bf16 hi and lo planes, and its log-decay total
    work = (torch.empty(b * (nc - 1) * h * (2 * n * p + 1),
                        dtype=torch.float32, device=x.device)
            if x.dtype == torch.bfloat16 and nc > 1 else None)
    fn = build.library("ssd_scan", _ARGTYPES).ssd_scan_launch
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(),
                 b_mat.data_ptr(), c_mat.data_ptr(),
                 None if d_skip is None else d_skip.data_ptr(), y.data_ptr(),
                 None if work is None else work.data_ptr(),
                 b, s, h, p, n, chunk, _DTYPES[x.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd launch failed: CUDA error {err}")
    _counted()
    return y


def ssd_plain(x, dt, a_log, b_mat, c_mat, d_skip=None, *, chunk=128):
    """The same function in plain PyTorch (the CPU path and the oracle)."""
    return ref.ssd_chunked(x, dt, a_log, b_mat, c_mat, d_skip, chunk=chunk)
