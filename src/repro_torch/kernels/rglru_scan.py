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

Backward: ``csrc/rglru_scan_bwd.cu``, launched by ``rglru_bwd``: the
reverse-time recurrence ``dh_t = dy_t + a_{t+1} dh_{t+1}``, then ``da_t =
dh_t h_{t-1}`` and ``db_t = dh_t``, carried through ``a = exp(log_a)`` and
``b = sqrt(max(1 - a^2, 0)) gate x`` to d log_a, d gate and d x (f32,
rounded once to x's dtype).  ``h_{t-1}`` is the f32 state, recomputed
forward inside the kernel (the forward's output is rounded).  It keeps
the forward's cut of time (``plan``), run backward: the tiles are walked
last to first through a ring of shared-memory stages, the carry of ``a
dh`` coming from the later tile, each tile's incoming state taken from a
checkpoint that the forward kernel writes when asked (``rglru(...,
checkpoint=True)``: a (B, tiles - 1, D) f32 tensor); the segments of a
tile meet in warp-shuffle scans, forward and in reverse (the source's
header has the design).  ``rglru_checkpoint_plain`` is the checkpoint in
plain PyTorch.  ``rglru_bwd_plain`` is
the same function in plain PyTorch, with the gradient ``jax.grad`` of
``ref.rglru_chunked`` gives where ``1 - a^2 = 0`` (``_dlog_a``).
``RGLRUFn`` is the ``torch.autograd.Function`` ``ops.rglru`` routes a CUDA
call through when an input needs a gradient; it keeps the checkpoint as
flash keeps its lse.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build, ref

launches = 0                 # kernel launches (plain-version calls excluded)
bwd_launches = 0             # backward kernel launches
_count_lock = threading.Lock()

# x, log_a, gate, y, ckpt; B, S, D, segs, per, dtype; stream
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
# x, log_a, gate, dy, dx, dlog_a, dgate, ckpt; B, S, D, segs, per, dtype;
# stream
_BWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
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


def tiles(s: int, staged: bool = None) -> int:
    """Tiles of ``plan(s, staged)`` over ``s`` steps: the checkpoint holds
    the incoming state of each but the first."""
    segs, per = plan(s, staged)
    return -(-s // (segs * per))


def _counted(bwd: bool = False) -> None:
    global launches, bwd_launches
    with _count_lock:
        if bwd:
            bwd_launches += 1
        else:
            launches += 1


def _check(name, x, *others):
    if x.dim() != 3 or any(t.shape != x.shape for t in others):
        raise ValueError(f"{name}: shapes {tuple(x.shape)}, "
                         + ", ".join(str(tuple(t.shape)) for t in others))
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in others):
        raise TypeError(f"{name}: dtypes {x.dtype}, "
                        + ", ".join(str(t.dtype) for t in others))
    for t in (x,) + others:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous and on "
                             "one device")


def rglru(x, log_a, gate_x, staged: bool = None, checkpoint: bool = False):
    """Launch the Hopper kernel.  x, log_a (<= 0) and gate_x: (B,S,D), one
    dtype, contiguous.  Returns the hidden states (B,S,D) in x's dtype;
    with ``checkpoint`` also each tile's incoming f32 state, (B, tiles -
    1, D), which ``rglru_bwd`` takes (the states do not change with it).
    ``staged`` forces a path (``plan``).  CUDA tensors only."""
    if x.device.type != "cuda":
        raise RuntimeError("rglru kernel needs CUDA tensors; use rglru_plain "
                           "on the CPU")
    _check("rglru", x, log_a, gate_x)
    b, s, d = x.shape
    segs, per = plan(s, staged)
    y = torch.empty_like(x)
    ckpt = torch.empty((b, tiles(s, staged) - 1, d), dtype=torch.float32,
                       device=x.device) if checkpoint else None
    fn = build.library("rglru_scan", _ARGTYPES).rglru_scan_launch
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), log_a.data_ptr(), gate_x.data_ptr(),
                 y.data_ptr(), None if ckpt is None or ckpt.numel() == 0
                 else ckpt.data_ptr(), b, s, d, segs, per, _DTYPES[x.dtype],
                 build.current_stream(x.device))
    if err:
        raise RuntimeError(f"rglru launch failed: CUDA error {err}")
    _counted()
    return (y, ckpt) if checkpoint else y


def rglru_plain(x, log_a, gate_x):
    """The same function in plain PyTorch (the CPU path and the oracle)."""
    return ref.rglru_chunked(x, log_a, gate_x)


def _states_f32(x, log_a, gate_x):
    """The f32 states h (f64 for f64 inputs), by the forward's scan."""
    f32 = torch.promote_types(x.dtype, torch.float32)
    la = log_a.to(f32)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * la), 0.0))
    a, bx = torch.exp(la), beta * gate_x.to(f32) * x.to(f32)

    def combine(c1, c2):
        return [c1[0] * c2[0], c1[1] * c2[0] + c2[1]]

    _, h = ref._associative_scan(combine, [a, bx], dim=1)
    return a, beta, h


def rglru_checkpoint_plain(x, log_a, gate_x, staged: bool = None):
    """``rglru(..., checkpoint=True)``'s checkpoint in plain PyTorch: the
    f32 state after the last step of each tile but the last, (B, tiles -
    1, D)."""
    segs, per = plan(x.shape[1], staged)
    rows = segs * per
    _, _, h = _states_f32(x, log_a, gate_x)
    return h[:, rows - 1::rows][:, :tiles(x.shape[1], staged) - 1] \
        .contiguous()


# ------------------------------------------------------------- backward
def rglru_bwd(x, log_a, gate_x, dy, staged: bool = None, ckpt=None):
    """Launch the backward kernel: (dx, dlog_a, dgate_x) of ``rglru(x,
    log_a, gate_x)`` for the output gradient ``dy``, in x's dtype.
    ``ckpt``: the forward's checkpoint (``rglru(..., checkpoint=True)`` on
    the same inputs and path); without it, where there are several tiles,
    a forward launch makes it first.  ``staged`` forces a path (``plan``).
    CUDA tensors only."""
    if x.device.type != "cuda":
        raise RuntimeError("rglru_bwd kernel needs CUDA tensors; use "
                           "rglru_bwd_plain on the CPU")
    dy = dy.contiguous()
    _check("rglru_bwd", x, log_a, gate_x, dy)
    b, s, d = x.shape
    segs, per = plan(s, staged)
    n = tiles(s, staged)
    if n > 1 and ckpt is None:
        _, ckpt = rglru(x, log_a, gate_x, staged, checkpoint=True)
    if n > 1 and (ckpt.shape != (b, n - 1, d) or ckpt.dtype != torch.float32
                  or ckpt.device != x.device or not ckpt.is_contiguous()):
        raise ValueError(f"rglru_bwd: checkpoint {tuple(ckpt.shape)} "
                         f"{ckpt.dtype} for {n} tiles of {tuple(x.shape)}")
    dx, dla, dg = (torch.empty_like(x) for _ in range(3))
    fn = build.launcher("rglru_scan_bwd", "rglru_scan_bwd_launch",
                        _BWD_ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), log_a.data_ptr(), gate_x.data_ptr(),
                 dy.data_ptr(), dx.data_ptr(), dla.data_ptr(), dg.data_ptr(),
                 ckpt.data_ptr() if n > 1 else None, b, s, d, segs, per,
                 _DTYPES[x.dtype], build.current_stream(x.device))
    if err:
        raise RuntimeError(f"rglru backward launch failed: CUDA error {err}")
    _counted(bwd=True)
    return dx, dla, dg


def _dlog_a(la, da, dbeta):
    """d log_a from the gradients of ``a = exp(la)`` and of ``beta =
    sqrt(max(1 - exp(2 la), 0))``, by the steps ``jax.grad`` takes: sqrt's
    ``0.5 / beta``, max's 1 above 0, 0.5 at 0 and 0 below, then ``-2
    exp(2 la)``.  So where ``1 - a^2 = 0`` (la = 0, or so near it that
    exp(2 la) rounds to 1) the gradient is -inf (+inf) where ``dh gate x``
    is positive (negative), and NaN where it is 0, as ``jax.grad`` of
    ``ref.rglru_chunked`` gives."""
    e2 = torch.exp(2.0 * la)
    u = 1.0 - e2
    beta = torch.sqrt(torch.clamp_min(u, 0.0))
    coef = torch.where(u > 0, 1.0, torch.where(u == 0, 0.5, 0.0))
    return da * torch.exp(la) - (dbeta * (0.5 / beta)) * coef * e2 * 2.0


def rglru_bwd_plain(x, log_a, gate_x, dy):
    """The backward kernel's function in plain PyTorch, in f32 (f64 for
    f64 inputs): the states by the forward's scan, the reverse recurrence
    by the same scan over reversed time (coefficients ``a_{t+1}``), then
    the gradients of the inputs, rounded once to x's dtype."""
    f32 = torch.promote_types(x.dtype, torch.float32)
    la, xf, gf = log_a.to(f32), x.to(f32), gate_x.to(f32)
    a, beta, h = _states_f32(x, log_a, gate_x)

    def combine(c1, c2):
        return [c1[0] * c2[0], c1[1] * c2[0] + c2[1]]

    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
    _, dh = ref._associative_scan(
        combine, [torch.flip(a_next, [1]), torch.flip(dy.to(f32), [1])],
        dim=1)
    dh = torch.flip(dh, [1])
    dhx = dh * xf
    dla = _dlog_a(la, dh * h_prev, dhx * gf)
    return ((dh * (beta * gf)).to(x.dtype), dla.to(x.dtype),
            (dhx * beta).to(x.dtype))


class RGLRUFn(torch.autograd.Function):
    """``rglru`` under autograd on the card: forward kernel (writing its
    checkpoint), backward kernel (from the saved inputs and checkpoint)."""

    @staticmethod
    def forward(ctx, x, log_a, gate_x):
        y, ckpt = rglru(x, log_a, gate_x, checkpoint=True)
        ctx.save_for_backward(x, log_a, gate_x, ckpt)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, log_a, gate_x, ckpt = ctx.saved_tensors
        return rglru_bwd(x, log_a, gate_x, dy, ckpt=ckpt)
