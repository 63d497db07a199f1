"""RMSNorm with the gemma-style ``(1 + scale)`` gain, and its fused forms.

Kernel: ``csrc/rmsnorm.cu`` (CUDA C++ for ``sm_90a``), replacing the TPU
kernel ``repro/kernels/rmsnorm.py::rmsnorm`` (``_rmsnorm_kernel``), which
the JAX model never wires in (it normalises in jnp at
``models/layers.py:34/:42``); the port runs it at every norm site.  One
kernel body serves four entry points, each one launch:

  rmsnorm(x, scale)            the norm itself (pre-norms, final norm);
  rmsnorm_pair(q, k, qs, ks)   the qk-norm: both tensors, each with its
                               own gain, in one launch;
  add_rmsnorm(x, y, scale)     s = x + y and its norm, both written (the
                               residual add before every MLP pre-norm);
  gated_rmsnorm(y, z, scale)   the norm of y * silu(z) (Mamba2's output).

Bound on the card: bytes.  At serving shapes a launch costs its fixed
overhead, so the fused forms save whole launches (the source's header has
the design).  Each entry point's ``*_plain`` twin is the plain PyTorch
expression the model ran before the fusion, which the CPU path runs and
the kernel is held against.  A wrapper launches on CUDA tensors and raises
on any other; it reads inputs through a row stride (a slice of a wider
projection is not copied) and writes contiguous outputs.

Backward: ``csrc/rmsnorm_bwd.cu``, one body for the four forms the
training path calls (the norm, the pair, the add, the gated norm): ``dx
= r (dy w - x r^2 mean(dy w x))`` from the saved input, plus the sum
output's gradient for the add form, and the gain's gradient summed over
rows in f32 by a second, deterministic pass.  The gated form recomputes
its input ``v = y * silu(z)`` from the saved y and z, rounded as the
forward rounds it, and carries ``dv`` on to ``dy = dv silu(z)`` and
``dz = dv y silu'(z)``; it is an instantiation of its own, which computes
the gate once an element, keeps ``v`` and ``silu(z)`` between the row's
two loops and, in bf16, copies the next rows into shared memory while it
computes the current ones.
Rows go to groups of 8 to 128 threads, several rows in flight a block
with 16-byte loads, all issued before the row's reduction (the source's
header has the design).
``rmsnorm_bwd``, ``rmsnorm_pair_bwd``, ``add_rmsnorm_bwd`` and
``gated_rmsnorm_bwd`` launch it; each ``*_bwd_plain`` is the same
arithmetic in plain PyTorch.  The TPU kernel has no backward (the JAX
package differentiates its jnp norm).  ``RMSNormFn``, ``RMSNormPairFn``,
``AddRMSNormFn`` and ``GatedRMSNormFn`` are the
``torch.autograd.Function``s ``ops`` routes a CUDA call through when an
input needs a gradient: forward kernel, then backward kernel.
"""
from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

launches = 0                 # kernel launches (plain-version calls excluded)
bwd_launches = 0             # backward kernel launches
_count_lock = threading.Lock()
_launcher = None             # rmsnorm_launch, once built and loaded

_NORM, _ADD, _GATED = 0, 1, 2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# mode, dtype, D, eps; segment 0: a, b, sa, sb, gain, out, sum, rows;
# segment 1: a, sa, gain, out, rows; stream
_ARGTYPES = [_I, _I, _I, ctypes.c_float, _P, _P, _L, _L, _P, _P, _P, _I,
             _P, _L, _P, _P, _I, _P]
# dtype, D, eps; segment 0: x, dy, dres, z, gain, dx, dz, rows; segment 1:
# x, dy, gain, dx, rows; partial, blocks, dgain0, dgain1, stream
_BWD_ARGTYPES = [_I, _I, ctypes.c_float, _P, _P, _P, _P, _P, _P, _P, _I, _P,
                 _P, _P, _P, _I, _P, _I, _P, _P, _P]
_BWD_MAX_D = 8192


def _counted(bwd: bool = False) -> None:
    global launches, bwd_launches
    with _count_lock:
        if bwd:
            bwd_launches += 1
        else:
            launches += 1


def _rows(t: torch.Tensor, d: int):
    """(tensor, row stride in elements) reading ``t`` as rows of its last
    axis: ``t`` itself where its leading axes collapse into one stride and
    its last axis is unit-strided, else a contiguous copy."""
    if t.is_contiguous():
        return t, d
    if t.stride(-1) != 1 and d > 1:
        return t.contiguous(), d
    stride = expect = None
    for size, st in reversed(list(zip(t.shape[:-1], t.stride()[:-1]))):
        if size == 1:
            continue
        if stride is None:
            stride = st
        elif st != expect:
            return t.contiguous(), d
        expect = st * size
    return t, d if stride is None else stride


def _check(name: str, x: torch.Tensor, scale: torch.Tensor, *others):
    """Device, type and shape checks shared by the four entry points."""
    if x.device.type != "cuda":
        raise RuntimeError(f"{name} kernel needs CUDA tensors; use "
                           f"{name}_plain on the CPU")
    d = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype}")
    if scale.shape != (d,) or scale.dtype != torch.float32 \
            or scale.device != x.device:
        raise ValueError(f"{name}: scale {tuple(scale.shape)} "
                         f"{scale.dtype} on {scale.device} for x "
                         f"{tuple(x.shape)} on {x.device}")
    for t in others:
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on "
                             f"{t.device} beside {tuple(x.shape)} {x.dtype} "
                             f"on {x.device}")
    return d


def _launch(mode, x, eps, a0, sa0, scale0, out0, b0=None, sb0=0, sum0=None,
            a1=None, sa1=0, scale1=None, out1=None):
    """One launch.  The host path is kept short: it is a sizeable part of
    a norm's cost at serving shapes."""
    global _launcher
    if _launcher is None:
        _launcher = build.library("rmsnorm", _ARGTYPES).rmsnorm_launch
    d = x.shape[-1]
    rows0 = out0.numel() // d
    rows1 = 0 if out1 is None else out1.numel() // d
    dev = x.device
    args = (mode, _DTYPES[x.dtype], d, eps, a0.data_ptr(),
            None if b0 is None else b0.data_ptr(), sa0, sb0,
            scale0.data_ptr(), out0.data_ptr(),
            None if sum0 is None else sum0.data_ptr(), rows0,
            None if a1 is None else a1.data_ptr(), sa1,
            None if scale1 is None else scale1.data_ptr(),
            None if out1 is None else out1.data_ptr(), rows1,
            build.current_stream(dev))
    if dev.index == torch.cuda.current_device():
        err = _launcher(*args)
    else:
        with torch.cuda.device(dev):
            err = _launcher(*args)
    if err:
        raise RuntimeError(f"rmsnorm launch failed: CUDA error {err} "
                           f"(D {d})")
    _counted()


def _empty(x):
    """An uninitialised contiguous tensor of x's shape and dtype."""
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """Launch the kernel.  x: (..., D); scale: (D,) float32.  Returns x's
    shape and dtype, contiguous.  CUDA tensors only."""
    d = _check("rmsnorm", x, scale)
    a, sa = _rows(x, d)
    out = _empty(x)
    _launch(_NORM, x, eps, a, sa, scale, out)
    return out


def rmsnorm_pair(q: torch.Tensor, k: torch.Tensor, q_scale: torch.Tensor,
                 k_scale: torch.Tensor, eps: float = 1e-6):
    """``(rmsnorm(q, q_scale), rmsnorm(k, k_scale))`` in one launch.  q and
    k: (..., D) of one dtype and width, any leading shapes."""
    d = _check("rmsnorm_pair", q, q_scale)
    _check("rmsnorm_pair", k, k_scale)
    if k.shape[-1] != d or k.dtype != q.dtype:
        raise ValueError(f"rmsnorm_pair: q {tuple(q.shape)} {q.dtype}, k "
                         f"{tuple(k.shape)} {k.dtype}")
    a0, sa0 = _rows(q, d)
    a1, sa1 = _rows(k, d)
    q_out, k_out = _empty(q), _empty(k)
    _launch(_NORM, q, eps, a0, sa0, q_scale, q_out, a1=a1, sa1=sa1,
            scale1=k_scale, out1=k_out)
    return q_out, k_out


def add_rmsnorm(x: torch.Tensor, y: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6):
    """``s = x + y`` (rounded to x's dtype) and ``rmsnorm(s, scale)``, both
    written by one launch.  x, y: (..., D), one shape and dtype."""
    d = _check("add_rmsnorm", x, scale, y)
    a, sa = _rows(x, d)
    b, sb = _rows(y, d)
    s, out = _empty(x), _empty(x)
    _launch(_ADD, x, eps, a, sa, scale, out, b0=b, sb0=sb, sum0=s)
    return s, out


def gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """``rmsnorm(y * silu(z), scale)`` in one launch, rounded as PyTorch
    rounds the expression.  y, z: (..., D), one shape and dtype."""
    d = _check("gated_rmsnorm", y, scale, z)
    a, sa = _rows(y, d)
    b, sb = _rows(z, d)
    out = _empty(y)
    _launch(_GATED, y, eps, a, sa, scale, out, b0=b, sb0=sb)
    return out


# ------------------------------------------------------- plain versions
def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
                  ) -> torch.Tensor:
    """The same function in plain PyTorch (the CPU path and the oracle)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rmsnorm_pair_plain(q, k, q_scale, k_scale, eps: float = 1e-6):
    return rmsnorm_plain(q, q_scale, eps), rmsnorm_plain(k, k_scale, eps)


def add_rmsnorm_plain(x, y, scale, eps: float = 1e-6):
    s = x + y
    return s, rmsnorm_plain(s, scale, eps)


def gated_rmsnorm_plain(y, z, scale, eps: float = 1e-6):
    return rmsnorm_plain(y * F.silu(z), scale, eps)


# ------------------------------------------------------------- backward
def _bwd_launch(x0, dy0, scale0, dres0=None, x1=None, dy1=None, scale1=None,
                eps: float = 1e-6, z0=None):
    """One backward launch (two kernels) over one or two segments of
    contiguous rows; ``z0`` makes segment 0 the gated form (x0 is then its
    y).  Returns (dx0, dgain0, dx1, dgain1), and dz0 after them with
    ``z0``."""
    d = x0.shape[-1]
    if d > _BWD_MAX_D:
        raise NotImplementedError(f"rmsnorm backward: width {d} > "
                                  f"{_BWD_MAX_D}")
    segs = [(x0, dy0, dres0 if z0 is None else z0)] + (
        [] if x1 is None else [(x1, dy1, None)])
    for x, dy, dres in segs:
        for t in (dy,) + (() if dres is None else (dres,)):
            if t.shape != x.shape or t.dtype != x.dtype \
                    or t.device != x.device:
                raise ValueError(f"rmsnorm backward: {tuple(t.shape)} "
                                 f"{t.dtype} beside {tuple(x.shape)} "
                                 f"{x.dtype}")
    x0, dy0 = x0.contiguous(), dy0.contiguous()
    dres0 = None if dres0 is None else dres0.contiguous()
    z0 = None if z0 is None else z0.contiguous()
    dz0 = None if z0 is None else _empty(z0)
    dx0, dg0 = _empty(x0), torch.empty(d, dtype=torch.float32,
                                       device=x0.device)
    rows0, rows1 = x0.numel() // d, 0
    dx1 = dg1 = None
    if x1 is not None:
        x1, dy1 = x1.contiguous(), dy1.contiguous()
        dx1 = _empty(x1)
        dg1 = torch.empty(d, dtype=torch.float32, device=x0.device)
        rows1 = x1.numel() // d
    # at most two blocks of 256 threads an SM (the gated form three of
    # 384); the launcher takes fewer where the rows run out or its tile
    # holds more registers, and its partials fill the first ones
    dev = x0.device
    blocks = (2 if z0 is None else 3) * build.sm_count(dev.index or 0)
    partial = torch.empty(blocks * 2 * d, dtype=torch.float32, device=dev)
    ptr = (lambda t: None if t is None else t.data_ptr())
    fn = build.library("rmsnorm_bwd", _BWD_ARGTYPES).rmsnorm_bwd_launch
    with torch.cuda.device(dev):
        err = fn(_DTYPES[x0.dtype], d, eps, x0.data_ptr(), dy0.data_ptr(),
                 ptr(dres0), ptr(z0), scale0.data_ptr(), dx0.data_ptr(),
                 ptr(dz0), rows0, ptr(x1), ptr(dy1), ptr(scale1), ptr(dx1),
                 rows1,
                 partial.data_ptr(), blocks, dg0.data_ptr(), ptr(dg1),
                 build.current_stream(dev))
    if err:
        raise RuntimeError(f"rmsnorm backward launch failed: CUDA error "
                           f"{err} (D {d})")
    _counted(bwd=True)
    if z0 is not None:
        return dx0, dg0, dx1, dg1, dz0
    return dx0, dg0, dx1, dg1


def rmsnorm_bwd(x, scale, dy, eps: float = 1e-6):
    """Launch the backward kernel: (dx in x's dtype, dscale f32) of
    ``rmsnorm(x, scale)`` for the output gradient ``dy``."""
    _check("rmsnorm_bwd", x, scale, dy)
    dx, dg, _, _ = _bwd_launch(x, dy, scale, eps=eps)
    return dx, dg


def rmsnorm_pair_bwd(q, k, q_scale, k_scale, dq_out, dk_out,
                     eps: float = 1e-6):
    """Both segments of the qk-norm in one launch: (dq, dk, dq_scale,
    dk_scale)."""
    _check("rmsnorm_pair_bwd", q, q_scale, dq_out)
    _check("rmsnorm_pair_bwd", k, k_scale, dk_out)
    dq, dqs, dk, dks = _bwd_launch(q, dq_out, q_scale, x1=k, dy1=dk_out,
                                   scale1=k_scale, eps=eps)
    return dq, dk, dqs, dks


def add_rmsnorm_bwd(s, scale, ds, dh, eps: float = 1e-6):
    """Backward of ``(s, h) = add_rmsnorm(x, y, scale)`` from the saved sum
    ``s`` and the gradients of both outputs: (dx = dy = ds + dnorm(dh) in
    s's dtype, rounded once, and dscale f32)."""
    _check("add_rmsnorm_bwd", s, scale, ds, dh)
    dx, dg, _, _ = _bwd_launch(s, dh, scale, dres0=ds, eps=eps)
    return dx, dg


def gated_rmsnorm_bwd(y, z, scale, dout, eps: float = 1e-6):
    """Backward of ``gated_rmsnorm(y, z, scale)`` from the saved y and z
    and the output gradient: (dy, dz in y's dtype, dscale f32)."""
    _check("gated_rmsnorm_bwd", y, scale, z, dout)
    dy, dg, _, _, dz = _bwd_launch(y, dout, scale, eps=eps, z0=z)
    return dy, dz, dg


def _norm_bwd_f32(x, scale, dy, eps):
    """(dx, dscale) of the norm in f32, dx not rounded."""
    xf, dyf = x.float(), dy.float()
    w = 1.0 + scale.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    dyw = dyf * w
    dot = (dyw * xf).mean(dim=-1, keepdim=True)
    dx = r * (dyw - xf * (r * r * dot))
    dscale = (dyf * (xf * r)).reshape(-1, x.shape[-1]).sum(0)
    return dx, dscale


def rmsnorm_bwd_plain(x, scale, dy, eps: float = 1e-6):
    """The backward kernel's arithmetic in plain PyTorch."""
    dx, dscale = _norm_bwd_f32(x, scale, dy, eps)
    return dx.to(x.dtype), dscale


def rmsnorm_pair_bwd_plain(q, k, q_scale, k_scale, dq_out, dk_out,
                           eps: float = 1e-6):
    dq, dqs = rmsnorm_bwd_plain(q, q_scale, dq_out, eps)
    dk, dks = rmsnorm_bwd_plain(k, k_scale, dk_out, eps)
    return dq, dk, dqs, dks


def add_rmsnorm_bwd_plain(s, scale, ds, dh, eps: float = 1e-6):
    dx, dscale = _norm_bwd_f32(s, scale, dh, eps)
    return (ds.float() + dx).to(s.dtype), dscale


def gated_rmsnorm_bwd_plain(y, z, scale, dout, eps: float = 1e-6):
    """The gated form's backward kernel in plain PyTorch: the norm's
    input ``v = y * silu(z)`` rounded as the forward rounds it, ``dv`` of
    the norm in f32, then ``dy = dv silu(z)`` and ``dz = dv y silu'(z)``
    with ``silu'(z) = sigmoid(z) (1 + z (1 - sigmoid(z)))``, each rounded
    once.  Returns (dy, dz, dscale f32)."""
    s = F.silu(z)
    dv, dscale = _norm_bwd_f32(y * s, scale, dout, eps)
    zf = z.float()
    sig = torch.sigmoid(zf)
    dz = dv * y.float() * (sig * (1.0 + zf * (1.0 - sig)))
    return (dv * s.float()).to(y.dtype), dz.to(z.dtype), dscale


class RMSNormFn(torch.autograd.Function):
    """``rmsnorm`` under autograd on the card: forward kernel, backward
    kernel."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        out = rmsnorm(x, scale, eps)
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, dy, ctx.eps)
        return dx, dscale, None


class RMSNormPairFn(torch.autograd.Function):
    """``rmsnorm_pair`` under autograd on the card."""

    @staticmethod
    def forward(ctx, q, k, q_scale, k_scale, eps):
        q_out, k_out = rmsnorm_pair(q, k, q_scale, k_scale, eps)
        ctx.save_for_backward(q, k, q_scale, k_scale)
        ctx.eps = eps
        return q_out, k_out

    @staticmethod
    def backward(ctx, dq_out, dk_out):
        q, k, q_scale, k_scale = ctx.saved_tensors
        dq, dk, dqs, dks = rmsnorm_pair_bwd(q, k, q_scale, k_scale, dq_out,
                                            dk_out, ctx.eps)
        return dq, dk, dqs, dks, None


class AddRMSNormFn(torch.autograd.Function):
    """``add_rmsnorm`` under autograd on the card: the backward needs only
    the sum, which the forward wrote."""

    @staticmethod
    def forward(ctx, x, y, scale, eps):
        s, out = add_rmsnorm(x, y, scale, eps)
        ctx.save_for_backward(s, scale)
        ctx.eps = eps
        return s, out

    @staticmethod
    def backward(ctx, ds, dh):
        s, scale = ctx.saved_tensors
        dx, dscale = add_rmsnorm_bwd(s, scale, ds, dh, ctx.eps)
        return dx, dx, dscale, None


class GatedRMSNormFn(torch.autograd.Function):
    """``gated_rmsnorm`` under autograd on the card: the backward
    recomputes ``y * silu(z)`` from the saved y and z."""

    @staticmethod
    def forward(ctx, y, z, scale, eps):
        out = gated_rmsnorm(y, z, scale, eps)
        ctx.save_for_backward(y, z, scale)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, dout):
        y, z, scale = ctx.saved_tensors
        dy, dz, dscale = gated_rmsnorm_bwd(y, z, scale, dout, ctx.eps)
        return dy, dz, dscale, None
