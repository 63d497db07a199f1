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

Backward: ``csrc/ssd_scan_bwd.cu``, launched by ``ssd_bwd``: the
gradients with respect to x, dt, ``a_log``, B, C and ``d_skip`` of the
function ``ref.ssd_chunked`` computes, from the inputs alone (the
forward's output is rounded, so the chunk states and each chunk's incoming
state are recomputed in f32).  Four steps: every chunk's state and its
local share of the carried state's gradient ``sum_i exp(cum_i) C_i
dy_i^T``; a sequential pass over chunks, forward for the incoming states
and in reverse for the carried state's gradient ``dh_c = exp(total_c)
dh_{c+1} + local_c``; every chunk's dx, d(dt), and its shares of dB and
dC from the intra-chunk and carried terms, the cumulative decay's
gradient turned into d(dt) by a reverse cumsum inside the chunk; then dB
and dC summed over the shares and ``d a_log``, ``d d_skip`` over every
(batch row, chunk), in a fixed order (no float atomics: two runs give the
same bits).  In bf16 the products run on the tensor cores as the
forward's do (one exact bf16 operand, the f32 one split into hi + lo), a
block takes a group of heads (``bwd_head_group``), forms C·Bᵀ once for
them and adds their dB and dC shares into one plane a group; f32 inputs
take a CUDA-core body with a plane a head, selected by dtype.
``ssd_bwd_plain`` is the same decomposition in plain PyTorch
(``ssd_bwd_states``, ``ssd_bwd_carry``, ``ssd_bwd_chunks``).  The TPU
kernel has no backward (the JAX package differentiates its jnp path).
``SSDFn`` is the ``torch.autograd.Function`` ``ops.ssd`` routes a CUDA
call through when an input needs a gradient.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build, ref

launches = 0                 # kernel launches (plain-version calls excluded)
bwd_launches = 0             # backward kernel launches
_count_lock = threading.Lock()

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
# x, dt, a_log, b, c, d_skip, dy; dx, ddt, db, dc, da_log, dd; work;
# B, S, H, P, N, chunk, group, dtype; stream
_BWD_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
BWD_MAX_HEAD_DIM = 64        # the backward's tile widths: P and N at most
BWD_MAX_STATE = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 128
P_BLOCK = 16                 # f32: head-dim columns per block (P a multiple)
TC_HEAD_DIMS = (16, 32, 64)  # bf16: the head dims of the tensor-core route
TC_MAX_STATE = 128           # bf16: state widths, multiples of 16 up to this
BWD_MAX_GROUP = 8            # bf16 backward: heads a block takes, at most


def _counted(bwd: bool = False) -> None:
    global launches, bwd_launches
    with _count_lock:
        if bwd:
            bwd_launches += 1
        else:
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


# ------------------------------------------------------------- backward
def bwd_head_group(b: int, s: int, h: int, chunk: int, sms: int) -> int:
    """Heads a block of the bf16 backward takes (C·Bᵀ is formed once for
    them), one block an SM: of 1 to ``BWD_MAX_GROUP``, the group whose
    waves of ``b * (s // chunk) * ceil(h / group)`` blocks over ``sms`` SMs
    take the fewest head-steps, the largest of those that tie."""
    blocks = b * (s // chunk)

    def steps(g):
        return -(-blocks * -(-h // g) // sms) * g
    return min(range(1, min(BWD_MAX_GROUP, h) + 1),
               key=lambda g: (steps(g), -g))


def bwd_workspace(b: int, s: int, h: int, p: int, n: int, chunk: int,
                  group: int = 1) -> int:
    """Floats of the backward's f32 workspace: two (B, NC, H, N, P) state
    planes (the incoming states, the carried state's gradient), dB's and
    dC's shares (B, S, ceil(H / group), N) of each head (f32, ``group``
    1) or group of heads (bf16), and three (B, NC, H) planes (the chunks'
    log-decay totals, the partials of d a_log and d d_skip)."""
    nc = s // chunk
    return b * nc * h * (2 * n * p + 3) + 2 * b * s * -(-h // group) * n


def ssd_bwd(x, dt, a_log, b_mat, c_mat, d_skip, dy, *, chunk=128):
    """Launch the backward kernel: (dx, ddt, da_log, db, dc, dd) of
    ``ssd(x, dt, a_log, b_mat, c_mat, d_skip, chunk=chunk)`` for the output
    gradient ``dy``, each in its input's dtype (dd None without
    ``d_skip``).  CUDA tensors only; the forward's shapes, P a multiple of
    16 up to 64 (16, 32 or 64 in bf16) and N of 16 up to 128."""
    if x.device.type != "cuda":
        raise RuntimeError("ssd_bwd kernel needs CUDA tensors; use "
                           "ssd_bwd_plain on the CPU")
    chunk = min(int(chunk), x.shape[1])
    a32 = a_log.to(torch.float32).contiguous()
    d32 = None if d_skip is None else d_skip.to(torch.float32).contiguous()
    dy = dy.contiguous()
    _check(x, dt, a32, b_mat, c_mat, d32, chunk)
    b, s, h, p = x.shape
    n = b_mat.shape[-1]
    if p > BWD_MAX_HEAD_DIM or n % 16 or n > BWD_MAX_STATE:
        raise ValueError(f"ssd_bwd: the kernel takes P up to "
                         f"{BWD_MAX_HEAD_DIM} and N a multiple of 16 up to "
                         f"{BWD_MAX_STATE}, not P {p}, N {n}")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"ssd_bwd: dy {tuple(dy.shape)} {dy.dtype} for x "
                         f"{tuple(x.shape)} {x.dtype}")
    if dy.data_ptr() % 16:      # bf16 rows are vector copies
        dy = dy.clone()
    group = (bwd_head_group(b, s, h, chunk, build.sm_count(x.device.index
                                                           or 0))
             if x.dtype == torch.bfloat16 else 1)
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    db, dc = torch.empty_like(b_mat), torch.empty_like(c_mat)
    da = torch.empty(h, dtype=torch.float32, device=x.device)
    dd = None if d32 is None else torch.empty_like(da)
    work = torch.empty(bwd_workspace(b, s, h, p, n, chunk, group),
                       dtype=torch.float32, device=x.device)
    ptr = (lambda t: None if t is None else t.data_ptr())
    fn = build.launcher("ssd_scan_bwd", "ssd_scan_bwd_launch", _BWD_ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), dt.data_ptr(), a32.data_ptr(),
                 b_mat.data_ptr(), c_mat.data_ptr(), ptr(d32), dy.data_ptr(),
                 dx.data_ptr(), ddt.data_ptr(), db.data_ptr(), dc.data_ptr(),
                 da.data_ptr(), ptr(dd), work.data_ptr(), b, s, h, p, n,
                 chunk, group, _DTYPES[x.dtype],
                 build.current_stream(x.device))
    if err:
        raise RuntimeError(f"ssd backward launch failed: CUDA error {err}")
    _counted(bwd=True)
    return (dx, ddt, da.to(a_log.dtype), db, dc,
            None if dd is None else dd.to(d_skip.dtype))


def _bwd_inputs(x, dt, a_log, b_mat, c_mat, chunk):
    """The forward's f32 terms, cut into chunks: a (H,), the log decays'
    cumulative sums ``cum`` and totals (B, NC, Q, H) / (B, NC, H), x dt
    (B, NC, Q, H, P), B and C (B, NC, Q, N)."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    nc = s // chunk
    f32 = torch.float32
    a = -torch.exp(a_log.to(f32))
    ld = (dt.to(f32) * a).reshape(bsz, nc, chunk, h)
    cum = torch.cumsum(ld, dim=2)
    xb = (x.to(f32) * dt.to(f32)[..., None]).reshape(bsz, nc, chunk, h, p)
    bm = b_mat.to(f32).reshape(bsz, nc, chunk, n)
    cm = c_mat.to(f32).reshape(bsz, nc, chunk, n)
    return a, ld, cum, cum[:, :, -1], xb, bm, cm


def ssd_bwd_states(bm, xb, cum, total):
    """Each chunk's incoming state (B, NC, H, N, P) f32, by the forward's
    sequential pass over the chunks' own states ``sum_j exp(total - cum_j)
    B_j (x dt)_j^T``."""
    decay_to_end = torch.exp(total[:, :, None] - cum)
    states = torch.einsum("bcqn,bcqh,bcqhp->bchnp", bm, decay_to_end, xb)
    hs = torch.zeros_like(states[:, 0])
    before = []
    for c in range(states.shape[1]):
        before.append(hs)
        hs = torch.exp(total[:, c])[..., None, None] * hs + states[:, c]
    return torch.stack(before, dim=1)


def ssd_bwd_carry(cm, dyc, cum, total):
    """The reverse pass: the gradient of each chunk's own state, which is
    the gradient of the state carried into the next chunk, ``dh_{c+1}``
    with ``dh_c = exp(total_c) dh_{c+1} + sum_i exp(cum_i) C_i dy_i^T``
    and nothing after the last chunk (the final state is no output).
    dyc: (B, NC, Q, H, P) f32.  Returns (B, NC, H, N, P)."""
    local = torch.einsum("bcqn,bcqh,bcqhp->bchnp", cm, torch.exp(cum), dyc)
    g = torch.zeros_like(local[:, 0])
    out = [None] * local.shape[1]
    for c in reversed(range(local.shape[1])):
        out[c] = g
        g = local[:, c] + torch.exp(total[:, c])[..., None, None] * g
    return torch.stack(out, dim=1)


def ssd_bwd_chunks(ld, cum, total, xb, bm, cm, dyc, h_in, dstate):
    """Every chunk's terms at once: (d xb (B,NC,Q,H,P), dB and dC
    (B,NC,Q,N) summed over heads, d cum (B,NC,Q,H), d total (B,NC,H)) from
    the intra-chunk term ``y_i = sum_{j<=i} C_i.B_j exp(cum_i - cum_j)
    xb_j``, the carried term ``exp(cum_i) C_i^T h_in`` and the chunk's
    state ``sum_j exp(total - cum_j) B_j xb_j^T``, whose gradient is
    ``dstate``."""
    L = torch.exp(ref.segsum(ld.permute(0, 1, 3, 2)))          # (B,NC,H,Q,Q)
    cb = torch.einsum("bcqn,bckn->bcqk", cm, bm)
    dxp = torch.einsum("bcqhp,bckhp->bchqk", dyc, xb)          # dy_i . xb_j
    m1 = cb[:, :, None] * L                                     # C.B decayed
    m2 = L * dxp
    t = m1 * dxp
    e, f = torch.exp(cum), torch.exp(total[:, :, None] - cum)  # (B,NC,Q,H)
    dxb = (torch.einsum("bchqk,bcqhp->bckhp", m1, dyc)
           + f[..., None] * torch.einsum("bckn,bchnp->bckhp", bm, dstate))
    dc = (torch.einsum("bchqk,bckn->bcqn", m2, bm)
          + torch.einsum("bcqh,bcqhp,bchnp->bcqn", e, dyc, h_in))
    db = (torch.einsum("bchqk,bcqn->bckn", m2, cm)
          + torch.einsum("bckh,bckhp,bchnp->bckn", f, xb, dstate))
    w = f * torch.einsum("bckn,bchnp,bckhp->bckh", bm, dstate, xb)
    dcum = ((t.sum(-1) - t.sum(-2)).permute(0, 1, 3, 2)
            + e * torch.einsum("bcqn,bchnp,bcqhp->bcqh", cm, h_in, dyc) - w)
    dtotal = w.sum(2) + torch.exp(total) * (dstate * h_in).sum((-2, -1))
    return dxb, db, dc, dcum, dtotal


def ssd_bwd_plain(x, dt, a_log, b_mat, c_mat, d_skip, dy, *, chunk=128):
    """The backward kernel's decomposition in plain PyTorch, in f32:
    (dx, ddt, da_log, db, dc, dd) in the inputs' dtypes (dd None without
    ``d_skip``).  The total's gradient joins the last step's cumulative
    decay, and a reverse cumsum inside each chunk turns the cumulative
    decays' gradients into the log decays' ``dl``: ``d dt = dl a + d xb .
    x``, ``d a = sum dl dt``, ``d a_log = d a * a``."""
    bsz, s, h, p = x.shape
    chunk = min(int(chunk), s)
    if s % chunk:
        raise ValueError(f"ssd: seq {s} % chunk {chunk}")
    a, ld, cum, total, xb, bm, cm = _bwd_inputs(x, dt, a_log, b_mat, c_mat,
                                                chunk)
    dyc = dy.to(torch.float32).reshape(xb.shape)
    h_in = ssd_bwd_states(bm, xb, cum, total)
    dstate = ssd_bwd_carry(cm, dyc, cum, total)
    dxb, db, dc, dcum, dtotal = ssd_bwd_chunks(ld, cum, total, xb, bm, cm,
                                               dyc, h_in, dstate)
    dcum[:, :, -1] += dtotal
    dl = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])
    xf = x.to(torch.float32).reshape(xb.shape)
    dtf = dt.to(torch.float32).reshape(ld.shape)
    ddt = dl * a + (dxb * xf).sum(-1)
    dxf = dxb * dtf[..., None]
    dd = None
    if d_skip is not None:
        dxf = dxf + d_skip.to(torch.float32)[:, None] * dyc
        dd = (dyc * xf).sum((0, 1, 2, 4)).to(d_skip.dtype)
    da_log = ((dl * dtf).sum((0, 1, 2)) * a).to(a_log.dtype)
    n = b_mat.shape[-1]
    return (dxf.reshape(x.shape).to(x.dtype),
            ddt.reshape(dt.shape).to(dt.dtype), da_log,
            db.reshape(bsz, s, n).to(b_mat.dtype),
            dc.reshape(bsz, s, n).to(c_mat.dtype), dd)


def ssd_param_scales(x, dt, a_log, b_mat, c_mat, dy, chunk):
    """Per head, the sums of |terms| of ``ssd``'s d a_log (|a| sum |dl
    dt|, dl from the plain decomposition) and of d d_skip (sum |dy x|),
    f32: the scales that these sums over every (b, s) are held to."""
    f = [t.to(torch.float32) for t in (x, dt, b_mat, c_mat, dy)]
    a, ld, cum, total, xb, bm, cm = _bwd_inputs(f[0], f[1], a_log, f[2],
                                                f[3], chunk)
    dyc = f[4].reshape(xb.shape)
    h_in = ssd_bwd_states(bm, xb, cum, total)
    dstate = ssd_bwd_carry(cm, dyc, cum, total)
    _, _, _, dcum, dtotal = ssd_bwd_chunks(ld, cum, total, xb, bm, cm, dyc,
                                           h_in, dstate)
    dcum[:, :, -1] += dtotal
    dl = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])
    return (a.abs() * (dl * f[1].reshape(dl.shape)).abs().sum((0, 1, 2)),
            (f[4] * f[0]).abs().sum((0, 1, 3)))


class SSDFn(torch.autograd.Function):
    """``ssd`` under autograd on the card: forward kernel, backward kernel
    (from the saved inputs)."""

    @staticmethod
    def forward(ctx, x, dt, a_log, b_mat, c_mat, d_skip, chunk):
        y = ssd(x, dt, a_log, b_mat, c_mat, d_skip, chunk=chunk)
        ctx.save_for_backward(x, dt, a_log, b_mat, c_mat, d_skip)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, a_log, b_mat, c_mat, d_skip = ctx.saved_tensors
        grads = ssd_bwd(x, dt, a_log, b_mat, c_mat, d_skip, dy,
                        chunk=ctx.chunk)
        return (*grads, None)
