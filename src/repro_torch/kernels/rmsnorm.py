"""Fused RMSNorm with the gemma-style ``(1 + scale)`` gain.

Kernel: a Triton kernel, replacing the TPU kernel
``repro/kernels/rmsnorm.py::rmsnorm`` (``_rmsnorm_kernel``), which the JAX
model never wires in (it normalises in jnp at ``models/layers.py:34/:42``);
the port runs it at both sites.

Bound on the card: bytes, 2 in and 2 out per bf16 element plus the gain.
One row reduction (f32 mean square) and one elementwise pass: the kernel
reads each row once into registers and writes it once.  Masked block loads
coalesce as well as hand-written CUDA would, which is why this one kernel
is Triton.  One program normalises one row of ``d_model`` (2560 wide, one
4096-wide block); the headwise qk-norm (D = 128) packs 16 rows into a
program so each moves a 4 KB tile instead of 256 bytes.

``rmsnorm`` launches the kernel on CUDA tensors; ``rmsnorm_plain`` is the
same function in plain PyTorch.  ``triton`` is imported inside the
launching function, so the module imports on machines without it.
"""
import threading

import torch

launches = 0                 # kernel launches (plain-version calls excluded)
_count_lock = threading.Lock()
_kernel = None


def _counted() -> None:
    global launches
    with _count_lock:
        launches += 1


def _triton_kernel():
    """Define (once) and return the Triton kernel."""
    global _kernel
    if _kernel is None:
        import triton
        import triton.language as tl

        # the kernel body resolves ``tl`` through the module's globals
        globals()["tl"] = tl

        @triton.jit(do_not_specialize=["n_rows"])
        def rmsnorm_kernel(x_ptr, scale_ptr, out_ptr, n_rows, d, eps,
                           ROWS: tl.constexpr, BLOCK_D: tl.constexpr):
            rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
            cols = tl.arange(0, BLOCK_D)
            col_ok = cols < d
            mask = (rows[:, None] < n_rows) & col_ok[None, :]
            offs = rows[:, None].to(tl.int64) * d + cols[None, :]
            x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            var = tl.sum(x * x, axis=1) / d
            y = x * tl.rsqrt(var + eps)[:, None]
            gain = 1.0 + tl.load(scale_ptr + cols, mask=col_ok,
                                 other=0.0).to(tl.float32)
            tl.store(out_ptr + offs,
                     (y * gain[None, :]).to(out_ptr.dtype.element_ty),
                     mask=mask)

        _kernel = rmsnorm_kernel
    return _kernel


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """Launch the Triton kernel.  x: (..., D) contiguous; scale: (D,).
    Returns x's shape and dtype.  CUDA tensors only."""
    if x.device.type != "cuda":
        raise RuntimeError("rmsnorm kernel needs CUDA tensors; use "
                           "rmsnorm_plain on the CPU")
    d = x.shape[-1]
    if scale.shape != (d,) or scale.device != x.device:
        raise ValueError(f"rmsnorm: scale {tuple(scale.shape)} on "
                         f"{scale.device} for x {tuple(x.shape)} on {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rmsnorm: dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("rmsnorm: x must be contiguous")
    import triton
    rows = x.numel() // d
    out = torch.empty_like(x)
    block_d = triton.next_power_of_2(d)
    per_prog = max(1, min(16, 2048 // block_d))
    grid = (triton.cdiv(rows, per_prog),)
    with torch.cuda.device(x.device):
        _triton_kernel()[grid](x, scale, out, rows, d, eps, ROWS=per_prog,
                               BLOCK_D=block_d,
                               num_warps=8 if block_d >= 2048 else 4)
    _counted()
    return out


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
                  ) -> torch.Tensor:
    """The same function in plain PyTorch (the CPU path and the oracle)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)
