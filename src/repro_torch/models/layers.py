"""Core layers: initializers, norms, MLPs, embeddings.

Plain functions over tensors; the parameters live in the ``nn.Module``s of
``repro_torch.models.model``.  ``rmsnorm`` goes through ``ops.rmsnorm``:
the CUDA norm kernel on the card, its plain version on the CPU (the norm's
fused forms are called where they apply: the qk pair in ``attention``,
the residual add in ``blocks``, the gate in ``ssm``).
"""
from __future__ import annotations

import math
import threading

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.kernels import ops


# ----------------------------------------------------------------- init utils
def dense_init_(t: torch.Tensor, in_axis: int, gen: torch.Generator):
    """Truncated-normal fan-in init (1/sqrt(fan_in), cut at 2 std), drawn in
    float32 and stored in ``t``'s dtype."""
    std = 1.0 / math.sqrt(t.shape[in_axis])
    tmp = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    torch.nn.init.trunc_normal_(tmp, 0.0, std, -2.0 * std, 2.0 * std,
                                generator=gen)
    t.copy_(tmp)


def embed_init_(t: torch.Tensor, gen: torch.Generator):
    tmp = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    tmp.normal_(generator=gen)
    t.copy_(tmp)


# ---------------------------------------------------------------------- norms
def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    """Gemma-style ``(1 + scale)`` RMSNorm over the last axis."""
    return ops.rmsnorm(x.contiguous(), scale, eps)


# ----------------------------------------------------------------------- mlps
_cpu_exp_lock = threading.Lock()
_cpu_exp_ready = False


def _first_cpu_exp() -> None:
    """The process's first CPU ``torch.exp``, on one element and so on this
    thread alone, once.  PyTorch's CPU ``exp`` is MKL's VML ``vmsExp`` in
    its high-accuracy mode, run by each of PyTorch's threads on its share
    of the tensor.  When the first call of a process runs on several
    threads at once, now and then (3% of fresh processes at two threads)
    the calling thread computes the first ~15k elements of its share with
    a far coarser approximation, up to 1.5e-4 relative, and the same call
    again is exact.  No process whose first call ran on one thread showed
    it."""
    global _cpu_exp_ready
    with _cpu_exp_lock:
        if not _cpu_exp_ready:
            torch.exp(torch.zeros(1))
            _cpu_exp_ready = True


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference rounds it: the logistic as
    ``1 / (1 + exp(-x))``, then the product, each operation rounded to x's
    dtype (XLA's expansion of ``lax.logistic``; ``F.silu`` rounds once,
    which moves a bf16 product by a spacing now and then).  The MoE FFNs
    use it; ``mlp`` keeps ``F.silu`` (one launch in place of four).  On the
    CPU the process's first ``exp`` runs serially first
    (``_first_cpu_exp``)."""
    if x.device.type == "cpu" and not _cpu_exp_ready:
        _first_cpu_exp()
    return x * torch.reciprocal(torch.exp(-x) + 1.0)


def mlp(p, x: torch.Tensor, kind: str = "swiglu"):
    up = x @ p["w_up"]
    if kind == "swiglu":
        act = F.silu(x @ p["w_gate"]) * up
    elif kind == "geglu":
        # jax.nn.gelu defaults to the tanh approximation
        act = F.gelu(x @ p["w_gate"], approximate="tanh") * up
    elif kind == "gelu":
        act = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(kind)
    return act @ p["w_down"]


# ----------------------------------------------------------------- embeddings
def embed(table: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig):
    """Rows of ``table`` times sqrt(d_model), the scalar rounded to the
    compute dtype first, as the reference does."""
    out = F.embedding(tokens.long(), table).to(cfg.dtype)
    return out * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype,
                              device=out.device)


def logits_head(table: torch.Tensor, x: torch.Tensor, cfg: ModelConfig,
                head: torch.Tensor = None):
    """Project to vocab.  Tied: ``(x * 1/sqrt(d)) @ table.T`` with the
    scalar in x's dtype; untied: ``x @ head``."""
    if head is not None:
        return x @ head
    scale = torch.tensor(1.0 / math.sqrt(cfg.d_model), dtype=x.dtype,
                         device=x.device)
    return (x * scale) @ table.T
