"""Core layers: initializers, norms, MLPs, embeddings.

Plain functions over tensors; the parameters live in the ``nn.Module``s of
``repro_torch.models.model``.  Both norms go through ``ops.rmsnorm``, the
Triton kernel on the card and its plain version on the CPU.
"""
from __future__ import annotations

import math

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


def rmsnorm_headwise(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    """qk-norm: normalise the trailing head_dim of (..., H, D) tensors."""
    return ops.rmsnorm(x.contiguous(), scale, eps)


# ----------------------------------------------------------------------- mlps
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
