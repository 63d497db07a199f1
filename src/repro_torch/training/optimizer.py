"""AdamW with decoupled weight decay, global-norm clipping and int8
error-feedback gradient compression: the port's copy of
``repro.training.optimizer`` (no ``torch.optim``).

Parameters, gradients and state are flat dicts of tensors keyed by
parameter name.  The state is ``{"mu", "nu": f32 dicts, "master": f32
copies of the parameters stored in another dtype, "step": int32 scalar}``.

**Float32 masters.**  The reference keeps its parameters in float32 and
casts them to the compute dtype at each use.  The port stores a parameter
in the compute dtype (bf16 at full width), so for each such parameter the
optimizer keeps a float32 master, updates it, and writes ``master`` cast to
the parameter's dtype back into the parameter.  The gradient of a bf16
parameter is the reference's gradient of its f32 master (the cotangent of
the cast), so this computes what the reference computes.

**In place, one tensor at a time.**  ``mu``, ``nu``, the masters and the
parameters are updated in place to save memory, and ``adamw_update`` casts
each gradient to float32, clips and applies it, and frees it before it
takes the next: at qwen3-4b's full width an f32 copy of every gradient at
once (16 GB) does not fit on one card beside the state.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.common.config import TrainConfig
from repro_torch.common.tree import tree_global_norm, tree_zeros_like

Tensors = Dict[str, torch.Tensor]


# ------------------------------------------------------------------- AdamW
def adamw_init(params: Tensors) -> dict:
    """Zero moments in float32 and an f32 master of every parameter that is
    not float32."""
    f32 = torch.float32
    return {
        "mu": tree_zeros_like(params, f32),
        "nu": tree_zeros_like(params, f32),
        "master": {k: p.detach().to(f32) for k, p in params.items()
                   if p.dtype != f32},
        "step": torch.zeros((), dtype=torch.int32),
    }


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-12), 1.0)


def clip_by_global_norm(grads: Tensors, max_norm: float
                        ) -> Tuple[Tensors, torch.Tensor]:
    """(grads scaled to a global norm of at most ``max_norm``, the norm)."""
    norm = tree_global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {k: g * scale.to(g.device) for k, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(grads: Tensors, opt_state: dict, params: Tensors, lr,
                 tc: TrainConfig, clip: Optional[float] = None,
                 norm: Optional[torch.Tensor] = None
                 ) -> Tuple[Tensors, dict, Optional[torch.Tensor]]:
    """One AdamW step, in place (module docstring).  ``grads`` is emptied
    as it goes: each gradient is dropped once applied.  With ``clip`` set
    the global norm is taken first (``norm`` when given: a sharded state's,
    over every rank's shards) and every gradient is scaled by
    ``min(1, clip / norm)`` as it is cast (``clip_by_global_norm``, one
    tensor at a time).  Returns (params, opt_state, the global norm, None
    without ``clip``)."""
    scale = None
    if clip is not None:
        norm = tree_global_norm(grads) if norm is None else norm
        scale = _clip_scale(norm, clip)
    step = opt_state["step"] + 1
    opt_state["step"] = step
    b1, b2 = tc.beta1, tc.beta2
    t = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32), t)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32), t)
    lr = torch.as_tensor(lr, dtype=torch.float32)
    on = {}                    # the scalars on each parameter's device

    def scalars(dev):
        if dev not in on:
            on[dev] = [None if x is None else x.to(dev)
                       for x in (c1, c2, lr, scale)]
        return on[dev]

    for name in list(grads):
        g = grads.pop(name)
        p = params[name]
        c1_, c2_, lr_, scale_ = scalars(p.device)
        g32 = g.to(torch.float32, copy=True)
        del g
        if scale_ is not None:
            g32.mul_(scale_)
        mu, nu = opt_state["mu"][name], opt_state["nu"][name]
        mu.mul_(b1).add_(g32, alpha=1 - b1)
        nu.mul_(b2).addcmul_(g32, g32, value=1 - b2)
        master = opt_state["master"].get(name)
        p32 = p if master is None else master
        # delta = (mu / c1) / (sqrt(nu / c2) + eps) + wd * p, in the
        # reference's order of operations; g32 is reused as scratch
        den = torch.div(nu, c2_, out=g32).sqrt_().add_(tc.eps)
        delta = torch.div(mu, c1_).div_(den)
        del den, g32
        delta.add_(p32 * tc.weight_decay)
        p32.sub_(delta.mul_(lr_))
        del delta
        if master is not None:
            p.copy_(master)
    return params, opt_state, norm


# -------------------------------------------------- int8 error-feedback comp.
def ef_init(params: Tensors) -> Tensors:
    """Error-feedback residual buffers, float32."""
    return tree_zeros_like(params, torch.float32)


def quantize_int8(x: torch.Tensor, amax: Optional[torch.Tensor] = None):
    """Per-tensor symmetric int8 quantization.  Returns (q, scale).
    ``amax``: the largest |x| when ``x`` is a shard of the tensor."""
    amax = x.abs().max() if amax is None else amax
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_grads_ef(grads: Tensors, ef_state: Tensors, amax_fn=None
                      ) -> Tuple[Tensors, Tensors]:
    """g' = Q(g + e); e_new = (g + e) - g'.  Returns (decompressed, ef_new),
    one leaf at a time.  ``amax_fn(t)``: the largest |.| of the whole leaf
    whose shard is ``t`` (a sharded state's; by default ``t``'s own)."""
    deq, ef = {}, {}
    for name, g in grads.items():
        t = g.to(torch.float32) + ef_state[name]
        d = dequantize_int8(*quantize_int8(
            t, None if amax_fn is None else amax_fn(t)))
        deq[name] = d
        ef[name] = g.to(torch.float32) + ef_state[name] - d
    return deq, ef
