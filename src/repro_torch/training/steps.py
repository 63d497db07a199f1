"""Loss and train-step builders: the port's copy of
``repro.training.steps``.

``make_train_step`` returns ``(state, batch) -> (state, metrics)``.  The
state is ``{"model": Model, "opt": the optimizer's dict}`` (and ``"ef"``,
the error-feedback residuals, with ``grad_compression="int8_ef"``); the
step updates it in place and returns it.  Gradient accumulation runs the
microbatches one after another and sums their gradients in float32; remat
happens inside the model (``forward(training=True)`` checkpoints each
layer).  On the card the forward and backward of attention and of the
norms are the Hopper kernels (``kernels/ops.py``), on the CPU their plain
versions under autograd.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.common.config import ModelConfig, TrainConfig
from repro_torch.models import model as model_lib
from repro_torch.training import optimizer as opt
from repro_torch.training.schedules import make_schedule


def cross_entropy(logits, labels, mask=None, z_loss: float = 0.0):
    """Next-token CE.  logits: (B,S,V); labels: (B,S) already shifted."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def make_loss_fn(cfg: ModelConfig, tc: TrainConfig, num_groups: int = 1):
    def loss_fn(model, batch):
        logits, aux = model_lib.forward(
            model, batch["tokens"], cfg, enc=batch.get("enc"),
            num_groups=num_groups, training=True)
        mask = batch.get("mask")
        # predict token t+1 from position t
        ce = cross_entropy(logits[:, :-1], batch["labels"][:, 1:],
                           None if mask is None else mask[:, 1:], tc.z_loss)
        total = ce + tc.aux_loss_coef * aux
        return total, {"loss": total, "ce": ce, "aux": aux}
    return loss_fn


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) on ``device``: integer arrays as
    int64, floating ones as float32."""
    out = {}
    for k, v in batch.items():
        t = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
        t = t.float() if t.is_floating_point() else t.long()
        out[k] = t.to(device)
    return out


def train_state(model: model_lib.Model, tc: Optional[TrainConfig] = None
                ) -> Dict[str, Any]:
    """The train state around ``model`` (its parameters set to require
    gradients): AdamW's state with float32 masters, and the error-feedback
    residuals when ``tc`` compresses gradients."""
    for p in model.parameters():
        p.requires_grad_(True)
    params = dict(model.named_parameters())
    state = {"model": model, "opt": opt.adamw_init(params)}
    if tc is not None and tc.grad_compression == "int8_ef":
        state["ef"] = opt.ef_init(params)
    return state


def init_train_state(cfg: ModelConfig, seed: int = 0, device="cuda",
                     tc: Optional[TrainConfig] = None) -> Dict[str, Any]:
    return train_state(model_lib.init_model(cfg, seed, device), tc)


def checkpoint_tree(state) -> Dict[str, Any]:
    """The state as a checkpoint holds it, every leaf float32 or int32:
    ``params`` (the f32 master of a parameter stored in another dtype, else
    the parameter), the optimizer's ``mu``, ``nu`` and ``step``, and
    ``ef`` when present."""
    o = state["opt"]
    params = {k: o["master"].get(k, p.detach())
              for k, p in state["model"].named_parameters()}
    tree = {"params": params,
            "opt": {"mu": o["mu"], "nu": o["nu"], "step": o["step"]}}
    if "ef" in state:
        tree["ef"] = state["ef"]
    return tree


@torch.no_grad()
def load_checkpoint_tree(state, tree) -> Dict[str, Any]:
    """Copy a restored ``checkpoint_tree`` into ``state`` in place; a
    parameter with a master is rebuilt from it, so a resumed run continues
    bit for bit."""
    o = state["opt"]
    for k, p in state["model"].named_parameters():
        src = tree["params"][k]
        if k in o["master"]:
            o["master"][k].copy_(src)
            p.copy_(o["master"][k])
        else:
            p.copy_(src)
        o["mu"][k].copy_(tree["opt"]["mu"][k])
        o["nu"][k].copy_(tree["opt"]["nu"][k])
    o["step"] = tree["opt"]["step"].to(torch.int32).clone()
    for k, e in state.get("ef", {}).items():
        e.copy_(tree["ef"][k])
    return state


def _grads(params) -> Dict[str, torch.Tensor]:
    """The parameters' gradients (zeros for an unused one), taken off the
    parameters."""
    out = {}
    for k, p in params.items():
        out[k] = torch.zeros_like(p) if p.grad is None else p.grad
        p.grad = None
    return out


def make_train_step(cfg: ModelConfig, tc: TrainConfig, num_groups: int = 1):
    loss_fn = make_loss_fn(cfg, tc, num_groups)
    schedule = make_schedule(tc)

    def backward(model, batch):
        loss, metrics = loss_fn(model, batch)
        loss.backward()
        return {k: v.detach() for k, v in metrics.items()}

    def compute_grads(model, params, batch):
        if tc.microbatches <= 1:
            metrics = backward(model, batch)
            return _grads(params), metrics
        # gradient accumulation over microbatch splits of the batch, in f32
        mb = tc.microbatches
        g_acc, m_acc = None, None
        for i in range(mb):
            micro = {}
            for k, x in batch.items():
                b = x.shape[0]
                assert b % mb == 0, (b, mb)
                micro[k] = x.reshape(mb, b // mb, *x.shape[1:])[i]
            metrics = backward(model, micro)
            g = {k: v.float() for k, v in _grads(params).items()}
            if g_acc is None:
                g_acc, m_acc = g, metrics
            else:
                g_acc = {k: g_acc[k] + g[k] for k in g_acc}
                m_acc = {k: m_acc[k] + metrics[k] for k in m_acc}
        inv = 1.0 / mb
        return ({k: x * inv for k, x in g_acc.items()},
                {k: x * inv for k, x in m_acc.items()})

    def train_step(state, batch):
        model = state["model"]
        params = dict(model.named_parameters())
        grads, metrics = compute_grads(model, params,
                                       to_device(batch, model.device))
        if tc.grad_compression == "int8_ef":
            grads, state["ef"] = opt.compress_grads_ef(grads, state["ef"])
        lr = schedule(state["opt"]["step"])
        _, _, gnorm = opt.adamw_update(grads, state["opt"], params, lr, tc,
                                       clip=tc.grad_clip)
        return state, dict(metrics, grad_norm=gnorm, lr=lr)

    return train_step


def make_eval_step(cfg: ModelConfig, tc: TrainConfig, num_groups: int = 1):
    loss_fn = make_loss_fn(cfg, tc, num_groups)

    @torch.no_grad()
    def eval_step(model, batch):
        _, metrics = loss_fn(model, to_device(batch, model.device))
        return metrics

    return eval_step
