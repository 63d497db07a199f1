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
from repro_torch.common.tree import unflatten
from repro_torch.models import model as model_lib
from repro_torch.sharding import placement as pl
from repro_torch.training import optimizer as opt
from repro_torch.training.schedules import make_schedule


def _nll(logits, labels, z_loss: float = 0.0):
    """Each position's negative log-likelihood (plus the z-loss), f32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    return nll


def cross_entropy(logits, labels, mask=None, z_loss: float = 0.0):
    """Next-token CE.  logits: (B,S,V); labels: (B,S) already shifted."""
    nll = _nll(logits, labels, z_loss)
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


def checkpoint_tree(state) -> Optional[Dict[str, Any]]:
    """The state as a checkpoint holds it, every leaf float32 or int32:
    ``params`` (the f32 master of a parameter stored in another dtype, else
    the parameter), the optimizer's ``mu``, ``nu`` and ``step``, and
    ``ef`` when present.  A sharded state's leaves are gathered whole one
    at a time (every rank calls it) and copied to the host on rank 0, so
    no rank holds more than one whole leaf on its device; rank 0 gets the
    host tree, the others ``None``.  The checkpoint does not depend on the
    mesh."""
    o = state["opt"]
    leaves = {f"params/{k}": o["master"].get(k, p.detach())
              for k, p in state["model"].named_parameters()}
    for part in ("mu", "nu"):
        leaves.update((f"opt/{part}/{k}", t) for k, t in o[part].items())
    leaves["opt/step"] = o["step"]
    leaves.update((f"ef/{k}", t) for k, t in state.get("ef", {}).items())
    if not hasattr(o["step"], "full_tensor"):
        return unflatten(leaves)
    import torch.distributed as dist

    host = {} if dist.get_rank() == 0 else None
    for path, t in leaves.items():
        full = t.full_tensor()
        if host is not None:
            host[path] = full.to("cpu", copy=True)
        del full
    return None if host is None else unflatten(host)


@torch.no_grad()
def load_checkpoint_tree(state, tree, place=None) -> Dict[str, Any]:
    """Copy a restored ``checkpoint_tree`` into ``state`` in place; a
    parameter with a master is rebuilt from it, so a resumed run continues
    bit for bit.  A sharded state takes its shard of each leaf:
    ``place(path, leaf)`` puts a restored leaf on the state's mesh
    (``ft.elastic.reshard_leaf``), one leaf at a time, so no placed copy of
    the whole tree is ever held."""
    o = state["opt"]

    def src(path: str) -> torch.Tensor:
        node = tree
        for key in path.split("/"):
            node = node[key]
        return pl.local(node if place is None else place(path, node))

    for k, p in state["model"].named_parameters():
        if k in o["master"]:
            pl.local(o["master"][k]).copy_(src(f"params/{k}"))
            pl.local(p).copy_(pl.local(o["master"][k]))
        else:
            pl.local(p).copy_(src(f"params/{k}"))
        for part in ("mu", "nu"):
            pl.local(o[part][k]).copy_(src(f"opt/{part}/{k}"))
    step = src("opt/step")
    if hasattr(o["step"], "to_local"):
        pl.local(o["step"]).copy_(step)
    else:
        o["step"] = step.to(torch.int32).clone()
    for k, e in state.get("ef", {}).items():
        pl.local(e).copy_(src(f"ef/{k}"))
    return state


def _grads(params) -> Dict[str, torch.Tensor]:
    """The parameters' gradients (zeros for an unused one), taken off the
    parameters."""
    out = {}
    for k, p in params.items():
        out[k] = torch.zeros_like(p) if p.grad is None else p.grad
        p.grad = None
    return out


def make_train_step(cfg: ModelConfig, tc: TrainConfig, num_groups: int = 1,
                    mesh=None):
    """The train step.  With a ``DeviceMesh`` the state must be placed on
    it (``sharding.placement.place_state``) and the step runs sharded
    (``_sharded_train_step``); ``num_groups`` is then the MoE FFN's
    capacity groups over each global microbatch, as the reference's
    ``num_groups = data ways``."""
    if mesh is not None:
        return _sharded_train_step(cfg, tc, num_groups, mesh)
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


def _sharded_train_step(cfg: ModelConfig, tc: TrainConfig, num_groups: int,
                        mesh):
    """The train step over a state placed on ``mesh``, with the reference's
    semantics over the whole global batch, which every rank is given.

    * Rows: microbatch m is rows ``[m b/M, (m+1) b/M)`` of the batch, as in
      the reference; each is split over the batch axes' ranks, and this
      rank runs its own contiguous part (``placement.batch_rows``).  The
      model axis's ranks run their data group's rows again.
    * Loss: ``sum(nll * mask) / sum(mask)`` over the whole microbatch: the
      masks' sums are all-reduced first, so every rank divides its own sum
      by the global count, and the gradients are summed over ranks, never
      averaged.  The MoE balance loss is the mean over the microbatch's
      ``num_groups`` groups: this rank runs its ``num_groups / ways`` of
      them and adds its share.
    * Gradients come back reduced to each leaf's shard
      (``placement.GatheredModel``); microbatches add up in f32 and are
      averaged, as in the unsharded step.  ``int8_ef`` quantizes each leaf
      by its amax over the whole leaf.  The norm for clipping sums every
      leaf's squares once (``placement.global_sq_norm_terms``), and AdamW
      updates each rank's shards in place, masters included."""
    import torch.distributed as dist

    schedule = make_schedule(tc)
    mb = max(tc.microbatches, 1)
    rank, ways = pl.batch_rows(mesh)
    if cfg.num_experts and num_groups % ways:
        raise ValueError(f"{num_groups} MoE groups over {ways} data ranks: "
                         "a group would straddle ranks")
    groups = max(num_groups // ways, 1)       # this rank's groups
    views: Dict[int, pl.GatheredModel] = {}

    def spans(b: int, s: int):
        """This rank's (first, last + 1) row of each microbatch."""
        per = b // mb // ways
        if b % mb or (b // mb) % ways or (cfg.num_experts and
                                            per * s % groups):
            raise ValueError(f"a batch of {b} x {s} does not split into "
                             f"{mb} microbatches over {ways} data ranks"
                             + (f" and {groups} groups a rank"
                                if cfg.num_experts else ""))
        return [(m * (b // mb) + rank * per, m * (b // mb) + (rank + 1) * per)
                for m in range(mb)]

    def train_step(state, batch):
        model = state["model"]
        view = views.get(id(model))
        if view is None:
            view = views[id(model)] = pl.GatheredModel(model, mesh)
        b, s = batch["tokens"].shape[:2]
        micros = [to_device({k: v[lo:hi] for k, v in batch.items()},
                            model.device) for lo, hi in spans(b, s)]
        masks = [m["mask"][:, 1:].float() if "mask" in m else
                 torch.ones_like(m["labels"][:, 1:], dtype=torch.float32)
                 for m in micros]
        counts = pl.all_reduce_over(torch.stack([x.sum() for x in masks]),
                                    mesh, pl.BATCH_AXES)
        leaves = view.leaves(model)
        names = list(leaves)
        g_acc, m_acc = None, None
        for micro, mask, count in zip(micros, masks, counts):
            logits, aux = view.forward(leaves, micro["tokens"],
                                       enc=micro.get("enc"),
                                       num_groups=groups, training=True)
            nll = _nll(logits[:, :-1], micro["labels"][:, 1:], tc.z_loss)
            ce = torch.sum(nll * mask) / torch.clamp_min(count, 1.0)
            aux = aux * (groups / max(num_groups, 1))
            total = ce + tc.aux_loss_coef * aux
            gs = torch.autograd.grad(total, [leaves[n] for n in names],
                                     allow_unused=True)
            g = {n: torch.zeros_like(leaves[n]) if x is None else x
                 for n, x in zip(names, gs)}
            metrics = torch.stack([total, ce, aux]).detach()
            if mb == 1:
                g_acc, m_acc = g, metrics
            elif g_acc is None:
                g_acc, m_acc = {k: x.float() for k, x in g.items()}, metrics
            else:
                g_acc = {k: g_acc[k] + g[k].float() for k in g_acc}
                m_acc = m_acc + metrics
        del leaves
        if mb > 1:
            g_acc = {k: x * (1.0 / mb) for k, x in g_acc.items()}
            m_acc = m_acc * (1.0 / mb)
        m_acc = pl.all_reduce_over(m_acc, mesh, pl.BATCH_AXES)
        params = dict(model.named_parameters())
        grads = g_acc
        if tc.grad_compression == "int8_ef":
            def amax(t):
                a = t.abs().max().reshape(1)
                return pl.all_reduce_over(a, mesh, mesh.mesh_dim_names,
                                          dist.ReduceOp.MAX)[0]
            ef = {k: pl.local(t) for k, t in state["ef"].items()}
            grads, ef_new = opt.compress_grads_ef(grads, ef, amax)
            for k, t in ef_new.items():
                ef[k].copy_(t)
        gnorm = pl.global_sq_norm_terms(grads, params, mesh).sum().sqrt()
        o = state["opt"]
        shards = {part: {k: pl.local(t) for k, t in o[part].items()}
                  for part in ("mu", "nu", "master")}
        shards["step"] = pl.local(o["step"]).cpu()
        lr = schedule(shards["step"])
        opt.adamw_update(grads, shards, {k: pl.local(p) for k, p in
                                         params.items()},
                         lr, tc, clip=tc.grad_clip, norm=gnorm)
        pl.local(o["step"]).copy_(shards["step"])
        loss, ce, aux = m_acc
        return state, {"loss": loss, "ce": ce, "aux": aux, "grad_norm": gnorm,
                       "lr": lr}

    return train_step


def make_eval_step(cfg: ModelConfig, tc: TrainConfig, num_groups: int = 1):
    loss_fn = make_loss_fn(cfg, tc, num_groups)

    @torch.no_grad()
    def eval_step(model, batch):
        _, metrics = loss_fn(model, to_device(batch, model.device))
        return metrics

    return eval_step
