"""Pipeline parallelism: GPipe over a mesh axis (the port's copy of
``repro.training.pipeline``).

The layer stack repeats its block pattern ``num_periods`` times, so
pipelining falls out naturally: stage s of S runs periods ``[s R/S, (s+1)
R/S)`` and M microbatches drain in M + S - 1 rotor steps, bubble fraction
(S-1)/(M+S-1).

The reference runs every stage as one SPMD program and rotates the
activations with ``ppermute``.  The port is single-controller, as its
serving mesh is: one process drives every stage of a ``sharding.mesh.Mesh``
(whose devices may repeat: four stages on one card) and at rotor step t
runs stage s on microbatch t - s, its input moved from stage s - 1 with
``.to`` (the next stage's device).  Stage s's layers must live on that
stage's device.

Scope: embedding / tail layers / final norm / head run outside the
pipeline region, on the model's device; the pipelined region is the
period stack.  Forward only, as in the reference.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.common.config import ModelConfig
from repro_torch.models import blocks as blk
from repro_torch.models import model as model_lib


def stage_devices(mesh, stage_axis: str) -> List[torch.device]:
    """The device of each stage: index s on ``stage_axis``, 0 on the
    others."""
    grid = np.moveaxis(mesh.devices, mesh.axis_names.index(stage_axis), 0)
    return list(grid.reshape(grid.shape[0], -1)[:, 0])


def _stage_apply(layers, x, cfg: ModelConfig, positions, memo):
    for layer in layers:
        x, _ = blk.apply_block(layer, x, cfg, layer.kind, layer.attn_kind,
                               positions=positions, memo=memo)
    return x


@torch.no_grad()
def gpipe_apply(mesh, stage_axis: str, period_layers, x_mb,
                cfg: ModelConfig) -> torch.Tensor:
    """Pipeline the period stack over ``stage_axis``.

    period_layers: the stack's ``num_periods * pattern_period`` blocks in
                   order (R/S periods a stage).
    x_mb: (M, mb, S, D) microbatched embedded activations.
    Returns (M, mb, S, D) outputs of the full stack, on ``x_mb``'s device.
    """
    devs = stage_devices(mesh, stage_axis)
    n_stages, m = len(devs), x_mb.shape[0]
    if cfg.num_periods % n_stages:
        raise ValueError(f"{cfg.num_periods} periods over {n_stages} stages")
    per = cfg.num_periods // n_stages * cfg.pattern_period
    stages = [period_layers[s * per:(s + 1) * per] for s in range(n_stages)]
    for s, (layers, dev) in enumerate(zip(stages, devs)):
        if any(layer.norm1.device != dev for layer in layers):
            raise ValueError(f"stage {s}'s layers are not on {dev}")
    seq = x_mb.shape[2]
    positions = [torch.arange(seq, dtype=torch.int32, device=d) for d in devs]
    memos = [model_lib._rope_memo(cfg, p) for p in positions]

    outputs = [None] * m
    state = [None] * n_stages          # each stage's output of the last step
    for t in range(m + n_stages - 1):
        new = [None] * n_stages
        for s in range(n_stages):
            i = t - s                  # the microbatch stage s holds at t
            if not 0 <= i < m:
                continue
            x_in = x_mb[i] if s == 0 else state[s - 1]
            new[s] = _stage_apply(stages[s], x_in.to(devs[s]), cfg,
                                  positions[s], memos[s])
        # the last stage emits microbatch t - (S-1); the rest rotate
        if new[-1] is not None:
            outputs[t - (n_stages - 1)] = new[-1].to(x_mb.device)
        state = new
    return torch.stack(outputs)


@torch.no_grad()
def pipeline_forward(mesh, stage_axis: str, model: model_lib.Model, tokens,
                     cfg: ModelConfig, num_microbatches: int) -> torch.Tensor:
    """Full LM forward with the period stack pipelined.

    Embedding, tail layers, final norm and logits run outside the pipeline
    on the model's device.  Returns logits (B, S, V)."""
    b, s = tokens.shape[0], tokens.shape[1]
    if b % num_microbatches:
        raise ValueError(f"batch {b} over {num_microbatches} microbatches")
    x = model_lib._embed(model, tokens, cfg)
    x_mb = x.reshape(num_microbatches, b // num_microbatches, s, -1)

    n_stack = cfg.num_periods * cfg.pattern_period
    x_mb = gpipe_apply(mesh, stage_axis, model.layers[:n_stack], x_mb, cfg)
    x = x_mb.reshape(b, s, -1)

    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    memo = model_lib._rope_memo(cfg, positions)
    x = _stage_apply(model.layers[n_stack:], x, cfg, positions, memo)
    return model_lib._logits(model, x, cfg)


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    """GPipe bubble overhead: (S-1)/(M+S-1)."""
    return (num_stages - 1) / (num_microbatches + num_stages - 1)
