"""End-to-end training loop and CLI: the port's copy of ``repro.launch.train``.

Wires together: config -> model init (bf16 weights with f32 masters at
full width) -> train step (the Hopper kernels' forward and backward on the
card) -> synthetic data pipeline -> checkpoint manager (async, atomic) ->
straggler monitor.  Without a mesh it runs on one device (``--device``,
default ``cuda``, an error without a card) with the MoE capacity in one
group.  Given a ``DeviceMesh`` (the CLI builds one with ``--dp``/``--tp``,
or under ``torchrun``) it places the state by ``sharding.specs``
(``sharding.placement``) and runs the sharded step, the MoE capacity in
one group a data rank, as the reference's ``num_groups = data ways``.

  python -m repro_torch.launch.train --arch qwen3-4b --steps 6 --batch 2 \\
      --seq 1024
  torchrun --nproc_per_node 1 -m repro_torch.launch.train --arch qwen3-4b \\
      --dp 1 --steps 6 --batch 2 --seq 1024
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --smoke --device cpu --steps 20
"""
from __future__ import annotations

import argparse
import time
from functools import partial
from typing import Any, Dict, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.common.config import ModelConfig, TrainConfig
from repro_torch.common.device import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticDataset
from repro_torch.ft.elastic import reshard_leaf
from repro_torch.ft.monitor import StragglerMonitor
from repro_torch.launch import multihost
from repro_torch.launch.mesh import parallel_config_for
from repro_torch.sharding import placement
from repro_torch.training import steps as steps_lib


def train_loop(cfg: ModelConfig, tc: TrainConfig, *, global_batch: int,
               seq_len: int, steps: int, ckpt_dir: Optional[str] = None,
               ckpt_every: int = 0, resume: bool = False,
               log_every: int = 10, device="cuda", mesh=None,
               monitor: Optional[StragglerMonitor] = None,
               log_fn=print) -> Dict[str, Any]:
    """``steps`` train steps.  With ``mesh`` every rank calls it, the
    device is the mesh's, and only rank 0 logs and writes checkpoints
    (every rank takes part in their gathers, one leaf at a time)."""
    rank = 0
    if mesh is None:
        dev = resolve_device(device)
    else:
        import torch.distributed as dist
        rank = dist.get_rank()
        dev = resolve_device(mesh.device_type)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
    log = log_fn if rank == 0 else (lambda *_: None)
    ds = SyntheticDataset(cfg, DataConfig(global_batch=global_batch,
                                          seq_len=seq_len, seed=tc.seed))
    state = steps_lib.init_train_state(cfg, tc.seed, dev, tc)
    num_groups = 1
    if mesh is not None:
        num_groups = parallel_config_for(mesh).data_ways
        state, specs = placement.place_by_specs(state, mesh)

    start_step = 0
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if resume and mgr and mgr.latest_step() is not None:
        start_step = mgr.latest_step()
        template = placement.state_tree(state)
        del template["opt"]["master"]
        tree = mgr.restore(start_step, template)
        place = None if mesh is None else partial(
            reshard_leaf, mesh=mesh, spec_fn=specs.__getitem__)
        steps_lib.load_checkpoint_tree(state, tree, place)
        log(f"resumed from step {start_step}")

    train_step = steps_lib.make_train_step(cfg, tc, num_groups=num_groups,
                                           mesh=mesh)

    history = []
    t_start = time.perf_counter()
    for step in range(start_step, start_step + steps):
        batch = ds.batch(step)
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}   # syncs
        dt_ms = (time.perf_counter() - t0) * 1e3
        if monitor is not None:
            monitor.observe(f"host{rank}", dt_ms)
        history.append({"step": step + 1, "ms": dt_ms, **metrics})
        if log_every and (step + 1) % log_every == 0:
            m = history[-1]
            log(f"step {m['step']:5d} loss {m['loss']:.4f} "
                f"ce {m['ce']:.4f} gnorm {m['grad_norm']:.3f} "
                f"lr {m['lr']:.2e} {dt_ms:.0f}ms")
        if mgr and ckpt_every and (step + 1) % ckpt_every == 0:
            tree = steps_lib.checkpoint_tree(state)
            if rank == 0:
                mgr.save_async(step + 1, tree)
            del tree
    if mgr:
        tree = steps_lib.checkpoint_tree(state)
        if rank == 0:
            mgr.wait()
            mgr.save(start_step + steps, tree)
        del tree
        if mesh is not None:
            torch.distributed.barrier()
    wall = time.perf_counter() - t_start
    return {"state": state, "history": history, "wall_s": wall,
            "final_loss": history[-1]["loss"] if history else float("nan")}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="cosine",
                    choices=["cosine", "wsd", "linear", "constant"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--dp", type=int, default=None,
                    help="data-parallel ways: train sharded over a mesh of "
                         "the process group's ranks (as under torchrun)")
    ap.add_argument("--tp", type=int, default=None,
                    help="model-axis ways of that mesh")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tc = TrainConfig(learning_rate=args.lr, schedule=args.schedule,
                     total_steps=args.steps,
                     warmup_steps=max(args.steps // 10, 1),
                     microbatches=args.microbatches)
    mesh = None
    if args.dp or args.tp or multihost.detect_cluster().is_multiprocess:
        env = multihost.initialize(device=args.device)
        mesh = multihost.global_mesh(args.dp, args.tp, device=args.device)
    try:
        out = train_loop(cfg, tc, global_batch=args.batch, seq_len=args.seq,
                         steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every, resume=args.resume,
                         device=args.device, mesh=mesh)
        if mesh is None or env.process_id == 0:
            print(f"done: {args.steps} steps in {out['wall_s']:.1f}s, "
                  f"final loss {out['final_loss']:.4f}")
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
