"""End-to-end training loop and CLI: the port's copy of ``repro.launch.train``.

Wires together: config -> model init (bf16 weights with f32 masters at
full width) -> train step (the Hopper kernels' forward and backward on the
card) -> synthetic data pipeline -> checkpoint manager (async, atomic) ->
straggler monitor.  One device: ``--device`` (default ``cuda``, an error
without a card) stands where the reference builds its mesh, and the MoE
capacity runs in one group.

  python -m repro_torch.launch.train --arch qwen3-4b --steps 6 --batch 2 \\
      --seq 1024
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --smoke --device cpu --steps 20
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.common.config import ModelConfig, TrainConfig
from repro_torch.common.device import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticDataset
from repro_torch.ft.monitor import StragglerMonitor
from repro_torch.training import steps as steps_lib


def train_loop(cfg: ModelConfig, tc: TrainConfig, *, global_batch: int,
               seq_len: int, steps: int, ckpt_dir: Optional[str] = None,
               ckpt_every: int = 0, resume: bool = False,
               log_every: int = 10, device="cuda",
               monitor: Optional[StragglerMonitor] = None,
               log_fn=print) -> Dict[str, Any]:
    dev = resolve_device(device)
    ds = SyntheticDataset(cfg, DataConfig(global_batch=global_batch,
                                          seq_len=seq_len, seed=tc.seed))
    state = steps_lib.init_train_state(cfg, tc.seed, dev, tc)

    start_step = 0
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if resume and mgr and mgr.latest_step() is not None:
        start_step = mgr.latest_step()
        tree = mgr.restore(start_step, steps_lib.checkpoint_tree(state))
        steps_lib.load_checkpoint_tree(state, tree)
        log_fn(f"resumed from step {start_step}")

    train_step = steps_lib.make_train_step(cfg, tc, num_groups=1)

    history = []
    t_start = time.perf_counter()
    for step in range(start_step, start_step + steps):
        batch = ds.batch(step)
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}   # syncs
        dt_ms = (time.perf_counter() - t0) * 1e3
        if monitor is not None:
            monitor.observe("host0", dt_ms)
        history.append({"step": step + 1, "ms": dt_ms, **metrics})
        if log_every and (step + 1) % log_every == 0:
            m = history[-1]
            log_fn(f"step {m['step']:5d} loss {m['loss']:.4f} "
                   f"ce {m['ce']:.4f} gnorm {m['grad_norm']:.3f} "
                   f"lr {m['lr']:.2e} {dt_ms:.0f}ms")
        if mgr and ckpt_every and (step + 1) % ckpt_every == 0:
            mgr.save_async(step + 1, steps_lib.checkpoint_tree(state))
    if mgr:
        mgr.wait()
        mgr.save(start_step + steps, steps_lib.checkpoint_tree(state))
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
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tc = TrainConfig(learning_rate=args.lr, schedule=args.schedule,
                     total_steps=args.steps,
                     warmup_steps=max(args.steps // 10, 1),
                     microbatches=args.microbatches)
    out = train_loop(cfg, tc, global_batch=args.batch, seq_len=args.seq,
                     steps=args.steps, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, resume=args.resume,
                     device=args.device)
    print(f"done: {args.steps} steps in {out['wall_s']:.1f}s, "
          f"final loss {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
