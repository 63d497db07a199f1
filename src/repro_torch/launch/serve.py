"""Serve CLI of the port: DDS-routed continuous serving on one device.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 16 --policy DDS
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu   # plain path

The path is the JAX CLI's: warm replicas -> profile pre-evaluation ->
two-level DDS routing -> SLO accounting.  Flags are those of
``repro.launch.serve`` without the paged-KV and chaos flags (not ported
yet), plus ``--device`` (default ``cuda``: the Hopper kernels) and
``--full`` (the arch's published widths; the smoke config otherwise).
Replicas share one set of weight tensors, drawn from seed 0.
"""
from __future__ import annotations

import argparse
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.policies import make_policy
from repro_torch.models import model as model_lib
from repro_torch.serving.engine import Replica, Request, ServingFleet
from repro_torch.serving.overload import PRIORITIES, BrownoutConfig


def build_fleet(cfg, policy_name: str, replicas: int = 2,
                slots: int = 2, capacity: int = 128,
                prefill_chunk_tokens: int = 32,
                step_slo_ms: float = 0.0,
                admission_margin: float = 0.0,
                brownout: bool = False, seed: int = 0,
                device="cuda", verbose: bool = True) -> ServingFleet:
    """A ``ServingFleet`` of ``replicas`` replicas that share one model
    drawn from ``seed`` on ``device``."""
    params = model_lib.init_model(cfg, seed, device)
    fleet = ServingFleet(make_policy(policy_name), source="replica0",
                         coordinator="replica1" if replicas > 1 else "replica0",
                         admission_margin=admission_margin)
    for i in range(replicas):
        rep = Replica(f"replica{i}", cfg, params, slots=slots,
                      capacity=capacity,
                      prefill_chunk_tokens=prefill_chunk_tokens,
                      step_slo_ms=step_slo_ms,
                      brownout=BrownoutConfig() if brownout else None)
        fleet.add_replica(rep)
        if verbose:
            print(f"replica{i}: warmup {rep.warmup_s:.2f}s on {rep.device}; "
                  f"chunked prefill "
                  f"{'on' if rep.prefill_caps['supported'] else 'off'} "
                  f"(budget ceiling {rep.prefill_chunk_tokens} tokens); "
                  f"ring KV")
    return fleet


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--full", action="store_true",
                    help="the arch's published widths (default: its smoke "
                         "config)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (Hopper kernels) or cpu (plain PyTorch)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--deadline-ms", type=float, default=10_000.0)
    ap.add_argument("--interval-ms", type=float, default=50.0)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--policy", default="DDS",
                    choices=["DDS", "DDS_EDF", "AOR", "AOE", "EODS", "JSQ"])
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="per-request sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="per-request top-k filter (0 = disabled)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="per-request nucleus (top-p) filter (1 = disabled)")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="sampling root; request i samples with seed+i")
    ap.add_argument("--prefill-chunk-tokens", type=int, default=32,
                    help="chunked-prefill budget CEILING per interleave slot")
    ap.add_argument("--step-slo-ms", type=float, default=0.0,
                    help="per-decode-step latency SLO: >0 shrinks the "
                         "prefill budget to the slack over the live step "
                         "time (0 = fixed ceiling)")
    ap.add_argument("--eos-id", type=int, default=-1,
                    help="stop decoding when this token id is emitted "
                         "(-1 = disabled)")
    ap.add_argument("--priority", default="interactive",
                    choices=list(PRIORITIES),
                    help="priority class for every request")
    ap.add_argument("--admission-margin", type=float, default=0.0,
                    help="reject a request whose deadline is below margin x "
                         "the best-case completion floor (0 = admit all)")
    ap.add_argument("--brownout", action="store_true",
                    help="arm queue-pressure brownout on each replica")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    fleet = build_fleet(cfg, args.policy, replicas=args.replicas,
                        prefill_chunk_tokens=args.prefill_chunk_tokens,
                        step_slo_ms=args.step_slo_ms,
                        admission_margin=args.admission_margin,
                        brownout=args.brownout, device=args.device)

    rng = np.random.default_rng(0)
    results: List = []
    with ThreadPoolExecutor(max_workers=8) as ex:
        futs = []
        for i in range(args.requests):
            prompt = rng.integers(2, cfg.vocab_size,
                                  size=(args.prompt_len,)).astype(np.int32)
            req = Request(i, prompt, args.new_tokens, args.deadline_ms,
                          temperature=args.temperature, top_k=args.top_k,
                          top_p=args.top_p, seed=args.sample_seed + i,
                          eos_id=args.eos_id if args.eos_id >= 0 else None,
                          priority=args.priority)
            futs.append(ex.submit(fleet.submit, req))
            time.sleep(args.interval_ms / 1e3)
        results = [f.result() for f in futs]

    met = sum(1 for r in results if r.met(args.deadline_ms))
    outcomes = {k: sum(1 for r in results if r.outcome == k)
                for k in ("ok", "rejected", "shed", "lost")}
    degraded = sum(1 for r in results if r.degraded)
    lats = sorted(r.latency_ms() for r in results)
    p50 = lats[len(lats) // 2]
    p99 = lats[min(int(len(lats) * 0.99), len(lats) - 1)]
    print(f"\npolicy={args.policy} requests={args.requests} met_SLO={met}"
          f" p50={p50:.0f}ms p99={p99:.0f}ms placements={fleet.stats}")
    print("outcomes: " + " ".join(f"{k}={v}" for k, v in outcomes.items())
          + f" degraded={degraded} browned_out={fleet.degraded()}")
    fleet.stop()


if __name__ == "__main__":
    main()
