"""Serve CLI of the port: DDS-routed continuous serving on one device.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 16 --policy DDS
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu   # plain path
  PYTHONPATH=src python -m repro_torch.launch.serve --paged --prefix-cache
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b --paged
  PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-medium --prefix-cache
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --chaos crash

The path is the JAX CLI's: warm replicas -> profile pre-evaluation ->
two-level DDS routing -> SLO accounting.  Flags are those of
``repro.launch.serve``, plus
``--device`` (default ``cuda``: the Hopper kernels) and ``--full`` (the
arch's published widths; on the CPU the smoke config otherwise).  On the
card the published widths are always served: the attention kernels take
head_dim 64, 128 or 256, and the smoke configs' head_dim is 16.  ``--paged`` swaps
the per-lane rings for block tables over a shared page pool
(``--page-size``/``--num-pages``), and ``--prefix-cache`` (which implies
``--paged``) adds cross-request prefix reuse.  Replicas share one set of
weight tensors, drawn from seed 0.  ``--chaos crash|hang|slow|partition``
injects that fault into ``replica0`` at ``--chaos-at-ms`` after the first
request (``slow`` at 4x) and ends the run with a chaos summary: requests
failed and failed over, the fleet's losses and the replicas it evicted.
``--arch llama-3.2-vision-90b`` raises ``ValueError``: its cross-attention
layers need per-request encoder states, which no request carries (the
model functions take ``enc``).
"""
from __future__ import annotations

import argparse
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.policies import make_policy
from repro_torch.ft import faults
from repro_torch.models import model as model_lib
from repro_torch.serving.engine import (Replica, Request, ServingFleet,
                                       refuse_cross)
from repro_torch.serving.overload import PRIORITIES, BrownoutConfig


def build_fleet(cfg, policy_name: str, replicas: int = 2,
                slots: int = 2, capacity: int = 128,
                prefill_chunk_tokens: int = 32,
                step_slo_ms: float = 0.0,
                admission_margin: float = 0.0,
                brownout: bool = False,
                paged: bool = False, page_size: int = 16,
                num_pages: int = 0, prefix_cache: bool = False,
                seed: int = 0, device="cuda",
                verbose: bool = True) -> ServingFleet:
    """A ``ServingFleet`` of ``replicas`` replicas that share one model
    drawn from ``seed`` on ``device``.  A stack no replica can serve (one
    with cross-attention layers) is refused before any weight is drawn."""
    refuse_cross(cfg, "replica0")
    params = model_lib.init_model(cfg, seed, device)
    fleet = ServingFleet(make_policy(policy_name), source="replica0",
                         coordinator="replica1" if replicas > 1 else "replica0",
                         admission_margin=admission_margin)
    for i in range(replicas):
        rep = Replica(f"replica{i}", cfg, params, slots=slots,
                      capacity=capacity,
                      prefill_chunk_tokens=prefill_chunk_tokens,
                      step_slo_ms=step_slo_ms,
                      brownout=BrownoutConfig() if brownout else None,
                      paged=paged, page_size=page_size,
                      num_pages=num_pages if num_pages > 0 else None,
                      prefix_cache=prefix_cache)
        fleet.add_replica(rep)
        if verbose:
            paging = (f"paged KV ({rep.num_pages} pages x {rep.page_size} tok"
                      f"{', prefix cache' if prefix_cache else ''})"
                      if paged else "ring KV")
            print(f"replica{i}: warmup {rep.warmup_s:.2f}s on {rep.device}; "
                  f"chunked prefill "
                  f"{'on' if rep.prefill_caps['supported'] else 'off'} "
                  f"(budget ceiling {rep.prefill_chunk_tokens} tokens); "
                  f"{paging}")
    return fleet


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--full", action="store_true",
                    help="the arch's published widths (always on the card; "
                         "on the CPU the smoke config otherwise)")
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
    ap.add_argument("--chaos", default="",
                    choices=["", "crash", "hang", "slow", "partition"],
                    help="inject this fault into the source replica mid-run "
                         "(empty = no chaos)")
    ap.add_argument("--chaos-at-ms", type=float, default=500.0,
                    help="when the injected fault fires, relative to the "
                         "first request")
    ap.add_argument("--priority", default="interactive",
                    choices=list(PRIORITIES),
                    help="priority class for every request")
    ap.add_argument("--admission-margin", type=float, default=0.0,
                    help="reject a request whose deadline is below margin x "
                         "the best-case completion floor (0 = admit all)")
    ap.add_argument("--brownout", action="store_true",
                    help="arm queue-pressure brownout on each replica")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: block-table lanes over a shared "
                         "page pool instead of per-lane rings")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (paged mode)")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="page-pool size (0 = slots x pages-per-lane, the "
                         "ring-equivalent footprint)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="cross-request prefix reuse: prompts sharing "
                         "full cached blocks skip their prefill "
                         "(global-attention stacks only, refused on "
                         "recurrent ones; implies --paged)")
    args = ap.parse_args(argv)
    if args.prefix_cache:
        args.paged = True

    # the Hopper attention kernels take head_dim 64, 128 or 256, which no
    # smoke config has
    full = args.full or torch.device(args.device).type == "cuda"
    cfg = get_config(args.arch) if full else get_smoke_config(args.arch)
    fleet = build_fleet(cfg, args.policy, replicas=args.replicas,
                        prefill_chunk_tokens=args.prefill_chunk_tokens,
                        step_slo_ms=args.step_slo_ms,
                        admission_margin=args.admission_margin,
                        brownout=args.brownout, paged=args.paged,
                        page_size=args.page_size, num_pages=args.num_pages,
                        prefix_cache=args.prefix_cache, device=args.device)

    inj = None
    if args.chaos:
        # the source replica is the one DDS loads up first: killing it is
        # the demo worth watching (in-flight streams fail over to peers)
        victim = "replica0"
        ev = (faults.slow(args.chaos_at_ms, 4.0) if args.chaos == "slow"
              else faults.FaultEvent(args.chaos_at_ms, args.chaos))
        inj = faults.inject(fleet, victim, faults.FaultPlan([ev]))
        print(f"chaos: {args.chaos} on {victim} at t+{args.chaos_at_ms:.0f}ms")
        inj.arm()

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
    if inj is not None:
        inj.stop()

    met = sum(1 for r in results if r.met(args.deadline_ms))
    failed = sum(1 for r in results if not r.ok)
    failovers = sum(1 for r in results if r.failed_over)
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
    if args.chaos or failed or failovers:
        print(f"chaos summary: failed={failed} failed_over={failovers} "
              f"fleet_failovers={fleet.failovers} lost={fleet.lost} "
              f"dead={fleet.dead}")
    fleet.stop()


if __name__ == "__main__":
    main()
