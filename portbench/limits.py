"""The readings a cell's limits are set from: the program's compared
numbers over many seeds, and the control's (the reference in the next
lower precision in the program's place) over some of them, in one process.

  python3 portbench/limits.py --workload mixtral-8x22b.chat \
      --seeds 11,12,13 --control 3 --seconds 20

Each seed builds the cell's program afresh, serves the cell's traffic for
``--seconds`` at the cell's load and drains it, and the reference judges
the same sample a run judges; for the first ``--control`` seeds the fp8
reference is judged on the same prompts and tokens.  A line a seed on
standard error, and all of it as JSON in ``--out``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import check, harness  # noqa: E402


def serve_readings(w, c, seed: int, seconds: float, control: bool,
                   device="cuda") -> dict:
    from portbench import serve
    from portbench.traffic import requests as traffic
    sess = serve.Session(c, seed, device)
    gen = traffic.make(w["traffic"], c["vocab_size"], seed, seconds)
    serve.warm(sess.fleet, gen.warm)
    r = harness.Run("", w, c, "serve")
    sess.window(gen, seconds, r)
    sess.stop(r)
    sample = check.serve_sample(r.outcomes, seed, w["check"])
    out = {"seed": seed, "requests": r.attempted, "failed": r.failed,
           "served": sum(len(s) for _, s in sample),
           "program": check.mean_gap(
               check.logit_gaps(c, seed, sample, device))}
    if control:
        out["control"] = check.mean_gap(check.logit_gaps(
            c, seed, sample, device, quant="fp8"))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    w = harness.load("workloads", args.workload)
    c = harness.load("configs", w["config"])
    harness.require_cuda(int(w["chips"]))
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = []
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        if w["kind"] == "serve":
            row = serve_readings(w, c, seed, args.seconds, i < args.control)
        else:
            from portbench import train
            row = train.readings(w, c, seed, i < args.control)
        row["s"] = time.perf_counter() - t0
        rows.append(row)
        print(f"[limits] {json.dumps(row)}", file=sys.stderr, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
