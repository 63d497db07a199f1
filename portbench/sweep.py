"""Find an open-loop cell's knee on the card: the highest rate at which
``attain`` of the requests meet both of the cell's limits (TTFT and TPOT)
without a growing backlog.

  python3 portbench/sweep.py --workload mixtral-8x22b.chat \
      --rates 1.5,2,2.5,1.5,2,2.5 --seconds 30 --out chiprun_out/sweep.json
  python3 portbench/sweep.py --workload mixtral-8x22b.chat \
      --apply chiprun_out/sweep.json

One process builds the cell's program once and serves each rate's window
in turn, each drained before the next; a rate named twice is served
twice, and meets the limits only where every one of its windows does.  A
backlog grows where the median TTFT of the window's last third exceeds
its first third's by more than half the TTFT limit: the thirds hold
prompts of different lengths, so a ratio of their medians reads the mix
(1.0/s read 3.3x, with every request met), and a queue that grows adds
its wait to every later request.  ``--apply`` writes the sweep and 0.8 x
the knee (``rate_per_s``) into the cell's file.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import harness  # noqa: E402

SHARE = 0.8          # the cell's rate as a share of the knee


def attainment(r, limits) -> dict:
    ok, ttfts, tpots = 0, [], []
    for o in r.outcomes:
        res = o.result
        if not o.ok:
            ttfts.append(r.drain_end_ms - o.start_ms)
            tpots.append(2.0 * limits["tpot_ms"])
            continue
        tpot = (res.latency_ms() - res.ttft_ms) / max(len(res.tokens) - 1, 1)
        ttfts.append(res.ttft_ms)
        tpots.append(tpot)
        ok += res.ttft_ms <= limits["ttft_ms"] and tpot <= limits["tpot_ms"]
    third = max(len(ttfts) // 3, 1)
    first = statistics.median(ttfts[:third])
    last = statistics.median(ttfts[-third:])
    return {"requests": len(r.outcomes), "met": ok,
            "attain": ok / max(len(r.outcomes), 1),
            "ttft_median_ms": statistics.median(ttfts),
            "tpot_median_ms": statistics.median(tpots),
            "ttft_median_first_third_ms": first,
            "ttft_median_last_third_ms": last,
            "backlog": bool(last - first > limits["ttft_ms"] / 2)}


def knee_of(rows, attain: float):
    """The highest rate all of whose windows met ``attain`` of the
    requests without a backlog (None where none did)."""
    rates = {r["rate_per_s"] for r in rows}
    good = [x for x in rates
            if all(r["attain"] >= attain and not r["backlog"]
                   for r in rows if r["rate_per_s"] == x)]
    return max(good, default=None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", default="")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--attain", type=float, default=0.9)
    ap.add_argument("--out", default="")
    ap.add_argument("--apply", default="")
    args = ap.parse_args(argv)
    path = harness.HERE / "workloads" / f"{args.workload}.json"
    w = harness.load("workloads", args.workload)
    if args.apply:
        sweep = json.loads(Path(args.apply).read_text())
        knee = knee_of(sweep["rates"], args.attain)
        if knee is None:
            raise SystemExit("no rate of the sweep met the limits")
        sweep["knee_per_s"] = knee
        w["sweep"] = sweep
        w["traffic"]["rate_per_s"] = round(SHARE * knee, 3)
        path.write_text(json.dumps(w, indent=2) + "\n")
        print(f"knee {knee}/s; rate_per_s {w['traffic']['rate_per_s']}")
        return 0
    from portbench import serve
    from portbench.traffic import requests as traffic
    c = harness.load("configs", w["config"])
    harness.require_cuda(int(w["chips"]))
    import torch
    sess = serve.Session(c, args.seed, "cuda")
    rows = []
    for rate in [float(x) for x in args.rates.split(",")]:
        t = dict(w["traffic"], rate_per_s=rate)
        gen = traffic.make(t, c["vocab_size"], args.seed, args.seconds)
        serve.warm(sess.fleet, gen.warm)
        r = harness.Run(args.workload, w, c, "serve")
        sess.window(gen, args.seconds, r)
        r.pool.shutdown(wait=True)
        row = dict(rate_per_s=rate, **attainment(r, w["limits"]))
        rows.append(row)
        print(f"[sweep] {json.dumps(row)}", file=sys.stderr, flush=True)
    sess.stop()
    out = {"seconds": args.seconds, "seed": args.seed,
           "card": torch.cuda.get_device_name(0), "rates": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
