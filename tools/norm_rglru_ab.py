"""Time the norm call sites and the RG-LRU scan of two source trees side by
side on one H100.

    python3 tools/norm_rglru_ab.py --compare OTHER_TREE

runs the timings of OTHER_TREE (e.g. an earlier commit unpacked with
``git archive`` into ``build/``, which is not committed) and of this
checkout in turns, other, this, this, other, each in a process of its own
that imports that tree's ``repro_torch`` (building its kernels into that
tree's ``build/kernels``), and prints one line per row with the two trees'
means and their ratio; ``--out`` (default ``build/norm_rglru_ab.json``)
gets every number.  With ``--tree DIR`` it times one tree and prints its
JSON.

Rows, bf16, the L2 flushed before each launch as ``chip_smoke.py`` flushes
it: the norm at 8 x 2560 and at one row (its fixed cost); each fused call
site at its decode shape, or where the tree has no fused form, the
expression it replaces (the qk pair: two norms; the residual add: ``x + y``
then the norm; Mamba2's gate: ``y * silu(z)`` then the norm); ``rglru`` at
one token, 32, 1024 and 2300 tokens of width 4096.  Each row has the
device time (the profiler's sum over the row's kernels), the device
operations a call issues, and the host issue cost (``chip_smoke.issue_us``:
N back-to-back calls between two syncs, over N).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def time_tree(tree: str) -> dict:
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    sys.path.insert(1, ROOT)
    import numpy as np
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import rglru_scan as gk
    from repro_torch.kernels import rmsnorm as rk

    if not torch.cuda.is_available():
        raise SystemExit("norm_rglru_ab: no CUDA device")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(cs.SEED + 7)
    bf = torch.bfloat16
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def rnd(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to(dev, bf)

    def row(fn):
        return {"ms": cs.device_ms(fn, flush),
                "device_ops": len(cs.device_events(fn)),
                "issue_us": cs.issue_us(fn)}

    out = {"tree": os.path.abspath(tree), "card": cs.card_line(),
           "fused": hasattr(rk, "rmsnorm_pair")}
    x, sc = rnd((8, 2560)), 0.1 * rnd((2560,)).float()
    one = rnd((1, 2560))
    out["norm 8x2560"] = row(lambda: rk.rmsnorm(x, sc, 1e-6))
    out["norm 1x2560 (fixed)"] = row(lambda: rk.rmsnorm(one, sc, 1e-6))

    q, k = rnd((8, 1, 32, 128)), rnd((8, 1, 8, 128))
    qs, ks = 0.1 * rnd((128,)).float(), 0.1 * rnd((128,)).float()
    y = rnd((8, 2560))
    proj = rnd((8, 2 * 3072 + 2 * 128 + 48))
    z, yg, sg = proj[:, :3072], rnd((8, 3072)), 0.1 * rnd((3072,)).float()
    if out["fused"]:
        def pair():
            return rk.rmsnorm_pair(q, k, qs, ks, 1e-6)

        def add():
            return rk.add_rmsnorm(x, y, sc, 1e-6)

        def gated():
            return rk.gated_rmsnorm(yg, z, sg, 1e-6)
    else:  # the expressions the fused forms replace
        def pair():
            return rk.rmsnorm(q, qs, 1e-6), rk.rmsnorm(k, ks, 1e-6)

        def add():
            s = x + y
            return s, rk.rmsnorm(s, sc, 1e-6)

        def gated():
            return rk.rmsnorm(yg * F.silu(z), sg, 1e-6)
    out["qk pair q8x32x128 k8x8x128"] = row(pair)
    out["add + norm 8x2560"] = row(add)
    out["gated norm 8x3072"] = row(gated)

    for s in (1, 32, 1024, 2300):
        args = cs.rglru_inputs(rng, (1, s, 4096), bf, dev)
        out[f"rglru 1x{s}x4096"] = row(lambda: gk.rglru(*args))
    return out


def compare(other: str, out_path: str) -> int:
    runs = []
    for tree in (other, ROOT, ROOT, other):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--tree", tree], capture_output=True,
                             text=True)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    print(f"card: {runs[0]['card']}")
    print(f"{'row':30s} {'metric':10s} {'other':>10s} {'this':>10s} "
          f"{'this/other':>10s}   (runs: other, this, this, other)")
    rows = [k for k, v in runs[1].items() if isinstance(v, dict)]
    for name in rows:
        for metric in ("ms", "device_ops", "issue_us"):
            o = [runs[0][name][metric], runs[3][name][metric]]
            t = [runs[1][name][metric], runs[2][name][metric]]
            om, tm = sum(o) / 2, sum(t) / 2
            print(f"{name:30s} {metric:10s} {om:10.4f} {tm:10.4f} "
                  f"{tm / om if om else float('nan'):10.3f}   "
                  f"{o[0]:.4f} {t[0]:.4f} {t[1]:.4f} {o[1]:.4f}")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"order": ["other", "this", "this", "other"],
                   "runs": runs}, f, indent=1)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", help="time this tree alone; print its JSON")
    ap.add_argument("--compare", help="the other tree, timed in turns with "
                    "this checkout")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "norm_rglru_ab.json"))
    args = ap.parse_args(argv)
    if args.tree:
        print(json.dumps(time_tree(args.tree)))
        return 0
    if args.compare:
        return compare(args.compare, args.out)
    ap.error("give --tree or --compare")
    return 2


if __name__ == "__main__":
    sys.exit(main())
