"""Time kernels of two source trees side by side on one H100.

    python3 tools/kernel_ab.py --compare OTHER_TREE [--rows fwd,bwd]

runs the timings of OTHER_TREE (e.g. an earlier commit unpacked with
``git archive`` into ``build/``, which is not committed) and of this
checkout in turns, other, this, this, other, each in a process of its own
that imports that tree's ``repro_torch`` (building its kernels into that
tree's ``build/kernels``), and prints one line per row and metric with the
two trees' means and their ratio, and for the backward rows each tree's
device ms by launch; ``--out`` (default ``build/kernel_ab.json``) gets
every number.  With ``--tree DIR`` it times one tree and prints its JSON.

Rows, bf16, the L2 flushed before each call as ``chip_smoke.py`` flushes
it:

- ``fwd``: the norm at 8 x 2560 and at one row (its fixed cost); each
  fused norm call site at its decode shape, or where the tree has no fused
  form, the expression it replaces (the qk pair: two norms; the residual
  add: ``x + y`` then the norm; Mamba2's gate: ``y * silu(z)`` then the
  norm); ``rglru`` at one token, 32, 1024 and 2300 tokens of width 4096,
  and at the training shape (2 x 1024 x 4096) without and, where the tree
  has it, with the checkpoint the backward takes.
  Metrics: device ms (the profiler's sum over the row's kernels), the
  device operations a call issues, and the host issue cost
  (``chip_smoke.issue_us``: N back-to-back calls between two syncs, over
  N).
- ``bwd``: the backward kernels at the training shapes ``chip_smoke.py``
  (phase 2c) times them: ``flash_attention_bwd`` at qwen3-4b's (B 2, S
  1024, 32 over 8 heads of 128, causal) and at recurrentgemma-9b's (16
  over 1 of 256, window 2048), ``ssd_bwd`` at mamba2-780m's (48 heads of
  64, state 128, chunk 128), ``rglru_bwd`` at recurrentgemma-9b's (B 2, S
  1024, width 4096; given the forward's checkpoint where the tree's
  backward takes one, else as the tree runs it) and the gated norm's
  backward at mamba2-780m's (2048 rows of 3072); the norm, add and pair
  forms' backward at qwen3-4b's (2048 rows of 2560; the pair over 2048 x
  32 and 2048 x 8 rows of 128).  Metric: device ms, and its split by
  launch.

A row one tree lacks is printed for the other alone.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS = ("fwd", "bwd")


def fwd_rows(cs, dev, flush) -> dict:
    """The norm call sites and the RG-LRU scan."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rglru_scan as gk
    from repro_torch.kernels import rmsnorm as rk

    rng = np.random.default_rng(cs.SEED + 7)
    bf = torch.bfloat16

    def rnd(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to(dev, bf)

    def row(fn):
        return {"ms": cs.device_ms(fn, flush),
                "device_ops": len(cs.device_events(fn)),
                "issue_us": cs.issue_us(fn)}

    out = {}
    fused = hasattr(rk, "rmsnorm_pair")
    x, sc = rnd((8, 2560)), 0.1 * rnd((2560,)).float()
    one = rnd((1, 2560))
    out["norm 8x2560"] = row(lambda: rk.rmsnorm(x, sc, 1e-6))
    out["norm 1x2560 (fixed)"] = row(lambda: rk.rmsnorm(one, sc, 1e-6))

    q, k = rnd((8, 1, 32, 128)), rnd((8, 1, 8, 128))
    qs, ks = 0.1 * rnd((128,)).float(), 0.1 * rnd((128,)).float()
    y = rnd((8, 2560))
    proj = rnd((8, 2 * 3072 + 2 * 128 + 48))
    z, yg, sg = proj[:, :3072], rnd((8, 3072)), 0.1 * rnd((3072,)).float()
    if fused:
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
    args = cs.rglru_inputs(rng, (2, 1024, 4096), bf, dev)
    out["rglru 2x1024x4096"] = row(lambda: gk.rglru(*args))
    if "checkpoint" in inspect.signature(gk.rglru).parameters:
        out["rglru 2x1024x4096 ckpt"] = row(
            lambda: gk.rglru(*args, checkpoint=True))
    return out


def bwd_rows(cs, dev, flush) -> dict:
    """The flash, SSD, RG-LRU and gated norm backward kernels at their
    training shapes."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.kernels import ssd_scan as sk

    rng = np.random.default_rng(cs.SEED + 26)
    bf = torch.bfloat16

    def row(fn):
        return {"ms": cs.device_ms(fn, flush),
                "split_ms": cs.kernel_breakdown(fn, flush)}

    out = {}
    for name, hq, hkv, d, window in (("flash bwd D128", 32, 8, 128, 0),
                                     ("flash bwd D256", 16, 1, 256, 2048)):
        q, k, v, do, qp, kp = cs.flash_bwd_inputs(rng, 2, 1024, 1024, hq, hkv,
                                                  d, bf, dev)
        kw = dict(q_pos=qp, k_pos=kp, causal=True, window=window,
                  scale=d ** -0.5)
        o, lse = fk.flash_attention(q, k, v, splits=1, return_lse=True, **kw)
        out[name] = row(lambda: fk.flash_attention_bwd(q, k, v, o, lse, do,
                                                       **kw))
        del q, k, v, do, o, lse
    x, dt, a_log, bm, cm, dsk = cs.ssd_inputs(rng, 2, 1024, 48, 64, 128, bf,
                                              dev)
    dy = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)
                          ).to(dev, bf)
    out["ssd bwd"] = row(lambda: sk.ssd_bwd(x, dt, a_log, bm, cm, dsk, dy,
                                            chunk=128))
    del x, dt, a_log, bm, cm, dsk, dy

    def rnd(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to(dev, bf)
    x, la, g = cs.rglru_inputs(rng, (2, 1024, 4096), bf, dev)
    dy = rnd((2, 1024, 4096))
    kw = {}
    if "ckpt" in inspect.signature(rg.rglru_bwd).parameters:
        kw["ckpt"] = rg.rglru(x, la, g, checkpoint=True)[1]
    out["rglru bwd"] = row(lambda: rg.rglru_bwd(x, la, g, dy, **kw))
    del x, la, g, dy, kw
    y, z, do = rnd((2048, 3072)), rnd((2048, 3072)), rnd((2048, 3072))
    gain = torch.from_numpy((rng.standard_normal(3072) * 0.1).astype(
        np.float32)).to(dev)
    out["gated norm bwd"] = row(lambda: rk.gated_rmsnorm_bwd(y, z, gain, do))
    del y, z, do
    # qwen3-4b's norm forms: the norm and the add over 2048 rows of 2560,
    # the qk pair over 2048 x 32 and 2048 x 8 rows of 128
    x, dn, ds = rnd((2048, 2560)), rnd((2048, 2560)), rnd((2048, 2560))
    g2 = torch.from_numpy((rng.standard_normal(2560) * 0.1).astype(
        np.float32)).to(dev)
    out["norm bwd"] = row(lambda: rk.rmsnorm_bwd(x, g2, dn))
    out["add bwd"] = row(lambda: rk.add_rmsnorm_bwd(x, g2, ds, dn))
    q, k = rnd((2048 * 32, 128)), rnd((2048 * 8, 128))
    dq, dk = rnd((2048 * 32, 128)), rnd((2048 * 8, 128))
    gq, gk_ = (torch.from_numpy((rng.standard_normal(128) * 0.1).astype(
        np.float32)).to(dev) for _ in range(2))
    out["pair bwd"] = row(lambda: rk.rmsnorm_pair_bwd(q, k, gq, gk_, dq, dk))
    return out


def time_tree(tree: str, groups) -> dict:
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    sys.path.insert(1, ROOT)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    dev = torch.device("cuda", 0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    out = {"tree": os.path.abspath(tree), "card": cs.card_line()}
    for g in groups:
        out.update({"fwd": fwd_rows, "bwd": bwd_rows}[g](cs, dev, flush))
    return out


def compare(other: str, groups, out_path: str) -> int:
    runs = []
    for tree in (other, ROOT, ROOT, other):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--tree", tree, "--rows", ",".join(groups)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    print(f"card: {runs[0]['card']}")
    print(f"{'row':30s} {'metric':10s} {'other':>10s} {'this':>10s} "
          f"{'this/other':>10s}   (runs: other, this, this, other)")
    for name in (k for k, v in runs[1].items() if isinstance(v, dict)):
        if name not in runs[0]:
            print(f"{name:30s} this tree only: " + ", ".join(
                f"{m} {(runs[1][name][m] + runs[2][name][m]) / 2:.4f}"
                for m, v in runs[1][name].items()
                if not isinstance(v, dict)))
            continue
        for metric, v in runs[1][name].items():
            if isinstance(v, dict):
                continue
            o = [runs[0][name][metric], runs[3][name][metric]]
            t = [runs[1][name][metric], runs[2][name][metric]]
            om, tm = sum(o) / 2, sum(t) / 2
            print(f"{name:30s} {metric:10s} {om:10.4f} {tm:10.4f} "
                  f"{tm / om if om else float('nan'):10.3f}   "
                  f"{o[0]:.4f} {t[0]:.4f} {t[1]:.4f} {o[1]:.4f}")
        if "split_ms" in runs[1][name]:
            for label, r in (("other", runs[0]), ("this", runs[1])):
                print(f"{'':30s} {label}: " + ", ".join(
                    f"{k} {v:.4f}" for k, v in r[name]["split_ms"].items()))
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
    ap.add_argument("--rows", default=",".join(GROUPS),
                    help="groups of rows, comma-separated: fwd (the norm "
                         "call sites, rglru), bwd (the backward kernels: "
                         "flash, ssd, rglru, the four norm forms)")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "kernel_ab.json"))
    args = ap.parse_args(argv)
    groups = [g for g in args.rows.split(",") if g]
    bad = [g for g in groups if g not in GROUPS]
    if bad or not groups:
        ap.error(f"--rows takes {', '.join(GROUPS)}, not {args.rows}")
    if args.tree:
        print(json.dumps(time_tree(args.tree, groups)))
        return 0
    if args.compare:
        return compare(args.compare, groups, args.out)
    ap.error("give --tree or --compare")
    return 2


if __name__ == "__main__":
    sys.exit(main())
