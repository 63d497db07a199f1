"""Time the norm backward's forms in several source trees on one H100.

    python3 tools/norm_bwd_ab.py TREE [TREE ...]

Each TREE is a copy of the repository (e.g. a commit unpacked with ``git
archive`` into ``build/``, which is not committed, or such a copy with one
change to ``csrc/rmsnorm_bwd.cu``).  The trees' ``rmsnorm_bwd`` libraries
are built first, all at once; then each tree is timed in a process of its
own, in the order given and then in reverse, so that every tree runs
twice and drift of the host falls on both sides.  Rows, bf16, the L2
flushed before each call as ``chip_smoke.py`` flushes it: the gated form
over 2048 rows of 3072 (mamba2-780m's), 1536 and 4096, with its time by
launch; the norm and the add form over 2048 rows of 2560 and the qk pair
over 2048 x 32 and 2048 x 8 rows of 128 (qwen3-4b's).  Device ms from
``chip_smoke.device_ms``; last, each tree's ``-Xptxas -v`` lines for the
gated form's instantiations (registers, spills).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one(tree: str) -> dict:
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    sys.path.insert(1, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import rmsnorm as rk

    if not torch.cuda.is_available():
        raise SystemExit("norm_bwd_ab: no CUDA device")
    build.build_all(["rmsnorm_bwd"])
    dev = torch.device("cuda", 0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rng = np.random.default_rng(5)

    def rnd(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to(dev, torch.bfloat16)

    def gain(d):
        return torch.from_numpy((rng.standard_normal(d) * 0.1).astype(
            np.float32)).to(dev)

    out = {"card": cs.card_line()}
    for d in (3072, 1536, 4096):
        y, z, do, g = rnd((2048, d)), rnd((2048, d)), rnd((2048, d)), gain(d)
        fn = (lambda: rk.gated_rmsnorm_bwd(y, z, g, do))
        out[f"gated {d}"] = dict(ms=cs.device_ms(fn, flush),
                                 split=cs.kernel_breakdown(fn, flush))
    x, dn, ds, g2 = rnd((2048, 2560)), rnd((2048, 2560)), rnd((2048, 2560)), \
        gain(2560)
    out["norm"] = dict(ms=cs.device_ms(lambda: rk.rmsnorm_bwd(x, g2, dn),
                                       flush))
    out["add"] = dict(ms=cs.device_ms(
        lambda: rk.add_rmsnorm_bwd(x, g2, ds, dn), flush))
    q, k = rnd((2048 * 32, 128)), rnd((2048 * 8, 128))
    dq, dk = rnd((2048 * 32, 128)), rnd((2048 * 8, 128))
    gq, gk = gain(128), gain(128)
    out["pair"] = dict(ms=cs.device_ms(
        lambda: rk.rmsnorm_pair_bwd(q, k, gq, gk, dq, dk), flush))
    lines = build.build_log("rmsnorm_bwd").splitlines()
    out["ptxas"] = [ln.strip() for i, ln in enumerate(lines)
                    if "Lb1E" in ln or (i and "Lb1E" in lines[i - 1])
                    or (i > 1 and "Lb1E" in lines[i - 2])]
    return out


def main(argv) -> int:
    if argv[:1] == ["--tree"]:
        print(json.dumps(one(argv[1])))
        return 0
    trees = argv
    if not trees:
        print(__doc__)
        return 2
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from repro_torch.kernels import build; "
         "build.build_all(['rmsnorm_bwd'])", os.path.join(t, "src")])
        for t in trees]
    if any(p.wait() for p in procs):
        return 1
    runs = {t: [] for t in trees}
    for t in trees + trees[::-1]:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--tree", t], capture_output=True, text=True)
        if res.returncode:
            print(t, res.stderr[-3000:], file=sys.stderr)
            return res.returncode
        runs[t].append(json.loads(res.stdout.strip().splitlines()[-1]))
    print(f"card: {runs[trees[0]][0]['card']}")
    for t, rs in runs.items():
        print(t)
        for key, row in rs[0].items():
            if isinstance(row, dict):
                print(f"  {key:12s} " + "  ".join(f"{r[key]['ms']:.4f}"
                                                   for r in rs)
                      + (f"  by launch {row['split']}" if "split" in row
                         else ""))
    for t, rs in runs.items():
        print("ptxas", t)
        print("\n".join(rs[0]["ptxas"]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
