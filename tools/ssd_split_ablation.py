"""The bf16 SSD kernel without its hi/lo split: how far it lands from the
f32 oracle.

The kernel (``src/repro_torch/kernels/csrc/ssd_scan.cu``) feeds each f32
operand of its tensor-core products (the decayed score, the weighted B,
the carried state) as bf16 hi + lo, two products.  This script copies
``src/`` and ``chip_smoke.py`` into ``build/ablation/`` (``build/`` is not
committed), deletes every product with a ``lo`` operand from the copy's
``ssd_scan.cu``, so that each f32 operand enters once, rounded to bf16,
and runs ``chip_smoke.check_ssd_sweep`` there with its spacing limit
lifted.  It prints the largest distance of the sweep's bf16 outputs from
the f32 oracle, in bf16 spacings; ``chip_smoke.py`` holds the real kernel
within 0.75.  It builds the copy's kernels with nvcc and needs an H100;
run it from the root of a checkout:

    python3 tools/ssd_split_ablation.py
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LO_PRODUCT = re.compile(r"^.*rt::mma_bf16\(.*(, al, |, pl, |, a, bl\[).*\n",
                        re.M)
LO_PRODUCTS = 6         # two in each of the state, carried and score terms
SWEEP = ("import sys; sys.path.insert(0, 'src'); "
         "import numpy as np, torch; import chip_smoke as cs; "
         "limit, cs.P_SPACINGS = cs.P_SPACINGS, float('inf'); "
         "sp = cs.check_ssd_sweep(torch.device('cuda', 0), "
         "np.random.default_rng(cs.SEED), lambda *a, **k: None); "
         "print(f'ssd bf16 without its lo products: {sp:.3f} bf16 spacings "
         "from the f32 oracle (chip_smoke.py holds the kernel within "
         "{limit})')")


def main() -> int:
    dst = os.path.join(ROOT, "build", "ablation")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "src"), os.path.join(dst, "src"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dst)
    cu = os.path.join(dst, "src", "repro_torch", "kernels", "csrc",
                      "ssd_scan.cu")
    with open(cu) as f:
        cut, n = LO_PRODUCT.subn("", f.read())
    if n != LO_PRODUCTS:
        raise SystemExit(f"expected {LO_PRODUCTS} lo products in "
                         f"ssd_scan.cu, found {n}")
    with open(cu, "w") as f:
        f.write(cut)
    return subprocess.run([sys.executable, "-c", SWEEP], cwd=dst).returncode


if __name__ == "__main__":
    sys.exit(main())
