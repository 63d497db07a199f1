"""Run one cell of the port's benchmark once.

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

from the root of a checkout (``src`` holds the program, ``repro_torch``).
With ``--trace 0`` the last line of standard output is the cell's
end-to-end metrics, with ``--trace 1`` its per-layer ones, in one JSON
object with ``correct``, ``attempted``, ``failed``, ``device`` and
``checks`` (each number compared, beside its limit, as on the last lines
of standard error).  Without a card, or with fewer than the cell asks for,
it exits 2 and prints no result; a run that ends with ``jax``, ``jaxlib``,
``flax`` or ``repro`` among its modules exits 3 and prints none.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's own caches, at fixed paths, so only a checkout's first run
# builds; the program's kernels build into its ``build/kernels``
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
os.environ["USE_FLAX"] = "0"
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import harness  # noqa: E402

# the profiled slice of a traced run, seconds
PROFILE_S = 3.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        w = harness.load("workloads", args.workload)
        c = harness.load("configs", w["config"])
        metrics = harness.cell_metrics(harness.benchmark(), args.workload,
                                       bool(args.trace))
        harness.require_cuda(int(w["chips"]))
    except harness.BenchError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import torch
    torch.cuda.set_device(0)
    if w["kind"] == "serve":
        from portbench import serve as runner
    else:
        from portbench import train as runner
    run, checks, correct, device = runner.run(
        args.workload, w, c, args.seed, args.seconds, bool(args.trace),
        T_START, profile_s=PROFILE_S)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run holds forbidden modules {found}",
              file=sys.stderr)
        return 3
    values = harness.read_metrics(run, metrics)
    breakdown = None
    if run.profile is not None:
        breakdown = {"device_ops": run.profile.device_ops(),
                     "idle_gaps": run.profile.idle_gaps(run.spans)}
    print(harness.checks_text(checks), file=sys.stderr)
    print(harness.result_line(correct, run.attempted, run.failed, values,
                              device, checks, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
