"""tpot_p95_ms: 95th percentile (nearest rank), over the requests due in
the window, of (latency - TTFT) / (tokens - 1); a failed request counts
past the cell's TPOT limit."""
import importlib.util
from pathlib import Path

from portbench.harness import percentile

_spec = importlib.util.spec_from_file_location(
    "portbench_metrics_serve", Path(__file__).with_name("_serve.py"))
_serve = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_serve)


def read(run):
    if run.kind != "serve" or not run.outcomes:
        return None
    lim = run.workload["limits"]["tpot_ms"]
    return percentile([_serve.tpot_ms(o, lim) for o in run.outcomes], 95)
