"""tpot_median_ms: the median, over every request due in the window, of
(latency - TTFT) / (tokens - 1), each read over its whole decode; a
failed request counts past the cell's TPOT limit."""
import importlib.util
import statistics
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "portbench_metrics_serve", Path(__file__).with_name("_serve.py"))
_serve = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_serve)


def read(run):
    if run.kind != "serve" or not run.outcomes:
        return None
    lim = run.workload["limits"]["tpot_ms"]
    return statistics.median(_serve.tpot_ms(o, lim) for o in run.outcomes)
