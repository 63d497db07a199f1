"""ttft_p95_ms: 95th percentile (nearest rank) of time to first token over
every request due in the window, timed from its due time; a request that
failed or never got a token counts past the cell's TTFT limit."""
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
    lim = run.workload["limits"]["ttft_ms"]
    return percentile([_serve.ttft_ms(o, lim, run.drain_end_ms)
                       for o in run.outcomes], 95)
