"""What every cell's run shares: finding a cell's files by name, the
metrics ``BENCHMARK.json`` asks of it, the per-metric readers, the device
checks and the result line.

A metric's reader is ``metrics/<name>.py`` with ``read(run)``, which
returns a number or ``None`` when the run holds nothing for it to read (the
metric is then left out of the line).  ``run`` is the ``Run`` a runner
fills: the cell, its configuration, the window's outcomes and counters, and
in a traced run the spans, launches and profile slice.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class BenchError(RuntimeError):
    """A run that cannot report: no card, a missing file, a forbidden
    module.  ``run.py`` prints it and exits 2 without a result line."""


def load(kind: str, name: str) -> Dict[str, Any]:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise BenchError(f"no {kind[:-1]} {name!r} ({path} is missing)")
    return json.loads(path.read_text())


def benchmark() -> Dict[str, Any]:
    path = ROOT / "BENCHMARK.json"
    if not path.is_file():
        raise BenchError(f"{path} is missing")
    return json.loads(path.read_text())


def cell_metrics(bench: Dict[str, Any], cell: str, trace: bool
                 ) -> List[Dict[str, Any]]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones.  A metric without ``workloads`` is
    reported where the metric it moves is."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        raise BenchError(f"metric {name!r} has no reader ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Run:
    """What one run measured, for the metric readers."""
    cell: str
    workload: Dict[str, Any]
    config: Dict[str, Any]
    kind: str                              # "serve" | "train"
    setup_s: float = 0.0
    window_s: float = 0.0                  # the measured window's seconds
    outcomes: List[Any] = field(default_factory=list)
    counters: Dict[str, float] = field(default_factory=dict)  # window deltas
    placements: Dict[str, int] = field(default_factory=dict)
    steps: List[Dict[str, float]] = field(default_factory=list)
    window_ns: tuple = (0, 0)              # wall-clock bounds of the window
    spans: Any = None                      # trace.Spans (traced runs)
    hooks: Any = None                      # trace.Hooks
    profile: Any = None                    # trace.Profile
    attempted: int = 0
    failed: int = 0


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile by nearest rank (the smallest value with at
    least q% of the values at or below it)."""
    v = sorted(values)
    k = max(math.ceil(q / 100.0 * len(v)) - 1, 0)
    return v[k]


def device_info(chips: int, trace_profile=None) -> Dict[str, Any]:
    import torch
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips,
           "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                    for i in range(chips))}
    if trace_profile is not None:
        out["busy_s"] = trace_profile.busy_s()
        out["window_s"] = trace_profile.window_s()
    return out


def require_cuda(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise BenchError("torch.cuda.is_available() is false: the "
                         "benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell asks for {chips} cards and "
                         f"{torch.cuda.device_count()} are present")


def forbidden_modules() -> List[str]:
    """Top-level module names in ``sys.modules`` that a run may not hold,
    compared whole (``repro_torch`` is not ``repro``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def read_metrics(run: Run, metrics: List[Dict[str, Any]]
                 ) -> Dict[str, Dict[str, Any]]:
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(correct: bool, attempted: int, failed: int, metrics,
                device, checks: Dict[str, Dict[str, float]],
                breakdown=None) -> str:
    """The last line of standard output; ``checks`` (each number compared,
    beside its limit) comes last."""
    out: Dict[str, Any] = {"correct": bool(correct),
                           "attempted": int(attempted),
                           "failed": int(failed), "metrics": metrics,
                           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def checks_text(checks: Dict[str, Dict[str, float]]) -> str:
    return "\n".join(f"check {name}: {c['value']!r} limit {c['limit']!r}"
                     for name, c in checks.items())
