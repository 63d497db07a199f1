"""idle_share.train: 1 - the device seconds a step (the kernels of the
profiled slice, CUPTI through ``torch.profiler``, over the steps run
wholly in it) over the wall seconds a step outside the slice, where no
profiler slows the host that paces the step."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "portbench_metrics_train", Path(__file__).with_name("_train.py"))
_train = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_train)


def read(run):
    p = run.profile
    if p is None or not p.recorded or run.kind != "train":
        return None
    inside, outside = _train.steps_apart(run)
    if not inside or not outside:
        return None
    busy = p.busy_s() / len(inside)
    return 1.0 - busy / (_train.seconds(outside) / len(outside))
