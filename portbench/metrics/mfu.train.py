"""mfu.train: model operations (``roofline.train_flops`` a step: 6 per
weight per token and causal attention's products, remat's recompute not
counted) over (seconds x 989 TFLOP/s), over the window's steps outside
the profiled slice (the whole window where there is none)."""
import importlib.util
from pathlib import Path

from portbench import roofline as R

_spec = importlib.util.spec_from_file_location(
    "portbench_metrics_train", Path(__file__).with_name("_train.py"))
_train = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_train)


def read(run):
    if run.kind != "train" or not run.steps:
        return None
    t = run.workload["traffic"]
    n, secs = len(run.steps), run.window_s
    if run.profile is not None:
        _, outside = _train.steps_apart(run)
        if outside:
            n, secs = len(outside), _train.seconds(outside)
    flops = R.train_flops(run.config, t["batch"], t["seq"]) * n
    return 100.0 * flops / (secs * R.PEAK_BF16_FLOPS)
