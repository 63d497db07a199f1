"""optimizer_ms: device milliseconds of the kernels launched from the
AdamW update (the benchmark's span around ``optimizer.adamw_update``,
which the train step calls through the module) in the profiled slice,
over the updates that ran wholly in it."""


def read(run):
    p = run.profile
    if p is None or not p.recorded or run.kind != "train":
        return None
    spans = [s for s in run.spans.named("adamw_update", p.t0, p.t1)
             if s[2] >= p.t0]
    if not spans:
        return None
    charged = p.charge(run.spans, {"adamw_update"})
    return charged.get("adamw_update", 0.0) * 1e3 / len(spans)
