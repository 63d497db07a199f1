"""decode_step_device_ms: device milliseconds of the kernels launched from
decode steps (``Replica._decode_step``) in the profiled slice, over those
steps."""


def read(run):
    p = run.profile
    if p is None or not p.recorded:
        return None
    steps = [s for s in run.spans.named("decode_step", p.t0, 1 << 62)
             if s[2] >= p.t0 and s[3] <= p.t1]
    if not steps:
        return None
    charged = p.charge(run.spans, {"decode_step", "prefill_chunk"})
    return charged.get("decode_step", 0.0) * 1e3 / len(steps)
