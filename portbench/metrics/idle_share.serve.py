"""idle_share.serve: 1 - the seconds in which a kernel ran over the
profiled slice's seconds (CUPTI through ``torch.profiler``); nothing where
the slice recorded no device work."""


def read(run):
    p = run.profile
    if p is None or not p.recorded or run.kind != "serve" \
            or p.window_s() <= 0:
        return None
    return 1.0 - p.busy_s() / p.window_s()
