"""setup_s: seconds from the process's start to the window's: imports,
kernel builds (none once the checkout has them), weights drawn on the
card, the replicas' warm-up and step curves or the trainer's first steps,
and the traffic's warm-up requests."""


def read(run):
    return run.setup_s
