"""train_tokens_per_s: tokens of the steps the window ran (each step's
rows x sequence length), over the window's seconds (its steps end in a
synchronise; the window ends with the first step past ``--seconds``)."""


def read(run):
    if run.kind != "train" or not run.steps:
        return None
    t = run.workload["traffic"]
    return len(run.steps) * t["batch"] * t["seq"] / run.window_s
