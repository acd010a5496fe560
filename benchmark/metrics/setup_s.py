"""setup_s: the run's set-up, from the start of the process to the
start of the window (imports and card, inputs, set-up work, warm-up)."""


def read(run):
    return run.setup_s
