"""dispatch.ms_per_call: the program's phase "dispatch" (the device
thread issuing launches) per call in the window, ms."""


def read(run):
    if "dispatch" not in run.phases:
        return None
    return 1e3 * run.phases["dispatch"] / len(run.calls)
