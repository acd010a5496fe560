"""device.idle_pct.call: the share of the traced window in which no
operation ran on the device, %."""

from benchmark.readings import idle_pct


def read(run):
    return idle_pct(run)
