"""The share of the traced window in which no operation ran on the device, in %."""

from portbench.harness import readers


def read(rec):
    return readers.idle_share(rec)
