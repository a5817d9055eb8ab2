"""device_idle_pct.single: 100 x (1 - the union of the device's
intervals over the profiled window)."""
from portbench import readers


def read(rec):
    return readers.device_idle_pct(rec)
