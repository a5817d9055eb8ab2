"""field_roofline.single: the field kernels' share of their roofline
(portbench.readers.field_roofline)."""
from portbench import readers


def read(rec):
    return readers.field_roofline(rec)
