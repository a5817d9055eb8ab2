"""collective_s.shard4: rank 0's seconds in collectives a proof
(`Mesh.seconds` summed, `Mesh.timed` on in the traced run)."""
from portbench import readers


def read(rec):
    return readers.mesh_total(rec, "seconds")
