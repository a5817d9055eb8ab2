"""collective_mb.shard4: MB a proof that rank 0 sends to other ranks
(`Mesh.bytes` summed)."""
from portbench import readers


def read(rec):
    total = readers.mesh_total(rec, "bytes")
    return None if total is None else total / 1e6
