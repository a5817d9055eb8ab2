"""Content-addressed proof store and stage checkpoints (the port's own
copy of `starks_tpu/utils/artifacts.py`).

Layout under a store directory:

  claims/<claim_key>.proof        serialized proof (serialize.py)
  claims/<claim_key>.json         claim metadata and transcript root
  stages/<claim_key>.<stage>.npy  array checkpoint

`claim_key` is blake2s over the canonical claim encoding (inp, steps,
round constants), equal to the JAX package's key, so a crashed batch
run resumes by skipping every claim whose proof is already on disk:
proofs are deterministic, so re-proving and resuming are the same.
Every write goes to a temporary file first and is renamed into place,
so a crash never leaves a truncated artifact that `has_proof` trusts.
"""

import json
import os

import numpy as np

from .. import serialize as ser
from ..transcript import blake

MODULUS = 2**256 - 351 * 2**32 + 1


def claim_key(inp: int, steps: int, round_constants) -> str:
    """Content address of a MiMC claim (hex blake2s digest).

    Inputs and constants are reduced mod the field modulus: the prover
    reduces them, so values that differ by p are one claim and share a
    key, while values that differ by 2^256 - p are distinct claims."""
    enc = (inp % MODULUS).to_bytes(32, 'big')
    enc += steps.to_bytes(8, 'big')
    enc += len(round_constants).to_bytes(8, 'big')
    for c in round_constants:
        enc += (c % MODULUS).to_bytes(32, 'big')
    return blake(enc).hex()


def _write_atomic(path: str, write, mode: str):
    tmp = path + ".tmp"
    with open(tmp, mode) as f:
        write(f)
    os.replace(tmp, path)


class ProofStore:
    """Durable, content-addressed proof and checkpoint store."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(os.path.join(root, "claims"), exist_ok=True)
        os.makedirs(os.path.join(root, "stages"), exist_ok=True)

    # -- proofs -----------------------------------------------------------
    def _paths(self, key: str):
        base = os.path.join(self.root, "claims", key)
        return base + ".proof", base + ".json"

    def has_proof(self, key: str) -> bool:
        return os.path.exists(self._paths(key)[0])

    def put_proof(self, key: str, proof, meta: dict = None):
        """Persist a proof object and its metadata (m_root, serialized
        length, and `meta`)."""
        ppath, mpath = self._paths(key)
        data = ser.serialize(proof)
        m_root = proof[0].hex() if proof and isinstance(proof[0], bytes) \
            else None
        _write_atomic(ppath, lambda f: f.write(data), "wb")
        record = {"m_root": m_root, "bin_length": len(data)}
        record.update(meta or {})
        _write_atomic(mpath, lambda f: json.dump(record, f), "w")

    def get_proof(self, key: str):
        with open(self._paths(key)[0], "rb") as f:
            return ser.deserialize(f.read())

    def get_meta(self, key: str) -> dict:
        with open(self._paths(key)[1]) as f:
            return json.load(f)

    # -- stage checkpoints --------------------------------------------------
    def _stage_path(self, key: str, stage: str) -> str:
        return os.path.join(self.root, "stages", f"{key}.{stage}.npy")

    def put_stage(self, key: str, stage: str, array):
        """Checkpoint an array (a numpy array, or a tensor on any
        device)."""
        if hasattr(array, "detach"):
            array = array.detach().cpu().numpy()
        _write_atomic(self._stage_path(key, stage),
                      lambda f: np.save(f, np.asarray(array)), "wb")

    def get_stage(self, key: str, stage: str):
        return np.load(self._stage_path(key, stage))

    def has_stage(self, key: str, stage: str) -> bool:
        return os.path.exists(self._stage_path(key, stage))
