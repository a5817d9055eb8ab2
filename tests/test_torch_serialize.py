"""The port's serialization and proof store (starks_tpu_torch.serialize,
starks_tpu_torch.utils.artifacts) against the JAX package's: the same
bytes for the same proof object (oracle MiMC proofs; the byte sections
of the port's fib-square AIR proof, whose boundary list of ints neither
package's codec encodes), the same claim keys, and round trips through
the store. Host only; every comparison is exact."""

import functools

import numpy as np
import pytest
import torch

from oracle import stark as ostark
from starks_tpu import serialize as jser
from starks_tpu.utils import artifacts as jart
import starks_tpu_torch as stt
from starks_tpu_torch import serialize as ser
from starks_tpu_torch.models import fib_square as fib
from starks_tpu_torch.utils.artifacts import ProofStore, claim_key

M = 2 ** 256 - 351 * 2 ** 32 + 1
CONSTS = [(i ** 7) ^ 42 for i in range(16)]
FIB_STEPS = 64


@functools.lru_cache(maxsize=None)
def _air_proof():
    return stt.prove_air(fib.fib_square_air(), [1, 1], FIB_STEPS,
                         device="cpu")


@functools.lru_cache(maxsize=None)
def _proof(kind: str):
    """An oracle MiMC proof, or the byte sections of the port's
    fib-square proof (all but its boundary list, element 5)."""
    if kind == "fib-square 64":
        return _air_proof()[:5]
    steps = int(kind.split()[1])
    return ostark.mk_mimc_proof(3, steps, CONSTS)


KINDS = ["mimc 128", "mimc 512", "fib-square 64"]
CODECS = {
    "serialize": (ser.serialize, jser.serialize),
    "serialize_v1": (ser.serialize_v1, jser.serialize_v1),
    "bin_length": (ser.bin_length, jser.bin_length),
    "raw_length": (ser.raw_length, jser.raw_length),
}


@pytest.mark.parametrize("codec", sorted(CODECS))
@pytest.mark.parametrize("kind", KINDS)
def test_same_bytes_as_jax(kind, codec):
    port, jax_fn = CODECS[codec]
    assert port(_proof(kind)) == jax_fn(_proof(kind))


@pytest.mark.parametrize("kind", KINDS)
def test_round_trip(kind):
    """serialize -> deserialize gives the proof back: pruned v3 for the
    MiMC proofs, structural v1 for the AIR proof."""
    proof = _proof(kind)
    data = ser.serialize(proof)
    assert data[:5] == (b"STPU\x01" if kind.startswith("fib")
                        else b"STPU\x03")
    assert ser.deserialize(data) == proof
    assert stt.deserialize_proof(stt.serialize_proof(proof)) == proof
    assert stt.bin_length(proof) == len(data) < stt.raw_length(proof)


@pytest.mark.parametrize("package", [ser, jser])
def test_air_proof_boundary_ints_are_not_encoded(package):
    """An AIR proof's element 5 is a list of ((step, register), value)
    int pairs: neither package's codec encodes ints, so both raise."""
    with pytest.raises(TypeError):
        package.serialize(_air_proof())


@pytest.mark.parametrize("kind", ["mimc 128", "fib-square 64"])
def test_reads_jax_written_v1(kind):
    proof = _proof(kind)
    assert ser.deserialize(jser.serialize_v1(proof)) == proof


@pytest.mark.parametrize("writer", ["serialize", "serialize_v1"])
def test_truncated_blob_is_rejected(writer):
    data = getattr(ser, writer)(_proof("mimc 128"))
    for cut in (1, 33, len(data) // 2):
        with pytest.raises(ValueError):
            ser.deserialize(data[:-cut])


def test_claim_key_equals_jax():
    """Inputs and constants reduced mod p, not 2^256: x and x + p are one
    claim, x and x + 2^256 - p are not."""
    claims = [(3, 64, CONSTS), (4, 64, CONSTS), (3, 128, CONSTS),
              (3 + M, 64, CONSTS), (3, 64, [c + M for c in CONSTS]),
              (M - 1, 2 ** 16, CONSTS[:8])]
    for inp, steps, consts in claims:
        assert claim_key(inp, steps, consts) == jart.claim_key(inp, steps,
                                                               consts)
    assert claim_key(3, 64, CONSTS) == claim_key(3 + M, 64, CONSTS)
    assert claim_key(3, 64, CONSTS) != claim_key(3 + 2 ** 256 - M, 64,
                                                 CONSTS)
    assert claim_key(3, 64, CONSTS) != claim_key(4, 64, CONSTS)


def test_proof_store_round_trip(tmp_path):
    """A stored proof comes back equal, with its metadata; the JAX
    package's store reads the same file; no temporary file is left."""
    store = ProofStore(str(tmp_path))
    proof = _proof("mimc 128")
    key = claim_key(3, 128, CONSTS)
    assert not store.has_proof(key)
    store.put_proof(key, proof, {"inp": 3, "steps": 128})
    assert store.has_proof(key)
    assert store.get_proof(key) == proof
    assert jart.ProofStore(str(tmp_path)).get_proof(key) == proof
    meta = store.get_meta(key)
    assert meta["m_root"] == proof[0].hex() and meta["inp"] == 3
    assert meta["bin_length"] == ser.bin_length(proof)
    assert not list(tmp_path.rglob("*.tmp"))


def test_proof_store_stages(tmp_path):
    store = ProofStore(str(tmp_path))
    arr = np.arange(64, dtype=np.int32).reshape(8, 8)
    store.put_stage("k1", "lde", arr)
    store.put_stage("k1", "trace", torch.from_numpy(arr) + 1)
    assert store.has_stage("k1", "lde") and not store.has_stage("k1", "fri")
    assert (store.get_stage("k1", "lde") == arr).all()
    assert (store.get_stage("k1", "trace") == arr + 1).all()
    assert not list(tmp_path.rglob("*.tmp"))
