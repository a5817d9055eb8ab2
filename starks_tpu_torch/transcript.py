"""Host-side Fiat-Shamir transcript engine (the port's own copy of
`starks_tpu/transcript.py`).

Semantics match SURVEY §A.3/§A.5 exactly: challenges are blake2s of
roots, query indices come from the seed-extension loop with the
multiples-exclusion remap. The verifier replays the transcript with
these functions; the prover derives the same values on the device
(ops/transcript_dev.py).
"""

import hashlib

MODULUS = 2**256 - 351 * 2**32 + 1


def blake(x: bytes) -> bytes:
    return hashlib.blake2s(x).digest()


def is_a_power_of_2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def pseudorandom_indices(seed: bytes, modulus: int, count: int,
                         exclude_multiples_of: int = 0) -> list:
    """Derive query indices from a 32-byte seed (SURVEY §A.5): extend the
    seed by iterated blake2s of its last 32 bytes, read 4-byte big-endian
    words, reduce; the exclusion remap x -> x + 1 + x//(ex-1) enumerates
    exactly the indices not divisible by ex."""
    assert modulus < 2**24
    data = seed
    while len(data) < 4 * count:
        data += blake(data[-32:])
    if exclude_multiples_of == 0:
        return [int.from_bytes(data[i:i + 4], 'big') % modulus
                for i in range(0, count * 4, 4)]
    ex = exclude_multiples_of
    real_modulus = modulus * (ex - 1) // ex
    o = [int.from_bytes(data[i:i + 4], 'big') % real_modulus
         for i in range(0, count * 4, 4)]
    return [x + 1 + (x // (ex - 1)) for x in o]


def challenge_int(root: bytes, suffix: int = None) -> int:
    """k_j = int(blake2s(root || byte(j))) — NOT pre-reduced mod p
    (SURVEY §A.5); reduce at use site when entering device arithmetic."""
    data = root if suffix is None else root + bytes([suffix])
    return int.from_bytes(blake(data), 'big')


def special_x(root: bytes) -> int:
    """FRI column evaluation point: int(root) mod p (SURVEY §A.5)."""
    return int.from_bytes(root, 'big') % MODULUS
