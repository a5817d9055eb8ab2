"""Device-resident Fiat-Shamir transcript.

Counterpart of `starks_tpu/ops/transcript_dev.py`: challenges and query
indices are derived from device digests with the batched blake2s
(ops/blake2s.py), so a proof never waits on the host between stages.
Byte semantics are identical to the host engine (transcript.py, SURVEY
§A.3/§A.5); parity is tested in tests/test_torch_transcript.py. Every
function takes a leading claim axis on its digests ([B, 8] roots give
[B, ...] results).
"""

import torch

from . import blake2s as b2
from . import limbs as fl


def special_x_limbs(root_words):
    """int(root) mod p as an [..., 8] int32 element, from [..., 8]
    digest words.
    The digest value is < 2^256 < 2p, so one conditional subtract
    canonicalizes (SURVEY §A.5 'special_x = int(m_root) mod p')."""
    return fl.cond_sub_p(b2.words_to_limbs(root_words))


def challenge_limbs(root_words, suffix: int):
    """k_j = int(blake2s(root || bytes([j]))) mod p, on device.

    The reference keeps k_j unreduced (SURVEY §A.5) but every use is
    inside mod-p arithmetic, so reducing here is transcript-equivalent."""
    m = torch.zeros(*root_words.shape[:-1], 16, dtype=torch.int64,
                    device=root_words.device)
    m[..., :8] = root_words
    m[..., 8] = suffix
    digest = b2.blake2s_words(m, 33)
    return fl.cond_sub_p(b2.words_to_limbs(digest))


def pseudorandom_indices_dev(root_words, modulus: int, count: int,
                             exclude_multiples_of: int = 0):
    """Query indices from a device digest: extend the seed by iterated
    blake2s of the last 32 bytes, read 4-byte BIG-endian words, reduce,
    exclusion-remap (same math as transcript.pseudorandom_indices).
    Returns an int64 [..., count] device tensor."""
    assert modulus < 2**24
    n_digests = (4 * count + 31) // 32      # seed + (n_digests-1) more
    chunks = [root_words]
    last = root_words
    for _ in range(n_digests - 1):
        last = b2.blake2s_words(
            torch.cat([last, torch.zeros_like(last)], dim=-1), 32)
        chunks.append(last)
    be = b2.byteswap32(torch.cat(chunks, dim=-1)[..., :count])
    if exclude_multiples_of == 0:
        return be % modulus
    ex = exclude_multiples_of
    real_modulus = modulus * (ex - 1) // ex
    o = be % real_modulus
    return o + 1 + o // (ex - 1)


def lincomb_coeffs(k_lin, k_adj, h_pows):
    """(k_lin + k_adj * h^i) mod p for a tiny [E, 8] power table — the
    8-periodic combined linear-combination coefficients (prover step 9),
    [..., E, 8] for [..., 8] weights. Plain tensor arithmetic: the JAX
    package computes it with XLA."""
    return fl.add(k_lin[..., None, :], fl.mul(k_adj[..., None, :], h_pows))
