"""The port's blake2s, device transcript and Merkle trees against
hashlib, the JAX package's host transcript and the oracle's trees."""

import hashlib
import random

import numpy as np
import pytest
import torch

from oracle import merkle as omerkle
from starks_tpu import transcript as ht
from starks_tpu_torch.ops import blake2s as b2
from starks_tpu_torch.ops import limbs as fl
from starks_tpu_torch.ops import merkle
from starks_tpu_torch.ops import transcript_dev as td
from starks_tpu_torch.utils.conversions import (ints_to_tensor,
                                                tensor_to_ints)

M = fl.MODULUS


def _words(data: bytes, nwords: int) -> torch.Tensor:
    padded = data + bytes(4 * nwords - len(data))
    return torch.from_numpy(
        np.frombuffer(padded, dtype='<u4').astype(np.int64))


def _bytes(words: torch.Tensor) -> bytes:
    return words.numpy().astype('<u4').tobytes()


def _root_words(root: bytes) -> torch.Tensor:
    return _words(root, 8)


def _rand_root(rng):
    return hashlib.blake2s(rng.randbytes(16)).digest()


@pytest.mark.parametrize("length", [32, 33, 64, 192])
def test_blake2s_matches_hashlib(length):
    rng = random.Random(length)
    msgs = [rng.randbytes(length) for _ in range(5)]
    nwords = -(-length // 64) * 16
    got = b2.blake2s_words(torch.stack([_words(m, nwords) for m in msgs]),
                           length)
    assert [_bytes(g) for g in got] == [hashlib.blake2s(m).digest()
                                         for m in msgs]


def test_limbs_to_words_is_big_endian_serialization():
    vals = [random.Random(1).randrange(M) for _ in range(16)]
    words = b2.limbs_to_words(ints_to_tensor(vals))
    assert [_bytes(w) for w in words] == [v.to_bytes(32, 'big')
                                          for v in vals]
    assert tensor_to_ints(b2.words_to_limbs(words)) == vals


def test_special_x():
    rng = random.Random(0)
    for _ in range(5):
        root = _rand_root(rng)
        got = tensor_to_ints(td.special_x_limbs(_root_words(root))[None])
        assert got == [ht.special_x(root)]


def test_challenge():
    rng = random.Random(1)
    for j in (1, 2, 3, 4, 17):
        root = _rand_root(rng)
        got = tensor_to_ints(td.challenge_limbs(_root_words(root), j)[None])
        assert got == [ht.challenge_int(root, j) % M]


@pytest.mark.parametrize("count,modulus,ex", [
    (40, 2**14, 0), (40, 2**14, 8), (80, 2**16, 8), (80, 2**19, 8),
    (3, 64, 4)])
def test_pseudorandom_indices(count, modulus, ex):
    root = _rand_root(random.Random(count * modulus + ex))
    want = ht.pseudorandom_indices(root, modulus, count,
                                   exclude_multiples_of=ex)
    got = td.pseudorandom_indices_dev(_root_words(root), modulus, count,
                                      exclude_multiples_of=ex)
    assert got.tolist() == want


def test_lincomb_coeffs():
    rng = random.Random(3)
    k1, k2 = rng.randrange(M), rng.randrange(M)
    hs = [rng.randrange(M) for _ in range(8)]
    got = td.lincomb_coeffs(ints_to_tensor([k1])[0], ints_to_tensor([k2])[0],
                            ints_to_tensor(hs))
    assert tensor_to_ints(got) == [(k1 + k2 * h) % M for h in hs]


@pytest.mark.parametrize("n,width", [(64, 8), (32, 24), (2, 8)])
def test_tree_root_and_bundles_match_oracle_tree(n, width):
    rng = random.Random(n + width)
    leaves = [rng.randbytes(4 * width) for _ in range(n)]
    tree = omerkle.merkelize(leaves)
    leaf_words = torch.stack([_words(x, width) for x in leaves])
    lvl1, levels, root = merkle.tree_build(leaf_words)
    assert _bytes(root) == tree[1]
    idx = torch.tensor([0, n - 1, n // 2, 1])
    bundle = merkle.tree_bundle(leaf_words, lvl1, levels, idx)
    branches = merkle.bundle_to_branches(bundle.numpy().astype(np.uint32),
                                         width)
    assert branches == [omerkle.mk_branch(tree, i) for i in idx.tolist()]
