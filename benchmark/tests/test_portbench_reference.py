"""The plain reference (refstark) against Python's ints, hashlib and
the program's plain path (`device="cpu"`) at small sizes."""

import hashlib
import json
import random

import numpy as np
import pytest
import torch

from portbench import manifest
from refstark import blake as B
from refstark import field as F
from refstark import merkle as M
from refstark import ntt as N
from refstark import stark as S

P = F.MODULUS
EDGES = [0, 1, 2, P - 1, P - 2, 2 ** 255, P - 2 ** 224]
CFG = json.loads((manifest.ROOT / "benchmark/configs/mimc-2e16.json")
                 .read_text())


def _pairs(n=300, seed=1):
    rng = random.Random(seed)
    a = EDGES + [rng.randrange(P) for _ in range(n)]
    b = EDGES[::-1] + [rng.randrange(P) for _ in range(n)]
    return a, b


@pytest.mark.parametrize("op, want", [
    (F.mul, lambda x, y: x * y % P), (F.add, lambda x, y: (x + y) % P),
    (F.sub, lambda x, y: (x - y) % P)])
def test_field_ops_against_ints(op, want):
    a, b = _pairs()
    got = F.to_ints(op(F.from_ints(a), F.from_ints(b)))
    assert got == [want(x, y) for x, y in zip(a, b)]


def test_batch_inverse_with_zeros():
    a, _ = _pairs(253)
    x = F.from_ints(a[:256])
    got = F.to_ints(F.batch_inv(x))
    assert got == [pow(v, P - 2, P) if v else 0 for v in a[:256]]


def test_ntt_against_the_definition():
    n = 16
    root = pow(7, (P - 1) // n, P)
    vals = _pairs(n)[0][:n]
    want = [sum(v * pow(root, i * j, P) for j, v in enumerate(vals)) % P
            for i in range(n)]
    x = F.from_ints(vals).reshape(16, 1, n)
    assert F.to_ints(N.ntt(x, root).reshape(16, n)) == want
    back = N.ntt(N.ntt(x, root), root, inverse=True)
    assert F.to_ints(back.reshape(16, n)) == vals


@pytest.mark.parametrize("blocks", [1, 3])
def test_blake2s_against_hashlib(blocks):
    rng = random.Random(blocks)
    msgs = [bytes(rng.randrange(256) for _ in range(64 * blocks))
            for _ in range(5)]
    words = torch.from_numpy(np.stack([np.frombuffer(m, "<u4")
                                       for m in msgs]).T.astype(np.int64))
    assert B.digest_bytes(B.hash_words(words)) == \
        [hashlib.blake2s(m).digest() for m in msgs]


@pytest.mark.parametrize("host_nodes", [1, 4, 2048])
def test_tree_levels_on_device_or_host(host_nodes):
    vals = _pairs(30)[0][:32]
    tree = M.Tree([F.from_ints(vals).reshape(16, 1, 32)], host_nodes)
    nodes = [v.to_bytes(32, "big") for v in vals]
    levels = [nodes]
    while len(levels[-1]) > 1:
        lv = levels[-1]
        levels.append([hashlib.blake2s(lv[2 * i] + lv[2 * i + 1]).digest()
                       for i in range(len(lv) // 2)])
    assert tree.roots == [levels[-1][0]]
    for i in (0, 5, 31):
        want = [nodes[i]] + [levels[k][(i >> k) ^ 1] for k in range(5)]
        assert tree.branches(0, [i]) == [want]


@pytest.mark.parametrize("steps, claims", [(128, 3), (256, 1)])
def test_reference_equals_the_programs_plain_path(steps, claims):
    from starks_tpu_torch import prover
    consts = CFG["round_constants"]
    rng = random.Random(steps)
    inps = [rng.randrange(P) for _ in range(claims)]
    want = S.prove(inps, steps, consts, CFG)
    got = prover.mk_mimc_proof_batch_fused(inps, steps, consts,
                                           device="cpu")
    assert got == want


def test_reference_with_few_constants_and_small_trees():
    from starks_tpu_torch import prover
    consts = CFG["round_constants"][:32]
    old = M.HOST_NODES
    M.HOST_NODES = 2
    try:
        want = S.prove([5], 64, consts, CFG)
    finally:
        M.HOST_NODES = old
    assert want == [prover.mk_mimc_proof(5, 64, consts, device="cpu")]
