"""Layer-parallel Merkle trees over evaluation tables.

Counterpart of `starks_tpu.ops.fused.tree_build_unrolled` /
`tree_bundle` (top_levels=0) and `ops/merkle.py::bundle_to_branches`.
Level k's hashes run as ONE batched blake2s call. Byte formats match
SURVEY §A.4: leaves are the raw 32-byte big-endian values (or 96-byte
P||D||B composites), unhashed; parent = blake2s(left || right);
branches are [leaf, sibling leaf, digest siblings...] bottom-up.

Every function also takes a leading claim axis: leaves [B, M, W] give B
trees in the same batched blake2s calls, and bundles take per-claim
indices [B, K].

`Tree` is the tree the provers commit with. With a mesh
(parallel/mesh.py) its leaves lie in contiguous row shards: each shard
builds the subtree over its own leaves, one all_gather gives every
shard the shard roots, and every shard hashes the top log2(s) levels,
so every shard holds the same root. A bundle row belongs to the shard
whose leaves hold its index (a leaf and its sibling idx ^ 1 always lie
in one shard); that shard fills it from its subtree and the top
levels, the others give zeros, and one all_reduce (sum) hands every
shard every row. Over one shard, or with no mesh (one device, any
claim axis), its bytes are those of `tree_build` and `tree_bundle`.
"""

import numpy as np
import torch

from . import blake2s as b2


def tree_build(leaf_words):
    """Tree over [..., M, W] int64 leaf words (W = 8 for 32-byte leaves,
    24 for the 96-byte P||D||B leaves). Returns (lvl1 [..., M/2, 8],
    levels [[..., M/4, 8], [..., M/8, 8], ..., [..., 1, 8]], root
    [..., 8]), every level at its true size."""
    *lead, m, w = leaf_words.shape
    lvl1 = b2.blake2s_words(leaf_words.reshape(*lead, m // 2, 2 * w),
                            2 * w * 4)
    levels = []
    cur = lvl1
    while cur.shape[-2] > 1:
        cur = b2.blake2s_words(cur.reshape(*lead, cur.shape[-2] // 2, 16),
                               64)
        levels.append(cur)
    root = (levels[-1] if levels else lvl1)[..., 0, :]
    return lvl1, levels, root


def _rows(table, idx):
    """table[..., idx, :] per claim: table [M, W] with idx [K], or
    table [B, M, W] with idx [B, K] (one flat gather at b * M + idx)."""
    if table.dim() == 2:
        return table[idx]
    b, m, w = table.shape
    base = torch.arange(0, b * m, m, device=idx.device)[:, None]
    return table.reshape(b * m, w)[idx + base]


def tree_bundle(leaf_words, lvl1, levels, idx):
    """[..., K, 2W + 8*(log2(M)-1)] branch bundles for int64 indices
    `idx` [..., K]: leaf, sibling leaf, then the sibling digest at each
    level bottom-up (the root omitted), gathered on device."""
    parts = [_rows(leaf_words, idx), _rows(leaf_words, idx ^ 1)]
    node = idx >> 1
    if levels:
        parts.append(_rows(lvl1, node ^ 1))
        node = node >> 1
    for level in levels[:-1]:
        parts.append(_rows(level, node ^ 1))
        node = node >> 1
    return torch.cat(parts, dim=-1)


class Tree:
    """The Merkle tree over leaf words [..., M, W] on one device, or with
    `mesh` over the [M/s, W] leaves this shard holds of M leaves in s
    contiguous shards. `root` [..., 8] is the whole tree's, on every
    shard; `bundle` gives the whole tree's branch bundles."""

    def __init__(self, leaf_words, mesh=None):
        if leaf_words.shape[-2] < 2:
            raise ValueError("a shard must hold at least one leaf pair")
        self.leaf, self.mesh = leaf_words, mesh
        self.lvl1, self.levels, local_root = tree_build(leaf_words)
        lead = leaf_words.shape[:-2]
        roots = (local_root[..., None, :] if mesh is None else
                 mesh.all_gather(local_root).movedim(0, -2))
        self.top = [roots]                  # [..., s, 8] up to [..., 1, 8]
        while self.top[-1].shape[-2] > 1:
            cur = self.top[-1]
            self.top.append(b2.blake2s_words(
                cur.reshape(*lead, cur.shape[-2] // 2, 16), 64))
        self.root = self.top[-1][..., 0, :]

    def bundle(self, idx):
        """`tree_bundle` of the whole tree at int64 indices [..., K],
        on every shard."""
        if self.mesh is None:
            return tree_bundle(self.leaf, self.lvl1, self.levels, idx)
        m_loc, r = self.leaf.shape[-2], self.mesh.shard_index
        owner = idx // m_loc
        mine = owner == r
        local = torch.where(mine, idx - r * m_loc, 0)
        parts = [tree_bundle(self.leaf, self.lvl1, self.levels, local)]
        node = owner
        for level in self.top[:-1]:
            parts.append(_rows(level, node ^ 1))
            node = node >> 1
        rows = torch.cat(parts, dim=-1)
        return self.mesh.all_reduce(rows * mine[..., None])


def bundle_to_branches(bundle_np, leaf_width_words: int) -> list:
    """Host decode of a fetched [K, total] uint32 bundle into
    reference-format branches [leaf, sibling leaf, digest siblings...]."""
    k, total = bundle_np.shape
    w = leaf_width_words
    n_levels = (total - 2 * w) // 8
    buf = np.ascontiguousarray(bundle_np).astype('<u4',
                                                 copy=False).tobytes()
    row_b = 4 * total
    out = []
    for r in range(k):
        base = r * row_b
        branch = [buf[base:base + 4 * w], buf[base + 4 * w:base + 8 * w]]
        off = base + 8 * w
        for _ in range(n_levels):
            branch.append(buf[off:off + 32])
            off += 32
        out.append(branch)
    return out
