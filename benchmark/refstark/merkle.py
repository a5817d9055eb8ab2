"""Merkle trees of the MiMC STARK (ethereum/research mimc_stark/
merkle_tree.py): leaves are the raw 32-byte big-endian values (or the
96-byte P||D||B concatenations of the main tree), not hashed; node i is
blake2s(node 2i || node 2i + 1); a branch is [leaf, its sibling, then
one sibling digest a level up to the root's children].

Large levels are hashed on the device (refstark.blake, all claims at
once); once a level has at most HOST_NODES nodes, the rest of the tree
is hashed on the host with hashlib.
"""

import torch

from . import blake as B
from . import field as F

HOST_NODES = 2048


def _bswap16(x):
    return ((x >> 8) & 0xFF) | ((x & 0xFF) << 8)


def element_words(x: torch.Tensor) -> torch.Tensor:
    """[16, *s] canonical elements -> [8, *s] 32-bit words of their
    32-byte big-endian encodings, read little-endian as blake2s reads
    its message."""
    return torch.stack([_bswap16(x[15 - 2 * j]) | (_bswap16(x[14 - 2 * j])
                                                   << 16)
                        for j in range(8)])


class Tree:
    """The trees of `columns` ([16, claims, n] each; one column gives
    32-byte leaves, several their concatenation), one per claim."""

    def __init__(self, columns, host_nodes: int = None):
        host_nodes = HOST_NODES if host_nodes is None else host_nodes
        self.columns = columns
        n = columns[0].shape[-1]
        self.claims = columns[0].shape[1]
        self.n = n
        words = [element_words(c) for c in columns]          # [8, C, n]
        leaf = torch.cat(words)                               # [8 w, C, n]
        pairs = torch.cat([leaf[..., 0::2], leaf[..., 1::2]])
        level = B.hash_words(pairs)                           # [8, C, n/2]
        self.device_levels = [level]
        while level.shape[-1] > max(host_nodes, 1):
            level = B.hash_words(torch.cat([level[..., 0::2],
                                            level[..., 1::2]]))
            self.device_levels.append(level)
        # Host levels, per claim: the last device level, then up to the
        # root.
        self.host_levels = []
        for c in range(self.claims):
            nodes = B.digest_bytes(level[:, c])
            levels = []
            while len(nodes) > 1:
                nodes = [B.blake(nodes[2 * i] + nodes[2 * i + 1])
                         for i in range(len(nodes) // 2)]
                levels.append(nodes)
            self.host_levels.append(levels)
        self.roots = [lv[-1][0] if lv else nodes[0]
                      for lv, nodes in zip(self.host_levels, (
                          B.digest_bytes(level[:, c])
                          for c in range(self.claims)))]

    def _leaves(self, claim: int, idx) -> list:
        pos = torch.tensor(idx, device=self.columns[0].device)
        parts = [F.to_be_bytes(col[:, claim].index_select(-1, pos))
                 for col in self.columns]
        return [b"".join(p) for p in zip(*parts)]

    def branches(self, claim: int, indices) -> list:
        """[leaf, sibling leaf, sibling digests...] for each index."""
        idx = list(indices)
        out = [[leaf, sib] for leaf, sib in zip(
            self._leaves(claim, idx), self._leaves(claim, [i ^ 1
                                                           for i in idx]))]
        k = 1
        for level in self.device_levels[:-1]:
            pos = torch.tensor([(i >> k) ^ 1 for i in idx],
                               device=level.device)
            for br, d in zip(out, B.digest_bytes(
                    level[:, claim].index_select(-1, pos))):
                br.append(d)
            k += 1
        # The last device level as bytes, then the host levels, below
        # the root.
        upper = ([B.digest_bytes(self.device_levels[-1][:, claim])]
                 + self.host_levels[claim])
        for nodes in upper[:-1]:
            for br, i in zip(out, idx):
                br.append(nodes[(i >> k) ^ 1])
            k += 1
        return out
