"""blake2s-256 (RFC 7693) over many messages at once, in plain PyTorch.

Words are int64 tensors holding 32-bit values, the word index on the
first axis: a message block is [16, *lanes], a state [8, *lanes]. Each
round's four column mixes run as one step on [4, *lanes] slices, then
the four diagonal mixes. `hashlib.blake2s` is the definition; the tests
hold this to it.
"""

import hashlib

import torch

M32 = 0xFFFFFFFF
IV = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]
SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]
# blake2s-256 with no key: h0 ^= 0x01010000 | (key length << 8) | 32.
H0 = [IV[0] ^ 0x01010020] + IV[1:]


def blake(data: bytes) -> bytes:
    return hashlib.blake2s(data).digest()


def _rotr(x, n):
    return (x >> n) | ((x << (32 - n)) & M32)


def _mix(a, b, c, d, x, y):
    a = (a + b + x) & M32
    d = _rotr(d ^ a, 16)
    c = (c + d) & M32
    b = _rotr(b ^ c, 12)
    a = (a + b + y) & M32
    d = _rotr(d ^ a, 8)
    c = (c + d) & M32
    b = _rotr(b ^ c, 7)
    return a, b, c, d


def _col(vals, like):
    return torch.tensor(vals, dtype=torch.int64, device=like.device).reshape(
        (len(vals),) + (1,) * (like.dim() - 1))


def compress(h, m, counter: int, last: bool):
    """One compression of block m [16, *lanes] into state h [8, *lanes]
    (or [8, 1, ...] to broadcast), `counter` the bytes hashed so far
    with this block."""
    tail = [IV[4] ^ (counter & M32), IV[5] ^ (counter >> 32),
            IV[6] ^ (M32 if last else 0), IV[7]]
    shape = torch.broadcast_shapes(h.shape[1:], m.shape[1:])
    a = h[0:4].expand((4,) + shape)
    b = h[4:8].expand((4,) + shape)
    c = _col(IV[0:4], m).expand((4,) + shape)
    d = _col(tail, m).expand((4,) + shape)
    for s in SIGMA:
        idx = torch.tensor(s, device=m.device)
        mx = m.index_select(0, idx[0:8:2])
        my = m.index_select(0, idx[1:8:2])
        a, b, c, d = _mix(a, b, c, d, mx, my)
        b, c, d = b.roll(-1, 0), c.roll(-2, 0), d.roll(-3, 0)
        mx = m.index_select(0, idx[8:16:2])
        my = m.index_select(0, idx[9:16:2])
        a, b, c, d = _mix(a, b, c, d, mx, my)
        b, c, d = b.roll(1, 0), c.roll(2, 0), d.roll(3, 0)
    return h ^ torch.cat([a, b]) ^ torch.cat([c, d])


def hash_words(words):
    """blake2s-256 of messages given as 32-bit little-endian words
    [16 k, *lanes] (64 k bytes each) -> digests [8, *lanes]."""
    blocks = words.shape[0] // 16
    h = _col(H0, words)
    for k in range(blocks):
        h = compress(h, words[16 * k:16 * (k + 1)], 64 * (k + 1),
                     k == blocks - 1)
    return h


def digest_bytes(h) -> list:
    """[8, n] digests -> n 32-byte strings."""
    import numpy as np
    arr = np.ascontiguousarray(h.T.cpu().numpy().astype("<u4"))
    return [row.tobytes() for row in arr]
