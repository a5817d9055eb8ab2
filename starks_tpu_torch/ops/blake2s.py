"""Batched blake2s-256 in plain PyTorch.

Counterpart of `starks_tpu/ops/blake2s.py`. The JAX package left blake2s
to XLA, so there is no Pallas kernel to port; this module is plain
tensor code on the card and on the CPU alike (a CUDA blake2s is later
work). Words are `int64` tensors holding uint32 values; every add and
rotate is masked back to 32 bits. One call hashes a whole batch of
equal-length messages: leading dims are the batch.

Field elements are serialized to 32-byte BIG-endian leaves (SURVEY
§A.4); `limbs_to_words` performs that reordering, so digests match
`hashlib.blake2s` on the reference's byte strings.
"""

import torch

from . import limbs as fl

_M32 = 0xFFFFFFFF

IV = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]

# Parameter word for: digest_length=32, key=0, fanout=1, depth=1.
_PARAM0 = 0x01010020

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


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & _M32


def _g(a, b, c, d, x, y):
    """The G mixing function on [..., 4] rows (four columns at once)."""
    a = (a + b + x) & _M32
    d = _rotr(d ^ a, 16)
    c = (c + d) & _M32
    b = _rotr(b ^ c, 12)
    a = (a + b + y) & _M32
    d = _rotr(d ^ a, 8)
    c = (c + d) & _M32
    b = _rotr(b ^ c, 7)
    return a, b, c, d


def compress(h, m, t: int, final: bool):
    """One compression. h: [..., 8] state; m: [..., 16] message words;
    t: bytes hashed through this block; final: last-block flag.

    Row form: the 4x4 state is four [..., 4] rows, so one G call mixes
    all four columns (or diagonals) — a quarter of the tensor ops of
    one call per G."""
    shape = h.shape[:-1] + (4,)
    r0, r1 = h[..., 0:4], h[..., 4:8]
    r2 = torch.tensor(IV[0:4], dtype=torch.int64,
                      device=h.device).expand(shape)
    r3 = torch.tensor([IV[4] ^ t, IV[5], IV[6] ^ (_M32 if final else 0),
                       IV[7]], dtype=torch.int64,
                      device=h.device).expand(shape)
    for s in SIGMA:
        r0, r1, r2, r3 = _g(r0, r1, r2, r3,
                            m[..., s[0:8:2]], m[..., s[1:8:2]])
        r1 = torch.roll(r1, -1, dims=-1)
        r2 = torch.roll(r2, -2, dims=-1)
        r3 = torch.roll(r3, -3, dims=-1)
        r0, r1, r2, r3 = _g(r0, r1, r2, r3,
                            m[..., s[8:16:2]], m[..., s[9:16:2]])
        r1 = torch.roll(r1, 1, dims=-1)
        r2 = torch.roll(r2, 2, dims=-1)
        r3 = torch.roll(r3, 3, dims=-1)
    return torch.cat([h[..., 0:4] ^ r0 ^ r2, h[..., 4:8] ^ r1 ^ r3], dim=-1)


def blake2s_words(m, total_bytes: int):
    """blake2s-256 of messages given as [..., W] int64 LE words (uint32
    values), W a multiple of 16 words, zero-padded past total_bytes.
    Returns [..., 8] digest words."""
    nwords = m.shape[-1]
    assert nwords % 16 == 0 and nwords * 4 >= total_bytes
    nblocks = nwords // 16
    h0 = list(IV)
    h0[0] ^= _PARAM0
    h = torch.tensor(h0, dtype=torch.int64, device=m.device).expand(
        m.shape[:-1] + (8,))
    for blk in range(nblocks):
        final = blk == nblocks - 1
        t = total_bytes if final else 64 * (blk + 1)
        h = compress(h, m[..., blk * 16:(blk + 1) * 16], t, final)
    return h


def byteswap32(x):
    return (((x & 0xFF) << 24) | ((x & 0xFF00) << 8)
            | ((x >> 8) & 0xFF00) | (x >> 24))


def limbs_to_words(x):
    """[..., 8] int32 field elements -> [..., 8] int64 message words equal
    to the 32-byte BIG-endian serialization read as little-endian uint32
    words (SURVEY §A.4 leaf format): the words in reverse order, each
    byte-swapped."""
    return byteswap32(fl.words_u32(x).flip(-1))


def words_to_limbs(w):
    """Inverse of limbs_to_words: [..., 8] int64 words -> int32 elements
    (the big-endian integer a digest's bytes spell, not reduced)."""
    return fl.words_to_storage(byteswap32(w).flip(-1))
