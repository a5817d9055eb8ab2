"""Plain PyTorch arithmetic mod p = 2^256 - 351 * 2^32 + 1.

An element is 16 limbs of 16 bits, least significant first, in int64,
with the limbs on the FIRST axis: a tensor [16, *shape] holds one
element per position of `shape`, so a limb is a contiguous slice. Every
function takes and returns canonical elements (each limb in [0, 2^16),
the value in [0, p)); products of limbs stay far below 2^63. Nothing
here is fast: each step is a plain elementwise tensor operation, the
same on the CPU and on a card.
"""

import numpy as np
import torch

MODULUS = 2 ** 256 - 351 * 2 ** 32 + 1
LIMBS = 16
MASK = 0xFFFF
# 2^256 = FOLD (mod p), FOLD = 351 * 2^32 - 1: a limb h above 2^256
# folds back as 351 h two limbs up, less h.
FOLD_MUL = 351
P_LIMBS = [(MODULUS >> (16 * i)) & MASK for i in range(LIMBS)]


def from_ints(vals, device="cpu") -> torch.Tensor:
    """[16, len(vals)] from Python ints (reduced mod p)."""
    raw = b"".join((v % MODULUS).to_bytes(32, "little") for v in vals)
    limbs = np.frombuffer(raw, dtype="<u2").reshape(-1, LIMBS)
    return torch.from_numpy(limbs.astype(np.int64).T.copy()).to(device)


def const(v: int, device, dims: int = 1) -> torch.Tensor:
    """One element as [16, 1, ..., 1] (`dims` ones), for broadcasting."""
    return from_ints([v], device).reshape((LIMBS,) + (1,) * dims)


def to_le_bytes(x: torch.Tensor) -> np.ndarray:
    """[16, n] canonical -> [n, 32] uint8, little-endian per element."""
    return np.ascontiguousarray(
        x.T.cpu().numpy().astype("<u2")).view(np.uint8).reshape(-1, 32)


def to_ints(x: torch.Tensor) -> list:
    raw = to_le_bytes(x)
    return [int.from_bytes(row.tobytes(), "little") for row in raw]


def to_be_bytes(x: torch.Tensor) -> list:
    """[16, n] canonical -> n 32-byte big-endian strings."""
    raw = to_le_bytes(x)[:, ::-1]
    return [row.tobytes() for row in raw]


def _carry(x: torch.Tensor, width: int) -> torch.Tensor:
    """Limbs of any size (a nonnegative value below 2^(16 width)) ->
    `width` limbs in [0, 2^16), carried one limb at a time."""
    out = torch.empty((width,) + x.shape[1:], dtype=torch.int64,
                      device=x.device)
    c = None
    for i in range(width):
        if i < x.shape[0]:
            t = x[i] if c is None else x[i] + c
        else:
            t = c
        torch.bitwise_and(t, MASK, out=out[i])
        c = t >> 16
    return out, c


def _p_limbs(width: int, like: torch.Tensor) -> torch.Tensor:
    p = torch.tensor(P_LIMBS + [0] * (width - LIMBS), dtype=torch.int64,
                     device=like.device)
    return p.reshape((width,) + (1,) * (like.dim() - 1))


def _below_2p(v: torch.Tensor) -> torch.Tensor:
    """Limbs of any size whose value lies in [0, 2p) -> canonical: v and
    v - p carried side by side (17 limbs), v kept where v - p borrowed."""
    width = LIMBS + 1
    if v.shape[0] < width:
        v = torch.cat([v, v.new_zeros((width - v.shape[0],) + v.shape[1:])])
    both, c = _carry(torch.stack([v, v - _p_limbs(width, v)], dim=1), width)
    keep = (c[1] < 0).unsqueeze(0)        # v < p: the difference borrowed
    return torch.where(keep, both[:LIMBS, 0], both[:LIMBS, 1])


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod p, broadcasting over the axes after the limbs."""
    shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    acc = torch.zeros((2 * LIMBS - 1,) + shape, dtype=torch.int64,
                      device=a.device)
    for i in range(LIMBS):
        acc[i:i + LIMBS] += a[i] * b
    # Each limb of acc is below 16 * 2^32. Fold the limbs from 2^256 up
    # as they are (351 h two limbs up, less h: below 2^45 a limb), carry
    # (below 2^302: 19 limbs), fold the three top limbs again: the value
    # is then below 2^256 + 2^87 < 2p.
    t = torch.zeros((LIMBS + 2,) + shape, dtype=torch.int64,
                    device=a.device)
    hi = acc[LIMBS:]
    t[:LIMBS] += acc[:LIMBS]
    t[2:2 + hi.shape[0]] += FOLD_MUL * hi
    t[:hi.shape[0]] -= hi
    v, _ = _carry(t, 19)
    lo, hi = v[:LIMBS].clone(), v[LIMBS:]
    lo[2:5] += FOLD_MUL * hi
    lo[:3] -= hi
    return _below_2p(lo)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _below_2p(a + b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _below_2p(a - b + _p_limbs(LIMBS, a if a.dim() >= b.dim()
                                      else b))


def powers(g: int, n: int, device) -> torch.Tensor:
    """[16, n]: g^0 .. g^(n-1), by doubling."""
    t = from_ints([1], device)
    while t.shape[1] < n:
        k = t.shape[1]
        step = const(pow(g, k, MODULUS), device)
        t = torch.cat([t, mul(t[:, :min(k, n - k)], step)], dim=1)
    return t


def batch_inv(x: torch.Tensor) -> torch.Tensor:
    """Inverses of [16, n] (n a power of two; 1/0 = 0), by a product
    tree: products up, one inverse by Python's pow at the top, and each
    node's inverse down as its parent's times its sibling."""
    zero = (x == 0).all(dim=0)
    one = from_ints([1], x.device)
    levels = [torch.where(zero.unsqueeze(0), one, x)]
    while levels[-1].shape[1] > 1:
        v = levels[-1]
        levels.append(mul(v[:, 0::2], v[:, 1::2]))
    top = to_ints(levels[-1])[0]
    inv = from_ints([pow(top, MODULUS - 2, MODULUS)], x.device)
    for v in reversed(levels[:-1]):
        nxt = torch.empty_like(v)
        nxt[:, 0::2] = mul(inv, v[:, 1::2])
        nxt[:, 1::2] = mul(inv, v[:, 0::2])
        inv = nxt
    return torch.where(zero.unsqueeze(0), torch.zeros_like(inv), inv)
