"""The STARK field as PyTorch tensors, and the plain field arithmetic.

Counterpart of `starks_tpu/ops/limbs.py` (add, sub, neg, mul, sqr,
cube, pow_const, powers_series, eq_zero, inv, batch_inv) plus the lane
functions of `starks_tpu/ops/plimbs.py` (`_add_lanes`, `_sub_lanes`,
`_mul_lanes`, `_cube_lanes`). No proof path calls neg, sqr, pow_const,
powers_series, eq_zero or inv: like their JAX counterparts, they are
plain helpers with no kernel. `batch_inv` is the plain version of the
batch-inverse kernel (`plimbs.batch_inv`), which the set-ups run.

Storage: a field element is a `torch.int32` tensor of shape [..., 8]
holding the 8 little-endian 32-bit words of its canonical value (bits
reinterpreted as signed). 32 contiguous bytes per element: two 16-byte
loads per CUDA thread, and the word size of the kernels' 32x32->64-bit
carry chains (csrc/field.cuh).

The plain arithmetic below is the reference form of every kernel: it
runs in `int64` on 16-bit limbs, because CPU builds of torch have no
`+` or `>>` for `uint32`. Every result is canonical, so any correct
reduction gives the same bits as the JAX package's limb kernels.
"""

import numpy as np
import torch

MODULUS = 2**256 - 351 * 2**32 + 1
NUM_WORDS = 8
NUM_LIMBS = 16
_M16 = 0xFFFF
_M32 = 0xFFFFFFFF


def _limbs_of(x: int, n: int = NUM_LIMBS):
    return [(x >> (16 * i)) & _M16 for i in range(n)]


_P_LIMBS = _limbs_of(MODULUS)
_C_LIMBS = _limbs_of(2**256 % MODULUS, 3)     # c = 351*2^32 - 1


# -- storage <-> working form -------------------------------------------

def words_u32(x: torch.Tensor) -> torch.Tensor:
    """[..., 8] int32 storage -> [..., 8] int64 word values in [0, 2^32)."""
    return x.to(torch.int64) & _M32


def words_to_storage(w: torch.Tensor) -> torch.Tensor:
    """[..., 8] int64 word values in [0, 2^32) -> int32 storage."""
    return (w - ((w >> 31) << 32)).to(torch.int32)


def to_limbs16(x: torch.Tensor) -> torch.Tensor:
    """[..., 8] int32 storage -> [..., 16] int64 16-bit limbs."""
    w = words_u32(x)
    return torch.stack([w & _M16, w >> 16], dim=-1).reshape(
        *x.shape[:-1], NUM_LIMBS)


def from_limbs16(limbs: torch.Tensor) -> torch.Tensor:
    """[..., 16] int64 16-bit limbs -> [..., 8] int32 storage."""
    pairs = limbs.reshape(*limbs.shape[:-1], NUM_WORDS, 2)
    return words_to_storage(pairs[..., 0] | (pairs[..., 1] << 16))


def from_jax_limbs(limbs: np.ndarray, device=None) -> torch.Tensor:
    """JAX-package limbs ([N, 16] uint32, 16-bit values) -> port tensor."""
    limbs = np.asarray(limbs, dtype=np.uint32)
    words = limbs[..., 0::2] | (limbs[..., 1::2] << 16)
    return torch.from_numpy(
        np.ascontiguousarray(words).view(np.int32).copy()).to(device)


def to_jax_limbs(x: torch.Tensor) -> np.ndarray:
    """Port tensor -> JAX-package limbs ([N, 16] uint32)."""
    w = x.detach().cpu().contiguous().numpy().view(np.uint32)
    return np.stack([w & _M16, w >> 16], axis=-1).reshape(
        *w.shape[:-1], NUM_LIMBS).astype(np.uint32)


# -- plain arithmetic on [..., 16] int64 limbs --------------------------

def _carry(cols: torch.Tensor):
    """Propagate signed int64 columns into 16-bit limbs.

    Returns (limbs [..., K], carry [...]); the carry is negative when
    the columns sum to a negative value (a borrow)."""
    out = torch.empty_like(cols)
    carry = torch.zeros_like(cols[..., 0])
    for i in range(cols.shape[-1]):
        t = cols[..., i] + carry
        out[..., i] = t & _M16
        carry = t >> 16
    return out, carry


def _p_like(x: torch.Tensor, width: int = NUM_LIMBS) -> torch.Tensor:
    return torch.tensor(_P_LIMBS + [0] * (width - NUM_LIMBS),
                        dtype=torch.int64, device=x.device)


def _cond_sub_p(x: torch.Tensor, top=None) -> torch.Tensor:
    """x - p where (top:x) >= p, else x; for (top:x) < 2p."""
    if top is not None:
        x = torch.cat([x, top[..., None]], dim=-1)
    d, borrow = _carry(x - _p_like(x, x.shape[-1]))
    return torch.where((borrow >= 0)[..., None], d, x)[..., :NUM_LIMBS]


def add16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s, carry = _carry(a + b)
    return _cond_sub_p(s, carry)


def sub16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d, borrow = _carry(a - b)
    e, _ = _carry(d + _p_like(d))
    return torch.where((borrow < 0)[..., None], e, d)


def mul16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook 16x16 limbs, two folds of the high half by
    c = 2^256 mod p, a carry fold, one conditional subtract of p."""
    a, b = torch.broadcast_tensors(a, b)
    prod = a[..., :, None] * b[..., None, :]            # each < 2^32
    cols = torch.zeros(*a.shape[:-1], 2 * NUM_LIMBS, dtype=torch.int64,
                       device=a.device)
    for i in range(NUM_LIMBS):
        cols[..., i:i + NUM_LIMBS] += prod[..., i, :]
    w, _ = _carry(cols)                                 # 512-bit value
    f = torch.zeros(*a.shape[:-1], NUM_LIMBS + 4, dtype=torch.int64,
                    device=a.device)
    f[..., :NUM_LIMBS] = w[..., :NUM_LIMBS]
    for k, c in enumerate(_C_LIMBS):
        f[..., k:k + NUM_LIMBS] += c * w[..., NUM_LIMBS:]
    f, _ = _carry(f)                                    # < 2^298
    g = f[..., :NUM_LIMBS].clone()
    for k, c in enumerate(_C_LIMBS):
        g[..., k:k + 4] += c * f[..., NUM_LIMBS:]
    g, top = _carry(g)                                  # top in {0, 1}
    for k, c in enumerate(_C_LIMBS):
        g[..., k] += c * top
    g, _ = _carry(g)
    return _cond_sub_p(g)


def div4_16(x: torch.Tensor) -> torch.Tensor:
    """x / 4 mod p for canonical x, exactly: p = 1 mod 4, so with
    k = -x mod 4 the sum x + k*p is a multiple of 4 below 4p, and its
    quarter is canonical."""
    k = (-x[..., 0]) & 3
    s, top = _carry(x + k[..., None] * _p_like(x))
    above = torch.cat([s[..., 1:], top[..., None]], dim=-1)
    return (s >> 2) | ((above & 3) << 14)


def cube16(a: torch.Tensor) -> torch.Tensor:
    return mul16(mul16(a, a), a)


# -- plain arithmetic on storage tensors --------------------------------

def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p on [..., 8] int32 tensors."""
    return from_limbs16(add16(to_limbs16(a), to_limbs16(b)))


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return from_limbs16(sub16(to_limbs16(a), to_limbs16(b)))


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return from_limbs16(mul16(to_limbs16(a), to_limbs16(b)))


def cube(a: torch.Tensor) -> torch.Tensor:
    return from_limbs16(cube16(to_limbs16(a)))


def cond_sub_p(a: torch.Tensor) -> torch.Tensor:
    """Canonicalize a value in [0, 2p) (e.g. a 256-bit digest)."""
    return from_limbs16(_cond_sub_p(to_limbs16(a)))


def neg(a: torch.Tensor) -> torch.Tensor:
    """(-a) mod p."""
    return sub(torch.zeros_like(a), a)


def sqr(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def _one_like(x: torch.Tensor) -> torch.Tensor:
    """The field's 1 in x's shape."""
    out = torch.zeros_like(x)
    out[..., 0] = 1
    return out


def pow_const(x: torch.Tensor, e: int) -> torch.Tensor:
    """x^e for a Python-int exponent e >= 0 (square and multiply, from
    the top bit down)."""
    acc = _one_like(x)
    for bit in bin(e)[2:] if e else "":
        acc = sqr(acc)
        if bit == "1":
            acc = mul(acc, x)
    return acc


def powers_series(g: torch.Tensor, n: int) -> torch.Tensor:
    """[n, 8]: g^0 .. g^(n-1) for one element g ([8] or [1, 8]), by
    doubling (each step multiplies the powers so far by the next power
    of g)."""
    g_pow = g.reshape(1, NUM_WORDS)
    arr = _one_like(g_pow)
    while arr.shape[0] < n:
        arr = torch.cat([arr, mul(arr, g_pow)])
        g_pow = sqr(g_pow)
    return arr[:n]


def eq_zero(x: torch.Tensor) -> torch.Tensor:
    """Boolean [...]: True where x is 0."""
    return torch.all(x == 0, dim=-1)


def inv(x: torch.Tensor) -> torch.Tensor:
    """The Fermat inverse x^(p-2), elementwise; inv(0) = 0.

    Counterpart of JAX `limbs.inv` (starks_tpu/ops/limbs.py:207) and
    `fused.inv_scan` (starks_tpu/ops/fused.py:689). 503 plain products
    over the whole array: for one element or a few."""
    return pow_const(x, MODULUS - 2)


def _int_of(x: torch.Tensor) -> int:
    """One element ([8] storage) as a Python int."""
    return sum(w << (32 * i) for i, w in enumerate(words_u32(x).tolist()))


def _inv_one(x: torch.Tensor) -> torch.Tensor:
    """x^(p-2) of one nonzero element ([1, 8]): the Fermat inverse of
    `inv`, by Python's modular power on its one value rather than 503
    plain products."""
    v = pow(_int_of(x[0]), MODULUS - 2, MODULUS)
    w = torch.tensor([(v >> (32 * i)) & _M32 for i in range(NUM_WORDS)],
                     dtype=torch.int64, device=x.device)
    return words_to_storage(w)[None]


# Columns of batch_inv's blocked layout when `rows` is not given: C
# sequential plain products a pass, over arrays of n / C elements.
BATCH_INV_COLS = 16


def _batch_inv_nonzero(v: torch.Tensor, rows=None) -> torch.Tensor:
    """Inverses of nonzero elements [n, 8] by Montgomery's trick over a
    blocked [R, C] layout (the tail padded with ones): each row's
    exclusive prefix products, the R row totals inverted (recursively, by
    the same trick, down to one Fermat inverse), then a backward pass,
    out = prefix * acc and acc *= x, as the kernel runs each run."""
    n = v.shape[0]
    if n == 1:
        return _inv_one(v)
    rows = -(-n // BATCH_INV_COLS) if rows is None else rows
    cols = -(-n // rows)
    pad = _one_like(v[:1]).expand(rows * cols - n, NUM_WORDS)
    x = torch.cat([v, pad]).reshape(rows, cols, NUM_WORDS)
    prefix = torch.empty_like(x)
    acc = _one_like(x[:, 0])
    for c in range(cols):
        prefix[:, c] = acc
        acc = mul(acc, x[:, c])
    acc = _batch_inv_nonzero(acc)                 # 1 / row totals
    out = torch.empty_like(x)
    for c in reversed(range(cols)):
        out[:, c] = mul(prefix[:, c], acc)
        acc = mul(acc, x[:, c])
    return out.reshape(rows * cols, NUM_WORDS)[:n]


def batch_inv(v: torch.Tensor, rows=None) -> torch.Tensor:
    """Elementwise inverse of [n, 8] by Montgomery's trick; zeros map to
    zero (each counts as 1 in the products).

    Counterpart of JAX `limbs.batch_inv` (starks_tpu/ops/limbs.py:213)
    and `fused.batch_inv_scan` (starks_tpu/ops/fused.py:706): the array
    viewed as [R, C] rows (R = `rows`, default ceil(n / BATCH_INV_COLS)),
    the in-row products vectorized across the R rows. The inverses are
    unique, so any layout gives the same values; the row totals are
    inverted by the same trick rather than a length-R scan, so no loop
    runs over elements, only 3C products a level. `rows` is the JAX
    function's own parameter; no caller sets it, and the tests set it
    to show that the layout changes no value."""
    if v.dim() != 2 or v.shape[-1] != NUM_WORDS:
        raise ValueError(f"expected [n, 8] field elements, got "
                         f"{tuple(v.shape)}")
    if v.shape[0] == 0:
        return v.clone()
    zero = eq_zero(v)[:, None]
    out = _batch_inv_nonzero(torch.where(zero, _one_like(v), v), rows)
    return torch.where(zero, torch.zeros_like(v), out)
