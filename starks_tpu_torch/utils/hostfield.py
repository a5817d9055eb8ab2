"""Host-side scalar field helpers for the transcript-adjacent small work
(the port's own copy of `starks_tpu/utils/hostfield.py`).

The verifier is O(queries * polylog) and inherently scalar (SURVEY §4.2),
and the prover has a handful of small computations (round-constant
mini-polynomial, boundary interpolant, the 8-periodic Z-numerator
inverses, the per-config 1/Z2 table) that run on host bigints. This
module is that thin scalar layer — NOT a general field library; the bulk
path is starks_tpu_torch.ops.limbs and the CUDA kernels.
"""

MODULUS = 2**256 - 351 * 2**32 + 1


def inv(a: int, m: int = MODULUS) -> int:
    """Modular inverse via extended Euclid (~10x faster than the Fermat
    pow(a, m-2, m) path for a 256-bit modulus; the verifier does ~10^3 of
    these per proof). inv(0) = 0, matching the reference convention
    (`starks/poly_utils.py :: PrimeField.inv`, SURVEY §3.1)."""
    a %= m
    if a == 0:
        return 0
    lm, hm = 1, 0
    low, high = a, m
    while low > 1:
        r = high // low
        lm, low, hm, high = hm - lm * r, high - low * r, lm, low
    return lm % m


def multi_inv(values, m: int = MODULUS):
    """Batch modular inverse (`starks/poly_utils.py :: multi_inv`,
    SURVEY §3.1): ONE extended-Euclid inversion + 3(n-1) multiplies.
    Zeros map to zero. The verifier batches its ~300 per-proof
    inversions through this (round-4 verifier speedup)."""
    partials = [1]
    for v in values:
        partials.append(partials[-1] * (v % m if v % m else 1) % m)
    outputs = [0] * len(values)
    acc = inv(partials[-1], m)
    for i in range(len(values) - 1, -1, -1):
        vi = values[i] % m
        outputs[i] = partials[i] * acc % m if vi else 0
        acc = acc * (vi if vi else 1) % m
    return outputs


def host_ntt(vals, root: int, inverse: bool = False, m: int = MODULUS):
    """Iterative radix-2 NTT over <root> (order must be a power of two >=
    len(vals); zero-pads). Natural order in/out; inverse scales by n^-1.
    Produces the same values as the reference's recursive fft (§4.4)."""
    order = 1
    acc = root % m
    while acc != 1:
        acc = acc * root % m
        order += 1
        assert order <= 2**20, "host_ntt is for small domains only"
    n = order
    assert n & (n - 1) == 0, "subgroup order must be a power of two"
    x = list(vals) + [0] * (n - len(vals))
    w = inv(root, m) if inverse else root

    # Bit-reversal permutation.
    bits = n.bit_length() - 1
    for i in range(n):
        r = int(format(i, f'0{bits}b')[::-1], 2) if bits else 0
        if r > i:
            x[i], x[r] = x[r], x[i]

    size = 2
    while size <= n:
        wlen = pow(w, n // size, m)
        half = size // 2
        for start in range(0, n, size):
            acc = 1
            for j in range(half):
                u = x[start + j]
                v = x[start + j + half] * acc % m
                x[start + j] = (u + v) % m
                x[start + j + half] = (u - v) % m
                acc = acc * wlen % m
        size *= 2
    if inverse:
        ninv = inv(n, m)
        x = [v * ninv % m for v in x]
    return x


def eval_poly_at(coeffs, x: int, m: int = MODULUS) -> int:
    y = 0
    for c in reversed(coeffs):
        y = (y * x + c) % m
    return y


def line_through(x0, y0, x1, y1, m: int = MODULUS):
    """Degree-1 interpolant through two points, as [a0, a1]."""
    slope = (y1 - y0) * inv(x0 - x1, m) * (-1) % m
    return [(y0 - slope * x0) % m, slope]


def _mul_linear(poly, c, m):
    """poly(x) * (x - c)."""
    out = [0] * (len(poly) + 1)
    for k, a in enumerate(poly):
        out[k + 1] = (out[k + 1] + a) % m
        out[k] = (out[k] - a * c) % m
    return out


def interp4(xs, ys, m: int = MODULUS):
    """Quartic (degree-3) interpolation through 4 points; coefficient list
    [a0..a3]. `interp4_coset` is its fast form for FRI's coset points."""
    coeffs = [0, 0, 0, 0]
    for j in range(4):
        num = [1]
        denom = 1
        for k in range(4):
            if k == j:
                continue
            num = _mul_linear(num, xs[k], m)
            denom = denom * (xs[j] - xs[k]) % m
        scale = ys[j] * inv(denom, m) % m
        for k in range(4):
            coeffs[k] = (coeffs[k] + num[k] * scale) % m
    return coeffs


_INV4 = None


def interp4_coset(x1: int, i4: int, ys, m: int = MODULUS,
                  x1_inv: int = None):
    """Quartic interpolation through the coset points x1 * {1, i, -1, -i}
    (i4 = primitive 4th root of unity) — the exact point structure of
    every FRI row (`starks/fri.py` groups rows by stride N/4, SURVEY
    §4.3), so Lagrange interpolation collapses to a 4-point inverse DFT:
    c_k = (1/4) * x1^{-k} * sum_j i^{-jk} ys[j]. ONE extended-Euclid
    inversion instead of `interp4`'s four; pass `x1_inv` (e.g. from a
    multi_inv batch over all of a round's queries) for zero."""
    global _INV4
    if _INV4 is None or m != MODULUS:
        inv4 = inv(4, m)
        if m == MODULUS:
            _INV4 = inv4
    else:
        inv4 = _INV4
    y0, y1, y2, y3 = ys
    e = (y0 + y2) % m
    d = (y0 - y2) % m
    f = (y1 + y3) % m
    g = (y3 - y1) * i4 % m
    s0 = (e + f) % m
    s1 = (d + g) % m
    s2 = (e - f) % m
    s3 = (d - g) % m
    x1i = inv(x1, m) if x1_inv is None else x1_inv
    c0 = s0 * inv4 % m
    c1 = s1 * inv4 * x1i % m
    x1i2 = x1i * x1i % m
    c2 = s2 * inv4 * x1i2 % m
    c3 = s3 * inv4 * x1i2 % m * x1i % m
    return [c0, c1, c2, c3]


def eval_quartic(p, x: int, m: int = MODULUS) -> int:
    xsq = x * x % m
    return (p[0] + p[1] * x + p[2] * xsq + p[3] * xsq * x) % m


def interp_many(xs, ys, m: int = MODULUS):
    """O(n^2) Lagrange interpolation (FRI final-round direct check)."""
    n = len(xs)
    # Vanishing polynomial of all xs.
    root = [1]
    for x in xs:
        root = _mul_linear(root, x, m)
    out = [0] * n
    for j in range(n):
        # Divide root by (x - xs[j]) synthetically (from the top down).
        q = [0] * n
        rem = root[n]
        for k in range(n - 1, -1, -1):
            q[k] = rem
            rem = (root[k] + rem * xs[j]) % m
        denom = eval_poly_at(q, xs[j], m)
        scale = ys[j] * inv(denom, m) % m
        for k in range(n):
            out[k] = (out[k] + q[k] * scale) % m
    return out
