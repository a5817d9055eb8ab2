// starkrt: the native host runtime of the PyTorch port (a copy of the
// JAX package's native/starkrt.cpp; the port builds its own).
//
// 256-bit arithmetic over the STARK prime p = 2^256 - 351*2^32 + 1 on
// 4x64-bit limbs (little-endian), with a sparse-prime folding reduction:
// 2^256 = c (mod p) with c = 351*2^32 - 1, so a 512-bit product reduces
// with two shifted multiply-adds by c plus a conditional subtract.
//
// It takes the O(steps) sequential host loops off the prover: the MiMC
// trace (a chain of dependent cubes, SURVEY §8 hard part #4), power
// tables and their slices, the four-step NTT's twiddle grid and the
// prover's 1/Z2 table, all Python-bigint loops otherwise.
//
// ABI: plain C, element = 32 bytes little-endian, which is the port's
// [n, 8] int32 layout (8 little-endian 32-bit words), so arrays pass as
// plain views. Built with g++ into build/ and loaded with ctypes by
// starks_tpu_torch/utils/native.py; tests/test_torch_native.py holds
// every entry point the port uses to Python bigints.

#include <cstdint>
#include <cstring>

typedef unsigned __int128 u128;
typedef uint64_t u64;

namespace {

// p = 2^256 - 351*2^32 + 1, little-endian 64-bit limbs.
const u64 P[4] = {0xFFFFFEA100000001ull, 0xFFFFFFFFFFFFFFFFull,
                  0xFFFFFFFFFFFFFFFFull, 0xFFFFFFFFFFFFFFFFull};
// c = 2^256 mod p = 351*2^32 - 1 (fits one limb).
const u64 C = 0x15EFFFFFFFFull;

struct Fe { u64 v[4]; };

inline bool geq_p(const Fe &a) {
  for (int i = 3; i >= 0; --i) {
    if (a.v[i] > P[i]) return true;
    if (a.v[i] < P[i]) return false;
  }
  return true;  // equal
}

inline void sub_p(Fe &a) {
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a.v[i] - P[i] - borrow;
    a.v[i] = (u64)d;
    borrow = (d >> 64) & 1;  // 1 if borrowed
  }
}

inline void cond_reduce(Fe &a) { if (geq_p(a)) sub_p(a); }

inline bool is_zero(const Fe &a) {
  return !(a.v[0] | a.v[1] | a.v[2] | a.v[3]);
}

// a + b mod p (inputs canonical).
inline Fe add(const Fe &a, const Fe &b) {
  Fe r;
  u128 carry = 0;
  for (int i = 0; i < 4; ++i) {
    u128 s = (u128)a.v[i] + b.v[i] + carry;
    r.v[i] = (u64)s;
    carry = s >> 64;
  }
  if (carry) {
    // r holds a+b-2^256; add c (== +2^256 mod p).
    u128 cc = C;
    for (int i = 0; i < 4 && cc; ++i) {
      u128 s = (u128)r.v[i] + (u64)cc;
      r.v[i] = (u64)s;
      cc = s >> 64;
    }
  }
  cond_reduce(r);
  return r;
}

// a - b mod p (inputs canonical): a + (p - b), with p - 0 taken as 0.
inline Fe sub(const Fe &a, const Fe &b) {
  if (is_zero(b)) return a;
  Fe nb;
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)P[i] - b.v[i] - borrow;
    nb.v[i] = (u64)d;
    borrow = (d >> 64) & 1;
  }
  return add(a, nb);
}

// 512-bit product then fold twice by 2^256 = c.
inline Fe mul(const Fe &a, const Fe &b) {
  u64 w[8] = {0};
  for (int i = 0; i < 4; ++i) {
    u128 carry = 0;
    for (int j = 0; j < 4; ++j) {
      u128 t = (u128)a.v[i] * b.v[j] + w[i + j] + carry;
      w[i + j] = (u64)t;
      carry = t >> 64;
    }
    w[i + 4] = (u64)carry;
  }
  // fold 1: lo + hi*c  (hi*c < 2^256 * 2^41 -> 5 limbs)
  u64 f[5] = {w[0], w[1], w[2], w[3], 0};
  u128 carry = 0;
  for (int i = 0; i < 4; ++i) {
    u128 t = (u128)w[i + 4] * C + f[i] + carry;
    f[i] = (u64)t;
    carry = t >> 64;
  }
  f[4] = (u64)carry;
  // fold 2: f[0..3] + f[4]*c (f[4] < 2^42; f[4]*c < 2^83 -> 2 limbs)
  Fe r = {{f[0], f[1], f[2], f[3]}};
  u128 t = (u128)f[4] * C + r.v[0];
  r.v[0] = (u64)t;
  u128 cc = t >> 64;
  for (int i = 1; i < 4 && cc; ++i) {
    u128 s = (u128)r.v[i] + (u64)cc;
    r.v[i] = (u64)s;
    cc = s >> 64;
  }
  if (cc) {  // wrapped 2^256: add c once more (cannot re-carry from canonical-ish range)
    u128 s = (u128)r.v[0] + C;
    r.v[0] = (u64)s;
    u128 c2 = s >> 64;
    for (int i = 1; i < 4 && c2; ++i) {
      u128 s2 = (u128)r.v[i] + 1;
      r.v[i] = (u64)s2;
      c2 = s2 >> 64;
    }
  }
  cond_reduce(r);
  return r;
}

inline Fe load(const uint8_t *p8) {
  Fe r;
  std::memcpy(r.v, p8, 32);
  return r;
}

inline void store(uint8_t *p8, const Fe &a) { std::memcpy(p8, a.v, 32); }

inline Fe pow_fe(Fe base, const Fe &e) {
  Fe r = {{1, 0, 0, 0}};
  for (int limb = 0; limb < 4; ++limb) {
    u64 bits = e.v[limb];
    // square-and-multiply LSB-first within the full 256-bit exponent.
    for (int i = 0; i < 64; ++i) {
      if (bits & 1) r = mul(r, base);
      bits >>= 1;
      base = mul(base, base);
    }
  }
  return r;
}

}  // namespace

extern "C" {

// out[i] = (a[i] * b[i]) mod p, n elements of 32 LE bytes each.
void starkrt_mul_array(const uint8_t *a, const uint8_t *b, uint8_t *out,
                       u64 n) {
  for (u64 i = 0; i < n; ++i)
    store(out + 32 * i, mul(load(a + 32 * i), load(b + 32 * i)));
}

// out[i] = (a[i] + b[i]) mod p.
void starkrt_add_array(const uint8_t *a, const uint8_t *b, uint8_t *out,
                       u64 n) {
  for (u64 i = 0; i < n; ++i)
    store(out + 32 * i, add(load(a + 32 * i), load(b + 32 * i)));
}

// MiMC trace: out = [x0, x1, ..., x_{steps-1}] with
// x_{i+1} = x_i^3 + constants[i mod n_const] (mod p). 32 LE bytes each.
void starkrt_mimc_trace(const uint8_t *inp, u64 steps,
                        const uint8_t *constants, u64 n_const,
                        uint8_t *out) {
  Fe x = load(inp);
  cond_reduce(x);
  store(out, x);
  for (u64 i = 0; i + 1 < steps; ++i) {
    Fe c = load(constants + 32 * (i % n_const));
    x = add(mul(mul(x, x), x), c);
    store(out + 32 * (i + 1), x);
  }
}

// Power table: out[i] = g^i mod p for i in [0, n).
void starkrt_power_table(const uint8_t *g, u64 n, uint8_t *out) {
  Fe acc = {{1, 0, 0, 0}};
  Fe gg = load(g);
  for (u64 i = 0; i < n; ++i) {
    store(out + 32 * i, acc);
    acc = mul(acc, gg);
  }
}

// out[i] = a * g^i mod p for i in [0, n): with a = g^start, the rows
// [start, start + n) of g's power table, so a rank of a sharded proof
// builds only its own slice.
void starkrt_geometric(const uint8_t *a, const uint8_t *g, u64 n,
                       uint8_t *out) {
  Fe acc = load(a);
  Fe gg = load(g);
  for (u64 i = 0; i < n; ++i) {
    store(out + 32 * i, acc);
    acc = mul(acc, gg);
  }
}

// out[r * cols + c] = g^((row0 + r) * c) for r < rows, c < cols: rows
// of a power grid (the four-step NTT's twiddles w^(n2 * k1) for one
// rank's rows n2), one power table per row.
void starkrt_power_grid(const uint8_t *g, u64 row0, u64 rows, u64 cols,
                        uint8_t *out) {
  Fe gg = load(g);
  Fe e = {{row0, 0, 0, 0}};
  Fe base = pow_fe(gg, e);
  for (u64 r = 0; r < rows; ++r) {
    Fe acc = {{1, 0, 0, 0}};
    uint8_t *row = out + 32 * r * cols;
    for (u64 c = 0; c < cols; ++c) {
      store(row + 32 * c, acc);
      acc = mul(acc, base);
    }
    base = mul(base, gg);
  }
}

void starkrt_batch_inv(const uint8_t *a, uint8_t *out, u64 n);

// out[i] = 1 / ((xs[i] - a) * (xs[i] - b)), and 0 where the product is
// 0 (multi_inv semantics): the inverse of a vanishing polynomial with
// roots a and b over a table of points (the MiMC prover's 1/Z2). One
// product per point, then one batch inversion in place.
void starkrt_inv_vanishing2(const uint8_t *xs, u64 n, const uint8_t *a,
                            const uint8_t *b, uint8_t *out) {
  const Fe av = load(a), bv = load(b);
  for (u64 i = 0; i < n; ++i) {
    const Fe x = load(xs + 32 * i);
    store(out + 32 * i, mul(sub(x, av), sub(x, bv)));
  }
  starkrt_batch_inv(out, out, n);
}

// out = base^e mod p (e is a 32-byte LE integer; e.g. p-2 for inversion).
void starkrt_pow(const uint8_t *base, const uint8_t *e, uint8_t *out) {
  store(out, pow_fe(load(base), load(e)));
}

// Batch inversion (multi_inv semantics, inv(0) = 0): one pow + 3(n-1) muls.
// out may be a: the backward pass reads a[i] before it writes out[i].
void starkrt_batch_inv(const uint8_t *a, uint8_t *out, u64 n) {
  // prefix products, mapping zeros to one
  Fe *pre = new Fe[n + 1];
  pre[0] = {{1, 0, 0, 0}};
  for (u64 i = 0; i < n; ++i) {
    Fe x = load(a + 32 * i);
    pre[i + 1] = is_zero(x) ? pre[i] : mul(pre[i], x);
  }
  Fe pm2 = {{P[0] - 2, P[1], P[2], P[3]}};
  Fe inv_all = pow_fe(pre[n], pm2);
  for (u64 i = n; i-- > 0;) {
    Fe x = load(a + 32 * i);
    if (is_zero(x)) {
      Fe zero = {{0, 0, 0, 0}};
      store(out + 32 * i, zero);
    } else {
      store(out + 32 * i, mul(inv_all, pre[i]));
      inv_all = mul(inv_all, x);
    }
  }
  delete[] pre;
}

// Full NTT on host (iterative DIT), for oracle-scale checks and host-side
// round-constant extension at any size. vals: n*32 bytes, modified copy
// written to out. roots: precomputed n power table of the root of unity.
void starkrt_ntt(const uint8_t *vals, const uint8_t *roots, u64 n,
                 uint8_t *out) {
  Fe *x = new Fe[n];
  // bit-reversal copy
  int bits = 0;
  while ((1ull << bits) < n) ++bits;
  for (u64 i = 0; i < n; ++i) {
    u64 r = 0;
    for (int b = 0; b < bits; ++b) r |= ((i >> b) & 1ull) << (bits - 1 - b);
    x[r] = load(vals + 32 * i);
  }
  for (u64 m = 1; m < n; m <<= 1) {
    u64 stride = n / (2 * m);
    for (u64 k = 0; k < n; k += 2 * m) {
      for (u64 j = 0; j < m; ++j) {
        Fe w = load(roots + 32 * (j * stride));
        Fe t = mul(x[k + m + j], w);
        Fe u = x[k + j];
        x[k + j] = add(u, t);
        // u - t = u + (p - t)
        Fe nt;
        u128 borrow = 0;
        for (int q = 0; q < 4; ++q) {
          u128 d = (u128)P[q] - t.v[q] - borrow;
          nt.v[q] = (u64)d;
          borrow = (d >> 64) & 1;
        }
        bool tz = !(t.v[0] | t.v[1] | t.v[2] | t.v[3]);
        if (tz) nt = {{0, 0, 0, 0}};
        x[k + m + j] = add(u, nt);
      }
    }
  }
  for (u64 i = 0; i < n; ++i) store(out + 32 * i, x[i]);
  delete[] x;
}

}  // extern "C"
