// The STARK field p = 2^256 - 351*2^32 + 1 as host/device functions.
//
// Replaces the lane functions of starks_tpu/ops/plimbs.py (_propagate,
// _cond_sub_p, _mul_lanes, _add_lanes, _sub_lanes, _cube_lanes). An
// element is 8 little-endian 32-bit words of its canonical value; every
// function takes canonical inputs and returns a canonical result, so any
// correct reduction gives the TPU kernels' bits. The exceptions are the
// lazy forms of the MiMC trace and the batch inverse (fold_lazy,
// mul_lazy, the *_chain functions, mimc_round): any value below 2^256,
// which canonical() reduces. The TPU's 16x16-bit
// column scheme was shaped by its 8x128 vector tiles; here a product is
// an 8x8 schoolbook of 32x32->64-bit multiply-adds.
//
// On the card (__CUDA_ARCH__) add, sub and mul are PTX carry chains
// (add.cc/addc, sub.cc/subc, mad.hi.cc/madc.hi) around 64-bit
// multiply-adds: each word's carry rides in the carry flag, so no
// 64-bit sum is built per word, and a product by c = 351*2^32 - 1 in
// the folds is one multiply by 351 and a shifted subtract
// (x*c = 351*x*2^32 - x). Without nvcc,
// and in nvcc's host pass, the header is plain C++ on 64-bit
// accumulators (the `#else` branches), so the arithmetic can be built
// with g++ and tested on a machine with no GPU; the device branches are
// held to the plain versions on the card (chip_smoke.py phase 2, with
// edge pairs that reach every carry path of the folds).
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define FIELD_FN __host__ __device__ __forceinline__
#else
#define FIELD_FN static inline
#endif

namespace field {

// p, as words: [1, 0xFFFFFEA1, 0xFFFFFFFF x 6].
FIELD_FN uint32_t p_word(int i) {
  return i == 0 ? 1u : (i == 1 ? 0xFFFFFEA1u : 0xFFFFFFFFu);
}

// c = 2^256 mod p = 351*2^32 - 1, as words [0xFFFFFFFF, 350].
constexpr uint32_t C0 = 0xFFFFFFFFu;
constexpr uint32_t C1 = 350u;
constexpr uint32_t C_MUL = 351u;  // c = C_MUL * 2^32 - 1

// 16-byte aligned, so a load or store of one element is two 16-byte
// accesses. Callers pass 16-byte aligned arrays (ops/plimbs.py checks).
struct alignas(16) Fe {
  uint32_t w[8];
};

#ifdef __CUDA_ARCH__
// One PTX instruction each. A run of them chains its carries through the
// carry flag: `asm volatile` keeps the run in program order, and no
// other instruction that writes the flag is emitted between them.
namespace ptx {
#define FIELD_PTX2(name, op)                                     \
  __device__ __forceinline__ uint32_t name(uint32_t x, uint32_t y) { \
    uint32_t r;                                                  \
    asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(x), "r"(y));  \
    return r;                                                    \
  }
#define FIELD_PTX3(name, op)                                               \
  __device__ __forceinline__ uint32_t name(uint32_t x, uint32_t y,         \
                                           uint32_t z) {                   \
    uint32_t r;                                                            \
    asm volatile(op " %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(y), "r"(z)); \
    return r;                                                              \
  }
FIELD_PTX2(add_cc, "add.cc.u32")
FIELD_PTX2(addc_cc, "addc.cc.u32")
FIELD_PTX2(addc, "addc.u32")
FIELD_PTX2(sub_cc, "sub.cc.u32")
FIELD_PTX2(subc_cc, "subc.cc.u32")
FIELD_PTX2(subc, "subc.u32")
FIELD_PTX3(mad_hi_cc, "mad.hi.cc.u32")
FIELD_PTX3(madc_hi_cc, "madc.hi.cc.u32")
FIELD_PTX3(madc_hi, "madc.hi.u32")
#undef FIELD_PTX2
#undef FIELD_PTX3
}  // namespace ptx

// (top:x) - p if that is >= 0, else x, for (top:x) < 2p: x - p is
// x + c - 2^256, so (top:x) >= p exactly when top is set or x + c
// carries out.
__device__ __forceinline__ void reduce_once_dev(uint32_t x[8], uint32_t top) {
  uint32_t s[8];
  s[0] = ptx::add_cc(x[0], C0);
  s[1] = ptx::addc_cc(x[1], C1);
#pragma unroll
  for (int i = 2; i < 8; ++i) s[i] = ptx::addc_cc(x[i], 0);
  const uint32_t take = top | ptx::addc(0, 0);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = take ? s[i] : x[i];
}
#endif

// (top:x) - p if that is >= 0, else x. Requires (top:x) < 2p.
FIELD_FN void reduce_once(uint32_t x[8], uint32_t top) {
  uint32_t d[8];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t t = (uint64_t)x[i] - p_word(i) - borrow;
    d[i] = (uint32_t)t;
    borrow = t >> 63;
  }
  const uint32_t take = (top | (uint32_t)(borrow ^ 1)) ? 0xFFFFFFFFu : 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = (d[i] & take) | (x[i] & ~take);
}

FIELD_FN Fe add(const Fe& a, const Fe& b) {
  Fe r;
#ifdef __CUDA_ARCH__
  r.w[0] = ptx::add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int i = 1; i < 8; ++i) r.w[i] = ptx::addc_cc(a.w[i], b.w[i]);
  reduce_once_dev(r.w, ptx::addc(0, 0));
#else
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t t = (uint64_t)a.w[i] + b.w[i] + carry;
    r.w[i] = (uint32_t)t;
    carry = t >> 32;
  }
  reduce_once(r.w, (uint32_t)carry);
#endif
  return r;
}

// a - b; on a borrow, add p back (mod 2^256 that is the TPU kernel's
// "subtract c again").
FIELD_FN Fe sub(const Fe& a, const Fe& b) {
  Fe r;
#ifdef __CUDA_ARCH__
  r.w[0] = ptx::sub_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int i = 1; i < 8; ++i) r.w[i] = ptx::subc_cc(a.w[i], b.w[i]);
  const uint32_t mask = ptx::subc(0, 0);  // all ones on a borrow
  r.w[0] = ptx::add_cc(r.w[0], p_word(0) & mask);
#pragma unroll
  for (int i = 1; i < 7; ++i) r.w[i] = ptx::addc_cc(r.w[i], p_word(i) & mask);
  r.w[7] = ptx::addc(r.w[7], p_word(7) & mask);
#else
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t t = (uint64_t)a.w[i] - b.w[i] - borrow;
    r.w[i] = (uint32_t)t;
    borrow = t >> 63;
  }
  const uint32_t mask = 0u - (uint32_t)borrow;
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t t = (uint64_t)r.w[i] + (p_word(i) & mask) + carry;
    r.w[i] = (uint32_t)t;
    carry = t >> 32;
  }
#endif
  return r;
}

// 512-bit w = a * b + add, the 8x8 schoolbook on 64-bit accumulators
// (add enters as the first row's addend; the sum stays below 2^512).
FIELD_FN void mul_wide(const Fe& a, const Fe& b, uint32_t w[16],
                       const Fe& add = Fe{}) {
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = i < 8 ? add.w[i] : 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t t = (uint64_t)a.w[i] * b.w[j] + w[i + j] + carry;
      w[i + j] = (uint32_t)t;
      carry = t >> 32;
    }
    w[i + 8] = (uint32_t)carry;
  }
}

#ifdef __CUDA_ARCH__
// The schoolbook on the card, row by row: t_j = a_j * b_i + w[i+j] is
// one 32x32+32 -> 64-bit multiply-add (IMAD.WIDE; it cannot overflow),
// and the row's words w[i+j] = lo(t_j) + hi(t_{j-1}) ride one carry
// chain, so each product costs a multiply-add and one add.
__device__ __forceinline__ void mul_wide_dev(const Fe& a, const Fe& b,
                                             uint32_t w[16]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t t[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      t[j] = (uint64_t)a.w[j] * b.w[i] + (i ? w[i + j] : 0u);
    w[i] = (uint32_t)t[0];
    w[i + 1] = ptx::add_cc((uint32_t)t[1], (uint32_t)(t[0] >> 32));
#pragma unroll
    for (int j = 2; j < 8; ++j)
      w[i + j] = ptx::addc_cc((uint32_t)t[j], (uint32_t)(t[j - 1] >> 32));
    w[i + 8] = ptx::addc((uint32_t)(t[7] >> 32), 0);
  }
}

// w mod p on the card for w < 2^512: two folds by c, each one multiply
// by 351 (x*c = 351*x*2^32 - x) and carry chains, then the carry fold
// and one conditional subtract in reduce_once_dev.
__device__ __forceinline__ Fe fold_dev(const uint32_t w[16]) {
  // Fold 1: f = lo + hi*c = lo + m*2^32 - hi, m = 351*hi (9 words);
  // f < 2^298 (10 words).
  const uint32_t* hi = w + 8;
  uint32_t m[9];
#pragma unroll
  for (int j = 0; j < 8; ++j) m[j] = hi[j] * C_MUL;
  m[1] = ptx::mad_hi_cc(hi[0], C_MUL, m[1]);
#pragma unroll
  for (int j = 1; j < 7; ++j)
    m[j + 1] = ptx::madc_hi_cc(hi[j], C_MUL, m[j + 1]);
  m[8] = ptx::madc_hi(hi[7], C_MUL, 0);
  uint32_t f[10];
  f[0] = w[0];
  f[1] = ptx::add_cc(w[1], m[0]);
#pragma unroll
  for (int j = 2; j < 8; ++j) f[j] = ptx::addc_cc(w[j], m[j - 1]);
  f[8] = ptx::addc_cc(m[7], 0);
  f[9] = ptx::addc(m[8], 0);
  f[0] = ptx::sub_cc(f[0], hi[0]);
#pragma unroll
  for (int j = 1; j < 8; ++j) f[j] = ptx::subc_cc(f[j], hi[j]);
  f[8] = ptx::subc_cc(f[8], 0);
  f[9] = ptx::subc(f[9], 0);

  // Fold 2: g = f[0..7] + h*c with h = f[8] + f[9]*2^32 < 2^42. With
  // n = 351*h < 2^51 (two words), h*c = n*2^32 - h < 2^83 is three
  // words d; g < 2^256 + 2^83, top = g >> 256.
  const uint32_t n0 = f[8] * C_MUL;
  const uint32_t n1 = __umulhi(f[8], C_MUL) + f[9] * C_MUL;
  const uint32_t d0 = ptx::sub_cc(0, f[8]);
  const uint32_t d1 = ptx::subc_cc(n0, f[9]);
  const uint32_t d2 = ptx::subc(n1, 0);
  Fe g;
  g.w[0] = ptx::add_cc(f[0], d0);
  g.w[1] = ptx::addc_cc(f[1], d1);
  g.w[2] = ptx::addc_cc(f[2], d2);
#pragma unroll
  for (int j = 3; j < 8; ++j) g.w[j] = ptx::addc_cc(f[j], 0);
  const uint32_t top = ptx::addc(0, 0);

  // top * 2^256 == top * c. When top is 1 the low words are below 2^83,
  // so adding c cannot carry out and gives a value below p; otherwise
  // one conditional subtract of p. reduce_once_dev does both.
  reduce_once_dev(g.w, top);
  return g;
}

// The MiMC trace's arithmetic (mimc_round), shaped for one warp's
// dependent chain rather than for many warps' throughput. With one warp
// nothing hides a stall, and each instruction holds its pipe as long as
// a full warp's would. An IMAD.WIDE with a 32-bit addend takes that
// addend as a register pair whose high word one more instruction (on
// the multiply pipe, as ptxas places it) zeroes; so here every word
// product is an IMAD.WIDE with no addend, every sum runs on the integer
// ALU's carry chains, and the results are lazy (below 2^256, not always
// canonical). PERF.md gives the designs timed against this one.

// u[0..n] = sum_j t_j 2^(32j) for n 64-bit products t: u_j = lo(t_j) +
// hi(t_{j-1}) on one carry chain.
template <int n>
__device__ __forceinline__ void row_sum(const uint64_t* t, uint32_t* u) {
  u[0] = (uint32_t)t[0];
  if constexpr (n == 1) {
    u[1] = (uint32_t)(t[0] >> 32);
  } else {
    u[1] = ptx::add_cc((uint32_t)t[1], (uint32_t)(t[0] >> 32));
#pragma unroll
    for (int j = 2; j < n; ++j)
      u[j] = ptx::addc_cc((uint32_t)t[j], (uint32_t)(t[j - 1] >> 32));
    u[n] = ptx::addc((uint32_t)(t[n - 1] >> 32), 0);
  }
}

// w[0..n] = w[0..n-1] + u[0..n] (w[n] is written, not read).
template <int n>
__device__ __forceinline__ void row_acc(uint32_t* w, const uint32_t* u) {
  w[0] = ptx::add_cc(w[0], u[0]);
#pragma unroll
  for (int j = 1; j < n; ++j) w[j] = ptx::addc_cc(w[j], u[j]);
  w[n] = ptx::addc(u[n], 0);
}

// w = a * b + add, row by row: row i's products a_j * b_i, its sum u on
// one chain and u added into w on a second, so a row's products wait on
// nothing and its chains on the row before only word by word.
__device__ __forceinline__ void mul_wide_chain(const Fe& a, const Fe& b,
                                               uint32_t w[16],
                                               const Fe& add) {
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = add.w[j];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t t[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = (uint64_t)a.w[j] * b.w[i];
    uint32_t u[9];
    row_sum<8>(t, u);
    row_acc<8>(w + i, u);
  }
}

// Row i of the square's cross products: a_i * a_{i+1..7} at w[2i+1 ..
// i+8] (row 0 writes them, later rows add).
template <int i>
__device__ __forceinline__ void sqr_cross_row(const Fe& a, uint32_t w[16]) {
  constexpr int n = 7 - i;
  uint64_t t[n];
#pragma unroll
  for (int j = 0; j < n; ++j) t[j] = (uint64_t)a.w[i + 1 + j] * a.w[i];
  if constexpr (i == 0) {
    row_sum<n>(t, w + 1);
  } else {
    uint32_t u[n + 1];
    row_sum<n>(t, u);
    row_acc<n>(w + 2 * i + 1, u);
  }
}

// w = a^2: the 28 cross products in rows as mul_wide_chain's, doubled by
// funnel shifts, then the 8 squares on the diagonal on one chain.
__device__ __forceinline__ void sqr_wide_chain(const Fe& a, uint32_t w[16]) {
  sqr_cross_row<0>(a, w);
  sqr_cross_row<1>(a, w);
  sqr_cross_row<2>(a, w);
  sqr_cross_row<3>(a, w);
  sqr_cross_row<4>(a, w);
  sqr_cross_row<5>(a, w);
  sqr_cross_row<6>(a, w);
  w[15] = __funnelshift_l(w[14], 0u, 1);
#pragma unroll
  for (int i = 14; i > 1; --i) w[i] = __funnelshift_l(w[i - 1], w[i], 1);
  w[1] <<= 1;
  uint64_t d[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) d[i] = (uint64_t)a.w[i] * a.w[i];
  w[0] = (uint32_t)d[0];
  w[1] = ptx::add_cc(w[1], (uint32_t)(d[0] >> 32));
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    w[2 * i] = ptx::addc_cc(w[2 * i], (uint32_t)d[i]);
    w[2 * i + 1] = i < 7 ? ptx::addc_cc(w[2 * i + 1], (uint32_t)(d[i] >> 32))
                         : ptx::addc(w[15], (uint32_t)(d[7] >> 32));
  }
}

// w mod p as a value below 2^256, not always canonical: fold 1 as f = lo
// + v*2^32 - hi with v = 351*hi from products with no addend (row_sum),
// fold 2 as in fold_dev, then g + top*c, which cannot carry out of word
// 2 (g < 2^83 when top is 1). No conditional subtract.
__device__ __forceinline__ Fe fold_lazy_chain(const uint32_t w[16]) {
  const uint32_t* hi = w + 8;
  uint64_t q[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) q[j] = (uint64_t)hi[j] * C_MUL;
  uint32_t v[9];
  row_sum<8>(q, v);
  uint32_t f[10];
  f[0] = w[0];
  f[1] = ptx::add_cc(w[1], v[0]);
#pragma unroll
  for (int j = 2; j < 8; ++j) f[j] = ptx::addc_cc(w[j], v[j - 1]);
  f[8] = ptx::addc_cc(v[7], 0);
  f[9] = ptx::addc(v[8], 0);
  f[0] = ptx::sub_cc(f[0], hi[0]);
#pragma unroll
  for (int j = 1; j < 8; ++j) f[j] = ptx::subc_cc(f[j], hi[j]);
  f[8] = ptx::subc_cc(f[8], 0);
  f[9] = ptx::subc(f[9], 0);

  const uint64_t n = (uint64_t)f[8] * C_MUL;
  const uint32_t n1 = (uint32_t)(n >> 32) + f[9] * C_MUL;
  const uint32_t d0 = ptx::sub_cc(0, f[8]);
  const uint32_t d1 = ptx::subc_cc((uint32_t)n, f[9]);
  const uint32_t d2 = ptx::subc(n1, 0);
  Fe g;
  g.w[0] = ptx::add_cc(f[0], d0);
  g.w[1] = ptx::addc_cc(f[1], d1);
  g.w[2] = ptx::addc_cc(f[2], d2);
#pragma unroll
  for (int j = 3; j < 8; ++j) g.w[j] = ptx::addc_cc(f[j], 0);
  const uint32_t m = 0u - ptx::addc(0, 0);
  g.w[0] = ptx::add_cc(g.w[0], C0 & m);
  g.w[1] = ptx::addc_cc(g.w[1], C1 & m);
  g.w[2] = ptx::addc(g.w[2], 0);
  return g;
}
#endif

// w mod p on the host for w < 2^512 as a value below 2^256, not always
// canonical (a lazy fold): the same two folds by c on 64-bit
// accumulators, then the carry fold.
FIELD_FN Fe fold_lazy(const uint32_t w[16]) {
  // Fold 1: f = lo + hi * c < 2^298 (10 words).
  uint32_t f[10];
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t t = (uint64_t)w[8 + i] * C0 + w[i] + carry;
    f[i] = (uint32_t)t;
    carry = t >> 32;
  }
  f[8] = (uint32_t)carry;
  carry = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t t = (uint64_t)w[8 + i] * C1 + f[i + 1] + carry;
    f[i + 1] = (uint32_t)t;
    carry = t >> 32;
  }
  f[9] = (uint32_t)carry;

  // Fold 2: g = f[0..7] + (f[8] + f[9]*2^32) * c < 2^256 + 2^83.
  Fe g;
  carry = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t t = (uint64_t)f[i] + carry + (i < 2 ? (uint64_t)f[8 + i] * C0 : 0);
    g.w[i] = (uint32_t)t;
    carry = t >> 32;
  }
  uint32_t top = (uint32_t)carry;
  carry = 0;
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    uint64_t t = (uint64_t)g.w[i] + carry + (i < 3 ? (uint64_t)f[7 + i] * C1 : 0);
    g.w[i] = (uint32_t)t;
    carry = t >> 32;
  }
  top += (uint32_t)carry;  // the value bound makes top <= 1

  // Carry fold: top * 2^256 == top * c. When top is 1 the low words are
  // below 2^83, so this cannot carry out.
  const uint32_t mask = 0u - top;
  carry = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t add_c = i == 0 ? (C0 & mask) : (i == 1 ? (C1 & mask) : 0u);
    uint64_t t = (uint64_t)g.w[i] + add_c + carry;
    g.w[i] = (uint32_t)t;
    carry = t >> 32;
  }
  return g;
}

// w mod p on the host for w < 2^512: the lazy fold and one conditional
// subtract.
FIELD_FN Fe fold(const uint32_t w[16]) {
  Fe g = fold_lazy(w);
  reduce_once(g.w, 0);
  return g;
}

// a * b mod p. The folds bound any product below 2^512, so a and b may
// be any values below 2^256, canonical or not; the result is canonical.
FIELD_FN Fe mul(const Fe& a, const Fe& b) {
  uint32_t w[16];
#ifdef __CUDA_ARCH__
  mul_wide_dev(a, b, w);
  return fold_dev(w);
#else
  mul_wide(a, b, w);
  return fold(w);
#endif
}

// 512-bit square w = a^2: the 28 cross products a_i a_j (i < j) once,
// doubled, plus the 8 squares a_i^2 on the diagonal; 36 word products
// where the schoolbook takes 64.
FIELD_FN void sqr_wide(const Fe& a, uint32_t w[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = 0;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = i + 1; j < 8; ++j) {
      uint64_t t = (uint64_t)a.w[i] * a.w[j] + w[i + j] + carry;
      w[i + j] = (uint32_t)t;
      carry = t >> 32;
    }
    w[i + 8] = (uint32_t)carry;
  }
#pragma unroll
  for (int i = 15; i > 0; --i) w[i] = (w[i] << 1) | (w[i - 1] >> 31);
  w[0] <<= 1;
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t t = (uint64_t)a.w[i] * a.w[i] + w[2 * i] + carry;
    w[2 * i] = (uint32_t)t;
    t = (uint64_t)w[2 * i + 1] + (t >> 32);
    w[2 * i + 1] = (uint32_t)t;
    carry = t >> 32;
  }
}

#ifdef __CUDA_ARCH__
// The square on the card: the cross products as rows of IMAD.WIDE on
// one carry chain each (as in mul_wide_dev), doubled by funnel shifts,
// then the diagonal added on one chain.
__device__ __forceinline__ void sqr_wide_dev(const Fe& a, uint32_t w[16]) {
  // Row 0 writes w[1..8]; row i adds a_i * a_{i+1..7} at w[2i+1..i+8].
  w[0] = 0;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    uint64_t t[8];
#pragma unroll
    for (int j = i + 1; j < 8; ++j)
      t[j] = (uint64_t)a.w[j] * a.w[i] + (i ? w[i + j] : 0u);
    w[2 * i + 1] = (uint32_t)t[i + 1];
    if (i == 6) {
      w[14] = (uint32_t)(t[7] >> 32);
    } else {
      w[2 * i + 2] =
          ptx::add_cc((uint32_t)t[i + 2], (uint32_t)(t[i + 1] >> 32));
#pragma unroll
      for (int j = i + 3; j < 8; ++j)
        w[i + j] = ptx::addc_cc((uint32_t)t[j], (uint32_t)(t[j - 1] >> 32));
      w[i + 8] = ptx::addc((uint32_t)(t[7] >> 32), 0);
    }
  }
  w[15] = __funnelshift_l(w[14], 0u, 1);
#pragma unroll
  for (int i = 14; i > 0; --i) w[i] = __funnelshift_l(w[i - 1], w[i], 1);
  uint64_t d[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) d[i] = (uint64_t)a.w[i] * a.w[i];
  w[0] = (uint32_t)d[0];
  w[1] = ptx::add_cc(w[1], (uint32_t)(d[0] >> 32));
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    w[2 * i] = ptx::addc_cc(w[2 * i], (uint32_t)d[i]);
    w[2 * i + 1] = i < 7 ? ptx::addc_cc(w[2 * i + 1], (uint32_t)(d[i] >> 32))
                         : ptx::addc(w[15], (uint32_t)(d[7] >> 32));
  }
}
#endif

// a^2 mod p, canonical, for any a below 2^256.
FIELD_FN Fe sqr(const Fe& a) {
  uint32_t w[16];
#ifdef __CUDA_ARCH__
  sqr_wide_dev(a, w);
  return fold_dev(w);
#else
  sqr_wide(a, w);
  return fold(w);
#endif
}

// x / 4 mod p, exactly and without a multiply: p = 1 mod 4, so with
// k = -x mod 4 the sum x + k*p = x - k*c + k*2^256 is a multiple of 4
// below 4p, and its quarter is canonical.
FIELD_FN Fe div4(const Fe& x) {
  const uint32_t k = (0u - x.w[0]) & 3u;
  const uint64_t kc = (uint64_t)k * (((uint64_t)C1 << 32) + C0);  // < 2^43
  uint32_t t[8];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t sub = i < 2 ? (uint32_t)(kc >> (32 * i)) : 0u;
    const uint64_t v = (uint64_t)x.w[i] - sub - borrow;
    t[i] = (uint32_t)v;
    borrow = v >> 63;
  }
  const uint32_t top = k - (uint32_t)borrow;  // (top:t) = x + k*p
  Fe r;
#pragma unroll
  for (int i = 0; i < 7; ++i) r.w[i] = (t[i] >> 2) | (t[i + 1] << 30);
  r.w[7] = (t[7] >> 2) | (top << 30);
  return r;
}

FIELD_FN Fe cube(const Fe& a) { return mul(sqr(a), a); }

// p - 2, as words: [0xFFFFFFFF, 0xFFFFFEA0, 0xFFFFFFFF x 6] (249 one bits).
FIELD_FN uint32_t p_minus_2_word(int i) {
  return i == 1 ? 0xFFFFFEA0u : 0xFFFFFFFFu;
}

// The Fermat inverse x^(p-2) mod p, with inv(0) = 0: square and multiply
// from the top bit (bit 255, taken by starting from x) down, 255
// squarings and 248 products. Not unrolled: each step's bit is read from
// p_minus_2_word, the same for every thread. The batch inverse runs
// inv_chain (below), the same value on a shorter chain.
FIELD_FN Fe inv(const Fe& x) {
  Fe acc = x;
#pragma unroll 1
  for (int i = 254; i >= 0; --i) {
    acc = sqr(acc);
    if ((p_minus_2_word(i >> 5) >> (i & 31)) & 1u) acc = mul(acc, x);
  }
  return acc;
}

#ifdef __CUDA_ARCH__
// w = a * b: mul_wide_chain with no addend (row 0 is written, not added).
__device__ __forceinline__ void mul_wide_chain0(const Fe& a, const Fe& b,
                                                uint32_t w[16]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t t[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = (uint64_t)a.w[j] * b.w[i];
    if (i == 0) {
      row_sum<8>(t, w);
    } else {
      uint32_t u[9];
      row_sum<8>(t, u);
      row_acc<8>(w + i, u);
    }
  }
}
#endif

// a * b mod p as a value below 2^256, not always canonical, for any a
// and b below 2^256: mul without its conditional subtract (the lazy
// fold), for a product that feeds only further products.
FIELD_FN Fe mul_lazy(const Fe& a, const Fe& b) {
  uint32_t w[16];
#ifdef __CUDA_ARCH__
  mul_wide_dev(a, b, w);
  return fold_lazy_chain(w);
#else
  mul_wide(a, b, w);
  return fold_lazy(w);
#endif
}

// a^2 and a * b mod p as values below 2^256, not always canonical, for
// any a and b below 2^256: the chain forms of sqr and mul (products with
// no addend, lazy folds, no conditional subtract), for one thread's
// dependent chain.
FIELD_FN Fe sqr_chain(const Fe& a) {
  uint32_t w[16];
#ifdef __CUDA_ARCH__
  sqr_wide_chain(a, w);
  return fold_lazy_chain(w);
#else
  sqr_wide(a, w);
  return fold_lazy(w);
#endif
}

FIELD_FN Fe mul_chain(const Fe& a, const Fe& b) {
  uint32_t w[16];
#ifdef __CUDA_ARCH__
  mul_wide_chain0(a, b, w);
  return fold_lazy_chain(w);
#else
  mul_wide(a, b, w);
  return fold_lazy(w);
#endif
}

// x^(2^k) * y in lazy form: k squarings, then one product.
FIELD_FN Fe sqr_n_mul(Fe x, int k, const Fe& y) {
#pragma unroll 1
  for (int i = 0; i < k; ++i) x = sqr_chain(x);
  return mul_chain(x, y);
}

FIELD_FN bool is_zero(const Fe& x) {
  uint32_t any = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) any |= x.w[i];
  return any == 0;
}

// x, canonical, for any x below 2^256 (x < 2p).
FIELD_FN Fe canonical(Fe x) {
#ifdef __CUDA_ARCH__
  reduce_once_dev(x.w, 0);
#else
  reduce_once(x.w, 0);
#endif
  return x;
}

// The Fermat inverse x^(p-2) mod p by an addition chain, with
// inv_chain(0) = 0: the value of inv, on a chain of 255 squarings and 17
// products where inv takes 248 products. With e_k = x^(2^k - 1), e_32
// comes from e_1, e_2, e_4, e_8, e_16 (31 squarings, 5 products); p - 2
// is [0xFFFFFFFF, 0xFFFFFEA0, 0xFFFFFFFF x 6] (low word first), so its
// top six words are e_32 then five blocks of 32 ones shifted in with one
// product each; word 1 is 23 ones (16 + 4 + 2 + 1), then 0101 and 00000;
// word 0 is 32 ones. Every step is a lazy chain form; the result is made
// canonical once. Not inlined on the card: it runs on one thread once a
// call (the block scan's top), and its 13 loops stay one copy.
#ifdef __CUDACC__
static __host__ __device__ __noinline__
#else
static inline
#endif
Fe inv_chain(const Fe& x) {
  const Fe e1 = x;
  const Fe e2 = sqr_n_mul(e1, 1, e1);
  const Fe e4 = sqr_n_mul(e2, 2, e2);
  const Fe e8 = sqr_n_mul(e4, 4, e4);
  const Fe e16 = sqr_n_mul(e8, 8, e8);
  const Fe e32 = sqr_n_mul(e16, 16, e16);   // word 7
  Fe acc = e32;
#pragma unroll 1
  for (int word = 6; word >= 2; --word) acc = sqr_n_mul(acc, 32, e32);
  acc = sqr_n_mul(acc, 16, e16);            // word 1: 23 ones ...
  acc = sqr_n_mul(acc, 4, e4);
  acc = sqr_n_mul(acc, 2, e2);
  acc = sqr_n_mul(acc, 1, e1);
  acc = sqr_n_mul(acc, 2, e1);              // ... 01 ...
  acc = sqr_n_mul(acc, 2, e1);              // ... 01, then 00000
  acc = sqr_n_mul(acc, 5 + 32, e32);        // and word 0
  return canonical(acc);
}

// One MiMC round in redundant form: x^3 + k mod p as a value below 2^256,
// not always canonical, for any x and k below 2^256. The square and the
// product fold lazily (no conditional subtract), and k enters the
// product as its first row's addend (s*x + k < 2^512), so neither a
// conditional subtract nor an add lies on the chain from x to the next
// x; canonical() of the result is the trace's row.
FIELD_FN Fe mimc_round(const Fe& x, const Fe& k) {
  uint32_t w[16];
#ifdef __CUDA_ARCH__
  sqr_wide_chain(x, w);
  const Fe s = fold_lazy_chain(w);
  mul_wide_chain(s, x, w, k);
  return fold_lazy_chain(w);
#else
  sqr_wide(x, w);
  const Fe s = fold_lazy(w);
  mul_wide(s, x, w, k);
  return fold_lazy(w);
#endif
}

}  // namespace field
