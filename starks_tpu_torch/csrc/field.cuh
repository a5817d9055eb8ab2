// The STARK field p = 2^256 - 351*2^32 + 1 as host/device functions.
//
// Replaces the lane functions of starks_tpu/ops/plimbs.py (_propagate,
// _cond_sub_p, _mul_lanes, _add_lanes, _sub_lanes, _cube_lanes). An
// element is 8 little-endian 32-bit words of its canonical value; every
// function takes canonical inputs and returns a canonical result, so any
// correct reduction gives the TPU kernels' bits. The TPU's 16x16-bit
// column scheme was shaped by its 8x128 vector tiles; here a product is
// an 8x8 schoolbook of 32x32->64-bit multiply-adds.
//
// Without nvcc the header compiles as plain C++ (g++), so the same
// arithmetic can be built and tested on a machine with no GPU.
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

// 16-byte aligned, so a load or store of one element is two 16-byte
// accesses. Callers pass 16-byte aligned arrays (ops/plimbs.py checks).
struct alignas(16) Fe {
  uint32_t w[8];
};

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
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t t = (uint64_t)a.w[i] + b.w[i] + carry;
    r.w[i] = (uint32_t)t;
    carry = t >> 32;
  }
  reduce_once(r.w, (uint32_t)carry);
  return r;
}

// a - b; on a borrow, add p back (mod 2^256 that is the TPU kernel's
// "subtract c again").
FIELD_FN Fe sub(const Fe& a, const Fe& b) {
  Fe r;
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
  return r;
}

FIELD_FN Fe mul(const Fe& a, const Fe& b) {
  // 512-bit product, 8x8 schoolbook.
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = 0;
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
  reduce_once(g.w, 0);
  return g;
}

FIELD_FN Fe cube(const Fe& a) { return mul(mul(a, a), a); }

}  // namespace field
