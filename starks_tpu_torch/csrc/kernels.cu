// The field kernels of the MiMC and general AIR proofs, for sm_90a.
//
// Each replaces one Pallas kernel of starks_tpu/ops/plimbs.py and
// computes what that kernel computes; the TPU's block structure is not
// carried over. Arrays are [n] elements of 8 little-endian 32-bit words
// (32 bytes, 16-byte aligned). One thread per output element (or
// butterfly), a grid-stride loop, no shared memory. Periodic tables are
// read as tab[i % len]; a scalar is one element in device memory.
//
// Each kernel's bound (bytes or integer multiply-adds) is noted in
// ops/plimbs.py; the simple form here is a first, correct version.
//
// Built by nvcc into a shared library with a plain C interface (loaded
// with ctypes by ops/_build.py). Each entry point launches on the given
// stream, does not synchronize, and returns cudaGetLastError(). Without
// nvcc the same file compiles as C++ with g++, and each entry point then
// runs its loop on the host, so the kernel bodies can be tested on a
// machine with no GPU.
#include "field.cuh"

using field::Fe;

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define KERNEL __global__ void
#define FOR_EACH(i, count)                                              \
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < (count); \
       i += gridDim.x * blockDim.x)
namespace {
constexpr uint32_t kThreads = 256;
inline uint32_t grid_for(uint32_t count) {
  uint32_t blocks = (count + kThreads - 1) / kThreads;
  return blocks < 65536u ? blocks : 65536u;
}
}  // namespace
#define LAUNCH(kernel, count, stream, ...)                              \
  do {                                                                  \
    if (count)                                                          \
      kernel<<<grid_for(count), kThreads, 0, (cudaStream_t)(stream)>>>( \
          __VA_ARGS__);                                                 \
    return (int)cudaGetLastError();                                     \
  } while (0)
#else
#define KERNEL static void
#define FOR_EACH(i, count) for (uint32_t i = 0; i < (count); ++i)
#define LAUNCH(kernel, count, stream, ...) \
  do {                                     \
    (void)(stream);                        \
    kernel(__VA_ARGS__);                   \
    return 0;                              \
  } while (0)
#endif

// A1: Pease DIF stage (replaces _dif_kernel via dif_stage_x). a and b
// are the two halves of x; the stage twiddle is table[(j >> t) << t];
// u = a + b and v = (a - b) * w go straight to their interleaved slots.
KERNEL dif_kernel(const Fe* __restrict__ x, const Fe* __restrict__ table,
                  Fe* __restrict__ out, uint32_t half, uint32_t t) {
  FOR_EACH(j, half) {
    const Fe a = x[j], b = x[j + half];
    out[2 * j] = field::add(a, b);
    out[2 * j + 1] = field::mul(field::sub(a, b), table[(j >> t) << t]);
  }
}

// A3: DIT stage on interleaved pairs (replaces _dit_kernel):
// u = a + w*b to the low half, v = a - w*b to the high half.
KERNEL dit_kernel(const Fe* __restrict__ x, const Fe* __restrict__ table,
                  Fe* __restrict__ out, uint32_t half, uint32_t t) {
  FOR_EACH(j, half) {
    const Fe a = x[2 * j];
    const Fe wb = field::mul(table[(j >> t) << t], x[2 * j + 1]);
    out[j] = field::add(a, wb);
    out[j + half] = field::sub(a, wb);
  }
}

// A2: x * s for a scalar s (replaces _scale_kernel).
KERNEL scale_kernel(const Fe* __restrict__ x, const Fe* __restrict__ s,
                    Fe* __restrict__ out, uint32_t n) {
  const Fe sv = *s;
  FOR_EACH(i, n) { out[i] = field::mul(x[i], sv); }
}

// A4: constraint, quotient and boundary map (replaces _db_kernel):
//   C = P(g1 x) - P^3 - K;  D = C * (x - last) * Znum^-1;
//   B = (P - (ia + slope*x)) * Z2^-1.
// P(g1 x) is P read `shift` elements ahead, cyclically.
KERNEL db_kernel(const Fe* __restrict__ p, const Fe* __restrict__ xs,
                 const Fe* __restrict__ k_tab, uint32_t k_len,
                 const Fe* __restrict__ zni_tab, uint32_t zni_len,
                 const Fe* __restrict__ iz2, const Fe* __restrict__ last,
                 const Fe* __restrict__ slope, const Fe* __restrict__ ia,
                 Fe* __restrict__ d_out, Fe* __restrict__ b_out, uint32_t n,
                 uint32_t shift) {
  const Fe last_v = *last, slope_v = *slope, ia_v = *ia;
  FOR_EACH(i, n) {
    const uint32_t ir = i + shift < n ? i + shift : i + shift - n;
    const Fe pv = p[i], x = xs[i];
    const Fe c = field::sub(field::sub(p[ir], field::cube(pv)),
                            k_tab[i % k_len]);
    d_out[i] = field::mul(field::mul(c, field::sub(x, last_v)),
                          zni_tab[i % zni_len]);
    const Fe i_ev = field::add(ia_v, field::mul(slope_v, x));
    b_out[i] = field::mul(field::sub(pv, i_ev), iz2[i]);
  }
}

// A5: L = D + cp(x)*P + cb(x)*B with periodic coefficient tables
// (replaces _l_kernel).
KERNEL l_kernel(const Fe* __restrict__ d, const Fe* __restrict__ p,
                const Fe* __restrict__ b, const Fe* __restrict__ cp,
                uint32_t cp_len, const Fe* __restrict__ cb, uint32_t cb_len,
                Fe* __restrict__ out, uint32_t n) {
  FOR_EACH(i, n) {
    const Fe t = field::add(field::mul(p[i], cp[i % cp_len]),
                            field::mul(b[i], cb[i % cb_len]));
    out[i] = field::add(d[i], t);
  }
}

// A6: FRI fold by 4 (replaces _fold4_kernel): the 4-point DFT (with
// eta) of the four strided quarters y_j = values[j*q + i], Horner at
// u = sx * ip[i], times 1/4.
KERNEL fold4_kernel(const Fe* __restrict__ values, const Fe* __restrict__ ip,
                    const Fe* __restrict__ sx, const Fe* __restrict__ eta,
                    const Fe* __restrict__ inv4, Fe* __restrict__ out,
                    uint32_t q) {
  const Fe sx_v = *sx, eta_v = *eta, inv4_v = *inv4;
  FOR_EACH(i, q) {
    const Fe y0 = values[i], y1 = values[q + i];
    const Fe y2 = values[2 * q + i], y3 = values[3 * q + i];
    const Fe e0 = field::add(y0, y2), d02 = field::sub(y0, y2);
    const Fe e1 = field::add(y1, y3), d13 = field::sub(y1, y3);
    const Fe a0 = field::add(e0, e1), a2 = field::sub(e0, e1);
    const Fe h = field::mul(d13, eta_v);
    const Fe a1 = field::sub(d02, h), a3 = field::add(d02, h);
    const Fe u = field::mul(sx_v, ip[i]);
    Fe acc = field::add(field::mul(u, a3), a2);
    acc = field::add(field::mul(u, acc), a1);
    acc = field::add(field::mul(u, acc), a0);
    out[i] = field::mul(acc, inv4_v);
  }
}

// A7/A8: elementwise field ops with periodic operands (replace
// _mul_kernel via mul_t and mul_tab_t, and _add_kernel, _sub_kernel,
// _cube_kernel via _ew). Each operand is read as x[i % len]: a full
// array (len = n), a periodic table (len = 8, or a constant column's
// extension) or a constant (len = 1), so no tiled or broadcast copy
// is ever built.
KERNEL mul_kernel(const Fe* __restrict__ a, uint32_t a_len,
                  const Fe* __restrict__ b, uint32_t b_len,
                  Fe* __restrict__ out, uint32_t n) {
  FOR_EACH(i, n) { out[i] = field::mul(a[i % a_len], b[i % b_len]); }
}

KERNEL add_kernel(const Fe* __restrict__ a, uint32_t a_len,
                  const Fe* __restrict__ b, uint32_t b_len,
                  Fe* __restrict__ out, uint32_t n) {
  FOR_EACH(i, n) { out[i] = field::add(a[i % a_len], b[i % b_len]); }
}

KERNEL sub_kernel(const Fe* __restrict__ a, uint32_t a_len,
                  const Fe* __restrict__ b, uint32_t b_len,
                  Fe* __restrict__ out, uint32_t n) {
  FOR_EACH(i, n) { out[i] = field::sub(a[i % a_len], b[i % b_len]); }
}

KERNEL cube_kernel(const Fe* __restrict__ a, Fe* __restrict__ out,
                   uint32_t n) {
  FOR_EACH(i, n) { out[i] = field::cube(a[i]); }
}

#define F(ptr) ((const Fe*)(ptr))
#define W(ptr) ((Fe*)(ptr))

extern "C" {

int starks_dif_stage(const void* x, const void* table, void* out, uint32_t n,
                     uint32_t t, void* stream) {
  LAUNCH(dif_kernel, n / 2, stream, F(x), F(table), W(out), n / 2, t);
}

int starks_dit_stage(const void* x, const void* table, void* out, uint32_t n,
                     uint32_t t, void* stream) {
  LAUNCH(dit_kernel, n / 2, stream, F(x), F(table), W(out), n / 2, t);
}

int starks_scale(const void* x, const void* s, void* out, uint32_t n,
                 void* stream) {
  LAUNCH(scale_kernel, n, stream, F(x), F(s), W(out), n);
}

int starks_db_map(const void* p, const void* xs, const void* k_tab,
                  uint32_t k_len, const void* zni_tab, uint32_t zni_len,
                  const void* iz2, const void* last, const void* slope,
                  const void* ia, void* d_out, void* b_out, uint32_t n,
                  uint32_t shift, void* stream) {
  LAUNCH(db_kernel, n, stream, F(p), F(xs), F(k_tab), k_len, F(zni_tab),
         zni_len, F(iz2), F(last), F(slope), F(ia), W(d_out), W(b_out), n,
         shift);
}

int starks_l_map(const void* d, const void* p, const void* b, const void* cp,
                 uint32_t cp_len, const void* cb, uint32_t cb_len, void* out,
                 uint32_t n, void* stream) {
  LAUNCH(l_kernel, n, stream, F(d), F(p), F(b), F(cp), cp_len, F(cb), cb_len,
         W(out), n);
}

int starks_fold4(const void* values, const void* ip, const void* sx,
                 const void* eta, const void* inv4, void* out, uint32_t q,
                 void* stream) {
  LAUNCH(fold4_kernel, q, stream, F(values), F(ip), F(sx), F(eta), F(inv4),
         W(out), q);
}

int starks_mul(const void* a, uint32_t a_len, const void* b, uint32_t b_len,
               void* out, uint32_t n, void* stream) {
  LAUNCH(mul_kernel, n, stream, F(a), a_len, F(b), b_len, W(out), n);
}

int starks_add(const void* a, uint32_t a_len, const void* b, uint32_t b_len,
               void* out, uint32_t n, void* stream) {
  LAUNCH(add_kernel, n, stream, F(a), a_len, F(b), b_len, W(out), n);
}

int starks_sub(const void* a, uint32_t a_len, const void* b, uint32_t b_len,
               void* out, uint32_t n, void* stream) {
  LAUNCH(sub_kernel, n, stream, F(a), a_len, F(b), b_len, W(out), n);
}

int starks_cube(const void* a, void* out, uint32_t n, void* stream) {
  LAUNCH(cube_kernel, n, stream, F(a), W(out), n);
}

}  // extern "C"
