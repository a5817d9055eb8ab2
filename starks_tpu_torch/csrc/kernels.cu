// The field kernels of the MiMC and general AIR proofs, for sm_90a.
//
// Each replaces one Pallas kernel of starks_tpu/ops/plimbs.py and
// computes what that kernel computes; the TPU's block structure is not
// carried over. Arrays are [n] elements of 8 little-endian 32-bit words
// (32 bytes, 16-byte aligned). One thread per output element (or
// butterfly) and a grid-stride loop, except the DIF and DIT passes,
// which run several NTT stages of a tile in shared memory, and the
// elementwise maps (stream_map, flat_map), one element per thread.
// Periodic tables are read as tab[i % len]; a scalar is one element in
// device memory.
//
// Every kernel takes a claim axis: `batch` proofs' arrays one after
// another ([batch, n] elements), one launch for all of them, the claim
// in blockIdx.y. Shared tables (twiddles, x, the periodic K and 1/Z
// tables, eta, the u-table, scalars of the setup) are read by every
// claim from the same pointer; per-claim operands (the boundary's
// slope and ia, the L map's coefficient tables, fold4's sx) are
// indexed by the claim. The AIR's elementwise ops (mul, add, sub,
// scale, cube) take a stride per operand instead: 0 for an operand
// every claim shares, its length for one with a block per claim.
// Claim offsets are 64-bit: batch * n * 32 bytes passes 2^32 at 2^20
// steps and 16 claims.
//
// Each kernel's bound (bytes or integer multiply-adds) is noted in
// ops/plimbs.py. The batch inverse is a block scan over several
// launches (its note is below).
//
// Built by nvcc into a shared library with a plain C interface (loaded
// with ctypes by ops/_build.py). Each entry point launches on the given
// stream, does not synchronize, and returns cudaGetLastError(). Without
// nvcc the same file compiles as C++ with g++, and each entry point then
// runs its loop on the host, so the kernel bodies can be tested on a
// machine with no GPU.
#include <cstddef>

#include "field.cuh"

using field::Fe;

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define KERNEL __global__ void
#define FOR_EACH(i, count)                                              \
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < (count); \
       i += gridDim.x * blockDim.x)
// One claim per grid row: LAUNCH makes gridDim.y = batch, so a block
// runs its claim once (no loop keeps claim state in registers).
#define FOR_EACH_CLAIM(c, batch) \
  if (const uint32_t c = blockIdx.y; c < (batch))
// At least `blocks` blocks of kThreads resident per SM: caps registers.
#define MIN_BLOCKS(blocks) __launch_bounds__(kThreads, blocks)
namespace {
constexpr uint32_t kThreads = 256;
inline uint32_t grid_for(uint32_t count) {
  uint32_t blocks = (count + kThreads - 1) / kThreads;
  return blocks < 65536u ? blocks : 65536u;
}
}  // namespace
// One grid row of blocks per claim (gridDim.y = batch <= 65535).
#define LAUNCH(kernel, count, batch, stream, ...)                        \
  do {                                                                   \
    if ((count) && (batch))                                              \
      kernel<<<dim3(grid_for(count), (batch)), kThreads, 0,              \
               (cudaStream_t)(stream)>>>(__VA_ARGS__);                   \
    return (int)cudaGetLastError();                                      \
  } while (0)
#else
#include <vector>
#define KERNEL static void
#define FOR_EACH(i, count) for (uint32_t i = 0; i < (count); ++i)
#define FOR_EACH_CLAIM(c, batch) for (uint32_t c = 0; c < (batch); ++c)
#define MIN_BLOCKS(blocks)
#define LAUNCH(kernel, count, batch, stream, ...) \
  do {                                            \
    (void)(stream);                               \
    kernel(__VA_ARGS__);                          \
    return 0;                                     \
  } while (0)
#endif

// A1, redesigned: several Pease DIF stages in one pass. A pass at
// stages s .. s+k-1 over n = 2^log_n elements works on n / 2^k groups.
// Group g holds the 2^k elements x[g + m * n/2^k] (m < 2^k) and runs
// the k stages as a local constant-geometry network: at local stage i,
// a = loc[r] and b = loc[r + 2^(k-1)] give loc'[2r] = a + b and
// loc'[2r+1] = (a - b) * w, with the twiddle of global stage s + i at
// the butterfly's global half-index j (dif_twiddle_index). The group's
// results are the contiguous out[g * 2^k + m], which is the array after
// stage s+k-1 of the stage-by-stage network, so passes compose.
FIELD_FN uint32_t dif_twiddle_index(uint32_t r, uint32_t g, uint32_t i,
                                    uint32_t log_n, uint32_t k, uint32_t s) {
  const uint32_t j = ((r >> i) << (log_n - k + i)) | (g << i) |
                     (r & ((1u << i) - 1));
  const uint32_t t = s + i;
  return (j >> t) << t;
}

FIELD_FN void dif_butterfly(const Fe& a, const Fe& b, const Fe& w, Fe& u,
                            Fe& v) {
  u = field::add(a, b);
  v = field::mul(field::sub(a, b), w);
}

// The transform's last stage (t = log n - 1) reads table[0] = 1 (the
// table is a power table), so its butterfly is u = a + b, v = a - b,
// with no product. With `scaled`, the scale sv (the LDE's 1/n)
// multiplies both here, so it takes no launch and no pass over the
// array. (sv comes by value: read through a pointer here, it cost the
// pass kernel more registers.)
FIELD_FN void dif_last_butterfly(const Fe& a, const Fe& b, bool scaled,
                                 const Fe& sv, Fe& u, Fe& v) {
  u = field::add(a, b);
  v = field::sub(a, b);
  if (scaled) {
    u = field::mul(u, sv);
    v = field::mul(v, sv);
  }
}

#ifdef __CUDACC__
// One block per tile of 2^(k + log_c) elements: C = 2^log_c consecutive
// groups (C > 1 only for a pass shorter than the transform's pass
// width, so every pass has the same tile), and one grid row per claim.
// One thread per butterfly; the tile lives in shared memory from load
// to store. For each m the C elements x[g0 + c + m * groups] are
// contiguous, so neighbouring threads load neighbouring elements when
// C > 1, and whole 32-byte sectors always; the store is one contiguous
// run of the tile. With about two warps per scheduler at 2^16 points
// the stages are bound by latency, so each twiddle is loaded a stage
// ahead, as two 16-byte loads through the read-only cache. The pass
// that ends the transform runs its last stage as dif_last_butterfly.
__global__ void dif_pass_kernel(const Fe* __restrict__ x,
                                const Fe* __restrict__ table,
                                const Fe* __restrict__ scale,
                                Fe* __restrict__ out, uint32_t log_n,
                                uint32_t s, uint32_t k, uint32_t log_c) {
  extern __shared__ Fe loc[];  // loc[c << k | m]
  x += (size_t)blockIdx.y << log_n;
  out += (size_t)blockIdx.y << log_n;
  const uint32_t groups = 1u << (log_n - k);
  const uint32_t size = 1u << (k + log_c);
  const uint32_t g0 = blockIdx.x << log_c;
  for (uint32_t e = threadIdx.x; e < size; e += blockDim.x) {
    const uint32_t c = e & ((1u << log_c) - 1), m = e >> log_c;
    loc[(c << k) | m] = x[g0 + c + m * groups];
  }
  __syncthreads();
  const uint32_t half = 1u << (k - 1);
  const uint32_t c = threadIdx.x >> (k - 1), r = threadIdx.x & (half - 1);
  Fe* grp = loc + (c << k);
  const uint32_t twiddled = s + k == log_n ? k - 1 : k;
  const uint4* tw = reinterpret_cast<const uint4*>(table);
  uint4 w0 = {}, w1 = {};
  if (twiddled) {
    const uint32_t idx = dif_twiddle_index(r, g0 + c, 0, log_n, k, s);
    w0 = __ldg(tw + 2 * idx);
    w1 = __ldg(tw + 2 * idx + 1);
  }
  for (uint32_t i = 0; i < k; ++i) {
    Fe u, v;
    if (i < twiddled) {
      const Fe w = {{w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w}};
      if (i + 1 < twiddled) {
        const uint32_t idx = dif_twiddle_index(r, g0 + c, i + 1, log_n, k, s);
        w0 = __ldg(tw + 2 * idx);
        w1 = __ldg(tw + 2 * idx + 1);
      }
      dif_butterfly(grp[r], grp[r + half], w, u, v);
    } else {
      dif_last_butterfly(grp[r], grp[r + half], scale != nullptr,
                         scale ? *scale : Fe{}, u, v);
    }
    __syncthreads();
    grp[2 * r] = u;
    grp[2 * r + 1] = v;
    __syncthreads();
  }
  for (uint32_t e = threadIdx.x; e < size; e += blockDim.x)
    out[(g0 << k) + e] = loc[e];
}
#else
// The same pass on the host: groups one after another, local stages in
// order.
static void dif_pass_host(const Fe* x, const Fe* table, const Fe* scale,
                          Fe* out, uint32_t log_n, uint32_t s, uint32_t k) {
  const uint32_t groups = 1u << (log_n - k), size = 1u << k;
  const uint32_t half = size / 2;
  const uint32_t twiddled = s + k == log_n ? k - 1 : k;
  const Fe sv = scale ? *scale : Fe{};
  std::vector<Fe> loc(size), nxt(size);
  for (uint32_t g = 0; g < groups; ++g) {
    for (uint32_t m = 0; m < size; ++m) loc[m] = x[g + m * groups];
    for (uint32_t i = 0; i < k; ++i) {
      for (uint32_t r = 0; r < half; ++r) {
        if (i < twiddled)
          dif_butterfly(loc[r], loc[r + half],
                        table[dif_twiddle_index(r, g, i, log_n, k, s)],
                        nxt[2 * r], nxt[2 * r + 1]);
        else
          dif_last_butterfly(loc[r], loc[r + half], scale != nullptr, sv,
                             nxt[2 * r], nxt[2 * r + 1]);
      }
      loc.swap(nxt);
    }
    for (uint32_t m = 0; m < size; ++m) out[g * size + m] = loc[m];
  }
}
#endif

// A3, redesigned: several DIT stages in one pass, the transpose of the
// DIF pass. A pass at stages s+k-1 down to s over n = 2^log_n elements
// works on n / 2^k groups: group g reads the contiguous run
// x[g * 2^k + m] (m < 2^k), runs the local stages i = k-1 down to 0 as
// a = loc[2r], b = loc[2r+1] -> loc'[r] = a + w*b, loc'[r + 2^(k-1)] =
// a - w*b, with the twiddle of the DIF butterfly it transposes
// (dif_twiddle_index), and writes x[g + m * n/2^k]: the array after
// stage s of the stage-by-stage network, so passes compose from the
// highest stages down.
//
// With log_ext > 0 the pass is the first of a transform whose input is
// zero except at multiples of ext = 2^log_ext, and x holds only those
// (the compact [n / ext] coefficients of the LDE). Its first log_ext
// local stages only copy (b is always zero), leaving group g's local
// element l equal to x[g * 2^(k-log_ext) + l mod 2^(k-log_ext)], so the
// pass loads that and starts at local stage k-1-log_ext.
FIELD_FN uint32_t dit_load_index(uint32_t g, uint32_t l, uint32_t k,
                                 uint32_t log_ext) {
  const uint32_t kc = k - log_ext;
  return (g << kc) | (l & ((1u << kc) - 1));
}

FIELD_FN void dit_butterfly(const Fe& a, const Fe& b, const Fe& w, Fe& u,
                            Fe& v) {
  const Fe wb = field::mul(w, b);
  u = field::add(a, wb);
  v = field::sub(a, wb);
}

#ifdef __CUDACC__
// Blocks as in dif_pass_kernel: one per tile of 2^(k + log_c) elements
// (C = 2^log_c groups when the pass is shorter than the transform's
// width) and claim, BPT butterflies per thread and stage (two for a
// 2^10 tile, so a block has at most 256 threads; the two are
// independent work for the scheduler). The tile ping-pongs between two
// buffers in shared memory, so each stage ends in one barrier and no
// result waits in registers for it. The load is one contiguous run of
// the tile (for the compact first pass, runs of 2^(k-log_ext) read ext
// times, from L2); the store writes, for each m, C contiguous elements
// (a whole 32-byte sector each when C = 1). Each twiddle is loaded a
// stage ahead. At most 80 registers a thread, so three blocks of 256
// threads (and 64 KB of shared memory each at k = 10) fit an SM.
constexpr uint32_t kPassThreads = 256;

// A tile of `size` elements in shared memory, as two planes of 16-byte
// halves: the low half of element e at h[e], the high half at
// h[size + e]. A butterfly's reads of elements 2r and 2r+1 then fall on
// 2-way bank conflicts (4-way when the halves are interleaved), its
// writes of r and r + 2^(k-1) on none.
struct Tile {
  uint4* h;
  uint32_t size;
  __device__ __forceinline__ Fe get(uint32_t e) const {
    const uint4 a = h[e], b = h[size + e];
    return {{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
  }
  __device__ __forceinline__ void set(uint32_t e, const Fe& v) const {
    h[e] = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
    h[size + e] = make_uint4(v.w[4], v.w[5], v.w[6], v.w[7]);
  }
};

template <int BPT>
__global__ void __launch_bounds__(kPassThreads, 3)
    dit_pass_kernel(const Fe* __restrict__ x, const Fe* __restrict__ table,
                    Fe* __restrict__ out, uint32_t log_n, uint32_t s,
                    uint32_t k, uint32_t log_c, uint32_t log_ext) {
  extern __shared__ uint4 buf[];  // two tiles, element c << k | m each
  x += (size_t)blockIdx.y << (log_n - log_ext);
  out += (size_t)blockIdx.y << log_n;
  const uint32_t groups = 1u << (log_n - k);
  const uint32_t size = 1u << (k + log_c);
  const uint32_t g0 = blockIdx.x << log_c;
  Tile cur{buf, size}, nxt{buf + 2 * size, size};
  for (uint32_t e = threadIdx.x; e < size; e += blockDim.x)
    cur.set(e, log_ext ? x[dit_load_index(g0 + (e >> k), e, k, log_ext)]
                       : x[(g0 << k) + e]);
  __syncthreads();
  const uint32_t half = 1u << (k - 1);
  const uint4* tw = reinterpret_cast<const uint4*>(table);
  int i = (int)(k - 1 - log_ext);
  uint32_t c[BPT], r[BPT];
  uint4 w0[BPT], w1[BPT];
#pragma unroll
  for (int q = 0; q < BPT; ++q) {
    const uint32_t b = threadIdx.x + q * blockDim.x;
    c[q] = b >> (k - 1);
    r[q] = b & (half - 1);
    const uint32_t idx =
        dif_twiddle_index(r[q], g0 + c[q], i < 0 ? 0 : i, log_n, k, s);
    w0[q] = __ldg(tw + 2 * idx);
    w1[q] = __ldg(tw + 2 * idx + 1);
  }
  for (; i >= 0; --i) {
#pragma unroll
    for (int q = 0; q < BPT; ++q) {
      const Fe w = {{w0[q].x, w0[q].y, w0[q].z, w0[q].w, w1[q].x, w1[q].y,
                     w1[q].z, w1[q].w}};
      if (i > 0) {
        const uint32_t idx =
            dif_twiddle_index(r[q], g0 + c[q], i - 1, log_n, k, s);
        w0[q] = __ldg(tw + 2 * idx);
        w1[q] = __ldg(tw + 2 * idx + 1);
      }
      const uint32_t base = c[q] << k;
      Fe u, v;
      dit_butterfly(cur.get(base + 2 * r[q]), cur.get(base + 2 * r[q] + 1), w,
                    u, v);
      nxt.set(base + r[q], u);
      nxt.set(base + r[q] + half, v);
    }
    __syncthreads();
    const Tile t = cur;
    cur = nxt;
    nxt = t;
  }
  for (uint32_t e = threadIdx.x; e < size; e += blockDim.x) {
    const uint32_t cc = e & ((1u << log_c) - 1), m = e >> log_c;
    out[g0 + cc + m * groups] = cur.get((cc << k) | m);
  }
}
#else
// The same pass on the host: groups one after another, local stages
// from the highest down.
static void dit_pass_host(const Fe* x, const Fe* table, Fe* out,
                          uint32_t log_n, uint32_t s, uint32_t k,
                          uint32_t log_ext) {
  const uint32_t groups = 1u << (log_n - k), size = 1u << k;
  const uint32_t half = size / 2;
  std::vector<Fe> loc(size), nxt(size);
  for (uint32_t g = 0; g < groups; ++g) {
    for (uint32_t m = 0; m < size; ++m)
      loc[m] = log_ext ? x[dit_load_index(g, m, k, log_ext)]
                       : x[g * size + m];
    for (int i = (int)(k - 1 - log_ext); i >= 0; --i) {
      for (uint32_t r = 0; r < half; ++r)
        dit_butterfly(loc[2 * r], loc[2 * r + 1],
                      table[dif_twiddle_index(r, g, i, log_n, k, s)],
                      nxt[r], nxt[r + half]);
      loc.swap(nxt);
    }
    for (uint32_t m = 0; m < size; ++m) out[g + m * groups] = loc[m];
  }
}
#endif

// A2 (x * s, acc + x * s) and A8's cube on one elementwise frame
// (replace _scale_kernel via scale_t, and _cube_kernel via _ew). Each
// op's apply computes element i from x, the accumulator y and the
// scalar *s, reading only what it uses.
#ifdef __CUDACC__
#define OP_FN static __host__ __device__ __forceinline__
#else
#define OP_FN static inline
#endif

// *s is read per element (a cached broadcast load): hoisted into
// registers ahead of the loop it took more registers and instructions
// and measured slower.
struct ScaleOp {
  OP_FN Fe apply(const Fe* x, const Fe*, const Fe* s, uint32_t i) {
    return field::mul(x[i], *s);
  }
};

struct ScaleAccOp {
  OP_FN Fe apply(const Fe* x, const Fe* y, const Fe* s, uint32_t i) {
    return field::add(y[i], field::mul(x[i], *s));
  }
};

struct CubeOp {
  OP_FN Fe apply(const Fe* x, const Fe*, const Fe*, uint32_t i) {
    return field::cube(x[i]);
  }
};

// One element per thread. On the H100 these maps are bound by the issue
// rate of their modmuls' integer instructions (a carry chain is serial,
// so a thread has no independent work to overlap), not by their bytes:
// with the inputs in L2 they take most of the time they take from
// device memory (chip_smoke.py phase 2), and resident warps hide that
// latency best. A persistent grid that streams tiles through shared
// memory by cp.async ahead of the arithmetic, and one that prefetches
// the next element in registers, both measured slower at 2^19; blocks
// of 128 threads beat 256 for cube and tie for scale.
//
// Over a claim axis, claim c reads x at c * x_stride and s at
// c * s_stride (0: shared by the claims); y and out are per claim. The
// claim is blockIdx.y and each thread maps one element: a claim guard
// and a grid-stride loop around the map measured slower for both ops.
template <class Op>
OP_FN void stream_map_at(const Fe* __restrict__ x, uint32_t x_stride,
                         const Fe* __restrict__ y, const Fe* __restrict__ s,
                         uint32_t s_stride, Fe* __restrict__ out, uint32_t n,
                         uint32_t c, uint32_t i) {
  const size_t o = (size_t)c * n;
  out[o + i] = Op::apply(x + (size_t)c * x_stride, y ? y + o : y,
                         s ? s + (size_t)c * s_stride : s, i);
}

// Cube reads and writes only per-claim arrays of one length, so its
// claims are one flat array and its map needs no claim index (which cost
// it 5% at 2^19).
template <class Op>
KERNEL flat_map_kernel(const Fe* __restrict__ x, Fe* __restrict__ out,
                       uint32_t n) {
  FOR_EACH(i, n) out[i] = Op::apply(x, nullptr, nullptr, i);
}

#ifdef __CUDACC__
constexpr uint32_t kMapThreads = 128;

template <class Op>
__global__ void stream_map_kernel(const Fe* __restrict__ x, uint32_t x_stride,
                                  const Fe* __restrict__ y,
                                  const Fe* __restrict__ s, uint32_t s_stride,
                                  Fe* __restrict__ out, uint32_t n) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) stream_map_at<Op>(x, x_stride, y, s, s_stride, out, n,
                               blockIdx.y, i);
}
#endif

template <class Op>
int stream_map(const Fe* x, uint32_t x_stride, const Fe* y, const Fe* s,
               uint32_t s_stride, Fe* out, uint32_t n, uint32_t batch,
               void* stream) {
#ifdef __CUDACC__
  if (n && batch)
    stream_map_kernel<Op><<<dim3((n + kMapThreads - 1) / kMapThreads, batch),
                            kMapThreads, 0, (cudaStream_t)stream>>>(
        x, x_stride, y, s, s_stride, out, n);
  return (int)cudaGetLastError();
#else
  (void)stream;
  for (uint32_t c = 0; c < batch; ++c)
    for (uint32_t i = 0; i < n; ++i)
      stream_map_at<Op>(x, x_stride, y, s, s_stride, out, n, c, i);
  return 0;
#endif
}

// A4: constraint, quotient and boundary map (replaces _db_kernel):
//   C = P(g1 x) - P^3 - K;  D = C * (x - last) * Znum^-1;
//   B = (P - (ia + slope*x)) * Z2^-1.
// P(g1 x) is P read `shift` elements ahead, cyclically; on one shard
// of a sharded domain, the `shift` elements past the shard's end come
// from `halo` (the next shard's first `shift` elements, per claim)
// instead, so the shard's P is never copied. K and Znum^-1 are tables
// of power-of-two length, read as tab[i & mask]. Six modmuls
// per element, one of them a square (P^2 for the cube); the kernel is
// bound by the rate of their integer instructions, about as many on
// the multiply-add pipe as on the add pipe (chip_smoke.py prints the
// SASS count).
// P, D and B are per claim, slope and ia one element per claim; the
// rest is shared. The claim's pointers take registers the parameters
// did not: uncapped, the kernel needs 90 and runs two blocks an SM,
// 10% slower than three.
KERNEL MIN_BLOCKS(3)
    db_kernel(const Fe* __restrict__ p, const Fe* __restrict__ halo,
              const Fe* __restrict__ xs,
              const Fe* __restrict__ k_tab, uint32_t k_mask,
              const Fe* __restrict__ zni_tab, uint32_t zni_mask,
              const Fe* __restrict__ iz2, const Fe* __restrict__ last,
              const Fe* __restrict__ slope, const Fe* __restrict__ ia,
              Fe* __restrict__ d_out, Fe* __restrict__ b_out, uint32_t n,
              uint32_t shift, uint32_t batch) {
  FOR_EACH_CLAIM(cl, batch) {
    const size_t o = (size_t)cl * n;
    const Fe* __restrict__ pc = p + o;
    // Past the end: the halo, or P's own start (one unsharded domain).
    const Fe* __restrict__ wrap = halo ? halo + (size_t)cl * shift : pc;
    Fe* __restrict__ dc = d_out + o;
    Fe* __restrict__ bc = b_out + o;
    const Fe last_v = *last, slope_v = slope[cl], ia_v = ia[cl];
    FOR_EACH(i, n) {
      const uint32_t j = i + shift;
      const Fe pn = j < n ? pc[j] : wrap[j - n];
      const Fe pv = pc[i], x = xs[i];
      const Fe c = field::sub(field::sub(pn, field::cube(pv)),
                              k_tab[i & k_mask]);
      dc[i] = field::mul(field::mul(c, field::sub(x, last_v)),
                         zni_tab[i & zni_mask]);
      const Fe i_ev = field::add(ia_v, field::mul(slope_v, x));
      bc[i] = field::mul(field::sub(pv, i_ev), iz2[i]);
    }
  }
}

// A5: L = D + cp(x)*P + cb(x)*B with periodic coefficient tables
// (replaces _l_kernel). Every operand is per claim: the tables are the
// claim's Fiat-Shamir weights.
KERNEL l_kernel(const Fe* __restrict__ d, const Fe* __restrict__ p,
                const Fe* __restrict__ b, const Fe* __restrict__ cp,
                uint32_t cp_len, const Fe* __restrict__ cb, uint32_t cb_len,
                Fe* __restrict__ out, uint32_t n, uint32_t batch) {
  FOR_EACH_CLAIM(cl, batch) {
    const size_t o = (size_t)cl * n;
    const Fe* __restrict__ dc = d + o;
    const Fe* __restrict__ pc = p + o;
    const Fe* __restrict__ bc = b + o;
    const Fe* __restrict__ cpc = cp + (size_t)cl * cp_len;
    const Fe* __restrict__ cbc = cb + (size_t)cl * cb_len;
    Fe* __restrict__ oc = out + o;
    FOR_EACH(i, n) {
      const Fe t = field::add(field::mul(pc[i], cpc[i % cp_len]),
                              field::mul(bc[i], cbc[i % cb_len]));
      oc[i] = field::add(dc[i], t);
    }
  }
}

// A6: FRI fold by 4 (replaces _fold4_kernel): the 4-point DFT (with
// eta) of the four strided quarters y_j = values[j*q + i], Horner at
// u = sx * ip[i << shift], divided by 4. Round r reads round 0's table
// (g^-i, i < N/4) at stride 4^r (shift = 2r), so one table serves every
// round. Five modmuls per output: the 1/4 is an exact division. The
// values, the column and sx are per claim; ip and eta are shared.
KERNEL fold4_kernel(const Fe* __restrict__ values, const Fe* __restrict__ ip,
                    const Fe* __restrict__ sx, const Fe* __restrict__ eta,
                    Fe* __restrict__ out, uint32_t q, uint32_t shift,
                    uint32_t batch) {
  FOR_EACH_CLAIM(cl, batch) {
    const Fe* __restrict__ v = values + (size_t)cl * 4 * q;
    Fe* __restrict__ oc = out + (size_t)cl * q;
    const Fe sx_v = sx[cl], eta_v = *eta;
    FOR_EACH(i, q) {
      const Fe y0 = v[i], y1 = v[q + i], y2 = v[2 * q + i], y3 = v[3 * q + i];
      const Fe e0 = field::add(y0, y2), d02 = field::sub(y0, y2);
      const Fe e1 = field::add(y1, y3), d13 = field::sub(y1, y3);
      const Fe a0 = field::add(e0, e1), a2 = field::sub(e0, e1);
      const Fe h = field::mul(d13, eta_v);
      const Fe a1 = field::sub(d02, h), a3 = field::add(d02, h);
      const Fe u = field::mul(sx_v, ip[i << shift]);
      Fe acc = field::add(field::mul(u, a3), a2);
      acc = field::add(field::mul(u, acc), a1);
      acc = field::add(field::mul(u, acc), a0);
      oc[i] = field::div4(acc);
    }
  }
}

// A7/A8: elementwise field ops with periodic operands (replace
// _mul_kernel via mul_t and mul_tab_t, and _add_kernel and _sub_kernel
// via _ew), one template. Each operand is read as x[i % len]: a full
// array (len = n), a periodic table (len = 8, or a constant column's
// extension) or a constant (len = 1), so no tiled or broadcast copy
// is ever built. Over a claim axis, claim c reads its operand block at
// c * stride: stride 0 for an operand the claims share (x - last, a
// constant column, a constant), len for one per claim (a column, or a
// claim's 8-periodic Fiat-Shamir table). Flattening [B, n] and reading
// a per-claim table as t[i % (8B)] would hand claim c the others'.
struct MulOp {
  OP_FN Fe apply(const Fe& a, const Fe& b) { return field::mul(a, b); }
};

struct AddOp {
  OP_FN Fe apply(const Fe& a, const Fe& b) { return field::add(a, b); }
};

struct SubOp {
  OP_FN Fe apply(const Fe& a, const Fe& b) { return field::sub(a, b); }
};

template <class Op>
KERNEL binary_kernel(const Fe* __restrict__ a, uint32_t a_len,
                     uint32_t a_stride, const Fe* __restrict__ b,
                     uint32_t b_len, uint32_t b_stride,
                     Fe* __restrict__ out, uint32_t n, uint32_t batch) {
  FOR_EACH_CLAIM(c, batch) {
    const Fe* __restrict__ ac = a + (size_t)c * a_stride;
    const Fe* __restrict__ bc = b + (size_t)c * b_stride;
    Fe* __restrict__ oc = out + (size_t)c * n;
    FOR_EACH(i, n) { oc[i] = Op::apply(ac[i % a_len], bc[i % b_len]); }
  }
}

// The MiMC trace over a claim batch (the counterpart of the lax.scan of
// trace_batch_device, starks_tpu/models/mimc.py; no Pallas kernel):
// trace[c][0] = x0[c], trace[c][i + 1] = trace[c][i]^3 + k[i % n_k].
// The recurrence is sequential, so each thread runs one claim through
// every step; blocks of one warp spread the claims over the SMs. With
// one claim a step is one warp's dependent chain: nothing hides its
// latency, and every instruction holds its pipe as long as a full
// warp's would. So the state is carried in redundant form
// (field::mimc_round: lazy folds, k in the product's first row) and
// only the stored row is made canonical, off the chain. The next
// step's constant is loaded while the step runs. Up to kMaxTraceConsts
// constants are staged in shared memory (SharedConsts); more are read
// from device memory through the read-only cache (GlobalConsts), which
// the one-step-ahead load hides.
struct SharedConsts {
  static constexpr bool kStaged = true;
  OP_FN Fe load(const Fe* k, uint32_t j) { return k[j]; }
};

struct GlobalConsts {
  static constexpr bool kStaged = false;
  OP_FN Fe load(const Fe* k, uint32_t j) {
#ifdef __CUDA_ARCH__
    const uint4* p = reinterpret_cast<const uint4*>(k + j);
    const uint4 a = __ldg(p), b = __ldg(p + 1);
    return Fe{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
#else
    return k[j];
#endif
  }
};

// A step of the trace: the next state from x and k, and the row stored.
struct RedundantRound {
  OP_FN Fe next(const Fe& x, const Fe& k) { return field::mimc_round(x, k); }
  OP_FN Fe row(const Fe& x) { return field::canonical(x); }
};

// The earlier design, kept as the yardstick it is timed against: every
// intermediate canonical, a cube, then an add.
struct CanonicalRound {
  OP_FN Fe next(const Fe& x, const Fe& k) {
    return field::add(field::cube(x), k);
  }
  OP_FN Fe row(const Fe& x) { return x; }
};

template <class Consts, class Round>
FIELD_FN void mimc_trace_claim(Fe x, const Fe* consts, uint32_t n_k, Fe* out,
                               uint32_t steps) {
  out[0] = x;
  Fe k = Consts::load(consts, 0);
  for (uint32_t i = 0, j = 0; i + 1 < steps; ++i) {
    j = j + 1 == n_k ? 0 : j + 1;
    const Fe next = Consts::load(consts, j);
    x = Round::next(x, k);
    out[i + 1] = Round::row(x);
    k = next;
  }
}

// Constants the trace stages in shared memory: they fill the 48 KB a
// launch gets without opting in.
constexpr uint32_t kMaxTraceConsts = (48u << 10) / sizeof(Fe);

#ifdef __CUDACC__
constexpr uint32_t kTraceThreads = 32;

template <class Consts, class Round>
__global__ void mimc_trace_kernel(const Fe* __restrict__ x0,
                                  const Fe* __restrict__ consts,
                                  uint32_t n_k, Fe* __restrict__ out,
                                  uint32_t steps, uint32_t batch) {
  extern __shared__ Fe k_sh[];
  const uint32_t c = blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (Consts::kStaged) {
    for (uint32_t j = threadIdx.x; j < n_k; j += blockDim.x)
      k_sh[j] = consts[j];
    __syncthreads();
    if (c < batch)
      mimc_trace_claim<Consts, Round>(x0[c], k_sh, n_k,
                                      out + (size_t)c * steps, steps);
  } else if (c < batch) {
    mimc_trace_claim<Consts, Round>(x0[c], consts, n_k,
                                    out + (size_t)c * steps, steps);
  }
}

// The latencies of the trace's chain floor (chip_smoke.py phase 2): one
// thread runs `links` dependent instructions, an IMAD.WIDE.U32 with no
// addend (t = lo(t) * b, as every product of mimc_round) for kind 0, an
// IADD3 with carry in and out (x = x + b + carry) for kind 1, and writes
// the SM clocks they took and the chain's value. The operands differ by
// thread, so the chain runs on the vector datapath.
constexpr uint32_t kProbeUnroll = 16;

__global__ void chain_probe_kernel(uint32_t kind, uint32_t links,
                                   uint32_t seed,
                                   unsigned long long* __restrict__ out) {
  uint64_t t = seed ^ threadIdx.x;
  uint32_t x = seed + threadIdx.x;
  const uint32_t b = (seed ^ threadIdx.x) * 2654435761u + 1u;
  const long long t0 = clock64();
  if (kind == 0) {
    for (uint32_t i = 0; i < links; i += kProbeUnroll) {
#pragma unroll
      for (uint32_t u = 0; u < kProbeUnroll; ++u)
        asm volatile("mul.wide.u32 %0, %1, %2;"
                     : "=l"(t) : "r"((uint32_t)t), "r"(b));
    }
  } else {
    for (uint32_t i = 0; i < links; i += kProbeUnroll)
      asm volatile(
          "add.cc.u32 %0, %0, %1;\n\t"
          "addc.cc.u32 %0, %0, %1;\n\taddc.cc.u32 %0, %0, %1;\n\t"
          "addc.cc.u32 %0, %0, %1;\n\taddc.cc.u32 %0, %0, %1;\n\t"
          "addc.cc.u32 %0, %0, %1;\n\taddc.cc.u32 %0, %0, %1;\n\t"
          "addc.cc.u32 %0, %0, %1;\n\taddc.cc.u32 %0, %0, %1;\n\t"
          "addc.cc.u32 %0, %0, %1;\n\taddc.cc.u32 %0, %0, %1;\n\t"
          "addc.cc.u32 %0, %0, %1;\n\taddc.cc.u32 %0, %0, %1;\n\t"
          "addc.cc.u32 %0, %0, %1;\n\taddc.cc.u32 %0, %0, %1;\n\t"
          "addc.u32 %0, %0, %1;"
          : "+r"(x) : "r"(b));
  }
  const long long t1 = clock64();
  out[0] = (unsigned long long)(t1 - t0);
  out[1] = t ^ x;
}
#endif

template <class Round>
int mimc_trace_launch(const Fe* x0, const Fe* consts, uint32_t n_k, Fe* out,
                      uint32_t steps, uint32_t batch, void* stream) {
  if (n_k == 0) return -1;
#ifdef __CUDACC__
  const uint32_t blocks = (batch + kTraceThreads - 1) / kTraceThreads;
  if (steps && batch && n_k <= kMaxTraceConsts)
    mimc_trace_kernel<SharedConsts, Round>
        <<<blocks, kTraceThreads, n_k * sizeof(Fe), (cudaStream_t)stream>>>(
            x0, consts, n_k, out, steps, batch);
  else if (steps && batch)
    mimc_trace_kernel<GlobalConsts, Round>
        <<<blocks, kTraceThreads, 0, (cudaStream_t)stream>>>(
            x0, consts, n_k, out, steps, batch);
  return (int)cudaGetLastError();
#else
  (void)stream;
  for (uint32_t c = 0; c < batch; ++c) {
    Fe* oc = out + (size_t)c * steps;
    if (n_k <= kMaxTraceConsts)
      mimc_trace_claim<SharedConsts, Round>(x0[c], consts, n_k, oc, steps);
    else
      mimc_trace_claim<GlobalConsts, Round>(x0[c], consts, n_k, oc, steps);
  }
  return 0;
#endif
}

// Batch inversion: out[i] = 1 / x[i], and 0 where x[i] is 0 (the JAX
// package's limbs.batch_inv and fused.batch_inv_scan, XLA scans with no
// Pallas kernel), as a block scan with one Fermat inverse in all.
// Montgomery's trick needs the product of every element (a zero counts
// as 1) and, for each element, the product of all the others; field
// products commute, so any partition of the elements into groups serves.
//
// A level of m elements is cut into blocks of T threads (a power of two,
// 32 to kInvThreads) and k elements a thread: thread j of block b holds
// the group of elements (b k + i) T + j, i < k (inv_index), so a warp's
// loads and stores are 32 consecutive 32-byte elements. The up-sweep
// kernel (batch_inv_up_kernel) takes each thread's group product, reduces
// the block's T products on a binary tree in shared memory and writes the
// block's total: the totals are the next level's elements, and levels
// follow until one block holds them all. That block's kernel
// (batch_inv_top_kernel) reduces the same way, one thread inverts the
// total (field::inv_chain, the only serial chain left: 255 squarings and
// 17 products), and the tree gives each thread the inverse of its group
// product, a node's inverse being its parent's times its sibling. A
// thread's backward pass over its group then writes 1 / x = acc *
// (exclusive prefix) and steps acc *= x. The down-sweep kernel
// (batch_inv_down_kernel) does the same for a lower level, its block
// totals' inverses read from the level above. 2L - 1 launches for L
// levels. Only the outputs are canonical: the group products, prefixes,
// totals and tree nodes are lazy (field::mul_lazy in the group passes,
// the chain forms on the trees).
//
// Bound: the function needs 3 modmuls a nonzero element and 64 bytes
// (x read, out written), and its inverse; the operations bound it. The
// up-sweep writes each element's exclusive prefix to out and the
// down-sweep reads it back, and takes a group's product again as its
// last prefix times its last element: 3 modmuls and 128 bytes an element
// (x read twice, out written twice and read once). Recomputing the
// prefixes in registers instead (4 modmuls and 96 bytes) measured slower
// at 2^23 elements (PERF.md). On the card each kernel is bound by the
// issue rate of its modmuls' integer instructions and by its bytes in
// turn, not both at once; a block's tree leaves most of its warps idle,
// which the blocks resident beside it fill (kInvMinBlocks). Below about
// 2^21 elements the inverse's chain and the levels' dependent products
// set the time.
constexpr uint32_t kInvThreads = 256;
// Elements a thread holds: 1, 2, 4, 8 or 16 (the kernels are
// instantiated for each).
constexpr uint32_t kInvMaxGroup = 16;

FIELD_FN uint32_t inv_index(uint32_t b, uint32_t j, uint32_t i,
                            uint32_t threads, uint32_t k) {
  return (b * k + i) * threads + j;
}

FIELD_FN Fe field_one() {
  Fe one{};
  one.w[0] = 1;
  return one;
}

// The blocks an SM must hold (__launch_bounds__): the kernels keep
// nothing per element in registers, so their group loops stay rolled and
// 4 blocks of 256 fit an SM (64 registers): a block's tree, whose levels
// leave most of its warps idle, then overlaps other blocks' group passes.
constexpr int kInvMinBlocks = 4;

// Thread j's forward pass over its group in block b of a level of m
// elements (a[m]): the product of its nonzero elements, each element's
// exclusive prefix product written to pre at the element's index.
template <int K>
FIELD_FN Fe group_forward(const Fe* __restrict__ a, uint32_t m, uint32_t b,
                          uint32_t j, uint32_t threads,
                          Fe* __restrict__ pre) {
  Fe acc = field_one();
#pragma unroll 1
  for (int i = 0; i < K; ++i) {
    const uint32_t e = inv_index(b, j, i, threads, K);
    if (e >= m) break;
    const Fe v = a[e];
    pre[e] = acc;
    if (!field::is_zero(v)) acc = field::mul_lazy(acc, v);
  }
  return acc;
}

// A group's product again from its stored prefixes: the last element's
// prefix times that element (a zero counts as 1); 1 for an empty group.
template <int K>
FIELD_FN Fe group_product_stored(const Fe* __restrict__ a, uint32_t m,
                                 uint32_t b, uint32_t j, uint32_t threads,
                                 const Fe* __restrict__ pre) {
  const uint32_t first = inv_index(b, j, 0, threads, K);
  if (first >= m) return field_one();
  const uint32_t held = (m - 1 - first) / threads + 1;
  const uint32_t e = inv_index(b, j, (held < K ? held : K) - 1, threads, K);
  const Fe v = a[e], q = pre[e];
  return field::is_zero(v) ? q : field::mul_lazy(q, v);
}

// Thread j's backward pass, acc the inverse of its group's product:
// out[e] = acc * prefix (the prefix read from out itself), then
// acc *= x[e], from the last element down (out[e] = 0 where x[e] is 0).
template <int K>
FIELD_FN void group_backward(const Fe* __restrict__ a, uint32_t m, uint32_t b,
                             uint32_t j, uint32_t threads, Fe acc,
                             Fe* __restrict__ out) {
#pragma unroll 1
  for (int i = K - 1; i >= 0; --i) {
    const uint32_t e = inv_index(b, j, i, threads, K);
    if (e >= m) continue;
    const Fe v = a[e];
    if (field::is_zero(v)) {
      out[e] = v;
      continue;
    }
    out[e] = field::mul(acc, out[e]);
    if (i) acc = field::mul_lazy(acc, v);
  }
}

// The binary tree over a block's T group products in shared memory:
// level s (T >> s nodes) at tree_offset(T, s), the root at 2T - 2. Up,
// step s makes node j of level s + 1 from nodes 2j and 2j + 1 of level
// s; down, with the root replaced by its inverse, step s turns nodes
// 2j and 2j + 1 of level s into their inverses (each its parent's
// inverse times its sibling), so level 0 ends holding each group
// product's inverse. Steps of one level run on threads j < T >> (s+1).
FIELD_FN uint32_t tree_offset(uint32_t threads, uint32_t s) {
  return 2 * threads - ((2 * threads) >> s);
}

FIELD_FN void tree_up(Fe* node, uint32_t threads, uint32_t s, uint32_t j) {
  const Fe* lo = node + tree_offset(threads, s);
  node[tree_offset(threads, s + 1) + j] = field::mul_chain(lo[2 * j],
                                                           lo[2 * j + 1]);
}

FIELD_FN void tree_down(Fe* node, uint32_t threads, uint32_t s, uint32_t j) {
  Fe* lo = node + tree_offset(threads, s);
  const Fe inv = node[tree_offset(threads, s + 1) + j];
  const Fe l = lo[2 * j], r = lo[2 * j + 1];
  lo[2 * j] = field::mul_chain(inv, r);
  lo[2 * j + 1] = field::mul_chain(inv, l);
}

FIELD_FN uint32_t log2_of(uint32_t v) {
  uint32_t s = 0;
  while ((1u << s) < v) ++s;
  return s;
}

// The top level's block: T' threads (at most T, at least 32) and k'
// elements a thread (at most k), the fewest that hold its m elements.
struct InvShape {
  uint32_t threads, k;
};

FIELD_FN InvShape inv_top_shape(uint32_t m, uint32_t threads, uint32_t k) {
  uint32_t t = 32;
  while (t < threads && t < m) t *= 2;
  uint32_t kk = 1;
  while (kk < k && t * kk < m) kk *= 2;
  return {t, kk};
}

#ifdef __CUDACC__
// The block's tree: its up-sweep, which leaves the root (the block's
// total) at node[2T - 2], and its down-sweep from the root's inverse.
__device__ __forceinline__ void block_tree_up(Fe* node, uint32_t threads) {
  const uint32_t j = threadIdx.x;
  __syncthreads();
  for (uint32_t s = 0; (threads >> s) > 1; ++s) {
    if (j < (threads >> (s + 1))) tree_up(node, threads, s, j);
    __syncthreads();
  }
}

__device__ __forceinline__ void block_tree_down(Fe* node, uint32_t threads) {
  const uint32_t j = threadIdx.x;
  __syncthreads();
  for (uint32_t s = log2_of(threads); s-- > 0;) {
    if (j < (threads >> (s + 1))) tree_down(node, threads, s, j);
    __syncthreads();
  }
}

template <int K>
__global__ void __launch_bounds__(kInvThreads, kInvMinBlocks)
    batch_inv_up_kernel(const Fe* __restrict__ a, uint32_t m,
                        Fe* __restrict__ pre, Fe* __restrict__ totals) {
  __shared__ Fe node[2 * kInvThreads];
  const uint32_t threads = blockDim.x, j = threadIdx.x, b = blockIdx.x;
  node[j] = group_forward<K>(a, m, b, j, threads, pre);
  block_tree_up(node, threads);
  if (j == 0) totals[b] = node[2 * threads - 2];
}

// inv_totals holds the inverse of each block's total (the level above's
// output); out held the up-sweep's prefixes and receives this level's
// inverses.
template <int K>
__global__ void __launch_bounds__(kInvThreads, kInvMinBlocks)
    batch_inv_down_kernel(const Fe* __restrict__ a, uint32_t m,
                          const Fe* __restrict__ inv_totals,
                          Fe* __restrict__ out) {
  __shared__ Fe node[2 * kInvThreads];
  const uint32_t threads = blockDim.x, j = threadIdx.x, b = blockIdx.x;
  node[j] = group_product_stored<K>(a, m, b, j, threads, out);
  block_tree_up(node, threads);
  if (j == 0) node[2 * threads - 2] = inv_totals[b];
  block_tree_down(node, threads);
  group_backward<K>(a, m, b, j, threads, node[j], out);
}

// One block over the top level's m elements: up, the inverse, down.
template <int K>
__global__ void __launch_bounds__(kInvThreads)
    batch_inv_top_kernel(const Fe* __restrict__ a, uint32_t m,
                         Fe* __restrict__ out) {
  __shared__ Fe node[2 * kInvThreads];
  const uint32_t threads = blockDim.x, j = threadIdx.x;
  node[j] = group_forward<K>(a, m, 0, j, threads, out);
  block_tree_up(node, threads);
  if (j == 0) node[2 * threads - 2] = field::inv_chain(node[2 * threads - 2]);
  block_tree_down(node, threads);
  group_backward<K>(a, m, 0, j, threads, node[j], out);
}

// Launches one kernel of the scan at a group size known only at run
// time (1, 2, 4, 8 or 16).
#define INV_DISPATCH(kernel, k, grid, threads, stream, ...)               \
  do {                                                                    \
    const cudaStream_t st = (cudaStream_t)(stream);                       \
    switch (k) {                                                          \
      case 1: kernel<1><<<grid, threads, 0, st>>>(__VA_ARGS__);           \
        break;                                                            \
      case 2: kernel<2><<<grid, threads, 0, st>>>(__VA_ARGS__);           \
        break;                                                            \
      case 4: kernel<4><<<grid, threads, 0, st>>>(__VA_ARGS__);           \
        break;                                                            \
      case 8: kernel<8><<<grid, threads, 0, st>>>(__VA_ARGS__);           \
        break;                                                            \
      default:                                                            \
        kernel<16><<<grid, threads, 0, st>>>(__VA_ARGS__);                \
    }                                                                     \
    const int rc = (int)cudaGetLastError();                               \
    if (rc) return rc;                                                    \
  } while (0)
#else
// The same kernels on the host: blocks one after another, each phase
// of a block (group passes, tree steps) for all its threads before the
// next, as the card's barriers order them.
template <int K>
static void inv_block_host(const Fe* a, uint32_t m, uint32_t b,
                           uint32_t threads, Fe* pre, Fe* totals,
                           const Fe* inv_total, bool top, Fe* out) {
  std::vector<Fe> node(2 * threads);
  for (uint32_t j = 0; j < threads; ++j)
    node[j] = inv_total ? group_product_stored<K>(a, m, b, j, threads, out)
                        : group_forward<K>(a, m, b, j, threads, pre);
  for (uint32_t s = 0; (threads >> s) > 1; ++s)
    for (uint32_t j = 0; j < (threads >> (s + 1)); ++j)
      tree_up(node.data(), threads, s, j);
  Fe& root = node[2 * threads - 2];
  if (totals) {
    totals[b] = root;
    return;
  }
  root = top ? field::inv_chain(root) : *inv_total;
  for (uint32_t s = log2_of(threads); s-- > 0;)
    for (uint32_t j = 0; j < (threads >> (s + 1)); ++j)
      tree_down(node.data(), threads, s, j);
  for (uint32_t j = 0; j < threads; ++j)
    group_backward<K>(a, m, b, j, threads, node[j], out);
}

static void inv_level_host(const Fe* a, uint32_t m, uint32_t blocks,
                           uint32_t threads, uint32_t k, Fe* pre, Fe* totals,
                           const Fe* inv_totals, bool top, Fe* out) {
  for (uint32_t b = 0; b < blocks; ++b) {
    const Fe* it = inv_totals ? inv_totals + b : nullptr;
    switch (k) {
      case 1: inv_block_host<1>(a, m, b, threads, pre, totals, it, top,
                                out); break;
      case 2: inv_block_host<2>(a, m, b, threads, pre, totals, it, top,
                                out); break;
      case 4: inv_block_host<4>(a, m, b, threads, pre, totals, it, top,
                                out); break;
      case 8: inv_block_host<8>(a, m, b, threads, pre, totals, it, top,
                                out); break;
      default: inv_block_host<16>(a, m, b, threads, pre, totals, it, top,
                                  out);
    }
  }
}
#endif

// Most levels a scan takes: each level but the top divides the count by
// at least 32, and n < 2^31.
constexpr uint32_t kInvMaxLevels = 8;

// The scan over x[n]: level 0 in blocks of threads x k elements, each
// level above in blocks of threads x k_up. Level l >= 1 keeps its m_l
// elements (the totals of level l - 1) and then their inverses in
// scratch, one after the other. Returns -1 on a bad shape, or when
// scratch_len is below what the levels need.
static int batch_inv_scan(const Fe* x, Fe* out, Fe* scratch,
                          uint32_t scratch_len, uint32_t n, uint32_t threads,
                          uint32_t k, uint32_t k_up, void* stream) {
  const auto group_ok = [](uint32_t g) {
    return g && g <= kInvMaxGroup && !(g & (g - 1));
  };
  if (n == 0 || threads < 32 || threads > kInvThreads ||
      (threads & (threads - 1)) || !group_ok(k) || !group_ok(k_up))
    return -1;
  uint32_t m[kInvMaxLevels], levels = 1, need = 0;
  m[0] = n;
  for (uint32_t tile = threads * k; m[levels - 1] > tile;
       tile = threads * k_up) {
    if (levels == kInvMaxLevels) return -1;
    m[levels] = (m[levels - 1] + tile - 1) / tile;
    need += 2 * m[levels++];
  }
  if (scratch_len < need) return -1;
  Fe* in[kInvMaxLevels];    // level l's elements (level 0's only read)
  Fe* res[kInvMaxLevels];   // and their inverses
  in[0] = const_cast<Fe*>(x);
  res[0] = out;
  for (uint32_t l = 1, off = 0; l < levels; off += 2 * m[l++]) {
    in[l] = scratch + off;
    res[l] = scratch + off + m[l];
  }
  const auto group = [&](uint32_t l) { return l ? k_up : k; };
  const uint32_t top = levels - 1;
  const InvShape ts = inv_top_shape(m[top], threads, group(top));
#ifdef __CUDACC__
  for (uint32_t l = 0; l < top; ++l)
    INV_DISPATCH(batch_inv_up_kernel, group(l), m[l + 1], threads, stream,
                 in[l], m[l], res[l], in[l + 1]);
  INV_DISPATCH(batch_inv_top_kernel, ts.k, 1, ts.threads, stream, in[top],
               m[top], res[top]);
  for (uint32_t l = top; l-- > 0;)
    INV_DISPATCH(batch_inv_down_kernel, group(l), m[l + 1], threads, stream,
                 in[l], m[l], res[l + 1], res[l]);
#else
  (void)stream;
  for (uint32_t l = 0; l < top; ++l)
    inv_level_host(in[l], m[l], m[l + 1], threads, group(l), res[l],
                   in[l + 1], nullptr, false, res[l]);
  inv_level_host(in[top], m[top], 1, ts.threads, ts.k, res[top], nullptr,
                 nullptr, true, res[top]);
  for (uint32_t l = top; l-- > 0;)
    inv_level_host(in[l], m[l], m[l + 1], threads, group(l), nullptr,
                   nullptr, res[l + 1], false, res[l]);
#endif
  return 0;
}

// The design the scan replaced, kept as the yardstick it is timed
// against (no path runs it): one thread per run of `run` consecutive
// elements, the last run short: a forward pass writes each exclusive
// prefix product of the run to out and carries the run's product (a
// zero counts as 1), one Fermat inverse (field::inv) of that product,
// then a backward pass, out[i] *= acc and acc *= x[i].
KERNEL batch_inv_runs_kernel(const Fe* __restrict__ x, Fe* __restrict__ out,
                             uint32_t n, uint32_t run) {
  const uint32_t runs = (n + run - 1) / run;
  FOR_EACH(r, runs) {
    const uint32_t lo = r * run, hi = n - lo < run ? n : lo + run;
    Fe acc = field_one();
    for (uint32_t i = lo; i < hi; ++i) {
      const Fe v = x[i];
      out[i] = acc;
      if (!field::is_zero(v)) acc = field::mul(acc, v);
    }
    acc = field::inv(acc);
    for (uint32_t i = hi; i-- > lo;) {
      const Fe v = x[i];
      if (field::is_zero(v)) {
        out[i] = v;
      } else {
        out[i] = field::mul(out[i], acc);
        acc = field::mul(acc, v);
      }
    }
  }
}

#define F(ptr) ((const Fe*)(ptr))
#define W(ptr) ((Fe*)(ptr))

extern "C" {

// The DIF transform as ceil(log_n / k) passes of at most k stages
// (1 <= k <= 10: a tile of 2^k elements, 2^(k-1) threads and 32 * 2^k
// bytes of shared memory, under the 48 KB a launch gets without opting
// in). table[0] must be 1. With s not null the outputs are multiplied
// by *s in the last stage. The passes ping-pong between out and
// scratch, so the last one writes out; x is only read, and scratch is
// unused for one pass. x, out and scratch hold `batch` transforms of n
// elements; the table and s are shared.
int starks_ntt_dif(const void* x, const void* table, const void* s,
                   void* out, void* scratch, uint32_t n, uint32_t k,
                   uint32_t batch, void* stream) {
  uint32_t log_n = 0;
  while ((1u << log_n) < n) ++log_n;
  const uint32_t passes = (log_n + k - 1) / k;
  const Fe* src = F(x);
  for (uint32_t p = 0, t = 0; t < log_n; ++p, t += k) {
    const uint32_t kk = log_n - t < k ? log_n - t : k;
    Fe* dst = (passes - 1 - p) % 2 ? W(scratch) : W(out);
#ifdef __CUDACC__
    const uint32_t blocks = n >> k, threads = 1u << (k - 1);
    const size_t smem = sizeof(Fe) << k;
    dif_pass_kernel<<<dim3(blocks, batch), threads, smem,
                      (cudaStream_t)stream>>>(src, F(table), F(s), dst,
                                              log_n, t, kk, k - kk);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
#else
    (void)stream;
    for (uint32_t c = 0; c < batch; ++c)
      dif_pass_host(src + (size_t)c * n, F(table), F(s), dst + (size_t)c * n,
                    log_n, t, kk);
#endif
    src = dst;
  }
  return 0;
}

// The DIT transform (bit-reversed in, natural out) as ceil(log_n / k)
// passes of at most k stages (1 <= k <= 10, as for the DIF), from the
// highest stages down. The pass with fewer stages, when k does not
// divide log_n, comes first (it timed the same last). With log_ext > 0,
// x holds the n / 2^log_ext nonzero inputs (every 2^log_ext-th) and the
// first pass, which must run at least log_ext stages, reads them
// (dit_pass_kernel). Passes ping-pong between out and scratch, so the
// last one writes out; scratch is unused for one pass. x holds `batch`
// inputs of n / 2^log_ext elements, out and scratch `batch` transforms
// of n; the table is shared.
int starks_ntt_dit(const void* x, const void* table, void* out,
                   void* scratch, uint32_t n, uint32_t k,
                   uint32_t log_ext, uint32_t batch, void* stream) {
  uint32_t log_n = 0;
  while ((1u << log_n) < n) ++log_n;
  const uint32_t passes = (log_n + k - 1) / k;
  const uint32_t short_k = log_n - (passes - 1) * k;
  if (short_k < log_ext) return -1;
  const Fe* src = F(x);
  for (uint32_t p = 0, top = log_n; p < passes; ++p) {
    const uint32_t kk = p ? k : short_k;
    const uint32_t s = top - kk, le = p ? 0 : log_ext;
    Fe* dst = (passes - 1 - p) % 2 ? W(scratch) : W(out);
#ifdef __CUDACC__
    // Two tiles of 2^k elements: 64 KB at k = 10, above the 48 KB a
    // launch gets without opting in (once per process).
    const int max_smem = (int)(2 * sizeof(Fe)) << 10;
    static const int opt_in =
        (int)cudaFuncSetAttribute(dit_pass_kernel<1>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  max_smem) |
        (int)cudaFuncSetAttribute(dit_pass_kernel<2>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  max_smem);
    if (opt_in) return opt_in;
    const uint32_t blocks = n >> k, butterflies = 1u << (k - 1);
    const size_t smem = (2 * sizeof(Fe)) << k;
    const dim3 grid(blocks, batch);
    if (butterflies > kPassThreads)
      dit_pass_kernel<2><<<grid, butterflies / 2, smem,
                           (cudaStream_t)stream>>>(src, F(table), dst, log_n,
                                                   s, kk, k - kk, le);
    else
      dit_pass_kernel<1><<<grid, butterflies, smem, (cudaStream_t)stream>>>(
          src, F(table), dst, log_n, s, kk, k - kk, le);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
#else
    (void)stream;
    for (uint32_t c = 0; c < batch; ++c)
      dit_pass_host(src + ((size_t)c << (log_n - le)), F(table),
                    dst + ((size_t)c << log_n), log_n, s, kk, le);
#endif
    src = dst;
    top = s;
  }
  return 0;
}

// x * s, or acc + x * s when acc is not null, over `batch` claims of n
// elements: claim c reads x at c * x_stride and s at c * s_stride (0:
// shared); acc and out are per claim.
int starks_scale(const void* x, uint32_t x_stride, const void* s,
                 uint32_t s_stride, const void* acc, void* out, uint32_t n,
                 uint32_t batch, void* stream) {
  return acc ? stream_map<ScaleAccOp>(F(x), x_stride, F(acc), F(s), s_stride,
                                      W(out), n, batch, stream)
             : stream_map<ScaleOp>(F(x), x_stride, nullptr, F(s), s_stride,
                                   W(out), n, batch, stream);
}

// The D/B, L and fold4 maps over `batch` claims ([batch, n] arrays; the
// per-claim operands as their kernels say). The D/B map's halo is null
// or [batch, shift] elements.
int starks_db_map(const void* p, const void* halo, const void* xs,
                  const void* k_tab, uint32_t k_len, const void* zni_tab,
                  uint32_t zni_len, const void* iz2, const void* last,
                  const void* slope, const void* ia, void* d_out,
                  void* b_out, uint32_t n, uint32_t shift, uint32_t batch,
                  void* stream) {
  if ((k_len & (k_len - 1)) || (zni_len & (zni_len - 1))) return -1;
  LAUNCH(db_kernel, n, batch, stream, F(p), F(halo), F(xs), F(k_tab),
         k_len - 1, F(zni_tab), zni_len - 1, F(iz2), F(last), F(slope),
         F(ia), W(d_out), W(b_out), n, shift, batch);
}

int starks_l_map(const void* d, const void* p, const void* b, const void* cp,
                 uint32_t cp_len, const void* cb, uint32_t cb_len, void* out,
                 uint32_t n, uint32_t batch, void* stream) {
  LAUNCH(l_kernel, n, batch, stream, F(d), F(p), F(b), F(cp), cp_len, F(cb),
         cb_len, W(out), n, batch);
}

int starks_fold4(const void* values, const void* ip, const void* sx,
                 const void* eta, void* out, uint32_t q, uint32_t shift,
                 uint32_t batch, void* stream) {
  LAUNCH(fold4_kernel, q, batch, stream, F(values), F(ip), F(sx), F(eta),
         W(out), q, shift, batch);
}

// a (op) b over `batch` claims of n elements: each operand read
// periodically at its length, and at its stride per claim (0: shared).
#define BINARY_ENTRY(name, Op)                                               \
  int name(const void* a, uint32_t a_len, uint32_t a_stride, const void* b, \
           uint32_t b_len, uint32_t b_stride, void* out, uint32_t n,        \
           uint32_t batch, void* stream) {                                   \
    LAUNCH(binary_kernel<Op>, n, batch, stream, F(a), a_len, a_stride, F(b), \
           b_len, b_stride, W(out), n, batch);                               \
  }
BINARY_ENTRY(starks_mul, MulOp)
BINARY_ENTRY(starks_add, AddOp)
BINARY_ENTRY(starks_sub, SubOp)

// The cube of `batch` claims of n elements: one flat array of batch * n
// (below 2^32) elements.
int starks_cube(const void* a, void* out, uint32_t n, uint32_t batch,
                void* stream) {
  const uint32_t total = n * batch;
#ifdef __CUDACC__
  if (total)
    flat_map_kernel<CubeOp><<<(total + kMapThreads - 1) / kMapThreads,
                              kMapThreads, 0, (cudaStream_t)stream>>>(
        F(a), W(out), total);
  return (int)cudaGetLastError();
#else
  (void)stream;
  flat_map_kernel<CubeOp>(F(a), W(out), total);
  return 0;
#endif
}

// `batch` MiMC traces of `steps` rows from the inputs x0 [batch] and the
// n_k >= 1 round constants.
int starks_mimc_trace(const void* x0, const void* consts, uint32_t n_k,
                      void* out, uint32_t steps, uint32_t batch,
                      void* stream) {
  return mimc_trace_launch<RedundantRound>(F(x0), F(consts), n_k, W(out),
                                           steps, batch, stream);
}

// The same traces by the earlier design (every intermediate canonical),
// which the kernel is timed beside.
int starks_mimc_trace_canonical(const void* x0, const void* consts,
                                uint32_t n_k, void* out, uint32_t steps,
                                uint32_t batch, void* stream) {
  return mimc_trace_launch<CanonicalRound>(F(x0), F(consts), n_k, W(out),
                                           steps, batch, stream);
}

// 1 / x over n elements (0 where x is 0) by the block scan, level 0 in
// blocks of `threads` (a power of two, 32 to 256) x k elements, each
// level above in blocks of threads x k_up (k and k_up 1, 2, 4, 8 or
// 16). scratch holds scratch_len elements: twice the element count of
// every level above 0.
int starks_batch_inv(const void* x, void* out, void* scratch,
                     uint32_t scratch_len, uint32_t n, uint32_t threads,
                     uint32_t k, uint32_t k_up, void* stream) {
  return batch_inv_scan(F(x), W(out), W(scratch), scratch_len, n, threads,
                        k, k_up, stream);
}

// The replaced design: one thread per run of `run` >= 1 elements (the
// last run may be short).
int starks_batch_inv_runs(const void* x, void* out, uint32_t n, uint32_t run,
                          void* stream) {
  if (run == 0) return -1;
  LAUNCH(batch_inv_runs_kernel, (n + run - 1) / run, 1u, stream, F(x),
         W(out), n, run);
}

// One thread's chain of `links` (a multiple of 16) dependent
// instructions, kind 0 IMAD.WIDE.U32, kind 1 IADD3 with carry: out[0] =
// the SM clocks it took. Needs a card (-1 without).
int starks_chain_probe(uint32_t kind, uint32_t links, void* out,
                       void* stream) {
  if (kind > 1 || links % 16) return -1;
#ifdef __CUDACC__
  chain_probe_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      kind, links, 12345u, (unsigned long long*)out);
  return (int)cudaGetLastError();
#else
  (void)out;
  (void)stream;
  return -1;
#endif
}

}  // extern "C"
