// K8: W4A8 fused dequant + matmul: per-row int8 activations times
// plane-per-group packed low-bit weight codes, int8 x int8 -> int32 dots.
//
// Replaces gptq_v2_tpu/ops/w4a16.py::_kernel_a8 (grid _w4a8_2d, entry
// w4a16_matmul with act_bits = 8) and the per-row activation quantization
// the JAX package runs around it.  Plain PyTorch version:
// ops/w4a16.py::quantize_activations_int8 on ops/w4a16.py::stored_rows, then
// ops/w4a16.py::w4a8_reference (each group's dot exact in float64, then the
// same fp32 algebra).
//
// Numerics (as JAX's): xq (M, C_pad) int8 = x's rows in stored (act-order)
// column order, zero-padded, quantized per row to x_scale = max(amax,
// 1e-12) / 127 and xq = clamp(rint(x / x_scale), +-127) (IEEE division,
// round half to even).  Per quantization group i (bit-plane i of a packing
// block, ops/packing.py):
//     dot_i = sum_k xq_k * (q_k - off) + off * sum_k xq_k      (exact int32)
//     acc  += float(dot_i) * s - float(sum_k xq_k) * zs
// with zs = z * s rounded to T (fp32 or bf16, the scales' type), the terms
// summed in group order, and out = T(acc * x_scale).  bits = 8 codes span
// 0..255 and would wrap as int8, so they are centred by off = 128 and the
// offset comes back through the exact row sum; bits <= 4 use off = 0.
//
// Bound on the H100: bytes at decode (each packed word is read once:
// C * R * bits / 8 bytes), operations at prefill (2 * M * C * R at the int8
// tensor-core rate, 1979 TOP/s).
//
// One staging kernel runs first on every route (w4a8_stage_rows, one block
// per row): it gathers x through perm, zero-pads, takes the row's amax,
// quantizes, and writes xq, x_scale and each (row, group)'s exact sum
// sum_k xq_k as int32.  Its output is bit-equal to the plain version's.
//
// Two matmul routes, chosen by the weights alone, never by M:
//
// Tensor-core route: bits 2 / 4 / 8, g % 16 == 0 and g <= 128, fp32 or bf16
// scales (the int8 dot does not depend on them).  One device routine,
// group_dots_a8, forms every group's dot in both kernels: a chain of
// mma.sync m16n8k32 (s8 x s8 -> s32; one m16n8k16 for a 16-wide tail)
// over the group's k chunks from zero.  The dot is an exact integer, so
// neither the chunking nor the order changes it.  B fragments are built
// from the packed words as they are (never repacked): one B register holds
// four consecutive k of one column, i.e. the plane's field of four words,
// gathered with __byte_perm and masked (bits 8: the byte xor 0x80, which
// is code - 128 as int8).  A group's term is group_term_a8, one fixed
// rounded form, and the terms are summed in group order from zero with
// __fadd_rn.  So a row gets the same bits at every M, tile and lane by
// construction: the decode kernel's rows equal the prefill kernel's.
// Keep it so: both kernels must go through group_dots_a8 and group_term_a8.
//
// * Decode (M <= 16, w4a8_decode_tc): the contraction is split over groups
//   as in K3's decode kernels (csrc/w4a16.cu; the split, the cluster sum
//   and the launch helpers are csrc/dequant_matmul.cuh's): a cluster of up to 8 blocks
//   owns a 64-column tile, a block holds 16 groups at a time, a warp two
//   groups of one packing block (one m16 tile, rows past M zero) for 32
//   columns at a time.  Words go straight from device memory to registers
//   in 16-byte loads, the next chunk's in flight while one is summed.
//   Terms are parked in shared memory and summed in group order across the
//   cluster through distributed shared memory; no atomics, so two launches
//   are bit-equal and a launch can be captured in a CUDA graph.
// * Prefill (M > 16, w4a8_prefill_tc): a block owns 128 rows x 128 columns
//   (64 x 64 up to M = 64), eight warps.  Per packing block its (g, BN)
//   words are staged once in shared memory with cp.async (16-byte chunks
//   xor-swizzled so a warp's B reads hit distinct banks), and per group
//   the (BM, g) slice of xq, both double-buffered one group ahead; A
//   fragments by ldmatrix (int8 viewed as b16), each B fragment built once
//   per chunk and used for every m tile of the warp.  Terms are summed in
//   group order in registers.
//
// CUDA-core route: every other g (a multiple of 4): the first kernel below,
// unchanged (w4a8_kernel: per plane the codes unpacked to an int8 tile in
// shared memory, __dp4a dots and row sums).
//
// Measured times against the bound and the library: PERF.md, kernel table.
#include "dequant_matmul.cuh"

namespace {

constexpr int BN = 64;
constexpr int THREADS = 256;

template <int BITS, int BM, typename T>
__global__ void __launch_bounds__(THREADS)
w4a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ x_scale,
            const int32_t* __restrict__ qw, const T* __restrict__ scales,
            const T* __restrict__ zeros, T* __restrict__ out, int m_rows, int c_pad,
            int r, int g) {
  constexpr int PLANES = 32 / BITS;
  constexpr unsigned MASK = (1u << BITS) - 1u;
  constexpr int OFF = BITS == 8 ? 128 : 0;
  constexpr int TM = BM / 16;
  const int gq = g / 4;      // 32-bit words of 4 int8 per group row
  const int stride = gq + 1;  // padded row stride of the code and activation tiles
  extern __shared__ int32_t smem[];
  int32_t* sw = smem;                 // (g, BN) packed words
  int32_t* sc = sw + g * BN;          // (BN, stride) int8x4 codes of one plane
  int32_t* sx = sc + BN * stride;     // (BM, stride) int8x4 activations of one plane
  int8_t* sc8 = reinterpret_cast<int8_t*>(sc);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int n_blocks = c_pad / (PLANES * g);
  const int32_t* x32 = reinterpret_cast<const int32_t*>(xq);

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int b = 0; b < n_blocks; ++b) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < g * BN; idx += THREADS) {
      int wrow = idx / BN, col = idx % BN;
      sw[idx] = (n0 + col < r) ? qw[static_cast<size_t>(b * g + wrow) * r + n0 + col] : 0;
    }
    for (int p = 0; p < PLANES; ++p) {
      __syncthreads();  // sw is complete; the previous plane's tiles are read
      const int c0 = (b * PLANES + p) * g;
      for (int idx = threadIdx.x; idx < BM * gq; idx += THREADS) {
        int mi = idx / gq, kq = idx % gq;
        sx[mi * stride + kq] =
            (m0 + mi < m_rows) ? x32[(static_cast<size_t>(m0 + mi) * c_pad + c0) / 4 + kq] : 0;
      }
      const int shift = BITS * p;
      for (int idx = threadIdx.x; idx < g * BN; idx += THREADS) {
        int k = idx / BN, col = idx % BN;
        int code = static_cast<int>((static_cast<unsigned>(sw[idx]) >> shift) & MASK) - OFF;
        sc8[col * stride * 4 + k] = static_cast<int8_t>(code);
      }
      __syncthreads();
      int dot[TM][4];
      int xs[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        xs[i] = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) dot[i][j] = 0;
      }
      for (int kq = 0; kq < gq; ++kq) {
        int cv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) cv[j] = sc[(tx + 16 * j) * stride + kq];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          int xv = sx[(ty + 16 * i) * stride + kq];
          xs[i] = __dp4a(xv, 0x01010101, xs[i]);
#pragma unroll
          for (int j = 0; j < 4; ++j) dot[i][j] = __dp4a(xv, cv[j], dot[i][j]);
        }
      }
      const int grp = b * PLANES + p;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int n = n0 + tx + 16 * j;
        if (n >= r) continue;
        float s = to_f32(scales[static_cast<size_t>(grp) * r + n]);
        float zs = round_to(to_f32(zeros[static_cast<size_t>(grp) * r + n]) * s, T());
#pragma unroll
        for (int i = 0; i < TM; ++i)
          acc[i][j] += static_cast<float>(dot[i][j] + OFF * xs[i]) * s
                       - static_cast<float>(xs[i]) * zs;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int m = m0 + ty + 16 * i;
    if (m >= m_rows) continue;
    float xsc = x_scale[m];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int n = n0 + tx + 16 * j;
      if (n < r) store(out + static_cast<size_t>(m) * r + n, acc[i][j] * xsc);
    }
  }
}

// --------------------------------------------------------------- staging

using bf16 = __nv_bfloat16;

constexpr int STAGE_THREADS = 1024;
constexpr int STAGE_KEEP = 4;  // 4-column steps a thread keeps in registers between the passes
constexpr int STAGE_SMEM_MAX = 48 * 1024;  // group sums a row may hold (static limit)

// One block per row: x[row] gathered to stored column order (x[row][perm[col]],
// x[row][col] without act-order, 0 past C), quantized per row; writes
// xq[row] (c_pad int8, 4 columns a thread a step), x_scale[row] and, when
// xsum is given, the exact int32 sum of each group of g columns.  The
// first pass takes the row's max (exact, so its order does not matter) and
// keeps up to STAGE_KEEP steps of values in registers (every row of 16384
// columns or fewer: no second gather); the second quantizes each value as
// the plain version does, fp32 division rounded to nearest and rint (half
// to even).
template <typename TX>
__global__ void __launch_bounds__(STAGE_THREADS)
w4a8_stage_rows(const TX* __restrict__ x, const int64_t* __restrict__ perm, int perm_len, int c,
                int8_t* __restrict__ xq, float* __restrict__ x_scale,
                int32_t* __restrict__ xsum, int c_pad, int g) {
  extern __shared__ int32_t gsum[];  // (c_pad / g) group sums
  __shared__ float wmax[STAGE_THREADS / 32];
  const int row = blockIdx.x, lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n_groups = c_pad / g, n4 = c_pad / 4;
  const int steps = (n4 + STAGE_THREADS - 1) / STAGE_THREADS;
  const TX* xr = x + static_cast<size_t>(row) * c;
  // the four stored columns of step `it` (0 past C and past c_pad)
  auto load4 = [&](int it, float (&v)[4]) {
    const int col0 = 4 * (it * STAGE_THREADS + threadIdx.x);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + j;
      const int src = perm != nullptr ? (col < perm_len ? static_cast<int>(perm[col]) : -1)
                                      : (col < c ? col : -1);
      v[j] = src >= 0 ? to_f32(xr[src]) : 0.0f;
    }
  };
  float kept[STAGE_KEEP][4];
  float amax = 0.0f;
#pragma unroll
  for (int it = 0; it < STAGE_KEEP; ++it) {
    if (it < steps) {
      load4(it, kept[it]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) kept[it][j] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) amax = fmaxf(amax, fabsf(kept[it][j]));
  }
  for (int it = STAGE_KEEP; it < steps; ++it) {
    float v[4];
    load4(it, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) amax = fmaxf(amax, fabsf(v[j]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (lane == 0) wmax[warp] = amax;
  if (xsum != nullptr)
    for (int i = threadIdx.x; i < n_groups; i += STAGE_THREADS) gsum[i] = 0;
  __syncthreads();
  amax = wmax[0];
#pragma unroll
  for (int w = 1; w < STAGE_THREADS / 32; ++w) amax = fmaxf(amax, wmax[w]);
  const float scale = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);

  // lanes whose 4-column steps share a group: a power of two up to 32 when
  // g divides 128 or is a multiple of it (then one shuffle reduction and one
  // shared add per group and warp step), else 1 (one shared add per thread)
  const int seg = (128 % g == 0) ? g / 4 : (g % 128 == 0) ? 32 : 1;
  char4* dst = reinterpret_cast<char4*>(xq + static_cast<size_t>(row) * c_pad);
  auto quantize = [&](int it, const float (&v)[4]) {
    const int c4 = it * STAGE_THREADS + threadIdx.x;
    const bool in = c4 < n4;
    int q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      q[j] = static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(v[j], scale)), -127.0f), 127.0f));
    if (in)
      dst[c4] = make_char4(static_cast<signed char>(q[0]), static_cast<signed char>(q[1]),
                           static_cast<signed char>(q[2]), static_cast<signed char>(q[3]));
    if (xsum == nullptr) return;
    int s = q[0] + q[1] + q[2] + q[3];  // 0 past c_pad
    for (int off = 1; off < seg; off <<= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (in && lane % seg == 0) atomicAdd(&gsum[4 * c4 / g], s);
  };
#pragma unroll
  for (int it = 0; it < STAGE_KEEP; ++it)
    if (it < steps) quantize(it, kept[it]);
  for (int it = STAGE_KEEP; it < steps; ++it) {
    float v[4];
    load4(it, v);
    quantize(it, v);
  }
  __syncthreads();
  if (xsum != nullptr)
    for (int i = threadIdx.x; i < n_groups; i += STAGE_THREADS)
      xsum[static_cast<size_t>(row) * n_groups + i] = gsum[i];
  if (threadIdx.x == 0) x_scale[row] = scale;
}

// ------------------------------------------------------ tensor-core route

// d += A . B for one m16n8k32 tile, s8 inputs, s32 accumulators (exact)
__device__ __forceinline__ void mma_s8_k32(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                           uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// and for one m16n8k16 tile: A rows gid, gid + 8 at k = 4t .. 4t + 3
__device__ __forceinline__ void mma_s8_k16(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// One plane's codes in four words (four consecutive k of one column) as
// four int8 (the lowest k in the low byte, as mma's B fragments take it):
// the byte that holds the plane's field is gathered from each word, then
// shifted and masked; bits 8 codes are centred, code - 128 as int8 being
// the byte xor 0x80.  Bits 2 and 4 fields never straddle a byte.
template <int BITS>
__device__ __forceinline__ uint32_t codes_s8x4(uint32_t w0, uint32_t w1, uint32_t w2,
                                               uint32_t w3, int plane) {
  const unsigned bit = BITS * plane, byte = bit >> 3;
  const unsigned sel = byte | ((byte + 4) << 4);
  const uint32_t both = __byte_perm(__byte_perm(w0, w1, sel), __byte_perm(w2, w3, sel), 0x5410u);
  if constexpr (BITS == 8) return both ^ 0x80808080u;
  else return (both >> (bit & 7u)) & (((1u << BITS) - 1u) * 0x01010101u);
}

// The group-dot routine both int8 kernels go through.  For NP groups
// (planes plane0 .. plane0 + NP - 1 of one packing block) and a warp's TM
// m16 tiles x NT n8 tiles, d is each group's exact dot sum_k xq_k * (q_k -
// off): for each k32 chunk of the group in k order (then one k16 tail when
// g % 32 == 16), load(kc, tail, a, w) hands over the chunk's A fragments
// (xq, one set per group; in the tail only a[.][.][0..1] count) and, per n
// tile, the eight words of the thread's column at k = 4t + i and 16 + 4t +
// i (t = lane % 4, i = 0..3; in the tail only the first four count), and
// one mma adds the chunk to each tile; d starts from zero.
template <int BITS, int NP, int TM, int NT, typename Load>
__device__ __forceinline__ void group_dots_a8(int (&d)[NP][TM][NT][4], int g, int plane0,
                                              Load&& load) {
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int mt = 0; mt < TM; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[p][mt][nt][e] = 0;
  const int n_full = g / 32;
  for (int kc = 0; kc < n_full; ++kc) {
    uint32_t a[NP][TM][4], w[NT][8];
    load(kc, false, a, w);
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint32_t b0 = codes_s8x4<BITS>(w[nt][0], w[nt][1], w[nt][2], w[nt][3], plane0 + p);
        const uint32_t b1 = codes_s8x4<BITS>(w[nt][4], w[nt][5], w[nt][6], w[nt][7], plane0 + p);
#pragma unroll
        for (int mt = 0; mt < TM; ++mt) mma_s8_k32(d[p][mt][nt], a[p][mt], b0, b1);
      }
  }
  if (g % 32) {
    uint32_t a[NP][TM][4], w[NT][8];
    load(n_full, true, a, w);
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint32_t b0 = codes_s8x4<BITS>(w[nt][0], w[nt][1], w[nt][2], w[nt][3], plane0 + p);
#pragma unroll
        for (int mt = 0; mt < TM; ++mt) mma_s8_k16(d[p][mt][nt], a[p][mt][0], a[p][mt][1], b0);
      }
  }
}

// A group's term in one fixed rounded form, from its exact dot and row sum
// xs: (dot + off * xs) * s - xs * zs (the integer sum is below 2^24, so
// exact as a float)
template <int BITS>
__device__ __forceinline__ float group_term_a8(int dot, int xs, float s, float zs) {
  constexpr int OFF = BITS == 8 ? 128 : 0;
  return __fmaf_rn(static_cast<float>(dot + OFF * xs), s, -__fmul_rn(static_cast<float>(xs), zs));
}

// 8 consecutive scales (or zeros) as floats; entries at or past `valid`
// read 0; vec: one 16-byte load (bf16) or two (fp32)
__device__ __forceinline__ void load8(const float* p, int valid, bool vec, float (&v)[8]) {
  if (vec && valid >= 8) {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
    const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = i < valid ? __ldg(p + i) : 0.0f;
}
__device__ __forceinline__ void load8(const bf16* p, int valid, bool vec, float (&v)[8]) {
  if (vec && valid >= 8) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = __uint_as_float(i % 2 ? (w[i / 2] & 0xFFFF0000u) : (w[i / 2] << 16));
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = i < valid ? __bfloat162float(p[i]) : 0.0f;
}

// the scales and zs = z * s rounded to T, as JAX rounds it, of 8 columns
template <typename T>
__device__ __forceinline__ void scales_zs(const T* scales, const T* zeros, size_t at, int valid,
                                          bool vec, float (&s)[8], float (&zs)[8]) {
  load8(scales + at, valid, vec, s);
  load8(zeros + at, valid, vec, zs);
#pragma unroll
  for (int i = 0; i < 8; ++i) zs[i] = round_to(__fmul_rn(zs[i], s[i]), T());
}

// out[0 .. 7] = T(v * xsc), v[c8] the value of column c8; 16-byte stores
// when vec (and all 8 columns are in range), else up to `valid`
__device__ __forceinline__ void store8(float* dst, const float (&v)[8], float xsc, int valid,
                                       bool vec) {
  if (vec && valid >= 8) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(__fmul_rn(v[0], xsc), __fmul_rn(v[1], xsc),
                                                    __fmul_rn(v[2], xsc), __fmul_rn(v[3], xsc));
    reinterpret_cast<float4*>(dst)[1] = make_float4(__fmul_rn(v[4], xsc), __fmul_rn(v[5], xsc),
                                                    __fmul_rn(v[6], xsc), __fmul_rn(v[7], xsc));
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (i < valid) dst[i] = __fmul_rn(v[i], xsc);
}
__device__ __forceinline__ void store8(bf16* dst, const float (&v)[8], float xsc, int valid,
                                       bool vec) {
  if (vec && valid >= 8) {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 pair =
          __floats2bfloat162_rn(__fmul_rn(v[2 * i], xsc), __fmul_rn(v[2 * i + 1], xsc));
      u[i] = *reinterpret_cast<const uint32_t*>(&pair);
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(u[0], u[1], u[2], u[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (i < valid) dst[i] = __float2bfloat16_rn(__fmul_rn(v[i], xsc));
}

// Decode on the int8 tensor cores: K3's split (a cluster of up to 8
// blocks per 64-column tile, block rank q holding groups [q * 16 L, (q + 1)
// * 16 L), 16 at a time) with each group's term from group_dots_a8.  Warp w
// takes slots 2w and 2w + 1, two groups of one packing block (16 groups per
// layer, an even number of planes), for columns 0-31 and then 32-63 of the
// tile; a thread loads 16-byte words of four columns at its eight k
// positions of a chunk, the next chunk's while one is summed.  Terms are
// parked in shared memory, then rank q sums its share of the tile's
// outputs over all groups in group order, reading its peers' terms through
// distributed shared memory, and writes T(acc * x_scale).  flags: bit 0
// 16-byte word loads, bit 1 vector scale loads.
template <int BITS, int MR, typename T>
__global__ void __launch_bounds__(D_THREADS, MR >= 16 ? 1 : 2)
w4a8_decode_tc(const int8_t* __restrict__ xq, const float* __restrict__ x_scale,
               const int32_t* __restrict__ xsum, const int32_t* __restrict__ qw,
               const T* __restrict__ scales, const T* __restrict__ zeros, T* __restrict__ out,
               int m_rows, int c_pad, int r, int g, int layers, int flags) {
  constexpr int PLANES = 32 / BITS;
  extern __shared__ __align__(16) float terms[];  // (16 L, MR, 64)

  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gid = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * D_BN;
  const int n_groups = c_pad / g, per_block = D_SLOTS * layers, n_kc = (g + 31) / 32;
  const bool vec = flags & 1, vec_s = flags & 2;

  for (int layer = 0; layer < layers; ++layer) {
    const int s_idx = layer * D_SLOTS + 2 * warp;  // this warp's first slot
    const int grp = rank * per_block + s_idx;      // and its group; grp + 1 is the other
    if (grp >= n_groups) continue;                 // n_groups is a multiple of planes
    for (int h = 0; h < 2; ++h) {
      const int nq = n0 + 32 * h + 4 * gid;  // the thread's four word columns
      const int32_t* wrow = qw + static_cast<size_t>(grp / PLANES) * g * r + nq;
      auto load_words = [&](int kc, int4 (&v)[8]) {
        const bool tail = 32 * kc + 16 >= g;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          v[e] = make_int4(0, 0, 0, 0);
          if (e >= 4 && tail) continue;
          const int32_t* src = wrow + static_cast<size_t>(32 * kc + 4 * t + (e & 3) + 16 * (e >> 2)) * r;
          if (vec) {
            if (nq < r) v[e] = __ldg(reinterpret_cast<const int4*>(src));
          } else {
            if (nq < r) v[e].x = __ldg(src);
            if (nq + 1 < r) v[e].y = __ldg(src + 1);
            if (nq + 2 < r) v[e].z = __ldg(src + 2);
            if (nq + 3 < r) v[e].w = __ldg(src + 3);
          }
        }
      };
      auto load_x = [&](int kc, uint32_t (&a)[2][1][4]) {
        const bool tail = 32 * kc + 16 >= g;
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = gid + 8 * (e & 1);
            const int col = (grp + p) * g + 32 * kc + 4 * t + 16 * (e >> 1);
            a[p][0][e] = row < MR && row < m_rows && !(tail && e >= 2)
                             ? __ldg(reinterpret_cast<const unsigned*>(
                                   xq + static_cast<size_t>(row) * c_pad + col))
                             : 0u;
          }
      };
      int4 wn[8];
      uint32_t an[2][1][4];
      load_words(0, wn);
      load_x(0, an);
      int d[2][1][4][4];
      group_dots_a8<BITS, 2, 1, 4>(
          d, g, grp % PLANES, [&](int kc, bool, uint32_t (&a)[2][1][4], uint32_t (&w)[4][8]) {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              w[0][e] = static_cast<uint32_t>(wn[e].x);
              w[1][e] = static_cast<uint32_t>(wn[e].y);
              w[2][e] = static_cast<uint32_t>(wn[e].z);
              w[3][e] = static_cast<uint32_t>(wn[e].w);
            }
#pragma unroll
            for (int p = 0; p < 2; ++p)
#pragma unroll
              for (int e = 0; e < 4; ++e) a[p][0][e] = an[p][0][e];
            if (kc + 1 < n_kc) {
              load_words(kc + 1, wn);
              load_x(kc + 1, an);
            }
          });
      // the thread holds rows gid and gid + 8 at tile columns cb .. cb + 7:
      // d[.][0][nt][e] is row gid + 8 (e >> 1), column cb + nt + 4 (e & 1)
      const int cb = 32 * h + 8 * t;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        float s[8], zs[8];
        scales_zs(scales, zeros, static_cast<size_t>(grp + p) * r + n0 + cb, r - (n0 + cb), vec_s,
                  s, zs);
        float* dst = terms + (s_idx + p) * MR * D_BN + cb;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = gid + 8 * hr;
          if (row >= MR) continue;
          const int xs = row < m_rows ? __ldg(xsum + static_cast<size_t>(row) * n_groups + grp + p) : 0;
#pragma unroll
          for (int c8 = 0; c8 < 8; ++c8)
            dst[row * D_BN + c8] =
                group_term_a8<BITS>(d[p][0][c8 % 4][2 * hr + c8 / 4], xs, s[c8], zs[c8]);
        }
      }
    }
  }
  cluster_sum<MR>(terms, n_groups, per_block, [&](int i, int col, float acc) {
    if (i < m_rows && n0 + col < r)
      store(out + static_cast<size_t>(i) * r + n0 + col, __fmul_rn(acc, x_scale[i]));
  });
}

// A prefill block tile (PrefillWarps).  Words are staged (g, BN) with no
// skew: a 16-byte chunk j of word row k sits at chunk j ^ 2 ((k >> 2) & 3),
// so the eight lanes of a phase (gid 0-1, t 0-3, rows 4t + i) read eight
// distinct bank quads.  xq rows carry 16 bytes of skew (ldmatrix rows in
// distinct banks, and room for a k16 tail's x4 load).
template <int TM, int WN>
struct PrefillTile : PrefillWarps<TM, WN> {
  using Warps = PrefillWarps<TM, WN>;
  // shared memory: two word tiles and two xq tiles
  static constexpr int smem(int g) { return 2 * g * Warps::BN * 4 + 2 * Warps::BM * (g + 16); }
};

__device__ __forceinline__ int swizzle(int k) { return 2 * ((k >> 2) & 3); }

// Prefill on the int8 tensor cores: a block owns BM rows x BN columns (128 x
// 128 in 64 x 32 warp tiles above 64 rows; 64 x 64 in 16 x 32 ones up to
// 64).  The groups are walked in order; the words of a packing block (g x
// BN) are staged once, and the xq slice of each group (BM x g), by
// cp.async one group ahead into two buffers each.  Per group,
// group_dots_a8 forms the dots (A by ldmatrix; a thread's 16-byte word
// reads give four columns, so each B fragment is made once per chunk for TM
// m tiles) and acc += term, in group order, as the decode kernel's cluster
// sum.  flags as for decode, and bit 2 16-byte output stores.
template <int BITS, int TM, int WN, typename T>
__global__ void __launch_bounds__(P_THREADS, TM == 1 ? 2 : 1)
w4a8_prefill_tc(const int8_t* __restrict__ xq, const float* __restrict__ x_scale,
                const int32_t* __restrict__ xsum, const int32_t* __restrict__ qw,
                const T* __restrict__ scales, const T* __restrict__ zeros, T* __restrict__ out,
                int m_rows, int c_pad, int r, int g, int flags) {
  constexpr int PLANES = 32 / BITS, NT = 4;
  using Tile = PrefillTile<TM, WN>;
  constexpr int P_BM = Tile::BM, P_BN = Tile::BN, CH = P_BN / 4;  // 16-byte chunks a word row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int32_t* sw = reinterpret_cast<int32_t*>(smem_raw);  // 2 x (g, P_BN) words
  int8_t* sx = reinterpret_cast<int8_t*>(sw + 2 * g * P_BN);  // 2 x (P_BM, g + 16) xq
  const int xstride = g + 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gid = lane / 4, t = lane % 4;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.x * P_BM, n0 = blockIdx.y * P_BN;
  const int n_groups = c_pad / g;
  const bool vec = flags & 1, vec_s = flags & 2, vec_o = flags & 4;

  auto stage_words = [&](int b, int buf) {
    int32_t* dst = sw + buf * g * P_BN;
    const int32_t* src = qw + static_cast<size_t>(b) * g * r + n0;
    if (vec) {
      for (int i = threadIdx.x; i < g * CH; i += P_THREADS) {
        const int k = i / CH, j = i % CH;
        const bool in = n0 + 4 * j < r;
        cp_async16(dst + k * P_BN + 4 * (j ^ swizzle(k)),
                   in ? src + static_cast<size_t>(k) * r + 4 * j : qw, in);
      }
    } else {
      for (int i = threadIdx.x; i < g * P_BN; i += P_THREADS) {
        const int k = i / P_BN, q = i % P_BN;
        const bool in = n0 + q < r;
        cp_async4(dst + k * P_BN + 4 * ((q / 4) ^ swizzle(k)) + q % 4,
                  in ? src + static_cast<size_t>(k) * r + q : qw, in);
      }
    }
  };
  auto stage_x = [&](int grp, int buf) {
    int8_t* dst = sx + buf * P_BM * xstride;
    const int chunks = g / 16;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < P_BM * chunks; i += P_THREADS) {
      const int row = i / chunks, q = 16 * (i % chunks);
      const bool in = m0 + row < m_rows;
      cp_async16(dst + row * xstride + q,
                 in ? xq + static_cast<size_t>(m0 + row) * c_pad + grp * g + q : xq, in);
    }
  };

  float acc[TM][NT][4];
#pragma unroll
  for (int mt = 0; mt < TM; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  const int cb = n0 + 32 * wn + 8 * t;  // the thread's 8 output columns
  const int rb = m0 + 16 * TM * wm + gid;  // and its first row; rows rb + 8 j
  stage_words(0, 0);
  stage_x(0, 0);
  cp_async_commit();
  for (int grp = 0; grp < n_groups; ++grp) {
    const int b = grp / PLANES;
    if (grp + 1 < n_groups) {
      if ((grp + 1) % PLANES == 0) stage_words(b + 1, (b + 1) & 1);
      stage_x(grp + 1, (grp + 1) & 1);
    }
    cp_async_commit();
    // the term's operands are on their way while the chain runs
    float s[8], zs[8];
    scales_zs(scales, zeros, static_cast<size_t>(grp) * r + cb, r - cb, vec_s, s, zs);
    int xs[TM][2];
#pragma unroll
    for (int mt = 0; mt < TM; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = rb + 16 * mt + 8 * hr;
        xs[mt][hr] = row < m_rows ? __ldg(xsum + static_cast<size_t>(row) * n_groups + grp) : 0;
      }
    cp_async_wait<1>();  // this group's tiles have landed
    __syncthreads();
    // the thread's word chunk (columns 32 wn + 4 gid ..) in every word row
    // it reads (k = 4t + i, 16 + 4t + i: swizzle(k) = 2t)
    const int32_t* wsrc = sw + (b & 1) * g * P_BN + 4 * ((8 * wn + gid) ^ (2 * t));
    const int8_t* xsrc =
        sx + (grp & 1) * P_BM * xstride + (16 * TM * wm + lane % 16) * xstride + 16 * (lane / 16);
    int d[1][TM][NT][4];
    group_dots_a8<BITS, 1, TM, NT>(
        d, g, grp % PLANES,
        [&](int kc, bool tail, uint32_t (&a)[1][TM][4], uint32_t (&w)[NT][8]) {
#pragma unroll
          for (int mt = 0; mt < TM; ++mt)
            ldmatrix_x4(a[0][mt], xsrc + 16 * mt * xstride + 32 * kc);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            int4 v = make_int4(0, 0, 0, 0);
            if (!(tail && e >= 4)) {
              const int k = 32 * kc + 4 * t + (e & 3) + 16 * (e >> 2);
              v = *reinterpret_cast<const int4*>(wsrc + k * P_BN);
            }
            w[0][e] = static_cast<uint32_t>(v.x);
            w[1][e] = static_cast<uint32_t>(v.y);
            w[2][e] = static_cast<uint32_t>(v.z);
            w[3][e] = static_cast<uint32_t>(v.w);
          }
        });
    // d[0][mt][nt][e]: row rb + 16 mt + 8 (e >> 1), column cb + nt + 4 (e & 1)
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8)
#pragma unroll
      for (int mt = 0; mt < TM; ++mt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float& a = acc[mt][c8 % 4][2 * hr + c8 / 4];
          a = __fadd_rn(a, group_term_a8<BITS>(d[0][mt][c8 % 4][2 * hr + c8 / 4], xs[mt][hr],
                                               s[c8], zs[c8]));
        }
    __syncthreads();  // the buffers read here are the next prefetch's targets
  }
#pragma unroll
  for (int mt = 0; mt < TM; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = rb + 16 * mt + 8 * hr;
      if (row >= m_rows) continue;
      float v[8];
#pragma unroll
      for (int c8 = 0; c8 < 8; ++c8) v[c8] = acc[mt][c8 % 4][2 * hr + c8 / 4];
      store8(out + static_cast<size_t>(row) * r + cb, v, x_scale[row], r - cb, vec_o);
    }
}

template <int BITS, int BM, typename T>
int launch(const int8_t* xq, const float* xs, const int32_t* qw, const void* s, const void* z,
           void* out, int m, int c_pad, int r, int g, cudaStream_t stream) {
  const int stride = g / 4 + 1;
  const int smem = (g * BN + (BN + BM) * stride) * static_cast<int>(sizeof(int32_t));
  static int smem_set[MAX_DEVICES] = {};
  return launch_kernel(w4a8_kernel<BITS, BM, T>, dim3((r + BN - 1) / BN, (m + BM - 1) / BM),
                       THREADS, smem, smem_set, stream, xq, xs, qw, static_cast<const T*>(s),
                       static_cast<const T*>(z), static_cast<T*>(out), m, c_pad, r, g);
}

template <typename T>
int dispatch(const int8_t* xq, const float* xs, const int32_t* qw, const void* s,
             const void* z, void* out, int m, int c_pad, int r, int g, int bits,
             cudaStream_t stream) {
  const bool small = m <= 16;
  switch (bits) {
    case 2: return small ? launch<2, 16, T>(xq, xs, qw, s, z, out, m, c_pad, r, g, stream)
                         : launch<2, 64, T>(xq, xs, qw, s, z, out, m, c_pad, r, g, stream);
    case 4: return small ? launch<4, 16, T>(xq, xs, qw, s, z, out, m, c_pad, r, g, stream)
                         : launch<4, 64, T>(xq, xs, qw, s, z, out, m, c_pad, r, g, stream);
    case 8: return small ? launch<8, 16, T>(xq, xs, qw, s, z, out, m, c_pad, r, g, stream)
                         : launch<8, 64, T>(xq, xs, qw, s, z, out, m, c_pad, r, g, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int BITS, int MR, typename T>
int launch_decode_tc(const int8_t* xq, const float* x_scale, const int32_t* xsum,
                     const int32_t* qw, const T* s, const T* z, T* out, int m, int c_pad, int r,
                     int g, int flags, cudaStream_t stream) {
  const DecodeSplit split = decode_split(c_pad / g);
  const int smem = D_SLOTS * split.layers * MR * D_BN * static_cast<int>(sizeof(float));
  if (smem > D_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  static int smem_set[MAX_DEVICES] = {};
  return launch_cluster(w4a8_decode_tc<BITS, MR, T>, (r + D_BN - 1) / D_BN, split.size, smem,
                        smem_set, stream, xq, x_scale, xsum, qw, s, z, out, m, c_pad, r, g,
                        split.layers, flags);
}

template <int BITS, int TM, int WN, typename T>
int launch_prefill_tc(const int8_t* xq, const float* x_scale, const int32_t* xsum,
                      const int32_t* qw, const T* s, const T* z, T* out, int m, int c_pad, int r,
                      int g, int flags, cudaStream_t stream) {
  using Tile = PrefillTile<TM, WN>;
  static int smem_set[MAX_DEVICES] = {};
  // row tiles vary fastest: the blocks in flight share a column tile's words in L2
  return launch_kernel(w4a8_prefill_tc<BITS, TM, WN, T>,
                       dim3((m + Tile::BM - 1) / Tile::BM, (r + Tile::BN - 1) / Tile::BN),
                       P_THREADS, Tile::smem(g), smem_set, stream, xq, x_scale, xsum, qw, s, z,
                       out, m, c_pad, r, g, flags);
}

template <int BITS, typename T>
int dispatch_tc(const int8_t* xq, const float* x_scale, const int32_t* xsum, const int32_t* qw,
                const T* s, const T* z, T* out, int m, int c_pad, int r, int g, int flags,
                cudaStream_t stream) {
  return dispatch_rows(
      m,
      [&](auto mr) {
        return launch_decode_tc<BITS, decltype(mr)::value, T>(xq, x_scale, xsum, qw, s, z, out, m,
                                                              c_pad, r, g, flags, stream);
      },
      [&](auto tm, auto wn) {
        return launch_prefill_tc<BITS, decltype(tm)::value, decltype(wn)::value, T>(
            xq, x_scale, xsum, qw, s, z, out, m, c_pad, r, g, flags, stream);
      });
}

template <typename T>
int matmul_tc(const int8_t* xq, const float* x_scale, const int32_t* xsum, const int32_t* qw,
              const void* s, const void* z, void* out, int m, int c_pad, int r, int g, int bits,
              cudaStream_t stream) {
  // 16-byte words (r % 4 == 0), scales and output stores (8 columns of T)
  const int per16 = 16 / static_cast<int>(sizeof(T));
  const int flags = (r % 4 == 0 && aligned16(qw) ? 1 : 0) |
                    (r % per16 == 0 && aligned16(s) && aligned16(z) ? 2 : 0) |
                    (r % per16 == 0 && aligned16(out) ? 4 : 0);
  const T* st = static_cast<const T*>(s);
  const T* zt = static_cast<const T*>(z);
  T* ot = static_cast<T*>(out);
  switch (bits) {
    case 2: return dispatch_tc<2, T>(xq, x_scale, xsum, qw, st, zt, ot, m, c_pad, r, g, flags, stream);
    case 4: return dispatch_tc<4, T>(xq, x_scale, xsum, qw, st, zt, ot, m, c_pad, r, g, flags, stream);
    default: return dispatch_tc<8, T>(xq, x_scale, xsum, qw, st, zt, ot, m, c_pad, r, g, flags, stream);
  }
}

bool tc_shape_ok(int m, int c_pad, int r, int g, int bits) {
  return m > 0 && r > 0 && g > 0 && g % 16 == 0 && g <= TC_MAX_G &&
         (bits == 2 || bits == 4 || bits == 8) && c_pad % ((32 / bits) * g) == 0;
}

int stage(const void* x, const int64_t* perm, int perm_len, int c, int8_t* xq, float* x_scale,
          int32_t* xsum, int m, int c_pad, int g, int xdtype, cudaStream_t stream) {
  if (m <= 0 || c <= 0 || g <= 0 || g % 4 != 0 || c_pad % g != 0 || c_pad < c ||
      (perm != nullptr && perm_len > c_pad) || reinterpret_cast<uintptr_t>(xq) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = xsum != nullptr ? (c_pad / g) * static_cast<int>(sizeof(int32_t)) : 0;
  if (smem > STAGE_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (xdtype == 0)
    w4a8_stage_rows<float><<<m, STAGE_THREADS, smem, stream>>>(
        static_cast<const float*>(x), perm, perm_len, c, xq, x_scale, xsum, c_pad, g);
  else if (xdtype == 1)
    w4a8_stage_rows<bf16><<<m, STAGE_THREADS, smem, stream>>>(
        static_cast<const bf16*>(x), perm, perm_len, c, xq, x_scale, xsum, c_pad, g);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// CUDA-core route on prepared rows (w4a8_kernel).  xq (m, c_pad) int8 in
// stored (act-order) column order, zero-padded; x_scale (m) fp32; qweight
// (c_pad * bits / 32, r) int32; scales/zeros (c_pad / g, r); out (m, r).
// scales, zeros and out share one dtype: 0 = fp32, 1 = bf16.  g must be a
// multiple of 4.
int w4a8_matmul(const int8_t* xq, const float* x_scale, const int32_t* qw, const void* s,
                const void* z, void* out, int m, int c_pad, int r, int g, int bits,
                int dtype, cudaStream_t stream) {
  if (m <= 0 || r <= 0 || g <= 0 || g % 4 != 0 || bits <= 0 ||
      c_pad % ((32 / bits) * g) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch<float>(xq, x_scale, qw, s, z, out, m, c_pad, r, g, bits, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(xq, x_scale, qw, s, z, out, m, c_pad, r, g, bits, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The staging kernel alone.  x (m, c) in original column order, fp32
// (xdtype 0) or bf16 (1); perm (perm_len,) int64 maps stored column ->
// original column, or null (no act-order); stored columns past perm_len
// (or past c) read zero.  Writes xq (m, c_pad) int8, x_scale (m) fp32 and,
// unless xsum is null, xsum (m, c_pad / g) int32.
int w4a8_stage(const void* x, const int64_t* perm, int perm_len, int c, int8_t* xq,
               float* x_scale, int32_t* xsum, int m, int c_pad, int g, int xdtype,
               cudaStream_t stream) {
  return stage(x, perm, perm_len, c, xq, x_scale, xsum, m, c_pad, g, xdtype, stream);
}

// The whole W4A8 linear: w4a8_stage into the workspaces xq, x_scale, xsum,
// then the tensor-core route (tc != 0) or the CUDA-core kernel (tc == 0;
// xsum may be null).  Arguments as for w4a8_stage and w4a8_matmul.
int w4a8_linear(const void* x, const int64_t* perm, int perm_len, int c, int8_t* xq,
                float* x_scale, int32_t* xsum, const int32_t* qw, const void* s, const void* z,
                void* out, int m, int c_pad, int r, int g, int bits, int xdtype, int dtype,
                int tc, cudaStream_t stream) {
  if (tc && (!tc_shape_ok(m, c_pad, r, g, bits) || xsum == nullptr || dtype < 0 || dtype > 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = stage(x, perm, perm_len, c, xq, x_scale, tc ? xsum : nullptr, m, c_pad, g,
                        xdtype, stream);
  if (err != 0) return err;
  if (!tc) return w4a8_matmul(xq, x_scale, qw, s, z, out, m, c_pad, r, g, bits, dtype, stream);
  if (dtype == 0) return matmul_tc<float>(xq, x_scale, xsum, qw, s, z, out, m, c_pad, r, g, bits, stream);
  return matmul_tc<bf16>(xq, x_scale, xsum, qw, s, z, out, m, c_pad, r, g, bits, stream);
}

const char* gptq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
