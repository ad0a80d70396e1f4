// K3: fused dequant + matmul over plane-per-group packed low-bit weights.
//
// Replaces gptq_v2_tpu/ops/w4a16.py::_kernel (grid _w4a16_2d, entry
// w4a16_matmul).  Plain PyTorch version: ops/w4a16.py::w4a16_reference.
//
// Layout (ops/packing.py): qweight is (C_pad / planes, R) int32 with
// planes = 32 / bits; within a packing block of planes * g stored columns,
// bit-plane i of the block's g words is exactly quantization group i.  So
// word row (b, k) holds position k of each of the block's planes groups.
// As in JAX, zs = z * s is rounded to the scales' type before use, every
// sum is fp32, and the output is written in the activation type.
//
// Bound on the H100: bytes at decode (each packed word is read once:
// C * R * bits / 8 bytes, ~8 MB for a 4096 x 4096 linear at 4 bits, 2.5 us
// at 3.35 TB/s), operations at prefill (2 * M * C * R: 34 GFLOP for the same
// linear at M = 1024, 35 us at 989 TFLOP/s in bf16).
//
// Two routes, chosen by the weights' dtype, bits and g, never by M:
//
// Tensor-core route: bf16, bits 1 / 2 / 4 / 8, g % 16 == 0 and g <= 128
// (entry w4a16_tc).  As the JAX kernel, a group's dot takes the codes in
// the activation type (bf16, exact for every code 0..255) with fp32
// accumulation.  One small kernel (w4a16_stage_rows) writes x's rows in
// stored (act-order) column order, zero-padded, in bf16, and each (row,
// group)'s sum xs in fp32, summed k = 0 .. g-1 in order.  Then one device
// routine, group_dots, forms every group's dot in both kernels: a chain of
// mma.sync.m16n8k16 (bf16 x bf16 -> fp32) over the group's k16 chunks in
// k order from zero, B fragments made from four words per chunk and column
// (which hold that chunk for all the block's groups; the weights are used
// as packed, never repacked).  A group's term is group_term(dot, s, xs, zs)
// = dot * s - xs * zs, and the terms are summed in group order from zero.
// An mma's output element depends only on its row of A and its column of
// B, so a row gets the same bits at every M, tile and lane by
// construction: the decode kernel's rows equal the prefill kernel's.  Keep
// it so: both kernels must go through group_dots.  A later move to wgmma,
// whose accumulation order need not match mma.sync's, must move both.
//
// * Decode (M <= 16, w4a16_decode_tc): the grid must fill 132 SMs although
//   M is tiny, so the contraction is split over groups as in the CUDA-core
//   decode kernel below: a cluster of up to 8 blocks owns a 64-column tile,
//   a block holds 16 groups at a time, and a warp two groups of one packing
//   block (one m16 tile, rows past M zero) for 32 columns at a time.  Words
//   go straight from device memory to registers in 16-byte loads, the next
//   chunk's in flight while one is summed, no barrier in the k loop.  Terms
//   are parked in shared memory and summed in group order across the
//   cluster through distributed shared memory; no float atomics.
// * Prefill (M > 16, w4a16_prefill_tc): a block owns 128 rows x 128
//   columns, eight warps of 64 x 32.  Per packing block its (g, 128) words
//   are staged once in shared memory with cp.async, and per group the
//   (128, g) slice of x, both double-buffered one group ahead; A fragments
//   by ldmatrix, B fragments made once per chunk and used by four m tiles.
//   Terms are summed in group order in registers.
//
// CUDA-core route: fp32, and bf16 with g % 16 != 0 or g > 128 (entries
// w4a16_decode at M <= 16 and w4a16_matmul above; these kernels are
// unchanged).  Decode: a gather kernel writes xt (x in stored order,
// transposed, fp32), and a cluster of up to 8 blocks per 64-column tile
// splits the groups; a thread walks one group's g words for four columns
// (16-byte loads to registers, codes to floats without I2F: or-ed into the
// mantissa of 2^23, minus 2^23) and forms the prefill kernel's term in its
// order; terms are summed in group order through distributed shared
// memory.  Prefill: a block owns 64 rows x 64 columns and per group adds
// (x_i . q_i) * s - (sum x_i) * zs on fp32 CUDA cores.
//
// The decode split, its cluster sum in group order and the launch helpers
// are csrc/dequant_matmul.cuh's, shared with K8 (csrc/w4a8.cu).
//
// Measured times against the bound and the library: PERF.md, kernel table.

#include "dequant_matmul.cuh"

namespace {

// A code (below 2^23) as a float without an int -> float convert: or-ed
// into the mantissa of 2^23, minus 2^23.  Exact: the same float as
// static_cast<float>(code).  One LOP3 (with the mask) and one FADD.
__device__ __forceinline__ float code_to_f32(unsigned code) {
  return __int_as_float(static_cast<int>(0x4B000000u | code)) - 8388608.0f;
}

// ---------------------------------------------------------------- decode

constexpr int D_QUADS = D_BN / 4;  // 4-column quads across a column tile
static_assert(D_QUADS * D_SLOTS == D_THREADS, "a thread per (quad, slot)");

// words a thread keeps in flight (16 bytes each), within the register budget
__host__ __device__ constexpr int decode_words_in_flight(int mr) { return mr <= 1 ? 8 : 4; }

// xt (C_pad, MR) fp32 = x's rows in stored column order, transposed:
// xt[col][i] = x[i][perm[col]] (x[i][col] without act-order), zero past C
// and for rows i >= m.  One thread per stored column.  A decode block then
// copies its groups' run of xt to shared memory with coalesced 16-byte
// loads (or, where that does not fit, reads xt directly).
template <int MR, typename T>
__global__ void __launch_bounds__(256)
w4a16_gather_rows(const T* __restrict__ x, const int64_t* __restrict__ perm, int perm_len,
                  int c, float* __restrict__ xt, int m_rows, int c_pad) {
  const int col = blockIdx.x * 256 + threadIdx.x;
  if (col >= c_pad) return;
  const int src = perm != nullptr ? (col < perm_len ? static_cast<int>(perm[col]) : -1)
                                  : (col < c ? col : -1);
  float v[MR];
#pragma unroll
  for (int i = 0; i < MR; ++i)
    v[i] = (src >= 0 && i < m_rows) ? to_f32(x[static_cast<size_t>(i) * c + src]) : 0.0f;
  float* dst = xt + static_cast<size_t>(col) * MR;
  if constexpr (MR % 4 == 0) {
#pragma unroll
    for (int i = 0; i < MR; i += 4)
      *reinterpret_cast<float4*>(dst + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < MR; ++i) dst[i] = v[i];
  }
}

// The split is over quantization groups.  A cluster of `size` blocks owns
// a column tile; block rank q holds groups [q * 16 L, (q + 1) * 16 L), 16
// at a time.  A thread (quad, slot) walks one group's g positions for its
// four columns: the two half-warps hold two planes of one packing block,
// so both read the same 16-byte words.  Per group it
// forms the prefill kernel's term, in the prefill kernel's operation order
// (part and xs summed over k = 0 .. g-1 from 0, then part * s - xs * zs),
// and parks it in shared memory.  Rank q then sums its share of the
// tile's outputs over all groups in group order, reading its peers'
// terms through distributed shared memory: the prefill kernel's sequential
// acc += term, so both paths give the same bits for a row.
template <int BITS, int MR, typename T>
__global__ void __launch_bounds__(D_THREADS, MR >= 16 ? 1 : 2)
w4a16_decode_kernel(const float* __restrict__ xt, const int32_t* __restrict__ qw,
                    const T* __restrict__ scales, const T* __restrict__ zeros,
                    T* __restrict__ out, int m_rows, int c_pad, int r, int g, int layers,
                    int vec, int x_in_smem) {
  constexpr int PLANES = 32 / BITS;
  constexpr unsigned MASK = (1u << BITS) - 1u;
  constexpr int PF = decode_words_in_flight(MR);
  extern __shared__ __align__(16) float terms[];  // (16 L, MR, 64), then x
  float* xstage = terms + D_SLOTS * layers * MR * D_BN;  // (16, g, MR) when x_in_smem

  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int lane = threadIdx.x % 32, quad = lane % D_QUADS;
  const int slot = (threadIdx.x / 32) * 2 + lane / D_QUADS;
  const int n0 = blockIdx.x * D_BN, n = n0 + 4 * quad;
  const int n_groups = c_pad / g, per_block = D_SLOTS * layers;

  auto load_word = [&](const int32_t* wrow, int k) {
    int4 w = make_int4(0, 0, 0, 0);
    if (k >= g) return w;
    const int32_t* src = wrow + static_cast<size_t>(k) * r;
    if (vec) {
      if (n < r) w = __ldg(reinterpret_cast<const int4*>(src));
    } else {
      if (n < r) w.x = __ldg(src);
      if (n + 1 < r) w.y = __ldg(src + 1);
      if (n + 2 < r) w.z = __ldg(src + 2);
      if (n + 3 < r) w.w = __ldg(src + 3);
    }
    return w;
  };

  for (int layer = 0; layer < layers; ++layer) {
    const int s_idx = layer * D_SLOTS + slot;
    const int grp0 = rank * per_block + layer * D_SLOTS;  // the layer's first group
    const int grp = grp0 + slot;
    const int32_t* wrow = qw + static_cast<size_t>(grp / PLANES) * g * r + n;
    // the first words are in flight while the block stages the layer's x
    int4 next[PF];
#pragma unroll
    for (int u = 0; u < PF; ++u)
      next[u] = grp < n_groups ? load_word(wrow, u) : make_int4(0, 0, 0, 0);
    const float* xsrc = xt + static_cast<size_t>(grp) * g * MR;
    if (x_in_smem) {
      // the layer's 16 groups are one contiguous run of xt
      const int n_cols = (min(grp0 + D_SLOTS, n_groups) - grp0) * g * MR;
      const float* from = xt + static_cast<size_t>(grp0) * g * MR;
      if (layer > 0) __syncthreads();
      for (int e = 4 * threadIdx.x; e + 3 < n_cols; e += 4 * D_THREADS)
        *reinterpret_cast<float4*>(xstage + e) = __ldg(reinterpret_cast<const float4*>(from + e));
      for (int e = n_cols / 4 * 4 + threadIdx.x; e < n_cols; e += D_THREADS)
        xstage[e] = __ldg(from + e);
      __syncthreads();
      xsrc = xstage + slot * g * MR;
    }
    float part[MR][4], xs[MR];
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      xs[i] = 0.0f;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) part[i][cc] = 0.0f;
    }
    if (grp < n_groups) {
      const int shift = BITS * (grp % PLANES);
      for (int k0 = 0; k0 < g; k0 += PF) {
        int4 cur[PF];
#pragma unroll
        for (int u = 0; u < PF; ++u) cur[u] = next[u];
#pragma unroll
        for (int u = 0; u < PF; ++u) next[u] = load_word(wrow, k0 + PF + u);
#pragma unroll
        for (int u = 0; u < PF; ++u) {
          const int k = k0 + u;
          if (k >= g) break;
          const unsigned wd[4] = {static_cast<unsigned>(cur[u].x), static_cast<unsigned>(cur[u].y),
                                  static_cast<unsigned>(cur[u].z), static_cast<unsigned>(cur[u].w)};
          float code[4];
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) code[cc] = code_to_f32((wd[cc] >> shift) & MASK);
          float xv[MR];
          if constexpr (MR % 4 == 0) {
#pragma unroll
            for (int i = 0; i < MR; i += 4) {
              const float4 x4 = *reinterpret_cast<const float4*>(xsrc + k * MR + i);
              xv[i] = x4.x;
              xv[i + 1] = x4.y;
              xv[i + 2] = x4.z;
              xv[i + 3] = x4.w;
            }
          } else {
#pragma unroll
            for (int i = 0; i < MR; ++i) xv[i] = xsrc[k * MR + i];
          }
#pragma unroll
          for (int i = 0; i < MR; ++i) {
            xs[i] += xv[i];
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) part[i][cc] = fmaf(xv[i], code[cc], part[i][cc]);
          }
        }
      }
    }
    float* dst = terms + s_idx * MR * D_BN + 4 * quad;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float s = 0.0f, zs = 0.0f;
      if (grp < n_groups && n + cc < r) {
        const size_t at = static_cast<size_t>(grp) * r + n + cc;
        s = to_f32(scales[at]);
        zs = round_to(to_f32(zeros[at]) * s, T());
      }
#pragma unroll
      for (int i = 0; i < MR; ++i) dst[i * D_BN + cc] = part[i][cc] * s - xs[i] * zs;
    }
  }
  cluster_sum<MR>(terms, n_groups, per_block, [&](int i, int col, float acc) {
    if (i < m_rows && n0 + col < r) store(out + static_cast<size_t>(i) * r + n0 + col, acc);
  });
}

// --------------------------------------------------------------- prefill

constexpr int BN = 64;
constexpr int THREADS = 256;

template <int BITS, int BM, typename T>
__global__ void __launch_bounds__(THREADS)
w4a16_kernel(const T* __restrict__ x, const int32_t* __restrict__ qw,
             const T* __restrict__ scales, const T* __restrict__ zeros,
             T* __restrict__ out, int m_rows, int c_pad, int r, int g) {
  constexpr int PLANES = 32 / BITS;
  constexpr unsigned MASK = (1u << BITS) - 1u;
  constexpr int TM = BM / 16;
  extern __shared__ float smem[];
  int32_t* sw = reinterpret_cast<int32_t*>(smem);  // (g, BN) words
  float* sx = smem + g * BN;                       // (BM, g) activations

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int n_blocks = c_pad / (PLANES * g);

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
      if (p > 0) __syncthreads();
      const int c0 = (b * PLANES + p) * g;
      for (int idx = threadIdx.x; idx < BM * g; idx += THREADS) {
        int mi = idx / g, k = idx % g;
        sx[idx] = (m0 + mi < m_rows) ? to_f32(x[static_cast<size_t>(m0 + mi) * c_pad + c0 + k])
                                     : 0.0f;
      }
      __syncthreads();
      float part[TM][4];
      float xs[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        xs[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = 0.0f;
      }
      const int shift = BITS * p;
      for (int k = 0; k < g; ++k) {
        float code[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          code[j] = static_cast<float>((static_cast<unsigned>(sw[k * BN + tx + 16 * j]) >> shift) & MASK);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          float xv = sx[(ty + 16 * i) * g + k];
          xs[i] += xv;
#pragma unroll
          for (int j = 0; j < 4; ++j) part[i][j] = fmaf(xv, code[j], part[i][j]);
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
        for (int i = 0; i < TM; ++i) acc[i][j] += part[i][j] * s - xs[i] * zs;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int m = m0 + ty + 16 * i;
    if (m >= m_rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int n = n0 + tx + 16 * j;
      if (n < r) store(out + static_cast<size_t>(m) * r + n, acc[i][j]);
    }
  }
}

// ------------------------------------------------------ tensor-core route

using bf16 = __nv_bfloat16;

constexpr int STAGE_COLS = 1024;  // stored columns per block of w4a16_stage_rows

// d += A . B for one m16n8k16 tile, bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One plane's codes in the words of two k positions, as the bf16 pair
// {code(lo), code(hi)} (the lower k in the low half, as mma's fragments
// take it).  Exact: every code 0..255 is a bf16 integer.  At 1, 2 and 4 bits
// a byte permute puts the plane's half of both words side by side, and the
// codes are or-ed into the mantissa of 128.0 (0x4300), minus 128 in bf16x2;
// 8-bit codes do not fit that mantissa and go through fp32.  No I2F.
template <int BITS>
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t lo, uint32_t hi, int plane) {
  __nv_bfloat162 v;
  if constexpr (BITS == 8) {
    v = __floats2bfloat162_rn(code_to_f32((lo >> (8 * plane)) & 0xFFu),
                              code_to_f32((hi >> (8 * plane)) & 0xFFu));
  } else {
    constexpr int HALF = 16 / BITS;  // planes in each 16-bit half of a word
    const uint32_t both =
        __byte_perm(lo, hi, plane < HALF ? 0x5410u : 0x7632u) >> (BITS * (plane % HALF));
    const uint32_t biased = (both & (((1u << BITS) - 1u) * 0x00010001u)) | 0x43004300u;
    v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased), __float2bfloat162_rn(128.0f));
  }
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The group-term routine both bf16 kernels go through.  For NP groups
// (planes plane0 .. plane0 + NP - 1 of one packing block) and a warp's TM
// m16 tiles x NT n8 tiles, d is each group's dot x_i . q_i: for each k16
// chunk of the group in k order, load(kc, a, w) hands over the chunk's A
// fragments (bf16 x, one set per group) and, per n tile, the four words of
// the thread's column at k = 2t, 2t + 1, 2t + 8, 2t + 9 (t = lane % 4),
// and one mma adds the chunk to each tile; d starts from zero.  Nothing
// else enters an element's sum, so it does not depend on M, on the tile or
// on the lane.  group_term then forms dot * s - xs * zs.
template <int BITS, int NP, int TM, int NT, typename Load>
__device__ __forceinline__ void group_dots(float (&d)[NP][TM][NT][4], int g, int plane0,
                                           Load&& load) {
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int mt = 0; mt < TM; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[p][mt][nt][e] = 0.0f;
  for (int kc = 0; kc < g / 16; ++kc) {
    uint32_t a[NP][TM][4], w[NT][4];
    load(kc, a, w);
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint32_t b0 = codes_bf16x2<BITS>(w[nt][0], w[nt][1], plane0 + p);
        const uint32_t b1 = codes_bf16x2<BITS>(w[nt][2], w[nt][3], plane0 + p);
#pragma unroll
        for (int mt = 0; mt < TM; ++mt) mma_bf16(d[p][mt][nt], a[p][mt], b0, b1);
      }
  }
}

__device__ __forceinline__ float group_term(float dot, float s, float xs, float zs) {
  return __fmaf_rn(dot, s, -__fmul_rn(xs, zs));
}

// 8 bf16 from p (entries at or past `valid` read 0), packed as loaded
__device__ __forceinline__ uint4 load8_bf16(const bf16* p, int valid, bool vec) {
  if (vec && valid >= 8) return __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
  uint32_t v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = 2 * i < valid ? __ldg(h + 2 * i) : 0u;
    const uint32_t hi = 2 * i + 1 < valid ? __ldg(h + 2 * i + 1) : 0u;
    v[i] = lo | (hi << 16);
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// entry i of 8 packed bf16, as a float (exact)
__device__ __forceinline__ float bf16_at(const uint4& v, int i) {
  const uint32_t w = i < 2 ? v.x : i < 4 ? v.y : i < 6 ? v.z : v.w;
  return __uint_as_float(i % 2 ? (w & 0xFFFF0000u) : (w << 16));
}

// the scale of entry i and zs = z * s rounded to bf16, as JAX rounds it
__device__ __forceinline__ void scale_zs(const uint4& s8, const uint4& z8, int i, float& s,
                                         float& zs) {
  s = bf16_at(s8, i);
  zs = __bfloat162float(__float2bfloat16_rn(bf16_at(z8, i) * s));
}

// xg (m, c_pad) bf16 = x's rows in stored column order (x[i][perm[col]],
// x[i][col] without act-order), zero past C; xsum (m, c_pad / g) fp32 =
// each group's sum of those values, k = 0 .. g-1 in order.  Both bf16
// kernels read these, so a row's xs is the same at every M.  Block (row,
// run of STAGE_COLS / g groups).
__global__ void __launch_bounds__(256)
w4a16_stage_rows(const bf16* __restrict__ x, const int64_t* __restrict__ perm, int perm_len,
                 int c, bf16* __restrict__ xg, float* __restrict__ xsum, int c_pad, int g) {
  __shared__ float v[STAGE_COLS];
  const int row = blockIdx.x, gpb = STAGE_COLS / g, grp0 = blockIdx.y * gpb;
  const int n_groups = c_pad / g, n_here = min(gpb, n_groups - grp0);
  const bf16* xr = x + static_cast<size_t>(row) * c;
  bf16* dst = xg + static_cast<size_t>(row) * c_pad + grp0 * g;
  for (int i = threadIdx.x; i < n_here * g; i += 256) {
    const int col = grp0 * g + i;
    const int src = perm != nullptr ? (col < perm_len ? static_cast<int>(perm[col]) : -1)
                                    : (col < c ? col : -1);
    const bf16 val = src >= 0 ? xr[src] : __float2bfloat16_rn(0.0f);
    dst[i] = val;
    v[i] = __bfloat162float(val);
  }
  __syncthreads();
  if (threadIdx.x < n_here) {
    float sum = 0.0f;
    for (int k = 0; k < g; ++k) sum = __fadd_rn(sum, v[threadIdx.x * g + k]);
    xsum[static_cast<size_t>(row) * n_groups + grp0 + threadIdx.x] = sum;
  }
}

// Decode on the tensor cores: the CUDA-core decode kernel's split (a
// cluster of up to 8 blocks per 64-column tile, block rank q holding groups
// [q * 16 L, (q + 1) * 16 L), 16 at a time) with each group's term from
// group_dots.  Warp w takes slots 2w and 2w + 1, two groups of one packing
// block (16 groups per layer, an even number of planes), for columns 0-31
// and then 32-63 of the tile; a thread loads 16-byte words of four columns
// at its four k positions, the next chunk's while one is summed.  Terms
// are parked in shared memory, then rank q sums its share of the tile's
// outputs over all groups in group order, reading its peers' terms
// through distributed shared memory.  flags: bit 0 16-byte word loads, bit
// 1 16-byte scale loads.
template <int BITS, int MR>
__global__ void __launch_bounds__(D_THREADS, MR >= 16 ? 1 : 2)
w4a16_decode_tc(const bf16* __restrict__ xg, const float* __restrict__ xsum,
                const int32_t* __restrict__ qw, const bf16* __restrict__ scales,
                const bf16* __restrict__ zeros, bf16* __restrict__ out, int m_rows, int c_pad,
                int r, int g, int layers, int flags) {
  constexpr int PLANES = 32 / BITS;
  extern __shared__ __align__(16) float terms[];  // (16 L, MR, 64)

  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gid = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * D_BN;
  const int n_groups = c_pad / g, per_block = D_SLOTS * layers, n_kc = g / 16;
  const bool vec = flags & 1, vec_s = flags & 2;

  for (int layer = 0; layer < layers; ++layer) {
    const int s_idx = layer * D_SLOTS + 2 * warp;  // this warp's first slot
    const int grp = rank * per_block + s_idx;      // and its group; grp + 1 is the other
    if (grp >= n_groups) continue;                 // n_groups is a multiple of planes
    for (int h = 0; h < 2; ++h) {
      const int nq = n0 + 32 * h + 4 * gid;  // the thread's four word columns
      const int32_t* wrow = qw + static_cast<size_t>(grp / PLANES) * g * r + nq;
      auto load_words = [&](int kc, int4 (&v)[4]) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int32_t* src =
              wrow + static_cast<size_t>(16 * kc + 2 * t + (e & 1) + 8 * (e >> 1)) * r;
          v[e] = make_int4(0, 0, 0, 0);
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
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = gid + 8 * (e & 1);
            const int col = (grp + p) * g + 16 * kc + 2 * t + 8 * (e >> 1);
            a[p][0][e] = row < MR && row < m_rows ? __ldg(reinterpret_cast<const unsigned*>(
                                            xg + static_cast<size_t>(row) * c_pad + col))
                                      : 0u;
          }
      };
      int4 wn[4];
      uint32_t an[2][1][4];
      load_words(0, wn);
      load_x(0, an);
      float d[2][1][4][4];
      group_dots<BITS, 2, 1, 4>(
          d, g, grp % PLANES, [&](int kc, uint32_t (&a)[2][1][4], uint32_t (&w)[4][4]) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
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
        const size_t at = static_cast<size_t>(grp + p) * r + n0 + cb;
        const uint4 s8 = load8_bf16(scales + at, r - (n0 + cb), vec_s);
        const uint4 z8 = load8_bf16(zeros + at, r - (n0 + cb), vec_s);
        float* dst = terms + (s_idx + p) * MR * D_BN + cb;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = gid + 8 * hr;
          if (row >= MR) continue;
          const float xs =
              row < m_rows ? __ldg(xsum + static_cast<size_t>(row) * n_groups + grp + p) : 0.0f;
#pragma unroll
          for (int c8 = 0; c8 < 8; ++c8) {
            float s, zs;
            scale_zs(s8, z8, c8, s, zs);
            dst[row * D_BN + c8] = group_term(d[p][0][c8 % 4][2 * hr + c8 / 4], s, xs, zs);
          }
        }
      }
    }
  }
  cluster_sum<MR>(terms, n_groups, per_block, [&](int i, int col, float acc) {
    if (i < m_rows && n0 + col < r) store(out + static_cast<size_t>(i) * r + n0 + col, acc);
  });
}

// A prefill block tile (PrefillWarps) with its staged words' row stride
template <int TM, int WN>
struct PrefillTile : PrefillWarps<TM, WN> {
  using Warps = PrefillWarps<TM, WN>;
  static constexpr int WSTRIDE = Warps::BN + 4;  // staged words per k row: 16 bytes of skew per row
  // shared memory: two word tiles and two x tiles
  static constexpr int smem(int g) { return 2 * g * WSTRIDE * 4 + 2 * Warps::BM * (g + 8) * 2; }
};

// Prefill on the tensor cores: a block owns BM rows x BN columns (128 x 128
// in 64 x 32 warp tiles above 64 rows; 64 x 64 in 16 x 32 ones up to 64,
// twice the blocks).  The groups are walked in order; the words of a
// packing block (g x BN) are staged once, and the x slice of each group
// (BM x g), by cp.async one group ahead into two buffers each.  Per group,
// group_dots forms the dots (A by ldmatrix; a thread's 16-byte word loads
// give four columns, so B fragments are made once per chunk for TM m tiles)
// and acc += term, in group order, as the decode kernel's cluster sum.
// flags as for decode, and bit 2 16-byte output stores.
template <int BITS, int TM, int WN>
__global__ void __launch_bounds__(P_THREADS, TM == 1 ? 2 : 1)
w4a16_prefill_tc(const bf16* __restrict__ xg, const float* __restrict__ xsum,
                 const int32_t* __restrict__ qw, const bf16* __restrict__ scales,
                 const bf16* __restrict__ zeros, bf16* __restrict__ out, int m_rows, int c_pad,
                 int r, int g, int flags) {
  constexpr int PLANES = 32 / BITS, NT = 4;
  using Tile = PrefillTile<TM, WN>;
  constexpr int P_BM = Tile::BM, P_BN = Tile::BN, P_WSTRIDE = Tile::WSTRIDE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int32_t* sw = reinterpret_cast<int32_t*>(smem_raw);          // 2 x (g, P_WSTRIDE) words
  bf16* sx = reinterpret_cast<bf16*>(sw + 2 * g * P_WSTRIDE);  // 2 x (P_BM, g + 8) x
  const int xstride = g + 8;  // 16 bytes of skew per row: ldmatrix rows in distinct banks
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gid = lane / 4, t = lane % 4;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.x * P_BM, n0 = blockIdx.y * P_BN;
  const int n_groups = c_pad / g;
  const bool vec = flags & 1, vec_s = flags & 2, vec_o = flags & 4;

  auto stage_words = [&](int b, int buf) {
    int32_t* dst = sw + buf * g * P_WSTRIDE;
    const int32_t* src = qw + static_cast<size_t>(b) * g * r + n0;
    if (vec) {
      for (int i = threadIdx.x; i < g * (P_BN / 4); i += P_THREADS) {
        const int k = i / (P_BN / 4), q = 4 * (i % (P_BN / 4));
        const bool in = n0 + q < r;
        cp_async16(dst + k * P_WSTRIDE + q, in ? src + static_cast<size_t>(k) * r + q : qw, in);
      }
    } else {
      for (int i = threadIdx.x; i < g * P_BN; i += P_THREADS) {
        const int k = i / P_BN, q = i % P_BN;
        const bool in = n0 + q < r;
        cp_async4(dst + k * P_WSTRIDE + q, in ? src + static_cast<size_t>(k) * r + q : qw, in);
      }
    }
  };
  auto stage_x = [&](int grp, int buf) {
    bf16* dst = sx + buf * P_BM * xstride;
    const int chunks = g / 8;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < P_BM * chunks; i += P_THREADS) {
      const int row = i / chunks, q = 8 * (i % chunks);
      const bool in = m0 + row < m_rows;
      cp_async16(dst + row * xstride + q,
                 in ? xg + static_cast<size_t>(m0 + row) * c_pad + grp * g + q : xg, in);
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
    const size_t at = static_cast<size_t>(grp) * r + cb;
    const uint4 s8 = load8_bf16(scales + at, r - cb, vec_s);
    const uint4 z8 = load8_bf16(zeros + at, r - cb, vec_s);
    float xs[TM][2];
#pragma unroll
    for (int mt = 0; mt < TM; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = rb + 16 * mt + 8 * hr;
        xs[mt][hr] = row < m_rows ? __ldg(xsum + static_cast<size_t>(row) * n_groups + grp) : 0.0f;
      }
    cp_async_wait<1>();  // this group's tiles have landed
    __syncthreads();
    const int32_t* wsrc = sw + (b & 1) * g * P_WSTRIDE + 32 * wn + 4 * gid;
    const bf16* xsrc =
        sx + (grp & 1) * P_BM * xstride + (16 * TM * wm + lane % 16) * xstride + 8 * (lane / 16);
    float d[1][TM][NT][4];
    group_dots<BITS, 1, TM, NT>(
        d, g, grp % PLANES, [&](int kc, uint32_t (&a)[1][TM][4], uint32_t (&w)[NT][4]) {
#pragma unroll
          for (int mt = 0; mt < TM; ++mt)
            ldmatrix_x4(a[0][mt], xsrc + 16 * mt * xstride + 16 * kc);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = 16 * kc + 2 * t + (e & 1) + 8 * (e >> 1);
            const int4 v = *reinterpret_cast<const int4*>(wsrc + k * P_WSTRIDE);
            w[0][e] = static_cast<uint32_t>(v.x);
            w[1][e] = static_cast<uint32_t>(v.y);
            w[2][e] = static_cast<uint32_t>(v.z);
            w[3][e] = static_cast<uint32_t>(v.w);
          }
        });
    // d[0][mt][nt][e]: row rb + 16 mt + 8 (e >> 1), column cb + nt + 4 (e & 1)
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8) {
      float s, zs;
      scale_zs(s8, z8, c8, s, zs);
#pragma unroll
      for (int mt = 0; mt < TM; ++mt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float& a = acc[mt][c8 % 4][2 * hr + c8 / 4];
          a = __fadd_rn(a, group_term(d[0][mt][c8 % 4][2 * hr + c8 / 4], s, xs[mt][hr], zs));
        }
    }
    __syncthreads();  // the buffers read here are the next prefetch's targets
  }
#pragma unroll
  for (int mt = 0; mt < TM; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = rb + 16 * mt + 8 * hr;
      if (row >= m_rows) continue;
      bf16* dst = out + static_cast<size_t>(row) * r + cb;
      if (vec_o && cb + 8 <= r) {
        uint32_t v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const __nv_bfloat162 pair =
              __floats2bfloat162_rn(acc[mt][(2 * i) % 4][2 * hr + (2 * i) / 4],
                                    acc[mt][(2 * i + 1) % 4][2 * hr + (2 * i + 1) / 4]);
          v[i] = *reinterpret_cast<const uint32_t*>(&pair);
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int c8 = 0; c8 < 8; ++c8)
          if (cb + c8 < r) dst[c8] = __float2bfloat16_rn(acc[mt][c8 % 4][2 * hr + c8 / 4]);
      }
    }
}

template <int BITS, int MR, typename T>
int launch_decode(const void* x, const int64_t* perm, int perm_len, int c, float* xt,
                  const int32_t* qw, const void* s, const void* z, void* out, int m, int c_pad,
                  int r, int g, cudaStream_t stream) {
  w4a16_gather_rows<MR, T><<<(c_pad + 255) / 256, 256, 0, stream>>>(
      static_cast<const T*>(x), perm, perm_len, c, xt, m, c_pad);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const DecodeSplit split = decode_split(c_pad / g);
  // terms, and the layer's x slice when it fits (else x is read from xt)
  const int terms_bytes = D_SLOTS * split.layers * MR * D_BN * static_cast<int>(sizeof(float));
  const int x_bytes = D_SLOTS * g * MR * static_cast<int>(sizeof(float));
  const int x_in_smem = terms_bytes + x_bytes <= D_SMEM_MAX;
  const int smem = terms_bytes + (x_in_smem ? x_bytes : 0);
  if (smem > D_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  static int smem_set[MAX_DEVICES] = {};
  // 16-byte word loads need r % 4 == 0 and an aligned base
  const int vec = r % 4 == 0 && aligned16(qw);
  return launch_cluster(w4a16_decode_kernel<BITS, MR, T>, (r + D_BN - 1) / D_BN, split.size, smem,
                        smem_set, stream, static_cast<const float*>(xt), qw,
                        static_cast<const T*>(s), static_cast<const T*>(z), static_cast<T*>(out), m,
                        c_pad, r, g, split.layers, vec, x_in_smem);
}

template <int BITS, int BM, typename T>
int launch(const void* x, const int32_t* qw, const void* s, const void* z, void* out,
           int m, int c_pad, int r, int g, cudaStream_t stream) {
  const int smem = (g * BN + BM * g) * static_cast<int>(sizeof(float));
  static int smem_set[MAX_DEVICES] = {};
  return launch_kernel(w4a16_kernel<BITS, BM, T>, dim3((r + BN - 1) / BN, (m + BM - 1) / BM),
                       THREADS, smem, smem_set, stream, static_cast<const T*>(x), qw,
                       static_cast<const T*>(s), static_cast<const T*>(z), static_cast<T*>(out),
                       m, c_pad, r, g);
}

// decode rows 1, 4, 8 or 16: the fewest that cover m
template <int BITS, typename T>
int decode_bits(const void* x, const int64_t* perm, int perm_len, int c, float* xt,
                const int32_t* qw, const void* s, const void* z, void* out, int m, int c_pad,
                int r, int g, cudaStream_t stream) {
  return decode_rows(m, [&](auto mr) {
    return launch_decode<BITS, decltype(mr)::value, T>(x, perm, perm_len, c, xt, qw, s, z, out,
                                                       m, c_pad, r, g, stream);
  });
}

template <typename T>
int dispatch_decode(const void* x, const int64_t* perm, int perm_len, int c, float* xt,
                    const int32_t* qw, const void* s, const void* z, void* out, int m, int c_pad,
                    int r, int g, int bits, cudaStream_t stream) {
  switch (bits) {
    case 1: return decode_bits<1, T>(x, perm, perm_len, c, xt, qw, s, z, out, m, c_pad, r, g, stream);
    case 2: return decode_bits<2, T>(x, perm, perm_len, c, xt, qw, s, z, out, m, c_pad, r, g, stream);
    case 4: return decode_bits<4, T>(x, perm, perm_len, c, xt, qw, s, z, out, m, c_pad, r, g, stream);
    case 8: return decode_bits<8, T>(x, perm, perm_len, c, xt, qw, s, z, out, m, c_pad, r, g, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(const void* x, const int32_t* qw, const void* s, const void* z, void* out,
             int m, int c_pad, int r, int g, int bits, cudaStream_t stream) {
  switch (bits) {
    case 1: return launch<1, 64, T>(x, qw, s, z, out, m, c_pad, r, g, stream);
    case 2: return launch<2, 64, T>(x, qw, s, z, out, m, c_pad, r, g, stream);
    case 4: return launch<4, 64, T>(x, qw, s, z, out, m, c_pad, r, g, stream);
    case 8: return launch<8, 64, T>(x, qw, s, z, out, m, c_pad, r, g, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int BITS, int MR>
int launch_decode_tc(const bf16* xg, const float* xs, const int32_t* qw, const bf16* s,
                     const bf16* z, bf16* out, int m, int c_pad, int r, int g, int flags,
                     cudaStream_t stream) {
  const DecodeSplit split = decode_split(c_pad / g);
  const int smem = D_SLOTS * split.layers * MR * D_BN * static_cast<int>(sizeof(float));
  if (smem > D_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  static int smem_set[MAX_DEVICES] = {};
  return launch_cluster(w4a16_decode_tc<BITS, MR>, (r + D_BN - 1) / D_BN, split.size, smem,
                        smem_set, stream, xg, xs, qw, s, z, out, m, c_pad, r, g, split.layers,
                        flags);
}

template <int BITS, int TM, int WN>
int launch_prefill_tc(const bf16* xg, const float* xs, const int32_t* qw, const bf16* s,
                      const bf16* z, bf16* out, int m, int c_pad, int r, int g, int flags,
                      cudaStream_t stream) {
  using Tile = PrefillTile<TM, WN>;
  static int smem_set[MAX_DEVICES] = {};
  // row tiles vary fastest: the blocks in flight share a column tile's words in L2
  return launch_kernel(w4a16_prefill_tc<BITS, TM, WN>,
                       dim3((m + Tile::BM - 1) / Tile::BM, (r + Tile::BN - 1) / Tile::BN),
                       P_THREADS, Tile::smem(g), smem_set, stream, xg, xs, qw, s, z, out, m, c_pad,
                       r, g, flags);
}

template <int BITS>
int dispatch_tc(const bf16* xg, const float* xs, const int32_t* qw, const bf16* s, const bf16* z,
                bf16* out, int m, int c_pad, int r, int g, int flags, cudaStream_t stream) {
  return dispatch_rows(
      m,
      [&](auto mr) {
        return launch_decode_tc<BITS, decltype(mr)::value>(xg, xs, qw, s, z, out, m, c_pad, r, g,
                                                           flags, stream);
      },
      [&](auto tm, auto wn) {
        return launch_prefill_tc<BITS, decltype(tm)::value, decltype(wn)::value>(
            xg, xs, qw, s, z, out, m, c_pad, r, g, flags, stream);
      });
}

}  // namespace

extern "C" {

// Prefill path.  x (m, c_pad) in stored (act-order) column order,
// zero-padded; qweight (c_pad * bits / 32, r) int32; scales/zeros
// (c_pad / g, r); out (m, r).  x, scales, zeros and out share one dtype:
// 0 = fp32, 1 = bf16.
int w4a16_matmul(const void* x, const int32_t* qw, const void* s, const void* z,
                 void* out, int m, int c_pad, int r, int g, int bits, int dtype,
                 cudaStream_t stream) {
  if (m <= 0 || r <= 0 || g <= 0 || bits <= 0 || c_pad % ((32 / bits) * g) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return dispatch<float>(x, qw, s, z, out, m, c_pad, r, g, bits, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, qw, s, z, out, m, c_pad, r, g, bits, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Decode path, 1 <= m <= 16.  x (m, c) in original column order; perm
// (perm_len,) int64 maps stored column -> original column, or null (no
// act-order); stored columns past perm_len (or past c) read zero.  xt is
// fp32 workspace of c_pad * MR floats, MR = 1, 4, 8 or 16, the fewest that
// cover m.  The other arguments as for w4a16_matmul.
int w4a16_decode(const void* x, const int64_t* perm, int perm_len, int c, float* xt,
                 const int32_t* qw, const void* s, const void* z, void* out, int m, int c_pad,
                 int r, int g, int bits, int dtype, cudaStream_t stream) {
  if (m <= 0 || m > 16 || c <= 0 || r <= 0 || g <= 0 || bits <= 0 ||
      c_pad % ((32 / bits) * g) != 0 || (perm != nullptr && perm_len > c_pad))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_decode<float>(x, perm, perm_len, c, xt, qw, s, z, out, m, c_pad, r, g, bits,
                                  stream);
  if (dtype == 1)
    return dispatch_decode<__nv_bfloat16>(x, perm, perm_len, c, xt, qw, s, z, out, m, c_pad, r,
                                          g, bits, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Tensor-core route, bf16, any m >= 1: x (m, c) in original column order,
// perm as for w4a16_decode; xg (m, c_pad) bf16 and xs (m, c_pad / g) fp32
// are workspace (x in stored order and its group sums); g % 16 == 0, g <=
// 128.  m <= 16 takes the decode kernel, above the prefill kernel: both
// form each group's term through group_dots, so a row has the same bits
// at every m.  The other arguments as for w4a16_matmul.
int w4a16_tc(const void* x, const int64_t* perm, int perm_len, int c, void* xg, float* xs,
             const int32_t* qw, const void* s, const void* z, void* out, int m, int c_pad,
             int r, int g, int bits, cudaStream_t stream) {
  if (m <= 0 || c <= 0 || r <= 0 || g <= 0 || g % 16 != 0 || g > TC_MAX_G ||
      (bits != 1 && bits != 2 && bits != 4 && bits != 8) || c_pad % ((32 / bits) * g) != 0 ||
      (perm != nullptr && perm_len > c_pad) || reinterpret_cast<uintptr_t>(xg) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int gpb = STAGE_COLS / g;
  const dim3 stage_grid(m, (c_pad / g + gpb - 1) / gpb);
  w4a16_stage_rows<<<stage_grid, 256, 0, stream>>>(static_cast<const bf16*>(x), perm, perm_len, c,
                                                   static_cast<bf16*>(xg), xs, c_pad, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte words (r % 4 == 0), scales (r % 8 == 0) and output stores
  const int flags = (r % 4 == 0 && aligned16(qw) ? 1 : 0) |
                    (r % 8 == 0 && aligned16(s) && aligned16(z) ? 2 : 0) |
                    (r % 8 == 0 && aligned16(out) ? 4 : 0);
  const bf16* xgb = static_cast<const bf16*>(xg);
  const bf16* sb = static_cast<const bf16*>(s);
  const bf16* zb = static_cast<const bf16*>(z);
  bf16* ob = static_cast<bf16*>(out);
  switch (bits) {
    case 1: return dispatch_tc<1>(xgb, xs, qw, sb, zb, ob, m, c_pad, r, g, flags, stream);
    case 2: return dispatch_tc<2>(xgb, xs, qw, sb, zb, ob, m, c_pad, r, g, flags, stream);
    case 4: return dispatch_tc<4>(xgb, xs, qw, sb, zb, ob, m, c_pad, r, g, flags, stream);
    default: return dispatch_tc<8>(xgb, xs, qw, sb, zb, ob, m, c_pad, r, g, flags, stream);
  }
}

const char* gptq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
