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
// at 3.35 TB/s), operations at prefill (2 * M * C * R).
//
// Decode path (M <= 16, C entry w4a16_decode): the grid must fill 132 SMs
// although M is tiny, so the contraction is split, over quantization
// groups.  A first small kernel (w4a16_gather_rows) writes x's rows in
// stored (act-order) column order, transposed, in fp32 (xt).  A cluster of
// up to 8 blocks then owns a column tile of 64 outputs; each block holds 16
// groups at a time and stages their slice of xt in shared memory.  A
// thread (4 columns, one group) walks the group's g word rows: one 16-byte
// int4 load per row straight to registers, neighbouring threads on
// neighbouring columns, several rows in flight; the two half-warps take
// two planes of one packing block and so read the same words.  The k loop
// has no barrier.  A code becomes a float without I2F: or-ed into the
// mantissa of 2^23, minus 2^23 (one LOP3, one FADD; exact).  Each thread
// forms its group's term exactly as the prefill kernel does (sums over
// k = 0 .. g-1 from 0, then part * s - xs * zs) and parks it in shared
// memory; after a cluster barrier each rank sums its share of the tile's
// outputs over all groups in group order, reading its peers' terms
// through distributed shared memory.  That is the prefill kernel's
// sequential acc += term, so the two paths give a row the same bits, and
// repeated launches are bit-equal: no float atomics, no workspace beyond
// xt, graph-capturable.  Measured on the H100 it is still slower than the
// library's dense bf16 product at M = 1-8 (PERF.md, kernel table): the arithmetic
// per code is ~4 + M instructions on fp32 CUDA cores, and each group's sum
// is one sequential chain, which caps the threads at R / 4 x groups (32K
// for a 4096 x 4096 linear).
// A faster split-K design with its own summation order was measured and
// dropped: its last-bit differences from the prefill path moved a
// near-tie past the serving gates of chip_smoke.py (PERF.md, section 6).
//
// Prefill path (M > 16, w4a16_kernel) is still the simple one: a block
// owns 64 rows x 64 columns and walks the whole contraction, staging the
// (g, 64) word tile once per packing block and the (64, g) activation
// slice per plane, and per group adds (x_i . q_i) * s - (sum x_i) * zs on
// fp32 CUDA cores, not yet tensor cores.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// A code (below 2^23) as a float without an int -> float convert: or-ed
// into the mantissa of 2^23, minus 2^23.  Exact: the same float as
// static_cast<float>(code).  One LOP3 (with the mask) and one FADD.
__device__ __forceinline__ float code_to_f32(unsigned code) {
  return __int_as_float(static_cast<int>(0x4B000000u | code)) - 8388608.0f;
}

// ---------------------------------------------------------------- decode

constexpr int D_QUADS = 16;                 // 4-column quads across a column tile
constexpr int D_BN = 4 * D_QUADS;           // 64 columns per column tile
constexpr int D_SLOTS = 16;                 // groups a block holds at once
constexpr int D_THREADS = D_QUADS * D_SLOTS;  // 256
constexpr int D_CLUSTER_MAX = 8;            // portable cluster size
constexpr int D_SMEM_MAX = 232448;          // 227 KB a block may opt in to

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

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_ranks = static_cast<int>(cluster.num_blocks());
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
  cluster.sync();
  // outputs o of the (MR, 64) tile, dealt to the ranks in turn
  for (int o = rank * D_THREADS + threadIdx.x; o < MR * D_BN; o += n_ranks * D_THREADS) {
    const int i = o / D_BN, nn = n0 + o % D_BN;
    float acc = 0.0f;
    for (int q = 0; q < n_ranks; ++q) {
      const float* peer = cluster.map_shared_rank(terms, q);
      const int n_here = min(per_block, n_groups - q * per_block);
      for (int s_idx = 0; s_idx < n_here; ++s_idx) acc += peer[s_idx * MR * D_BN + o];
    }
    if (i < m_rows && nn < r) store(out + static_cast<size_t>(i) * r + nn, acc);
  }
  cluster.sync();  // no block leaves while a peer reads its terms
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

constexpr int MAX_DEVICES = 64;

// Raises a kernel instance's dynamic shared-memory limit once per device
// (to the largest size asked for so far), not on every launch: decode
// launches K3 once per linear per token.
template <typename K>
cudaError_t allow_smem(K kern, int smem, int (&smem_set)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = smem;
  }
  return cudaSuccess;
}

template <int BITS, int MR, typename T>
int launch_decode(const void* x, const int64_t* perm, int perm_len, int c, float* xt,
                  const int32_t* qw, const void* s, const void* z, void* out, int m, int c_pad,
                  int r, int g, cudaStream_t stream) {
  w4a16_gather_rows<MR, T><<<(c_pad + 255) / 256, 256, 0, stream>>>(
      static_cast<const T*>(x), perm, perm_len, c, xt, m, c_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // a cluster of up to 8 blocks holds all of a column tile's groups, 16
  // per block per layer
  const int n_groups = c_pad / g;
  const int layers = (n_groups + D_SLOTS * D_CLUSTER_MAX - 1) / (D_SLOTS * D_CLUSTER_MAX);
  const int size = (n_groups + D_SLOTS * layers - 1) / (D_SLOTS * layers);
  // terms, and the layer's x slice when it fits (else x is read from xt)
  const int terms_bytes = D_SLOTS * layers * MR * D_BN * static_cast<int>(sizeof(float));
  const int x_bytes = D_SLOTS * g * MR * static_cast<int>(sizeof(float));
  const int x_in_smem = terms_bytes + x_bytes <= D_SMEM_MAX;
  const int smem = terms_bytes + (x_in_smem ? x_bytes : 0);
  if (smem > D_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = w4a16_decode_kernel<BITS, MR, T>;
  static int smem_set[MAX_DEVICES] = {};
  err = allow_smem(kern, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = size;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((r + D_BN - 1) / D_BN, size);
  cfg.blockDim = dim3(D_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  // 16-byte word loads need r % 4 == 0 and an aligned base
  const int vec = r % 4 == 0 && reinterpret_cast<uintptr_t>(qw) % 16 == 0;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const float*>(xt), qw,
                           static_cast<const T*>(s), static_cast<const T*>(z),
                           static_cast<T*>(out), m, c_pad, r, g, layers, vec, x_in_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS, int BM, typename T>
int launch(const void* x, const int32_t* qw, const void* s, const void* z, void* out,
           int m, int c_pad, int r, int g, cudaStream_t stream) {
  const int smem = (g * BN + BM * g) * static_cast<int>(sizeof(float));
  auto kern = w4a16_kernel<BITS, BM, T>;
  static int smem_set[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(kern, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((r + BN - 1) / BN, (m + BM - 1) / BM);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), qw, static_cast<const T*>(s), static_cast<const T*>(z),
      static_cast<T*>(out), m, c_pad, r, g);
  return static_cast<int>(cudaGetLastError());
}

// decode rows 1, 4, 8 or 16: the fewest that cover m
template <typename T>
int dispatch_decode(const void* x, const int64_t* perm, int perm_len, int c, float* xt,
                    const int32_t* qw, const void* s, const void* z, void* out, int m, int c_pad,
                    int r, int g, int bits, cudaStream_t stream) {
#define K3_DECODE(B, MR) \
  launch_decode<B, MR, T>(x, perm, perm_len, c, xt, qw, s, z, out, m, c_pad, r, g, stream)
#define K3_DECODE_ROWS(B) \
  (m <= 1 ? K3_DECODE(B, 1) : m <= 4 ? K3_DECODE(B, 4) : m <= 8 ? K3_DECODE(B, 8) : K3_DECODE(B, 16))
  switch (bits) {
    case 2: return K3_DECODE_ROWS(2);
    case 4: return K3_DECODE_ROWS(4);
    case 8: return K3_DECODE_ROWS(8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K3_DECODE_ROWS
#undef K3_DECODE
}

template <typename T>
int dispatch(const void* x, const int32_t* qw, const void* s, const void* z, void* out,
             int m, int c_pad, int r, int g, int bits, cudaStream_t stream) {
  switch (bits) {
    case 2: return launch<2, 64, T>(x, qw, s, z, out, m, c_pad, r, g, stream);
    case 4: return launch<4, 64, T>(x, qw, s, z, out, m, c_pad, r, g, stream);
    case 8: return launch<8, 64, T>(x, qw, s, z, out, m, c_pad, r, g, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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

const char* gptq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
