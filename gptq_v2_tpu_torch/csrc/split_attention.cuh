// Device code shared by the two split-over-keys attention kernels,
// csrc/contiguous_attention.cu (K4/K7, the contiguous cache) and
// csrc/paged_attention.cu (K6, the page pool): the split's tiles, the
// scores, the split's softmax, PV, and the in-order merge of the splits.
// The kernels differ only in where a block finds its keys and its query
// row; each stages the split's K and V rows into `tiles` and its q heads
// into `qs`, then runs split_body.  A change here moves both.
//
// Head dims 64, 96, 128, 192 and 256.  The K and V tiles are dynamic shared
// memory at every head dim (Tile::BYTES a launch): at hd 256 a bf16 pair
// takes 65 KB, past the 48 KB a block may hold without opting in, and at
// int4 hd 256 the tiles with the static arrays pass it too, so every
// kernel opts in (allow_smem, once a device).  ptxas cannot see dynamic
// shared memory, so the split kernels name the blocks an SM holds
// (blocks_per_sm) in their __launch_bounds__; without it ptxas budgets
// registers for full occupancy and the hd-128 decode rows ran up to 22%
// slower.  In PV a thread owns one d for all heads: two key halves added
// in order at hd 64 (KG = 2), threads 96-127 idle at hd 96, two d's, t
// and t + 128, at hd 256 (DPT = 2), and at hd 192 (DeepSeek's 128 + 64)
// the same two for threads 0-63, one for the rest: 192 is neither a
// divisor nor a multiple of 128.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int THREADS = 128;  // 4 warps
constexpr int KPS = 64;       // keys per split
static_assert(THREADS == 2 * KPS, "scores take two threads a key");

enum Mode { BF16 = 0, INT8 = 1, INT4 = 2 };

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ int low_nibble(int x) {
  return static_cast<int>(static_cast<unsigned>(x) << 28) >> 28;
}

// 16 bytes of a cache row as floats: 8 bf16 or 16 int8 values to lo; for
// INT4 the 16 low nibbles to lo and the 16 high nibbles to hi
template <int MODE>
__device__ __forceinline__ void unpack16(const uint4& raw, float* lo, float* hi) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (MODE == BF16) {
      lo[2 * i] = __uint_as_float(w[i] << 16);
      lo[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int x = static_cast<int>(w[i] << (24 - 8 * j)) >> 24;  // byte j, sign-extended
        if (MODE == INT8) {
          lo[4 * i + j] = static_cast<float>(x);
        } else {
          lo[4 * i + j] = static_cast<float>(low_nibble(x));
          hi[4 * i + j] = static_cast<float>(x >> 4);
        }
      }
    }
  }
}

// one element of a V row (INT4: both nibbles of one byte)
template <int MODE>
__device__ __forceinline__ void load_elem(const unsigned char* p, float& lo, float& hi) {
  if (MODE == BF16) {
    lo = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
  } else {
    const int x = static_cast<signed char>(*p);
    if (MODE == INT8) {
      lo = static_cast<float>(x);
    } else {
      lo = static_cast<float>(low_nibble(x));
      hi = static_cast<float>(x >> 4);
    }
  }
}

// the split's K and V tiles in the launch's dynamic shared memory: KPS K
// rows of KROW bytes (padded, so 8 keys' chunk c sit in 8 bank groups),
// then KPS V rows of ROW bytes; KG key groups and DPT dims a thread in PV
template <int MODE, int HD>
struct Tile {
  static_assert(HD % 32 == 0 && HD <= 2 * THREADS, "head dim");
  static constexpr int ROW = HD * (MODE == BF16 ? 2 : 1);  // bytes of one kv head's (pair's) row
  static constexpr int CPR = ROW / 16;                     // 16-byte chunks a row
  static constexpr int EPC = MODE == BF16 ? 8 : 16;        // d's a chunk
  static constexpr int KROW = ROW + 16;
  static constexpr int BYTES = KPS * (KROW + ROW);
  static constexpr int KG = HD < THREADS ? THREADS / HD : 1;   // 2 at hd 64, else 1
  static constexpr int DPT = HD > THREADS ? 2 : 1;  // 2 at hd 192 and 256, else 1
  // hd 192: a thread's second d, t + 128, is past the row for t >= 64
  static constexpr bool RAGGED_D = HD > THREADS && HD % THREADS != 0;
};

// blocks an SM holds by shared memory (228 KB, 1 KB reserved a block; the
// tiles and split_body's arrays), at most 8: the split kernels'
// __launch_bounds__, so that ptxas budgets registers for the occupancy the
// tiles allow, which it cannot see in dynamic shared memory
template <int MODE, int HD, int NH>
constexpr int blocks_per_sm() {
  using T = Tile<MODE, HD>;
  constexpr int smem = T::BYTES + 4 * NH * (HD + 3 * KPS) + 4 * (T::KG > 1 ? NH : 1) * HD + 1024;
  return 228 * 1024 / smem < 8 ? 228 * 1024 / smem : 8;
}

// opt KERNEL into its BYTES of dynamic shared memory, once a device (at
// hd 256 they and the static arrays pass the 48 KB a block gets without
// it); the flag is per kernel: one flag for all instantiations left the
// later ones without the opt-in
template <auto KERNEL, int BYTES>
cudaError_t allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64 || done[dev]) return err;
  err = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

// NH q heads of a block's scores, softmax and PV over one split of n keys
// (1 <= n <= KPS); part(i) is the partial index of local head i, whose
// (m, l, acc[HD]) the block writes.  Called by every thread once K and V
// are in flight (two cp.async commit groups, K first) and qs is written.
template <int MODE, int HD, int NH, class Part>
__device__ __forceinline__ void split_body(const unsigned char* tiles, const float (&qs)[NH][HD],
                                           int n, float scale, float soft_cap, float* part_m,
                                           float* part_l, float* part_acc, Part part) {
  using T = Tile<MODE, HD>;
  constexpr int ROW = T::ROW, CPR = T::CPR, EPC = T::EPC, KROW = T::KROW;
  constexpr int KG = T::KG, DPT = T::DPT;
  const unsigned char* ks = tiles;
  const unsigned char* vs = tiles + KPS * KROW;
  __shared__ float sc[2][NH][KPS];
  __shared__ __align__(16) float ps[KPS][NH];
  __shared__ float red[KG > 1 ? NH : 1][HD];
  const int t = threadIdx.x;

  cp_async_wait<1>();  // K has landed; V may still be in flight
  __syncthreads();

  // scores: thread (key jj, half) over half of hd for every head
  {
    const int jj = t % KPS, half = t / KPS;
    if (jj < n) {
      float s[NH];
#pragma unroll
      for (int i = 0; i < NH; ++i) s[i] = 0.0f;
      const unsigned char* row = ks + jj * KROW + half * (ROW / 2);
#pragma unroll 2
      for (int c = 0; c < CPR / 2; ++c) {
        const int d0 = half * (HD / 2) + c * EPC;
        float klo[EPC], khi[EPC];
        unpack16<MODE>(*reinterpret_cast<const uint4*>(row + c * 16), klo, khi);
#pragma unroll
        for (int i = 0; i < NH; ++i) {
          const bool upper = MODE == INT4 && i >= NH / 2;
          float acc = s[i];
#pragma unroll
          for (int e = 0; e < EPC; ++e) acc = fmaf(qs[i][d0 + e], upper ? khi[e] : klo[e], acc);
          s[i] = acc;
        }
      }
#pragma unroll
      for (int i = 0; i < NH; ++i) sc[half][i][jj] = s[i];
    }
  }
  __syncthreads();

  // softmax over the split, one warp a head: m, p = exp(s - m), l
  {
    const int warp = t / 32, lane = t % 32;
    for (int i = warp; i < NH; i += THREADS / 32) {
      float s[KPS / 32], mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < KPS / 32; ++u) {
        const int jj = lane + 32 * u;
        float x = -INFINITY;
        if (jj < n) {
          x = (sc[0][i][jj] + sc[1][i][jj]) * scale;
          if (soft_cap > 0.0f) x = soft_cap * tanhf(x / soft_cap);
        }
        s[u] = x;
        mx = fmaxf(mx, x);
      }
      mx = warp_max(mx);
      float l = 0.0f;
#pragma unroll
      for (int u = 0; u < KPS / 32; ++u) {
        const int jj = lane + 32 * u;
        const float p = jj < n ? expf(s[u] - mx) : 0.0f;
        ps[jj][i] = p;
        l += p;
      }
      l = warp_sum(l);
      if (lane == 0) {
        part_m[part(i)] = mx;
        part_l[part(i)] = l;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // PV: thread (d, key group) for every head, keys in order; at hd 192 and
  // 256 a thread owns DPT = 2 dims, d and d + THREADS (at 192 only threads
  // 0-63 own the second).  At hd 96 threads 96-127 have key group 1, whose
  // keys start at KPS: they sit out.
  {
    const int d = t % HD, kg = t / HD;
    const int k_end = min(n, (kg + 1) * (KPS / KG));
    const int n_d = T::RAGGED_D && d + THREADS >= HD ? 1 : DPT;  // dims this thread owns
    float acc[DPT][NH];
#pragma unroll
    for (int u = 0; u < DPT; ++u)
#pragma unroll
      for (int i = 0; i < NH; ++i) acc[u][i] = 0.0f;
    for (int jj = kg * (KPS / KG); jj < k_end; ++jj) {
#pragma unroll
      for (int u = 0; u < DPT; ++u) {
        if (u >= n_d) break;
        float vlo, vhi = 0.0f;
        load_elem<MODE>(vs + jj * ROW + (d + u * THREADS) * (MODE == BF16 ? 2 : 1), vlo, vhi);
#pragma unroll
        for (int i = 0; i < NH; ++i)
          acc[u][i] = fmaf(ps[jj][i], MODE == INT4 && i >= NH / 2 ? vhi : vlo, acc[u][i]);
      }
    }
    if (KG > 1) {
      if (kg == 1) {
#pragma unroll
        for (int i = 0; i < NH; ++i) red[i][d] = acc[0][i];
      }
      __syncthreads();
      if (kg == 0) {
#pragma unroll
        for (int i = 0; i < NH; ++i) acc[0][i] += red[i][d];
      }
    }
    if (kg == 0) {
#pragma unroll
      for (int u = 0; u < DPT; ++u) {
        if (u >= n_d) break;
#pragma unroll
        for (int i = 0; i < NH; ++i) part_acc[part(i) * HD + d + u * THREADS] = acc[u][i];
      }
    }
  }
}

// The merge: one block per (row, q head qh), one thread per d, the row's
// partials at `base` (n_splits of them).  M = max over splits and the sink
// logit; den = exp(sink - M) + Σ l_z exp(m_z - M), num = Σ acc_z exp(m_z - M)
// in split order, empty splits skipped; returns num / den · scale, or 0
// for a row with no visible key.  The max is a block reduction (exact in
// any order) whose loads also keep the first MERGE_Z splits' m and l in
// shared memory; each split's factor exp(m_z - M) is formed once there,
// MERGE_Z splits at a time; then every thread folds l_z and acc_z[d] in
// split order, its loads of acc issued MERGE_BATCH at a time ahead of
// their fold.
constexpr int MERGE_Z = 256;
constexpr int MERGE_BATCH = 16;

template <int HD>
__device__ __forceinline__ float merge_splits(const float* part_m, const float* part_l,
                                              const float* part_acc, size_t base, int n_splits,
                                              const float* sinks, int qh, float scale) {
  __shared__ float fz[MERGE_Z], lz[MERGE_Z], wmax[HD / 32];
  const int d = threadIdx.x;
  float mx = -INFINITY;
  for (int z = d; z < n_splits; z += HD) {
    const float m = part_m[base + z];
    mx = fmaxf(mx, m);
    if (z < MERGE_Z) {  // read back by this thread for the first chunk
      fz[z] = m;
      lz[z] = part_l[base + z];
    }
  }
  mx = warp_max(mx);
  if (d % 32 == 0) wmax[d / 32] = mx;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < HD / 32; ++w) mx = fmaxf(mx, wmax[w]);
  const float sink = sinks != nullptr ? sinks[qh] : -INFINITY;
  mx = fmaxf(mx, sink);
  float den = sinks != nullptr ? expf(sink - mx) : 0.0f, num = 0.0f;
  for (int z0 = 0; z0 < n_splits; z0 += MERGE_Z) {
    const int nz = min(MERGE_Z, n_splits - z0);
    if (z0 > 0) __syncthreads();  // the previous chunk's factors are read
    for (int z = d; z < nz; z += HD) {
      const float m = z0 == 0 ? fz[z] : part_m[base + z0 + z];
      if (z0 > 0) lz[z] = part_l[base + z0 + z];
      // an empty split adds nothing; its acc was never written
      fz[z] = m == -INFINITY ? 0.0f : expf(m - mx);
    }
    __syncthreads();
    const float* acc = part_acc + (base + z0) * HD + d;
    for (int zb = 0; zb < nz; zb += MERGE_BATCH) {
      float v[MERGE_BATCH];  // all loads of a batch issued before its fold
#pragma unroll
      for (int u = 0; u < MERGE_BATCH; ++u)
        v[u] = zb + u < nz ? acc[static_cast<size_t>(zb + u) * HD] : 0.0f;
#pragma unroll
      for (int u = 0; u < MERGE_BATCH; ++u) {
        const float f = zb + u < nz ? fz[zb + u] : 0.0f;
        if (f != 0.0f) {
          den = fmaf(lz[zb + u], f, den);
          num = fmaf(v[u], f, num);
        }
      }
    }
  }
  return den > 0.0f ? num / den * scale : 0.0f;
}

// heads per block: GB = the largest divisor of groups up to 8, doubled
// for the int4 pairs
int heads_per_block(int groups) {
  int gb = 8;
  while (groups % gb) --gb;
  return gb;
}

}  // namespace
