// Device helpers and launch helpers shared by the two dequant-matmul kernel
// sources, csrc/w4a16.cu (K3, bf16 activations) and csrc/w4a8.cu (K8, int8
// activations).  Both split decode (M <= 16) over quantization groups
// across a thread-block cluster and sum the groups' terms in group order
// through distributed shared memory (cluster_sum), and both run prefill as
// a tile kernel of eight warps fed by cp.async and ldmatrix; the M -> kernel
// choice is one function (dispatch_rows).  A change here moves both.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

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

// ------------------------------------------------------ cp.async, ldmatrix

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(s));
}

// ------------------------------------------------------------------ decode

constexpr int D_BN = 64;                   // columns per column tile
constexpr int D_SLOTS = 16;                // groups a block holds at once
constexpr int D_THREADS = 256;             // eight warps
constexpr int D_CLUSTER_MAX = 8;           // portable cluster size
constexpr int D_SMEM_MAX = 232448;         // 227 KB a block may opt in to
constexpr int TC_MAX_G = 128;              // the largest g whose prefill tiles fit

// The decode kernels' epilogue.  Every block of the cluster has parked its
// groups' terms in `terms`: slot s (group rank * per_block + s) holds an
// (MR, 64) tile of them.  Output o of the tile is dealt to rank o / 256 %
// ranks, summed over all groups in group order from zero with __fadd_rn
// (peers' terms read through distributed shared memory, no atomics) and
// handed to emit(row, tile column, acc).
template <int MR, typename Emit>
__device__ __forceinline__ void cluster_sum(const float* terms, int n_groups, int per_block,
                                            Emit&& emit) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  cluster.sync();
  for (int o = rank * D_THREADS + threadIdx.x; o < MR * D_BN; o += n_ranks * D_THREADS) {
    float acc = 0.0f;
    for (int q = 0; q < n_ranks; ++q) {
      const float* peer = cluster.map_shared_rank(terms, q);
      const int n_here = min(per_block, n_groups - q * per_block);
      for (int s_idx = 0; s_idx < n_here; ++s_idx)
        acc = __fadd_rn(acc, peer[s_idx * MR * D_BN + o]);
    }
    emit(o / D_BN, o % D_BN, acc);
  }
  cluster.sync();  // no block leaves while a peer reads its terms
}

// A cluster of up to 8 blocks holds all of a column tile's groups, 16 per
// block per layer: `layers` layers a block, `size` blocks a cluster.
struct DecodeSplit {
  int layers, size;
};
inline DecodeSplit decode_split(int n_groups) {
  const int layers = (n_groups + D_SLOTS * D_CLUSTER_MAX - 1) / (D_SLOTS * D_CLUSTER_MAX);
  return {layers, (n_groups + D_SLOTS * layers - 1) / (D_SLOTS * layers)};
}

// ------------------------------------------------------------------ prefill

constexpr int P_THREADS = 256;  // eight warps

// A tensor-core prefill block tile: WN warps across, 8 / WN down, each warp
// TM m16 tiles x 4 n8 tiles (16 TM rows x 32 columns)
template <int TM, int WN>
struct PrefillWarps {
  static constexpr int BM = (8 / WN) * 16 * TM, BN = 32 * WN;
};

// ------------------------------------------------------------------ launch

constexpr int MAX_DEVICES = 64;

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Raises a kernel instance's dynamic shared-memory limit once per device
// (to the largest size asked for so far), not on every launch: decode
// launches K3 and K8 once per linear per token.  Each kernel instance keeps
// its own smem_set.
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

// kern<<<grid, threads, smem, stream>>>(args...) after allow_smem
template <typename... KArgs, typename... Args>
int launch_kernel(void (*kern)(KArgs...), dim3 grid, int threads, int smem,
                  int (&smem_set)[MAX_DEVICES], cudaStream_t stream, Args... args) {
  cudaError_t err = allow_smem(kern, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// A decode launch: grid (column tiles, size) in clusters of (1, size, 1)
// blocks of D_THREADS, after allow_smem
template <typename... KArgs, typename... Args>
int launch_cluster(void (*kern)(KArgs...), int col_tiles, int size, int smem,
                   int (&smem_set)[MAX_DEVICES], cudaStream_t stream, Args... args) {
  cudaError_t err = allow_smem(kern, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = size;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(col_tiles, size);
  cfg.blockDim = dim3(D_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
using Int = std::integral_constant<int, N>;

// decode(Int<MR>()) with MR = 1, 4, 8 or 16, the fewest rows that cover m
template <typename Decode>
int decode_rows(int m, Decode&& decode) {
  if (m <= 1) return decode(Int<1>());
  if (m <= 4) return decode(Int<4>());
  if (m <= 8) return decode(Int<8>());
  return decode(Int<16>());
}

// The tensor-core routes' choice by M: decode at m <= 16, else prefill in
// 64 x 64 tiles (prefill(Int<TM = 1>, Int<WN = 2>)) up to 64 rows and 128 x
// 128 (TM 4, WN 4) above
template <typename Decode, typename Prefill>
int dispatch_rows(int m, Decode&& decode, Prefill&& prefill) {
  if (m <= 16) return decode_rows(m, decode);
  if (m <= 64) return prefill(Int<1>(), Int<2>());
  return prefill(Int<4>(), Int<4>());
}

}  // namespace
