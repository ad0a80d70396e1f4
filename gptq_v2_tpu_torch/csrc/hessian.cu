// K1: symmetric Hessian accumulation H += X^T X with fp32 accumulation.
//
// Replaces gptq_v2_tpu/ops/hessian_pallas.py::_kernel (pl.pallas_call at
// hessian_pallas.py:91 in _accumulate_hessian_lower; entry
// accumulate_hessian).
//
// What bounds it on the H100.  The work is T*D*(D+1) flops (the symmetric
// half of X^T X).  For bf16 X at the tensor cores' 989 TFLOP/s that is
// 0.139 / 1.004 ms at D = 4096 / 11008, T = 8192.  The bytes are each
// tile pair's two column panels of X (shared across tile pairs through
// L2: the blocks in flight sweep T together, so a panel row is fetched
// from memory about once) plus H read once and written twice; at T = 8192
// they take less than half the operations' time.  So the bound is
// operations.
//
// bf16 X (the main path): tensor-core SYRK, syrk_lower_tc_kernel.  The TPU
// kernel runs bf16 x bf16 -> fp32 on the MXU at default precision; bf16
// products are exact in fp32, so mma.sync m16n8k16 bf16 -> fp32 forms the
// same products.
//
// - Grid: one block per 128x128 tile pair (i >= j) of the lower tile
//   triangle.  T is not split across blocks, so every entry has one fixed
//   summation order (two launches are bit-equal) and nothing is atomic.
// - Operands: both are column panels of the T-major X, A = X[:, i-panel]^T
//   and B = X[:, j-panel], staged 64 token rows at a time into a two-stage
//   cp.async ring (16-byte copies; T and D tails zero-filled through the
//   src-size operand), rows padded to 272 bytes so the eight rows one
//   ldmatrix reads fall in eight bank groups; fragments by ldmatrix.trans.
//   A diagonal tile stages its one panel once.  Three stages (of 64 or of
//   32 rows) also fit two blocks an SM but were slower in a trial on the
//   card (64 rows spill registers; 32 rows pay twice the barriers).
// - Accumulation: eight warps each hold a 64x32 fp32 tile (64 registers a
//   thread).  The tensor cores' fp32 accumulation does not round to
//   nearest, so a sum carried through T/16 mma steps drifts past the
//   1e-5 of max|H| the tests allow at a few thousand tokens; so every 32
//   tokens are summed from zero in the tensor core (two mma steps) and
//   added to the running sum with one round-to-nearest fp32 add.
// - Epilogue: tile (i, j) of H is read once, the sum added and written
//   back from the fragments; the new values go to shared memory
//   transposed, and tile (j, i) is written from there in coalesced 16-byte
//   stores, so H stays a full symmetric matrix.  A diagonal tile keeps its
//   lower triangle (r >= c) and mirrors it: an mma does not promise that
//   (a, b) and (b, a) are summed in one order, and H must stay symmetric
//   bit for bit.
// - Edges: rows of X that are not 16-byte aligned (D % 8 != 0) are staged
//   by element loads in the same kernel; D off a multiple of 128 is masked.
// - What holds it back: every tile pair streams its two panels from L2,
//   512 bytes a token, which at the times in PERF.md is L2 traffic of some
//   3.5 TB/s; larger tiles (wgmma) or panels shared across a cluster would
//   cut it.
//
// fp32 X: CUDA-core SYRK, syrk_lower_kernel<float>, fp32 FMAs (TF32 stays
// off in quantization): one 128x128 lower tile per block, 8x8 outputs a
// thread in registers, T looped inside the block, the tile written to both
// (i, j) and (j, i).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TILE = 128;  // output tile side
constexpr int THREADS = 256;

// (i, j) with i >= j from the linear index of the lower tile triangle
__device__ __forceinline__ void tile_pair(int l, int* i, int* j) {
  int r = static_cast<int>((sqrtf(8.0f * l + 1.0f) - 1.0f) * 0.5f);
  while (r * (r + 1) / 2 > l) --r;
  while ((r + 1) * (r + 2) / 2 <= l) ++r;
  *i = r;
  *j = l - r * (r + 1) / 2;
}

// ---------------------------------------------------------------- bf16 X

constexpr int TC_BK = 64;                  // token rows per stage
constexpr int CHAIN = 2;                   // k16 mma steps summed from zero
constexpr int TC_STAGES = 2;
constexpr int WM_TILES = 4;                // m16 tiles per warp
constexpr int WN_TILES = 4;                // n8 tiles per warp
constexpr int WARPS_M = TILE / (16 * WM_TILES), WARPS_N = TILE / (8 * WN_TILES);
constexpr int TC_THREADS = 32 * WARPS_M * WARPS_N;
constexpr int TC_MIN_BLOCKS = 2;           // blocks an SM holds (registers)
constexpr int TC_LD = TILE + 8;            // bf16 per staged row (272 bytes)
constexpr int TC_PANEL = TC_BK * TC_LD;    // bf16 per staged panel
constexpr int OUT_LD = TILE + 4;           // fp32 per row of the transposed tile
constexpr int TC_SMEM_PIPE = TC_STAGES * 2 * TC_PANEL * 2;
constexpr int TC_SMEM_OUT = TILE * OUT_LD * 4;
constexpr int TC_SMEM = TC_SMEM_PIPE > TC_SMEM_OUT ? TC_SMEM_PIPE : TC_SMEM_OUT;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Token rows [t0, t0 + TC_BK) of X's columns [c0, c0 + TILE) into dst
// (row-major, TC_LD apart); rows past T and columns past D read as 0.
// vec: X's rows are 16-byte aligned (D % 8 == 0), so a column chunk of 8
// lies wholly inside or outside D.
__device__ __forceinline__ void stage_panel(const uint16_t* __restrict__ x, int t0, int n_rows,
                                            int d, int c0, uint16_t* dst, bool vec) {
  if (vec) {
#pragma unroll
    for (int e = threadIdx.x; e < TC_BK * (TILE / 8); e += TC_THREADS) {
      const int r = e / (TILE / 8), c = (e % (TILE / 8)) * 8;
      const int t = t0 + r, col = c0 + c;
      const bool in = t < n_rows && col < d;
      cp_async16(dst + r * TC_LD + c, in ? x + static_cast<size_t>(t) * d + col : x,
                 in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < TC_BK * TILE; e += TC_THREADS) {
      const int r = e / TILE, c = e % TILE;
      const int t = t0 + r, col = c0 + c;
      dst[r * TC_LD + c] = t < n_rows && col < d ? x[static_cast<size_t>(t) * d + col] : 0;
    }
  }
}

// hvec: 4 when H's rows take 16-byte stores (D % 4 == 0, aligned), 2 for
// 8-byte ones, else 0
__global__ void __launch_bounds__(TC_THREADS, TC_MIN_BLOCKS)
syrk_lower_tc_kernel(const uint16_t* __restrict__ x, float* __restrict__ h, int n_rows, int d,
                     int vec_x, int hvec) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* panels = reinterpret_cast<uint16_t*>(smem);  // [stage][A, B][TC_BK][TC_LD]
  int ti, tj;
  tile_pair(blockIdx.x, &ti, &tj);
  const int i0 = ti * TILE, j0 = tj * TILE;
  const bool diag = ti == tj;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the warp's (16·WM_TILES) x (8·WN_TILES) block of the tile
  const int wm = (warp / WARPS_N) * 16 * WM_TILES, wn = (warp % WARPS_N) * 8 * WN_TILES;
  const int nk = (n_rows + TC_BK - 1) / TC_BK;

  auto load = [&](int stage, int kt) {
    uint16_t* a = panels + stage * 2 * TC_PANEL;
    stage_panel(x, kt * TC_BK, n_rows, d, i0, a, vec_x);
    if (!diag) stage_panel(x, kt * TC_BK, n_rows, d, j0, a + TC_PANEL, vec_x);
  };

  float acc[WM_TILES][WN_TILES][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int mt = 0; mt < WM_TILES; ++mt)
#pragma unroll
    for (int nt = 0; nt < WN_TILES; ++nt)
#pragma unroll
      for (int f = 0; f < 4; ++f) acc[mt][nt][f] = 0.0f;

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  // ldmatrix.x4.trans row addresses (stored rows are tokens k): for A,
  // matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15,
  // k 8-15) = a0..a3; for B, (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7,
  // n 8-15), (k 8-15, n 8-15) = b0, b1 of two n8 tiles
  const int a_k = (lane & 7) + ((lane >> 4) << 3), a_m = ((lane >> 3) & 1) << 3;
  const int b_k = (lane & 7) + (((lane >> 3) & 1) << 3), b_n = (lane >> 4) << 3;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();
    const int next = kt + TC_STAGES - 1;
    if (next < nk) load(next % TC_STAGES, next);
    cp_async_commit();
    const uint16_t* sa = panels + (kt % TC_STAGES) * 2 * TC_PANEL;
    const uint16_t* sb = diag ? sa : sa + TC_PANEL;
#pragma unroll
    for (int k0 = 0; k0 < TC_BK; k0 += 16 * CHAIN) {
      uint32_t bf[CHAIN][WN_TILES / 2][4];  // [k16 step][n16 pair][fragment]
#pragma unroll
      for (int ks = 0; ks < CHAIN; ++ks)
#pragma unroll
        for (int np = 0; np < WN_TILES / 2; ++np)
          ldmatrix_x4_trans(bf[ks][np],
                            sb + (k0 + 16 * ks + b_k) * TC_LD + wn + np * 16 + b_n);
#pragma unroll
      for (int mt = 0; mt < WM_TILES; ++mt) {
        uint32_t af[CHAIN][4];
#pragma unroll
        for (int ks = 0; ks < CHAIN; ++ks)
          ldmatrix_x4_trans(af[ks], sa + (k0 + 16 * ks + a_k) * TC_LD + wm + mt * 16 + a_m);
#pragma unroll
        for (int nt = 0; nt < WN_TILES; ++nt) {
          // CHAIN k16 steps from zero in the tensor core, then one
          // round-to-nearest add into the running sum (see the header)
          float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int ks = 0; ks < CHAIN; ++ks)
            mma_bf16(part, af[ks], bf[ks][nt / 2][(nt % 2) * 2],
                     bf[ks][nt / 2][(nt % 2) * 2 + 1]);
#pragma unroll
          for (int f = 0; f < 4; ++f) acc[mt][nt][f] += part[f];
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // st[n][m] = the new H(i0 + m, j0 + n), for the transposed write of
  // tile (j, i); on a diagonal tile it holds the whole mirrored tile
  float* st = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, tig = lane & 3;
  const int m_lim = d - i0, n_lim = d - j0;
#pragma unroll
  for (int mt = 0; mt < WM_TILES; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = wm + mt * 16 + g + 8 * hf;
      if (m >= m_lim) continue;
#pragma unroll
      for (int nt = 0; nt < WN_TILES; ++nt) {
        const int n = wn + nt * 8 + 2 * tig;
        const float a0 = acc[mt][nt][2 * hf], a1 = acc[mt][nt][2 * hf + 1];
        float* hp = h + static_cast<size_t>(i0 + m) * d + j0 + n;
        if (diag) {
          if (n <= m) {
            const float v = hp[0] + a0;
            st[n * OUT_LD + m] = v;
            st[m * OUT_LD + n] = v;
          }
          if (n + 1 <= m) {
            const float v = hp[1] + a1;
            st[(n + 1) * OUT_LD + m] = v;
            st[m * OUT_LD + n + 1] = v;
          }
        } else if (hvec >= 2 && n + 1 < n_lim) {
          float2 v = *reinterpret_cast<const float2*>(hp);
          v.x += a0;
          v.y += a1;
          *reinterpret_cast<float2*>(hp) = v;
          st[n * OUT_LD + m] = v.x;
          st[(n + 1) * OUT_LD + m] = v.y;
        } else {
          if (n < n_lim) {
            const float v = hp[0] + a0;
            hp[0] = v;
            st[n * OUT_LD + m] = v;
          }
          if (n + 1 < n_lim) {
            const float v = hp[1] + a1;
            hp[1] = v;
            st[(n + 1) * OUT_LD + m] = v;
          }
        }
      }
    }
  __syncthreads();

  // tile (j, i): row j0 + n, columns i0 + m .. m + 3 from st[n][m .. m + 3]
  for (int e = threadIdx.x; e < TILE * (TILE / 4); e += TC_THREADS) {
    const int n = e / (TILE / 4), m = (e % (TILE / 4)) * 4;
    if (n >= n_lim || m >= m_lim) continue;
    const float4 v = *reinterpret_cast<const float4*>(st + n * OUT_LD + m);
    float* hp = h + static_cast<size_t>(j0 + n) * d + i0 + m;
    if (hvec == 4 && m + 3 < m_lim) {
      *reinterpret_cast<float4*>(hp) = v;
    } else {
      hp[0] = v.x;
      if (m + 1 < m_lim) hp[1] = v.y;
      if (m + 2 < m_lim) hp[2] = v.z;
      if (m + 3 < m_lim) hp[3] = v.w;
    }
  }
}

constexpr int MAX_DEVICES = 64;
int tc_smem_set[MAX_DEVICES];

int launch_tc(const void* x, float* h, int n_rows, int d, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (tc_smem_set[dev] < TC_SMEM) {  // raised once per device, not per launch
    err = cudaFuncSetAttribute(syrk_lower_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    tc_smem_set[dev] = TC_SMEM;
  }
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x), ha = reinterpret_cast<uintptr_t>(h);
  const int vec_x = d % 8 == 0 && xa % 16 == 0;
  const int hvec = d % 4 == 0 && ha % 16 == 0 ? 4 : d % 2 == 0 && ha % 8 == 0 ? 2 : 0;
  const int nt = (d + TILE - 1) / TILE;
  syrk_lower_tc_kernel<<<nt * (nt + 1) / 2, TC_THREADS, TC_SMEM, stream>>>(
      static_cast<const uint16_t*>(x), h, n_rows, d, vec_x, hvec);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------------- fp32 X

constexpr int BK = 16;     // token rows per shared-memory stage
constexpr int TM = 8;      // outputs per thread along each tile side

template <typename T>
__device__ __forceinline__ void load_stage(const T* __restrict__ x, int t0, int n_rows,
                                           int d, int c0, float (*dst)[TILE]) {
  // BK x TILE elements, 8 per thread, consecutive threads on consecutive
  // columns (coalesced)
#pragma unroll
  for (int e = threadIdx.x; e < BK * TILE; e += THREADS) {
    int r = e / TILE, c = e % TILE;
    int t = t0 + r, col = c0 + c;
    float v = 0.0f;
    if (t < n_rows && col < d) v = x[static_cast<size_t>(t) * d + col];
    dst[r][c] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
syrk_lower_kernel(const T* __restrict__ x, float* __restrict__ h, int n_rows, int d) {
  __shared__ float sa[BK][TILE];
  __shared__ float sb[BK][TILE];
  int ti, tj;
  tile_pair(blockIdx.x, &ti, &tj);
  const int i0 = ti * TILE, j0 = tj * TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[TM][TM];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TM; ++n) acc[m][n] = 0.0f;

  for (int t0 = 0; t0 < n_rows; t0 += BK) {
    load_stage(x, t0, n_rows, d, i0, sa);
    load_stage(x, t0, n_rows, d, j0, sb);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TM];
#pragma unroll
      for (int m = 0; m < TM; ++m) a[m] = sa[k][ty + 16 * m];
#pragma unroll
      for (int n = 0; n < TM; ++n) b[n] = sb[k][tx + 16 * n];
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < TM; ++n) acc[m][n] = fmaf(a[m], b[n], acc[m][n]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < TM; ++m) {
    int row = i0 + ty + 16 * m;
    if (row >= d) continue;
#pragma unroll
    for (int n = 0; n < TM; ++n) {
      int col = j0 + tx + 16 * n;
      if (col >= d) continue;
      size_t lo = static_cast<size_t>(row) * d + col;
      float v = h[lo] + acc[m][n];
      h[lo] = v;
      if (ti != tj) h[static_cast<size_t>(col) * d + row] = v;
    }
  }
}

template <typename T>
int launch(const void* x, float* h, int n_rows, int d, cudaStream_t stream) {
  int nt = (d + TILE - 1) / TILE;
  int pairs = nt * (nt + 1) / 2;
  syrk_lower_kernel<T><<<pairs, THREADS, 0, stream>>>(static_cast<const T*>(x), h,
                                                        n_rows, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// H (d, d) fp32, symmetric on entry, updated in place: H += X^T X for
// X (n_rows, d) row-major.  dtype: 0 = fp32, 1 = bf16.
int hessian_accumulate(const void* x, float* h, int n_rows, int d, int dtype,
                       cudaStream_t stream) {
  if (n_rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch<float>(x, h, n_rows, d, stream);
  if (dtype == 1) return launch_tc(x, h, n_rows, d, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* gptq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
