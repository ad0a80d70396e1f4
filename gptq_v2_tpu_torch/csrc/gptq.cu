// K2: blocked GPTQ column solver with fp16 error feedback, and
// K5: its group-stepped form with the quantization parameters given.
//
// K2 replaces gptq_v2_tpu/ops/gptq_pallas.py::_kernel (grid _solve_pallas,
// entry gptq_solve); plain PyTorch version: ops/gptq_cuda.py::_solve_uniform.
// K5 replaces gptq_v2_tpu/ops/gptq_pallas.py::_kernel_step (grid
// _step_call, entry gptq_solve_stepped); plain PyTorch version:
// ops/gptq_cuda.py::_step_reference.
//
// GPTQ treats weight rows independently.  For each group of g columns the
// host launches two kernels on the caller's stream:
//
// 1. column_loop_kernel: scale/zero per row (K2: min-max of the group's
//    running weights; K5: given, computed between launches by find_params,
//    the MSE grid search or EXL2 scale quantization, with maxq per group),
//    then the g-step column loop: quantize column j (round-half-even, true
//    division), dequantize through fp16 (the native round trip the TPU
//    kernel emulates), e_j = (w_j - dq) / hinv[j, j], and the rank-1 update
//    w_k -= e_j * hinv[j, k] of the columns k > j of the group.
//    Bound on the H100: the dependent chain of g steps (a shuffle, two
//    IEEE divisions, rint, the fp16 round trip), which no parallelism
//    shortens, and the instructions each SM issues a step for its rows.
//    The chain stays in registers: 8 threads share a row, thread p holds
//    the columns k = p (mod 8); the owner of column j passes w_j to the
//    row by __shfl_sync, every thread computes e_j itself and updates its
//    own later columns.  The j loop runs in chunks of 8 unrolled steps
//    with the registers shifted down after each, so every register index
//    is a constant and the code stays one chunk long.  hinv's diagonal
//    block sits in shared memory as its upper triangle (a warp's rows read
//    the same words: broadcasts); every global load of the prologue is in
//    flight at once; codes and E are staged in shared memory and written
//    coalesced at the end.  A block holds 32 rows, so R = 4096 fills 128
//    SMs with 8 warps each.
// 2. tail_update_kernel: W^T[i2:, :] -= hinv[i1:i2, i2:]^T @ E over the
//    group's error rows E (g, R).  Bound: fp32 operations, R (C - i2) g
//    FMAs a group (~32 operations a byte of W traffic against the card's
//    ~20).  A SIMT GEMM: 128 x 128 output tiles (C-axis x R-axis), 256
//    threads with an 8 x 8 micro-tile each (smaller tiles for the late
//    groups, which leave few tiles, timed no faster on the H100).  k-major
//    panels of hinv and E come in by 16-byte cp.async three stages of 32
//    deep; the shared loads are float4 (A broadcast, B conflict-free).
//    The W tile comes in by cp.async too, into the two stage buffers the
//    last stage leaves idle, while that stage's products run; the update
//    of W is a float4 read-modify-write.
//
// No tensor cores: Hopper has no fp32 MMA, and TF32 or split-TF32 change
// the sums (outside the numerics contract, docs/PARITY.md).
//
// Every rounded operation keeps one order, whatever the tile or the grid:
// in the loop each multiply, subtract and divide is rounded separately
// (__fmul_rn, __fsub_rn, __fdiv_rn: no FMA contraction), columns are
// updated for j ascending and Σerr² is summed with __fadd_rn in j order;
// in the tail each output's depth-g sum stays in one thread, starts at 0
// and accumulates by fmaf over k ascending, then one __fsub_rn into W.  So
// the outputs do not depend on the launch shape, and the loop computes
// exactly what the plain version does.
//
// K2 loops over the groups inside one host call; K5 is one group per call,
// W^T updated in place between calls, so the running weight the next
// group's parameters are computed from carries every earlier group's
// updates (the reference's kernel-path schedule, gptq_py.py:125-157).
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// ------------------------------------------------------------ column loop

constexpr int LOOP_THREADS = 256;
constexpr int TPR = 8;                    // threads a row
constexpr int ROWS = LOOP_THREADS / TPR;  // weight rows a block
// k-major staging tile (G, ROWS + 32/TPR): conflict-free for the (row, p)
// reads and the owner's E stores
constexpr int TS = ROWS + 32 / TPR;

template <int G>
struct LoopShape {
  static constexpr int NI = G / TPR;  // columns a thread holds
  // hinv's upper triangle, and G zeros past it for the reads of the
  // registers past the last column
  static constexpr int TRI = G * (G + 1) / 2 + G;
  static constexpr int SMEM = (TRI + G * TS) * 4 + G * ROWS;
};

// offset of hinv[j, k] (k >= j) in the packed upper triangle
__device__ constexpr int tri(int g, int j, int k) {
  return j * g - j * (j - 1) / 2 + (k - j);
}

// GIVEN: scale/zero are inputs (K5), else min-max outputs (K2); fb16: the
// feedback dequantizes through fp16
template <int G, bool GIVEN>
__global__ void __launch_bounds__(LOOP_THREADS)
column_loop_kernel(const float* __restrict__ w, const float* __restrict__ hinv,
                   uint8_t* __restrict__ q, float* __restrict__ e,
                   float* __restrict__ err2, float* __restrict__ scale_io,
                   float* __restrict__ zero_io, int c, int r, int es, int gi,
                   float maxq, int sym, int fb16) {
  using S = LoopShape<G>;
  extern __shared__ float smem[];
  float* sh = smem;                 // hinv[i1 + j, i1 + k], k >= j, packed
  float* st = smem + S::TRI;        // (G, TS): the block's weights, then E
  uint8_t* sq = reinterpret_cast<uint8_t*>(st + G * TS);  // (G, ROWS) codes
  const int i1 = gi * G;
  const int r0 = blockIdx.x * ROWS;

  // every load in flight at once (16-byte rows of hinv: c and i1 are
  // multiples of 4), then the stores: the upper triangle of hinv's
  // diagonal block, zeros past it, the block's weights k-major
  constexpr int NH = G * G / 4 / LOOP_THREADS;
  float4 hv[NH];
#pragma unroll
  for (int u = 0; u < NH; ++u) {
    const int idx = threadIdx.x + u * LOOP_THREADS;
    const int j = idx / (G / 4), k = idx % (G / 4) * 4;
    hv[u] = k + 3 >= j ? *reinterpret_cast<const float4*>(
                             hinv + static_cast<size_t>(i1 + j) * c + i1 + k)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // below the diagonal
  }
  float wv[S::NI];  // G * ROWS = NI * LOOP_THREADS weights
#pragma unroll
  for (int u = 0; u < S::NI; ++u) {
    const int idx = threadIdx.x + u * LOOP_THREADS;
    const int k = idx / ROWS, rw = idx % ROWS;
    wv[u] = r0 + rw < r ? w[static_cast<size_t>(i1 + k) * r + r0 + rw] : 0.0f;
  }
#pragma unroll
  for (int u = 0; u < NH; ++u) {
    const int idx = threadIdx.x + u * LOOP_THREADS;
    const int j = idx / (G / 4), k = idx % (G / 4) * 4;
    const float v[4] = {hv[u].x, hv[u].y, hv[u].z, hv[u].w};
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (k + t >= j) sh[tri(G, j, k + t)] = v[t];
  }
  for (int k = threadIdx.x; k < G; k += LOOP_THREADS) sh[S::TRI - G + k] = 0.0f;
#pragma unroll
  for (int u = 0; u < S::NI; ++u) {
    const int idx = threadIdx.x + u * LOOP_THREADS;
    st[idx / ROWS * TS + idx % ROWS] = wv[u];
  }
  __syncthreads();

  const int row = threadIdx.x / TPR, p = threadIdx.x % TPR;
  const int gr = r0 + row;
  const bool live = gr < r;
  float wk[S::NI];  // wk[i] is column p + TPR * i of the row
#pragma unroll
  for (int i = 0; i < S::NI; ++i) wk[i] = st[(p + TPR * i) * TS + row];

  float scale, qzero;
  if (GIVEN) {
    scale = live ? scale_io[gr] : 1.0f;
    qzero = live ? zero_io[gr] : 0.0f;
  } else {
    // min-max parameters of the pre-loop block (reference quant.py:89-118)
    float mx = wk[0], mn = wk[0];
#pragma unroll
    for (int i = 1; i < S::NI; ++i) {
      mx = fmaxf(mx, wk[i]);
      mn = fminf(mn, wk[i]);
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      mn = fminf(mn, __shfl_xor_sync(FULL, mn, off));
    }
    if (sym) {
      float absmax = fmaxf(mx, -mn);
      scale = __fadd_rn(__fmul_rn(absmax, __fdiv_rn(2.0f, maxq)), 1e-12f);
      qzero = rintf(__fmul_rn(__fadd_rn(maxq, 1.0f), 0.5f));
    } else {
      float x_max = fmaxf(mx, 0.0f), x_min = fminf(mn, 0.0f);
      scale = __fadd_rn(__fdiv_rn(__fsub_rn(x_max, x_min), maxq), 1e-12f);
      qzero = rintf(__fdiv_rn(-x_min, scale));
    }
  }
  const float scale16 = __half2float(__float2half_rn(scale));
  __syncthreads();  // every row's weights are in registers: st now takes E

  // The j loop runs in chunks of TPR steps; chunk c0 consumes register 0
  // (column p + TPR * c0), then the registers shift down by one, so every
  // register index stays a constant while the code stays one chunk long.
  // Registers past the group's last column are updated too (it is
  // cheaper than predicating them): they are never read back, and their
  // hinv reads stay inside the triangle's zeroed padding.
  float e2 = 0.0f;
#pragma unroll 1
  for (int c0 = 0; c0 < S::NI; ++c0) {
#pragma unroll
    for (int jj = 0; jj < TPR; ++jj) {
      const int j = c0 * TPR + jj;
      const float wj = __shfl_sync(FULL, wk[0], jj, TPR);
      const float qj =
          fminf(fmaxf(__fadd_rn(rintf(__fdiv_rn(wj, scale)), qzero), 0.0f), maxq);
      float dq;
      if (fb16) {
        dq = __half2float(__float2half_rn(__fmul_rn(__fsub_rn(qj, qzero), scale16)));
      } else {
        dq = __fmul_rn(__fsub_rn(qj, qzero), scale);
      }
      const float ej = __fdiv_rn(__fsub_rn(wj, dq), sh[tri(G, j, j)]);
      if (p == jj) {
        st[j * TS + row] = ej;
        sq[j * ROWS + row] = static_cast<uint8_t>(qj);
      }
      e2 = __fadd_rn(e2, __fmul_rn(ej, ej));
      // hj[TPR * i] is hinv[j, p + TPR * (c0 + i)], the column in wk[i]
      const float* hj = sh + tri(G, j, TPR * c0) + p;
      if (p > jj) wk[0] = __fsub_rn(wk[0], __fmul_rn(ej, hj[0]));
#pragma unroll
      for (int i = 1; i < S::NI; ++i) wk[i] = __fsub_rn(wk[i], __fmul_rn(ej, hj[TPR * i]));
    }
#pragma unroll
    for (int i = 0; i + 1 < S::NI; ++i) wk[i] = wk[i + 1];
  }
  if (p == 0 && live) {
    err2[static_cast<size_t>(gi) * r + gr] = e2;
    if (!GIVEN) {
      scale_io[static_cast<size_t>(gi) * r + gr] = scale;
      zero_io[static_cast<size_t>(gi) * r + gr] = qzero;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * ROWS; idx += LOOP_THREADS) {
    const int j = idx / ROWS, rw = idx % ROWS;
    if (r0 + rw < r) {
      e[static_cast<size_t>(j) * es + r0 + rw] = st[j * TS + rw];
      q[static_cast<size_t>(i1 + j) * r + r0 + rw] = sq[j * ROWS + rw];
    }
  }
}

// ------------------------------------------------------------------- tail

constexpr int TAIL_THREADS = 256;  // a 16 x 16 grid of threads
constexpr int BM = 128, BN = 128;  // output tile: W^T rows (C-axis) x weight rows
constexpr int MI = BM / 64, NJ = BN / 64;  // float4 runs a thread
constexpr int TK = 32;             // k depth of a stage
constexpr int STAGES = 3;
constexpr int STAGE = TK * (BM + BN);  // floats: hinv panel, then E panel
constexpr int TAIL_SMEM = STAGES * STAGE * 4;
// the last stage's two idle buffers take the W tile, half in each
static_assert(BM / 2 * BN <= STAGE, "a W half-tile must fit a stage buffer");

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// W^T[c, r] -= sum_k hinv[i1 + k, c] * E[k, r] for c in [i2, C).  hinv,
// e and (when vec) w are 16-byte aligned; c, i2 and es are multiples of 4;
// vec also says r is.
template <int G>
__global__ void __launch_bounds__(TAIL_THREADS, 2)
tail_update_kernel(float* __restrict__ w, const float* __restrict__ hinv,
                   const float* __restrict__ e, int c, int r, int es, int i1,
                   int i2, int vec) {
  extern __shared__ float4 tail_smem[];
  float* const smem = reinterpret_cast<float*>(tail_smem);  // STAGES x (TK x BM, TK x BN)
  const int cb = i2 + blockIdx.y * BM;  // first W^T row (column of W)
  const int rb = blockIdx.x * BN;       // first weight row
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  auto load_stage = [&](int s, int k0) {
    float* sa = smem + s * STAGE;
    float* sb = sa + TK * BM;
    for (int idx = threadIdx.x; idx < TK * BM / 4; idx += TAIL_THREADS) {
      const int k = idx / (BM / 4), m = (idx % (BM / 4)) * 4;
      const bool ok = cb + m < c;
      cp_async16(sa + k * BM + m,
                 ok ? hinv + static_cast<size_t>(i1 + k0 + k) * c + cb + m : hinv, ok);
    }
    for (int idx = threadIdx.x; idx < TK * BN / 4; idx += TAIL_THREADS) {
      const int k = idx / (BN / 4), n = (idx % (BN / 4)) * 4;
      const bool ok = rb + n < r;
      cp_async16(sb + k * BN + n, ok ? e + static_cast<size_t>(k0 + k) * es + rb + n : e, ok);
    }
  };
  // row m of the W tile: in stage buffer h0 for the first half, h1 for the second
  auto w_tile_row = [&](int h0, int h1, int m) {
    return smem + (m < BM / 2 ? h0 : h1) * STAGE + (m % (BM / 2)) * BN;
  };

  float acc[4 * MI][4 * NJ];
#pragma unroll
  for (int m = 0; m < 4 * MI; ++m)
#pragma unroll
    for (int n = 0; n < 4 * NJ; ++n) acc[m][n] = 0.0f;

  constexpr int KT = G / TK;
  constexpr int H0 = KT % STAGES, H1 = (KT + 1) % STAGES;  // idle in the last stage
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s * TK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; every thread is done with kt - 1
    if (kt + STAGES - 1 < KT) {
      load_stage((kt + STAGES - 1) % STAGES, (kt + STAGES - 1) * TK);
    } else if (kt == KT - 1 && vec) {
      // the W tile, in flight during the last stage's products
      for (int idx = threadIdx.x; idx < BM * BN / 4; idx += TAIL_THREADS) {
        const int m = idx / (BN / 4), n = (idx % (BN / 4)) * 4;
        const bool ok = cb + m < c && rb + n < r;
        cp_async16(w_tile_row(H0, H1, m) + n,
                   ok ? w + static_cast<size_t>(cb + m) * r + rb + n : w, ok);
      }
    }
    cp_async_commit();
    const float* a_s = smem + (kt % STAGES) * STAGE + ty * 4;
    const float* b_s = smem + (kt % STAGES) * STAGE + TK * BM + tx * 4;
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      float a[4 * MI], b[4 * NJ];
#pragma unroll
      for (int u = 0; u < MI; ++u) {
        const float4 v = *reinterpret_cast<const float4*>(a_s + k * BM + 64 * u);
        a[4 * u] = v.x, a[4 * u + 1] = v.y, a[4 * u + 2] = v.z, a[4 * u + 3] = v.w;
      }
#pragma unroll
      for (int u = 0; u < NJ; ++u) {
        const float4 v = *reinterpret_cast<const float4*>(b_s + k * BN + 64 * u);
        b[4 * u] = v.x, b[4 * u + 1] = v.y, b[4 * u + 2] = v.z, b[4 * u + 3] = v.w;
      }
#pragma unroll
      for (int m = 0; m < 4 * MI; ++m)
#pragma unroll
        for (int n = 0; n < 4 * NJ; ++n) acc[m][n] = fmaf(a[m], b[n], acc[m][n]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the W tile landed

#pragma unroll
  for (int m = 0; m < 4 * MI; ++m) {
    const int tm = ty * 4 + 64 * (m / 4) + m % 4;  // row in the tile
    const int col = cb + tm;
    if (col >= c) continue;
    float* wrow = w + static_cast<size_t>(col) * r;
#pragma unroll
    for (int u = 0; u < NJ; ++u) {
      const int tn = tx * 4 + 64 * u, rw = rb + tn;
      if (vec && rw < r) {
        float4 v = *reinterpret_cast<const float4*>(w_tile_row(H0, H1, tm) + tn);
        v.x = __fsub_rn(v.x, acc[m][4 * u]);
        v.y = __fsub_rn(v.y, acc[m][4 * u + 1]);
        v.z = __fsub_rn(v.z, acc[m][4 * u + 2]);
        v.w = __fsub_rn(v.w, acc[m][4 * u + 3]);
        *reinterpret_cast<float4*>(wrow + rw) = v;
      } else if (!vec) {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (rw + t < r) wrow[rw + t] = __fsub_rn(wrow[rw + t], acc[m][4 * u + t]);
      }
    }
  }
}

// ------------------------------------------------------------------- host

// raise a kernel's dynamic shared-memory limit once for each device
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int& set_for) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev == set_for) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) set_for = dev;
  return err;
}

template <int G, bool GIVEN>
cudaError_t launch_loop(const float* w, const float* hinv, uint8_t* q, float* e,
                        float* err2, float* scale, float* zero, int c, int r, int es,
                        int gi, float maxq, int sym, int fb16, cudaStream_t stream) {
  using S = LoopShape<G>;
  static int smem_set_for = -1;  // the device the shared-memory limit was raised on
  cudaError_t err = allow_smem(column_loop_kernel<G, GIVEN>, S::SMEM, smem_set_for);
  if (err != cudaSuccess) return err;
  column_loop_kernel<G, GIVEN><<<(r + ROWS - 1) / ROWS, LOOP_THREADS, S::SMEM, stream>>>(
      w, hinv, q, e, err2, scale, zero, c, r, es, gi, maxq, sym, fb16);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_tail(float* w, const float* hinv, const float* e, int c, int r,
                        int es, int i1, int i2, int vec, cudaStream_t stream) {
  static int smem_set_for = -1;
  cudaError_t err = allow_smem(tail_update_kernel<G>, TAIL_SMEM, smem_set_for);
  if (err != cudaSuccess) return err;
  const dim3 grid((r + BN - 1) / BN, (c - i2 + BM - 1) / BM);
  tail_update_kernel<G><<<grid, TAIL_THREADS, TAIL_SMEM, stream>>>(w, hinv, e, c, r, es,
                                                                  i1, i2, vec);
  return cudaGetLastError();
}

// one group: the column loop, then the tail update of the columns >= i2
template <int G, bool GIVEN>
cudaError_t group_step(float* w, const float* hinv, uint8_t* q, float* e, float* err2,
                       float* scale, float* zero, int c, int r, int gi, float maxq,
                       int sym, int fb16, cudaStream_t stream) {
  const int es = (r + 3) & ~3;
  cudaError_t err = launch_loop<G, GIVEN>(w, hinv, q, e, err2, scale, zero, c, r, es, gi,
                                          maxq, sym, fb16, stream);
  const int i1 = gi * G, i2 = i1 + G;
  if (err != cudaSuccess || i2 >= c) return err;
  const int vec = r % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  return launch_tail<G>(w, hinv, e, c, r, es, i1, i2, vec, stream);
}

bool bad_input(const float* hinv, const float* e, int c, int r, int g) {
  return c <= 0 || r <= 0 || g <= 0 || c % g != 0 ||
         reinterpret_cast<uintptr_t>(hinv) % 16 != 0 ||
         reinterpret_cast<uintptr_t>(e) % 16 != 0;
}

template <int G>
int solve(float* w, const float* hinv, uint8_t* q, float* e, float* err2,
          float* scale, float* zero, int c, int r, float maxq, int sym, int fb16,
          cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  for (int gi = 0; err == cudaSuccess && gi < c / G; ++gi)
    err = group_step<G, false>(w, hinv, q, e, err2, scale, zero, c, r, gi, maxq,
                               sym, fb16, stream);
  return static_cast<int>(err);
}

template <int G>
int step(float* w, const float* hinv, uint8_t* q, float* e, float* err2,
         const float* scale, const float* zero, int c, int r, int gi, float maxq,
         int fb16, cudaStream_t stream) {
  return static_cast<int>(group_step<G, true>(w, hinv, q, e, err2,
                                              const_cast<float*>(scale),
                                              const_cast<float*>(zero), c, r, gi, maxq,
                                              0, fb16, stream));
}

}  // namespace

extern "C" {

// w: (c, r) fp32 W^T, act-order permuted, updated in place (the running
// weight state); hinv: (c, c) fp32 upper Cholesky factor of H^-1,
// 16-byte aligned.  Outputs: q (c, r) uint8 codes; e (g, round_up(r, 4))
// fp32 scratch, 16-byte aligned; err2, scale, zero (c/g, r) fp32.  g must
// divide c and be 32, 64 or 128.
int gptq_solve(float* w, const float* hinv, uint8_t* q, float* e, float* err2,
               float* scale, float* zero, int c, int r, int g, float maxq, int sym,
               int fb16, cudaStream_t stream) {
  if (bad_input(hinv, e, c, r, g)) return static_cast<int>(cudaErrorInvalidValue);
  switch (g) {
    case 32: return solve<32>(w, hinv, q, e, err2, scale, zero, c, r, maxq, sym, fb16, stream);
    case 64: return solve<64>(w, hinv, q, e, err2, scale, zero, c, r, maxq, sym, fb16, stream);
    case 128: return solve<128>(w, hinv, q, e, err2, scale, zero, c, r, maxq, sym, fb16, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K5, one group gi: w (c, r) fp32 W^T updated in place; scale, zero (r,)
// fp32 given; q (c, r) uint8 codes (rows gi*g .. gi*g+g-1 written); e
// (g, round_up(r, 4)) scratch; err2 (c/g, r) (row gi written).  maxq is
// the group's.  Alignment as gptq_solve.
int gptq_step(float* w, const float* hinv, uint8_t* q, float* e, float* err2,
              const float* scale, const float* zero, int c, int r, int g, int gi,
              float maxq, int fb16, cudaStream_t stream) {
  if (bad_input(hinv, e, c, r, g) || gi < 0 || gi >= c / g)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (g) {
    case 32: return step<32>(w, hinv, q, e, err2, scale, zero, c, r, gi, maxq, fb16, stream);
    case 64: return step<64>(w, hinv, q, e, err2, scale, zero, c, r, gi, maxq, fb16, stream);
    case 128: return step<128>(w, hinv, q, e, err2, scale, zero, c, r, gi, maxq, fb16, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* gptq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
