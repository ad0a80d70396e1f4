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
// host launches two kernels:
//
// 1. column_loop_kernel: a block owns 32 weight rows.  It loads the
//    group's (g, 32) slice of W^T, the g x g diagonal block of hinv (64 KB
//    at g = 128) into shared memory, takes scale/zero per row (K2: min-max
//    from the block; K5: given, computed between launches by find_params,
//    the MSE grid search or EXL2 scale quantization, with maxq per group),
//    then runs the g-step column loop: quantize column j (round-half-even,
//    true division), dequantize through fp16 (the native round trip the TPU
//    kernel emulates), e_j = (w_j - dq) / hinv[j, j], and the rank-1 update
//    w_k -= e_j * hinv[j, k] of the columns k > j of the group.  Four
//    threads of one warp share a row and split the k loop, so 4096 rows
//    keep 512 warps busy.  Every multiply, subtract and divide of the loop
//    is rounded separately (__fmul_rn, __fsub_rn, __fdiv_rn): no FMA
//    contraction, so the loop computes exactly what the plain version does.
// 2. tail_update_kernel: W^T[i2:, :] -= hinv[i1:i2, i2:]^T @ E, a tiled
//    fp32 product (64 x 64 output tiles, 16-deep k stages in shared memory)
//    over the group's error rows E (g, R).  Only the columns >= i2 are
//    touched (the TPU kernel rewrites the whole block, masked).
//
// K2 loops over the groups inside one host call; K5 is one group per call,
// W^T updated in place between calls, so the running weight the next
// group's parameters are computed from carries every earlier group's
// updates (the reference's kernel-path schedule, gptq_py.py:125-157).
//
// Bound on the H100: operations (fp32, no tensor cores: TF32 is outside the
// numerics contract), plus the serial chain of g dependent column steps per
// group, which no parallelism removes.  The simple design keeps the chain
// in shared memory and spreads rows over as many warps as R allows; the
// tail product is where the operations are.
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int ROWS = 32;  // weight rows per column-loop block
constexpr int TPR = 4;    // threads per row
constexpr int LOOP_THREADS = ROWS * TPR;

constexpr int PAD = 4;  // row stride G + 4 makes the (row, part) banks conflict-free

// GIVEN: scale/zero are inputs (K5), else min-max outputs (K2)
template <int G, bool GIVEN>
__global__ void __launch_bounds__(LOOP_THREADS)
column_loop_kernel(const float* __restrict__ w, const float* __restrict__ hinv,
                   uint8_t* __restrict__ q, float* __restrict__ e,
                   float* __restrict__ err2, float* __restrict__ scale_io,
                   float* __restrict__ zero_io, int c, int r, int gi, float maxq,
                   int sym, int fb16) {
  extern __shared__ float smem[];
  float* sh = smem;              // (G, G) hinv diagonal block
  float* sw = smem + G * G;      // (ROWS, G + 4) running weights, row-major
  constexpr int RS = G + PAD;
  const int i1 = gi * G;
  const int r0 = blockIdx.x * ROWS;

  for (int idx = threadIdx.x; idx < G * G; idx += LOOP_THREADS) {
    int a = idx / G, b = idx % G;
    sh[idx] = hinv[static_cast<size_t>(i1 + a) * c + i1 + b];
  }
  for (int idx = threadIdx.x; idx < G * ROWS; idx += LOOP_THREADS) {
    int k = idx / ROWS, row = idx % ROWS;
    float v = 0.0f;
    if (r0 + row < r) v = w[static_cast<size_t>(i1 + k) * r + r0 + row];
    sw[row * RS + k] = v;
  }
  __syncthreads();

  const int row = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int gr = r0 + row;
  const bool live = gr < r;
  float* wr = sw + row * RS;

  float scale, qzero;
  if (GIVEN) {
    scale = live ? scale_io[gr] : 1.0f;
    qzero = live ? zero_io[gr] : 0.0f;
  } else {
    // min-max parameters of the pre-loop block (reference quant.py:89-118)
    float mx = wr[part], mn = wr[part];
    for (int k = part + TPR; k < G; k += TPR) {
      mx = fmaxf(mx, wr[k]);
      mn = fminf(mn, wr[k]);
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
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

  float e2 = 0.0f;
  for (int j = 0; j < G; ++j) {
    __syncwarp();
    float wj = wr[j];
    float qj = fminf(fmaxf(__fadd_rn(rintf(__fdiv_rn(wj, scale)), qzero), 0.0f), maxq);
    float dq;
    if (fb16) {
      dq = __half2float(__float2half_rn(__fmul_rn(__fsub_rn(qj, qzero), scale16)));
    } else {
      dq = __fmul_rn(__fsub_rn(qj, qzero), scale);
    }
    float ej = __fdiv_rn(__fsub_rn(wj, dq), sh[j * G + j]);
    if (part == 0 && live) {
      q[static_cast<size_t>(i1 + j) * r + gr] = static_cast<uint8_t>(qj);
      e[static_cast<size_t>(j) * r + gr] = ej;
    }
    e2 = __fadd_rn(e2, __fmul_rn(ej, ej));
    const float* hj = sh + j * G;
    for (int k = j + 1 + part; k < G; k += TPR) {
      wr[k] = __fsub_rn(wr[k], __fmul_rn(ej, hj[k]));
    }
  }
  if (part == 0 && live) {
    err2[static_cast<size_t>(gi) * r + gr] = e2;
    if (!GIVEN) {
      scale_io[static_cast<size_t>(gi) * r + gr] = scale;
      zero_io[static_cast<size_t>(gi) * r + gr] = qzero;
    }
  }
}

constexpr int TT = 64;   // tail output tile (columns c x rows r)
constexpr int TK = 16;   // k stage
constexpr int TAIL_THREADS = 256;

// W^T[c, r] -= sum_k hinv[i1 + k, c] * E[k, r] for c in [i2, C)
template <int G>
__global__ void __launch_bounds__(TAIL_THREADS)
tail_update_kernel(float* __restrict__ w, const float* __restrict__ hinv,
                   const float* __restrict__ e, int c, int r, int i1, int i2) {
  __shared__ float sa[TK][TT];
  __shared__ float sb[TK][TT];
  const int cb = i2 + blockIdx.y * TT;  // first W^T row (column of W)
  const int rb = blockIdx.x * TT;       // first weight row
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[m][n] = 0.0f;

  for (int k0 = 0; k0 < G; k0 += TK) {
    for (int idx = threadIdx.x; idx < TK * TT; idx += TAIL_THREADS) {
      int k = idx / TT, o = idx % TT;
      int col = cb + o, rw = rb + o;
      sa[k][o] = col < c ? hinv[static_cast<size_t>(i1 + k0 + k) * c + col] : 0.0f;
      sb[k][o] = rw < r ? e[static_cast<size_t>(k0 + k) * r + rw] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) a[m] = sa[k][ty + 16 * m];
#pragma unroll
      for (int n = 0; n < 4; ++n) b[n] = sb[k][tx + 16 * n];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(a[m], b[n], acc[m][n]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    int col = cb + ty + 16 * m;
    if (col >= c) continue;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      int rw = rb + tx + 16 * n;
      if (rw >= r) continue;
      size_t o = static_cast<size_t>(col) * r + rw;
      w[o] = __fsub_rn(w[o], acc[m][n]);
    }
  }
}

template <int G>
constexpr int loop_smem() {
  return (G * G + ROWS * (G + PAD)) * static_cast<int>(sizeof(float));
}

// one group: the column loop, then the tail update of the columns >= i2
template <int G, bool GIVEN>
cudaError_t group_step(float* w, const float* hinv, uint8_t* q, float* e, float* err2,
                       float* scale, float* zero, int c, int r, int gi, float maxq,
                       int sym, int fb16, cudaStream_t stream) {
  const dim3 loop_grid((r + ROWS - 1) / ROWS);
  column_loop_kernel<G, GIVEN><<<loop_grid, LOOP_THREADS, loop_smem<G>(), stream>>>(
      w, hinv, q, e, err2, scale, zero, c, r, gi, maxq, sym, fb16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int i2 = (gi + 1) * G;
  if (i2 < c) {
    dim3 tail_grid((r + TT - 1) / TT, (c - i2 + TT - 1) / TT);
    tail_update_kernel<G><<<tail_grid, TAIL_THREADS, 0, stream>>>(
        w, hinv, e, c, r, gi * G, i2);
    err = cudaGetLastError();
  }
  return err;
}

template <int G, bool GIVEN>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(column_loop_kernel<G, GIVEN>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              loop_smem<G>());
}

template <int G>
int solve(float* w, const float* hinv, uint8_t* q, float* e, float* err2,
          float* scale, float* zero, int c, int r, float maxq, int sym, int fb16,
          cudaStream_t stream) {
  cudaError_t err = allow_smem<G, false>();
  for (int gi = 0; err == cudaSuccess && gi < c / G; ++gi)
    err = group_step<G, false>(w, hinv, q, e, err2, scale, zero, c, r, gi, maxq,
                               sym, fb16, stream);
  return static_cast<int>(err);
}

template <int G>
int step(float* w, const float* hinv, uint8_t* q, float* e, float* err2,
         const float* scale, const float* zero, int c, int r, int gi, float maxq,
         int fb16, cudaStream_t stream) {
  cudaError_t err = allow_smem<G, true>();
  if (err == cudaSuccess)
    err = group_step<G, true>(w, hinv, q, e, err2, const_cast<float*>(scale),
                              const_cast<float*>(zero), c, r, gi, maxq, 0, fb16,
                              stream);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// w: (c, r) fp32 W^T, act-order permuted, updated in place (the running
// weight state); hinv: (c, c) fp32 upper Cholesky factor of H^-1.
// Outputs: q (c, r) uint8 codes; e (g, r) fp32 scratch; err2, scale, zero
// (c/g, r) fp32.  g must divide c and be 32, 64 or 128.
int gptq_solve(float* w, const float* hinv, uint8_t* q, float* e, float* err2,
               float* scale, float* zero, int c, int r, int g, float maxq, int sym,
               int fb16, cudaStream_t stream) {
  if (c <= 0 || r <= 0 || g <= 0 || c % g != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (g) {
    case 32: return solve<32>(w, hinv, q, e, err2, scale, zero, c, r, maxq, sym, fb16, stream);
    case 64: return solve<64>(w, hinv, q, e, err2, scale, zero, c, r, maxq, sym, fb16, stream);
    case 128: return solve<128>(w, hinv, q, e, err2, scale, zero, c, r, maxq, sym, fb16, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K5, one group gi: w (c, r) fp32 W^T updated in place; scale, zero (r,)
// fp32 given; q (c, r) uint8 codes (rows gi*g .. gi*g+g-1 written); e (g, r)
// scratch; err2 (c/g, r) (row gi written).  maxq is the group's.
int gptq_step(float* w, const float* hinv, uint8_t* q, float* e, float* err2,
              const float* scale, const float* zero, int c, int r, int g, int gi,
              float maxq, int fb16, cudaStream_t stream) {
  if (c <= 0 || r <= 0 || g <= 0 || c % g != 0 || gi < 0 || gi >= c / g)
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
