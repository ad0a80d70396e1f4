// K8: W4A8 fused dequant + matmul: per-row int8 activations times
// plane-per-group packed low-bit weight codes, int8 x int8 -> int32 dots.
//
// Replaces gptq_v2_tpu/ops/w4a16.py::_kernel_a8 (grid _w4a8_2d, entry
// w4a16_matmul with act_bits = 8).  Plain PyTorch version:
// ops/w4a16.py::w4a8_reference (each group's dot exact in float64, then the
// same fp32 algebra).
//
// Inputs: xq (M, C_pad) int8, already act-order gathered, zero-padded and
// quantized per row (ops/w4a16.py::quantize_activations_int8), x_scale (M)
// fp32, qweight (C_pad / planes, R) int32, scales / zeros (C_pad / g, R) in
// T (fp32 or bf16).  Per quantization group i (bit-plane i of a packing
// block, ops/packing.py):
//     dot_i = sum_k xq_k * (q_k - off) + off * sum_k xq_k      (exact int32)
//     acc  += float(dot_i) * s - float(sum_k xq_k) * zs
// with zs = z * s rounded to T, and out = T(acc * x_scale).  bits = 8 codes
// span 0..255 and would wrap as int8, so they are centred by off = 128 and
// the offset comes back through the exact row sum; bits <= 4 use off = 0.
//
// A block owns BM activation rows x 64 output columns and walks the whole
// contraction, as K3 (csrc/w4a16.cu) does: per packing block it stages the
// (g, 64) word tile in shared memory once for every plane; per plane it
// unpacks that plane's codes into a (64, g) int8 tile (4 consecutive k of
// one column per 32-bit word) and stages the (BM, g) int8 activation
// slice, then each thread forms its 4 x TM dots with __dp4a (4 int8 MACs
// per instruction) and the row sums with __dp4a against 0x01010101.  Rows
// are padded by 1 word so the column reads fall in distinct banks.
//
// Bound on the H100: bytes at decode (each packed word is read once per row
// tile: C * R * bits / 8 bytes), operations at prefill (2 * M * C * R, on
// the int8 CUDA-core dp4a path here, not yet the int8 tensor cores).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BN = 64;
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

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

constexpr int MAX_DEVICES = 64;

template <int BITS, int BM, typename T>
int launch(const int8_t* xq, const float* xs, const int32_t* qw, const void* s, const void* z,
           void* out, int m, int c_pad, int r, int g, cudaStream_t stream) {
  const int stride = g / 4 + 1;
  const int smem = (g * BN + (BN + BM) * stride) * static_cast<int>(sizeof(int32_t));
  auto kern = w4a8_kernel<BITS, BM, T>;
  // raised once per kernel instance and device, as in csrc/w4a16.cu
  static int smem_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = smem;
  }
  dim3 grid((r + BN - 1) / BN, (m + BM - 1) / BM);
  kern<<<grid, THREADS, smem, stream>>>(xq, xs, qw, static_cast<const T*>(s),
                                        static_cast<const T*>(z), static_cast<T*>(out), m,
                                        c_pad, r, g);
  return static_cast<int>(cudaGetLastError());
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

}  // namespace

extern "C" {

// xq (m, c_pad) int8 in stored (act-order) column order, zero-padded;
// x_scale (m) fp32; qweight (c_pad * bits / 32, r) int32; scales/zeros
// (c_pad / g, r); out (m, r).  scales, zeros and out share one dtype:
// 0 = fp32, 1 = bf16.  g must be a multiple of 4.
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

const char* gptq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
