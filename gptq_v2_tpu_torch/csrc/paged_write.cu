// K9: the paged KV write.
//
// Replaces gptq_v2_tpu/ops/paged_write.py::_write_kernel (entry
// paged_write_rows), and with it the quantize, nibble-pack, interleave and
// page lookup that XLA fuses ahead of it (gptq_v2_tpu/serving/kv_cache.py::
// write_kv / write_kv_flat): one launch is a layer's whole paged write.
// The TPU kernel issues one HBM-to-HBM DMA per ready-made storage row from
// a scalar-prefetched (page, offset) table; eager PyTorch would spend ~10
// (int8) to ~18 (int4) device ops a layer making those rows, so here the
// kernel reads each token's K and V in the model's dtype and writes the
// storage row itself.
//
// Plain PyTorch versions (ops/paged_write.py): paged_write_kv_reference
// (quantize, page_offsets, interleave_kv, indexed store) and, for the raw
// row entry paged_write, paged_write_reference (the indexed store).
//
// Row t of the write is token (b, n) = (t / n_cols, t % n_cols).  Its
// target is (pages[t], offsets[t]), or (block_tables[b, pos / ps], pos %
// ps) with pos = positions[b, n], and (0, 0), the trash page, when
// pad_mask[b, n] is set.  Index tensors are int32 or int64 (a bit of
// idx64 each) with element strides.  A row whose page or offset is out of
// range is not written (the indexed store would fault instead).  Rows
// aimed at the same slot (pad rows on the trash page) race, word by word:
// the slot ends up holding words of any of them; nothing reads it.
//
// The storage row (combined head c = 2h for K, 2h + 1 for V; for int4
// pages c = 2p, 2p + 1 over adjacent head pairs (2p, 2p + 1)), bit-equal
// to kv_cache.quantize_kv_write:
//   fp32 / bf16 pool: a copy or __float2bfloat16_rn;
//   int8:  clamp(rint(x / s), -127, 127), x / s an IEEE division
//          (__fdiv_rn; the build has no --use_fast_math), rint ties to
//          even as torch.round;
//   int4:  the same clamped to +-7, byte [p, d] = head 2p's code in the low
//          nibble, head 2p + 1's in the high one.
// s is one float or one per kv head (step 0 or 1), K and V independently,
// read from device memory.
//
// Work mapping: grid (token row, slice of THREADS units of the row); a
// thread takes one unit, 8 consecutive elements of one output combined
// head (one 16-byte load per input head row in bf16, two in fp32; for int4
// one from each head of the pair), and writes it as one store, so no
// thread waits on a second load (a 7B bf16 row is 1024 units, 8 blocks).
// Consecutive threads take consecutive units, so loads and stores
// coalesce within a head row.  The raw row mode copies one 16-byte word a
// thread.
//
// Bound on the H100: bytes -- K and V read once, the storage row written
// once, the indices read once.  At decode sizes (8 rows of 7B width, bf16:
// 256 KB) that is ~0.08 us of HBM time against a launch of a few us; the
// design's gain is the launches it removes, not the copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 128;

enum Store : int { STORE_RAW = 0, STORE_F32 = 1, STORE_BF16 = 2, STORE_I8 = 3, STORE_I4 = 4 };
enum InDtype : int { IN_F32 = 0, IN_BF16 = 1 };
enum Idx64 : int { PAGES64 = 1, OFFSETS64 = 2, TABLES64 = 4, POSITIONS64 = 8 };

struct Target {
  const void* pages;  // flat form: (T,) each; null in the block-table form
  const void* offsets;
  long long pages_step, offsets_step;
  const void* tables;  // block-table form: (B, max_pages)
  long long table_stride;
  int max_pages;
  const void* positions;  // (B, N)
  long long pos_sb, pos_sn;
  const bool* pad;  // (B, N) or null
  long long pad_sb, pad_sn;
  int n_cols;  // N
  int idx64;   // Idx64 bits
};

struct WriteArgs {
  void* kv;  // (L, n_pages, page_size, n_comb, hd)
  int layer, n_pages, page_size;
  long long row_bytes;
  int units;  // per row: 16-byte words (raw rows) or 8-element chunks
  const void* k;  // (B, N, n_kv, hd), each token's (n_kv, hd) block dense
  const void* v;
  long long k_sb, k_sn, v_sb, v_sn;  // element strides
  const float* k_scale;  // quantized stores: 1 or n_kv floats (step 0 / 1)
  const float* v_scale;
  int k_scale_step, v_scale_step;
  int n_comb, hd;
  Target target;
};

__device__ __forceinline__ long long load_index(const void* p, bool is64, long long i) {
  return is64 ? static_cast<const long long*>(p)[i]
              : static_cast<long long>(static_cast<const int32_t*>(p)[i]);
}

// Row t's (page, offset); false if out of range (the row is not written).
__device__ __forceinline__ bool resolve(const Target& g, int t, int n_pages, int page_size,
                                        long long* page, long long* off) {
  if (g.tables == nullptr) {
    *page = load_index(g.pages, g.idx64 & PAGES64, t * g.pages_step);
    *off = load_index(g.offsets, g.idx64 & OFFSETS64, t * g.offsets_step);
  } else {
    const int b = t / g.n_cols, n = t - b * g.n_cols;
    if (g.pad != nullptr && g.pad[b * g.pad_sb + n * g.pad_sn]) {
      *page = 0;
      *off = 0;
    } else {
      const long long pos =
          load_index(g.positions, g.idx64 & POSITIONS64, b * g.pos_sb + n * g.pos_sn);
      if (pos < 0 || pos / page_size >= g.max_pages) return false;
      *page = load_index(g.tables, g.idx64 & TABLES64, b * g.table_stride + pos / page_size);
      *off = pos % page_size;
    }
  }
  return *page >= 0 && *page < n_pages && *off >= 0 && *off < page_size;
}

// 8 consecutive input elements as floats (exact for bf16 and fp32).
__device__ __forceinline__ void load8(const float* p, float x[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float x[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(u[i] << 16);
    x[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ int code(float x, float s, float qmax) {
  return static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(x, s)), -qmax), qmax));
}

// 8 codes of one head, one byte each (int8 pages).
__device__ __forceinline__ uint2 codes8(const float x[8], float s) {
  uint32_t w[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i / 4] |= (static_cast<uint32_t>(code(x[i], s, 127.f)) & 0xFFu) << (8 * (i % 4));
  return make_uint2(w[0], w[1]);
}

// 8 bytes of an adjacent head pair: lo's code in the low nibble, hi's in the high.
__device__ __forceinline__ uint2 nibbles8(const float lo[8], float s_lo, const float hi[8],
                                          float s_hi) {
  uint32_t w[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t byte = (static_cast<uint32_t>(code(lo[i], s_lo, 7.f)) & 0xFu) |
                          ((static_cast<uint32_t>(code(hi[i], s_hi, 7.f)) & 0xFu) << 4);
    w[i / 4] |= byte << (8 * (i % 4));
  }
  return make_uint2(w[0], w[1]);
}

template <typename In, int STORE>
__global__ void __launch_bounds__(THREADS) paged_write_kernel(const WriteArgs a) {
  const int t = blockIdx.x;
  const int u = blockIdx.y * THREADS + threadIdx.x;  // this thread's unit of the row
  long long page, off;
  if (u >= a.units || !resolve(a.target, t, a.n_pages, a.page_size, &page, &off)) return;
  char* dst = static_cast<char*>(a.kv) +
              ((static_cast<long long>(a.layer) * a.n_pages + page) * a.page_size + off) *
                  a.row_bytes;
  if constexpr (STORE == STORE_RAW) {
    // a ready-made storage row, copied as 16-byte words
    reinterpret_cast<uint4*>(dst)[u] =
        static_cast<const uint4*>(a.k)[static_cast<long long>(t) * a.units + u];
  } else {
    const int b = t / a.target.n_cols, n = t - b * a.target.n_cols;
    const In* k = static_cast<const In*>(a.k) + b * a.k_sb + n * a.k_sn;
    const In* v = static_cast<const In*>(a.v) + b * a.v_sb + n * a.v_sn;
    const int chunks = a.hd / 8;
    const int c = u / chunks, d = (u - c * chunks) * 8;
    const bool is_v = c & 1;
    const int h = c >> 1;  // kv head, or int4 head pair
    const In* src = is_v ? v : k;
    const long long o = static_cast<long long>(c) * a.hd + d;  // element of the row
    if constexpr (STORE == STORE_I4) {
      const float* sc = is_v ? a.v_scale : a.k_scale;
      const int step = is_v ? a.v_scale_step : a.k_scale_step;
      float lo[8], hi[8];
      load8(src + (2 * h) * a.hd + d, lo);
      load8(src + (2 * h + 1) * a.hd + d, hi);
      reinterpret_cast<uint2*>(dst)[o / 8] =
          nibbles8(lo, sc[2 * h * step], hi, sc[(2 * h + 1) * step]);
    } else if constexpr (STORE == STORE_I8) {
      const float s = is_v ? a.v_scale[h * a.v_scale_step] : a.k_scale[h * a.k_scale_step];
      float x[8];
      load8(src + h * a.hd + d, x);
      reinterpret_cast<uint2*>(dst)[o / 8] = codes8(x, s);
    } else if constexpr ((STORE == STORE_F32) == (sizeof(In) == 4)) {
      // same type: copy the bits (8 elements: one or two 16-byte words)
      const uint4* s4 = reinterpret_cast<const uint4*>(src + h * a.hd + d);
      uint4* d4 = reinterpret_cast<uint4*>(dst + o * sizeof(In));
#pragma unroll
      for (int i = 0; i < static_cast<int>(sizeof(In)) / 2; ++i) d4[i] = s4[i];
    } else if constexpr (STORE == STORE_F32) {  // bf16 -> fp32, exact
      float x[8];
      load8(src + h * a.hd + d, x);
      float4* d4 = reinterpret_cast<float4*>(dst + o * 4);
      d4[0] = make_float4(x[0], x[1], x[2], x[3]);
      d4[1] = make_float4(x[4], x[5], x[6], x[7]);
    } else {  // fp32 -> bf16, round to nearest even
      float x[8];
      load8(src + h * a.hd + d, x);
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 p = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
        w[i] = *reinterpret_cast<const uint32_t*>(&p);
      }
      reinterpret_cast<uint4*>(dst)[o / 8] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

template <typename In, int STORE>
int launch(const WriteArgs& a, int n_rows, cudaStream_t stream) {
  const dim3 grid(n_rows, (a.units + THREADS - 1) / THREADS);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  paged_write_kernel<In, STORE><<<grid, THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename In>
int launch_store(const WriteArgs& a, int store, int n_rows, cudaStream_t stream) {
  switch (store) {
    case STORE_F32: return launch<In, STORE_F32>(a, n_rows, stream);
    case STORE_BF16: return launch<In, STORE_BF16>(a, n_rows, stream);
    case STORE_I8: return launch<In, STORE_I8>(a, n_rows, stream);
    case STORE_I4: return launch<In, STORE_I4>(a, n_rows, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

}  // namespace

extern "C" {

// The raw row entry (the JAX kernel's signature).  kv: (L, n_pages,
// page_size, row) in any dtype, row = vecs_per_row 16-byte words; rows:
// (n_rows, row) of the same dtype; pages, offsets: (n_rows,) int32.  All
// pointers 16-byte aligned.
int paged_write(void* kv, const void* rows, const int32_t* pages, const int32_t* offsets,
                int layer, int n_pages, int page_size, int n_rows, int vecs_per_row,
                cudaStream_t stream) {
  if (n_rows <= 0 || n_pages <= 0 || page_size <= 0 || vecs_per_row <= 0 || layer < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (misaligned(kv) || misaligned(rows)) return static_cast<int>(cudaErrorMisalignedAddress);
  WriteArgs a{};
  a.kv = kv;
  a.layer = layer, a.n_pages = n_pages, a.page_size = page_size;
  a.row_bytes = 16LL * vecs_per_row;
  a.units = vecs_per_row;
  a.k = rows;
  a.target.pages = pages, a.target.offsets = offsets;
  a.target.pages_step = a.target.offsets_step = 1;
  a.target.n_cols = 1;
  return launch<uint4, STORE_RAW>(a, n_rows, stream);
}

// The fused write of one layer: K and V (in_dtype IN_F32 / IN_BF16, each
// token's (n_kv, hd) block dense, hd % 8 == 0, 16-byte aligned rows) in the
// storage form `store` into kv[layer] at the rows' targets.  Flat form:
// pages/offsets (tables null), n_cols 1.  Block-table form: tables,
// positions and an optional pad mask (pages null).  The wrapper
// (ops/paged_write.py::paged_write_kv) checks shapes, strides and dtypes.
int paged_write_kv(void* kv, int layer, int n_pages, int page_size, int n_comb, int hd,
                   const void* k, const void* v, int in_dtype, int store,
                   long long k_sb, long long k_sn, long long v_sb, long long v_sn,
                   const float* k_scale, const float* v_scale, int k_scale_step,
                   int v_scale_step, int n_rows, int n_cols,
                   const void* pages, const void* offsets, long long pages_step,
                   long long offsets_step, const void* tables, long long table_stride,
                   int max_pages, const void* positions, long long pos_sb, long long pos_sn,
                   const bool* pad, long long pad_sb, long long pad_sn, int idx64,
                   cudaStream_t stream) {
  if (n_rows <= 0 || n_cols <= 0 || n_pages <= 0 || page_size <= 0 || layer < 0 ||
      n_comb <= 0 || hd <= 0 || hd % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((store == STORE_I8 || store == STORE_I4) && (k_scale == nullptr || v_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((tables == nullptr) == (pages == nullptr) || (tables && positions == nullptr) ||
      (pages && offsets == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (misaligned(kv) || misaligned(k) || misaligned(v))
    return static_cast<int>(cudaErrorMisalignedAddress);
  WriteArgs a{};
  a.kv = kv;
  a.layer = layer, a.n_pages = n_pages, a.page_size = page_size;
  const int out_size = store == STORE_F32 ? 4 : store == STORE_BF16 ? 2 : 1;
  a.row_bytes = static_cast<long long>(n_comb) * hd * out_size;
  a.units = n_comb * (hd / 8);
  a.k = k, a.v = v;
  a.k_sb = k_sb, a.k_sn = k_sn, a.v_sb = v_sb, a.v_sn = v_sn;
  a.k_scale = k_scale, a.v_scale = v_scale;
  a.k_scale_step = k_scale_step, a.v_scale_step = v_scale_step;
  a.n_comb = n_comb, a.hd = hd;
  Target& g = a.target;
  g.pages = pages, g.offsets = offsets, g.pages_step = pages_step, g.offsets_step = offsets_step;
  g.tables = tables, g.table_stride = table_stride, g.max_pages = max_pages;
  g.positions = positions, g.pos_sb = pos_sb, g.pos_sn = pos_sn;
  g.pad = pad, g.pad_sb = pad_sb, g.pad_sn = pad_sn;
  g.n_cols = n_cols, g.idx64 = idx64;
  if (in_dtype == IN_F32) return launch_store<float>(a, store, n_rows, stream);
  if (in_dtype == IN_BF16) return launch_store<__nv_bfloat16>(a, store, n_rows, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* gptq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
