// K6: ragged paged attention -- mixed prefill and decode rows over the page
// pool.
//
// Replaces gptq_v2_tpu/ops/_ragged_sink_kernel.py::ragged_paged_attention_kernel
// (grid and pl.pallas_call in ragged_paged_attention), which also stands in
// for upstream jax.experimental...ragged_paged_attention (the same function
// with no sinks).  Plain PyTorch version:
// ops/paged_attention.py::paged_ragged_attention_reference.
//
// Inputs: q (T, Hq, hd) bf16, rows grouped by sequence: sequence i owns rows
// [cu[i], cu[i+1]) for i < num_seqs, the last of them at position
// kv_lens[i] - 1; the pool (P, ps, C, hd), C = 2·Hkv, K of kv head h at
// combined index 2h and V at 2h+1, bf16 or int8 -- or, for int4, C = Hkv
// with combined index 2p holding K and 2p+1 holding V of the adjacent head
// pair (2p, 2p+1), head 2p in the low nibble; block tables (S, pps): key j
// of sequence i sits at page tables[i, j / ps], offset j % ps.
//
// One block per (query row t, unit u), a unit being a kv head (bf16, int8)
// or an adjacent int4 pair, whose bytes are read once for both heads as K7
// does.  The block serves every q head that reads the unit's rows: the
// `groups` GQA heads of kv head u, or the 2·groups heads of the pair --
// contiguous q heads in both cases.  The block finds its sequence by a
// binary search over cu[0..num_seqs]; rows at or past cu[num_seqs] write
// zeros (the plain version zeroes their probabilities).  The row's position
// is tok_pos = kv_lens[seq] - n_new + local, and only keys j in
// [lo, min(tok_pos, kv_lens[seq] - 1)] are read, lo raised by the sliding
// window (j > tok_pos - window): causal inside the sequence's new run.
// Four warps split those keys four at a time, each lane holding hd/32
// elements of a row; scores are fp32 (bf16 and int8 products are exact in
// fp32), scaled by sm_scale·k_scale, soft-capped, and folded into a per-warp
// online softmax (running max, sum, fp32 p·V accumulator); the warps merge
// in shared memory with the sink logit in the denominator, and the output
// is scaled by v_scale.  Scalar int8 k/v scales arrive as arguments, as in
// the TPU kernel; per-head int4 scales are folded outside
// (serving/decode.py::fold_paged_kv_scales) and arrive as 1.0.  Unlike the
// TPU kernel and the plain version, p stays fp32 for the PV product.
//
// Bound on the H100: bytes -- the visible K/V rows of every query row, at
// ~2 operations per byte.  The simple design re-reads a prefill chunk's keys
// once per row of the chunk (a 64-row chunk reads its prefix 64 times), and
// at small batch has few blocks (T·Hkv).  The redesign that removes both,
// for a later PR: tiles of rows of one sequence sharing each K/V page in
// shared memory, QKᵀ and PV on the tensor cores (wgmma), and a split of
// long key ranges over blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int KPI = 4;  // keys per warp and step

enum Mode { BF16 = 0, INT8 = 1, INT4 = 2 };

struct Args {
  const __nv_bfloat16* q;  // (T, Hq, hd)
  const void* kv;          // (P, ps, C, hd)
  const int32_t* kv_lens;  // (S,)
  const int32_t* tables;   // (S, pps)
  const int32_t* cu;       // (S + 1,)
  const int32_t* num_seqs;  // (1,)
  const float* sinks;      // (Hq,) or null
  __nv_bfloat16* out;      // (T, Hq, hd)
  int n_seqs, pages_per_seq, page_size, n_units, groups, window;
  float qk_scale, v_scale, soft_cap;  // soft_cap <= 0: off
};

template <int N>
struct alignas(N) Raw {
  unsigned char b[N];
};

// one lane's EPL elements of a pool row, as floats; for INT4 the low
// nibbles go to lo and the high nibbles to hi
template <int MODE, int EPL>
__device__ __forceinline__ void load_row(const void* base, size_t off, float (&lo)[EPL],
                                         float (&hi)[EPL]) {
  if (MODE == BF16) {
    Raw<EPL * 2> r = *reinterpret_cast<const Raw<EPL * 2>*>(
        static_cast<const __nv_bfloat16*>(base) + off);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(r.b);
#pragma unroll
    for (int e = 0; e < EPL; ++e) lo[e] = __bfloat162float(h[e]);
  } else {
    Raw<EPL> r = *reinterpret_cast<const Raw<EPL>*>(static_cast<const int8_t*>(base) + off);
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      int x = static_cast<int>(static_cast<signed char>(r.b[e]));
      if (MODE == INT8) {
        lo[e] = static_cast<float>(x);
      } else {
        lo[e] = static_cast<float>(static_cast<int>(static_cast<unsigned>(x) << 28) >> 28);
        hi[e] = static_cast<float>(x >> 4);
      }
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// NH q heads per block: `groups`, or 2·groups for an int4 pair (the low
// nibble's head first)
template <int MODE, int EPL, int NH>
__global__ void __launch_bounds__(THREADS) paged_attention_kernel(Args a) {
  constexpr int HD = 32 * EPL;
  __shared__ float sm_m[WARPS][NH];
  __shared__ float sm_l[WARPS][NH];
  __shared__ float sm_acc[WARPS][NH][HD];

  const int t = blockIdx.x, u = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d0 = lane * EPL;
  const int hq = (MODE == INT4 ? 2 * a.n_units : a.n_units) * a.groups;
  const size_t head0 = static_cast<size_t>(t) * hq + static_cast<size_t>(u) * NH;

  const int n_seqs = min(a.num_seqs[0], a.n_seqs);
  if (n_seqs <= 0 || t >= a.cu[n_seqs]) {  // a pad row
    for (int idx = threadIdx.x; idx < NH * HD; idx += THREADS)
      a.out[head0 * HD + idx] = __float2bfloat16_rn(0.0f);
    return;
  }
  int lo = 0, hi = n_seqs - 1;  // the last sequence whose rows start at or before t
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (a.cu[mid] <= t) lo = mid;
    else hi = mid - 1;
  }
  const int seq = lo;
  const int n_new = a.cu[seq + 1] - a.cu[seq];
  const int kv_len = a.kv_lens[seq];
  const int tok_pos = kv_len - n_new + (t - a.cu[seq]);
  const int hi_key = min(min(tok_pos, kv_len - 1), a.pages_per_seq * a.page_size - 1);
  const int lo_key = a.window > 0 ? max(0, tok_pos - a.window + 1) : 0;

  float qr[NH][EPL];
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    const __nv_bfloat16* qp = a.q + (head0 + i) * HD + d0;
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[i][e] = __bfloat162float(qp[e]);
  }

  float m[NH], l[NH], acc[NH][EPL];
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[i][e] = 0.0f;
  }

  const int32_t* table = a.tables + static_cast<size_t>(seq) * a.pages_per_seq;
  const size_t row_stride = static_cast<size_t>(2 * a.n_units) * HD;
  const size_t page_stride = static_cast<size_t>(a.page_size) * row_stride;
  const size_t k_off = static_cast<size_t>(2 * u) * HD + d0;  // V follows at + HD
  for (int j0 = lo_key + warp * KPI; j0 <= hi_key; j0 += WARPS * KPI) {
    float klo[KPI][EPL], khi[KPI][EPL], vlo[KPI][EPL], vhi[KPI][EPL];
#pragma unroll
    for (int s = 0; s < KPI; ++s) {
      const int j = min(j0 + s, hi_key);  // keys past hi_key are masked below
      const size_t off = static_cast<size_t>(table[j / a.page_size]) * page_stride +
                         static_cast<size_t>(j % a.page_size) * row_stride + k_off;
      load_row<MODE, EPL>(a.kv, off, klo[s], khi[s]);
      load_row<MODE, EPL>(a.kv, off + HD, vlo[s], vhi[s]);
    }
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      const bool upper = MODE == INT4 && i >= NH / 2;
      float sc[KPI];
      float smax = m[i];
#pragma unroll
      for (int s = 0; s < KPI; ++s) {
        float part = 0.0f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part = fmaf(qr[i][e], upper ? khi[s][e] : klo[s][e], part);
        float x = warp_sum(part) * a.qk_scale;
        if (a.soft_cap > 0.0f) x = a.soft_cap * tanhf(x / a.soft_cap);
        sc[s] = j0 + s <= hi_key ? x : -INFINITY;
        smax = fmaxf(smax, sc[s]);
      }
      const float corr = expf(m[i] - smax);
      l[i] *= corr;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[i][e] *= corr;
#pragma unroll
      for (int s = 0; s < KPI; ++s) {
        const float p = expf(sc[s] - smax);
        l[i] += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[i][e] = fmaf(p, upper ? vhi[s][e] : vlo[s][e], acc[i][e]);
      }
      m[i] = smax;
    }
  }

#pragma unroll
  for (int i = 0; i < NH; ++i) {
    if (lane == 0) {
      sm_m[warp][i] = m[i];
      sm_l[warp][i] = l[i];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][i][d0 + e] = acc[i][e];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < NH * HD; idx += THREADS) {
    const int i = idx / HD, d = idx % HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w][i]);
    const float sink = a.sinks != nullptr ? a.sinks[head0 % hq + i] : -INFINITY;
    mx = fmaxf(mx, sink);
    float den = a.sinks != nullptr ? expf(sink - mx) : 0.0f, num = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = sm_m[w][i] == -INFINITY ? 0.0f : expf(sm_m[w][i] - mx);
      den = fmaf(sm_l[w][i], f, den);
      num = fmaf(sm_acc[w][i][d], f, num);
    }
    a.out[(head0 + i) * HD + d] =
        __float2bfloat16_rn(den > 0.0f ? num / den * a.v_scale : 0.0f);
  }
}

template <int MODE, int EPL, int NH>
cudaError_t launch_one(const Args& a, int n_rows, cudaStream_t stream) {
  paged_attention_kernel<MODE, EPL, NH><<<dim3(n_rows, a.n_units), THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

// heads per block: groups ∈ {1, 2, 4, 8}, doubled for the int4 pairs
template <int MODE, int EPL>
cudaError_t launch_nh(const Args& a, int n_rows, cudaStream_t stream) {
  constexpr int F = MODE == INT4 ? 2 : 1;
  switch (a.groups) {
    case 1: return launch_one<MODE, EPL, F>(a, n_rows, stream);
    case 2: return launch_one<MODE, EPL, 2 * F>(a, n_rows, stream);
    case 4: return launch_one<MODE, EPL, 4 * F>(a, n_rows, stream);
    case 8: return launch_one<MODE, EPL, 8 * F>(a, n_rows, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int MODE>
cudaError_t launch_hd(const Args& a, int n_rows, int hd, cudaStream_t stream) {
  switch (hd) {
    case 64: return launch_nh<MODE, 2>(a, n_rows, stream);
    case 128: return launch_nh<MODE, 4>(a, n_rows, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K6.  q, out: (n_rows, Hq, hd) bf16; kv: (P, page_size, 2·n_units, hd)
// bf16 (mode 0), int8 (mode 1) or adjacent-pair int4 (mode 2), n_units =
// Hkv (modes 0, 1) or Hkv/2 (mode 2); kv_lens: (n_seqs,), tables: (n_seqs,
// pages_per_seq), cu: (n_seqs + 1,), num_seqs: (1,), all int32; sinks: (Hq,)
// fp32 or null.  qk_scale = sm_scale·k_scale; window 0 and soft_cap 0
// switch those off.  hd must be 64 or 128 and Hq/Hkv 1, 2, 4 or 8.
int paged_attention(const void* q, const void* kv, const int32_t* kv_lens,
                    const int32_t* tables, const int32_t* cu, const int32_t* num_seqs,
                    const float* sinks, void* out, int n_rows, int n_seqs, int pages_per_seq,
                    int page_size, int n_units, int groups, int hd, int mode, float qk_scale,
                    float v_scale, float soft_cap, int window, cudaStream_t stream) {
  if (n_rows <= 0 || n_seqs <= 0 || pages_per_seq <= 0 || page_size <= 0 || n_units <= 0 ||
      groups <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.kv = kv;
  a.kv_lens = kv_lens;
  a.tables = tables;
  a.cu = cu;
  a.num_seqs = num_seqs;
  a.sinks = sinks;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.n_seqs = n_seqs;
  a.pages_per_seq = pages_per_seq;
  a.page_size = page_size;
  a.n_units = n_units;
  a.groups = groups;
  a.window = window;
  a.qk_scale = qk_scale;
  a.v_scale = v_scale;
  a.soft_cap = soft_cap;
  switch (mode) {
    case BF16: return static_cast<int>(launch_hd<BF16>(a, n_rows, hd, stream));
    case INT8: return static_cast<int>(launch_hd<INT8>(a, n_rows, hd, stream));
    case INT4: return static_cast<int>(launch_hd<INT4>(a, n_rows, hd, stream));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* gptq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
