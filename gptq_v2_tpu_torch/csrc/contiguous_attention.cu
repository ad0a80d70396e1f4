// K4 and K7: one-token decode attention over the contiguous KV cache.
//
// K4 replaces gptq_v2_tpu/ops/contiguous_attention.py::_kernel (grid
// _call, entry contiguous_decode_attention): bf16 or int8 cache
// (L, B, S, Hkv, hd).  Plain PyTorch version:
// ops/contiguous_attention.py::contiguous_decode_attention_ref.
// K7 replaces ::_kernel_p4 (grid _call_p4, entry
// contiguous_decode_attention_p4): the head-pair nibble-packed int4 cache
// (L, B, S, Hkv/2, hd), byte [p, d] holding kv head p in its low nibble and
// kv head p + Hkv/2 in its high nibble, both sign-extended.  Plain version:
// ::contiguous_decode_attention_xla4.
//
// One block per (slot b, kv head h) for K4, per (slot b, head pair p) for
// K7, so one block serves every q head that reads the streamed rows: the
// `groups` GQA heads of h (K4), or those of p and of p + Hkv/2 (K7: the
// packed bytes are read once for both nibbles).  The k-scale is folded into
// q by the caller and the v-scale applied to the output, so the kernel sees
// raw int8/int4 codes.  Only the keys a query can see are read: positions
// [lo, hi] with hi = min(pos, s - 1) and lo raised by the sliding window
// (j > pos - window) and the chunk (j // chunk == pos // chunk).  Four warps
// split those keys, four consecutive keys per warp and step, each lane
// holding hd/32 elements of a row; scores are fp32 (bf16 and int8 products
// are exact in fp32), scaled, soft-capped, and folded into a per-warp online
// softmax (running max m, sum l, and the fp32 p·V accumulator).  The four
// warps' (m, l, acc) are merged in shared memory; a sink logit joins the
// merge as exp(sink - M) in the denominator.  Unlike the TPU kernel, p stays
// fp32 for the PV product.  The TPU kernel keeps a whole head row resident
// when there are sinks; here each block owns whole heads, so sinks need no
// such constraint.
//
// Bound on the H100: bytes (each visible K/V row read once; a decode step
// does ~2 operations per byte read).  The simple design reads rows with one
// coalesced 32-lane access per row and keeps 8 rows in flight per warp; its
// limit is the few blocks at small batch (B·Hkv blocks), which a split of
// the keys over blocks (flash-decoding) would lift.
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
  const __nv_bfloat16* q;  // (B, Hq, hd)
  const void* k;           // (L, B, S_max, Hc, hd)
  const void* v;
  const int32_t* pos;      // (B,)
  const float* sinks;      // (Hq,) or null
  __nv_bfloat16* out;      // (B, Hq, hd)
  int layer, n_slots, s_max, s_used, hc, groups, window, chunk;
  float sm_scale, soft_cap;  // soft_cap <= 0: off
};

template <int N>
struct alignas(N) Raw {
  unsigned char b[N];
};

// one lane's EPL elements of a cache row, as floats; for INT4 the low
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

// NH q heads per block: `groups` (K4) or 2·groups (K7, low-nibble heads first)
template <int MODE, int EPL, int NH>
__global__ void __launch_bounds__(THREADS) decode_attention_kernel(Args a) {
  constexpr int HD = 32 * EPL;
  __shared__ float sm_m[WARPS][NH];
  __shared__ float sm_l[WARPS][NH];
  __shared__ float sm_acc[WARPS][NH][HD];

  const int b = blockIdx.x, h = blockIdx.y;  // slot; kv head (K4) or pair (K7)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d0 = lane * EPL;
  const int n_kv = MODE == INT4 ? 2 * a.hc : a.hc;
  const int hq = n_kv * a.groups;
  // global q head of local head i
  auto qhead = [&](int i) {
    if (MODE == INT4) {
      const int half = i / a.groups;
      return (h + half * a.hc) * a.groups + i % a.groups;
    }
    return h * a.groups + i;
  };

  float qr[NH][EPL];
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    const __nv_bfloat16* qp = a.q + (static_cast<size_t>(b) * hq + qhead(i)) * HD + d0;
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[i][e] = __bfloat162float(qp[e]);
  }

  const int pos = a.pos[b];
  const int hi_key = min(pos, a.s_used - 1);
  int lo_key = 0;
  if (a.window > 0) lo_key = max(lo_key, pos - a.window + 1);
  if (a.chunk > 0) lo_key = max(lo_key, (pos / a.chunk) * a.chunk);

  float m[NH], l[NH], acc[NH][EPL];
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[i][e] = 0.0f;
  }

  const size_t row_stride = static_cast<size_t>(a.hc) * HD;
  const size_t slot_base =
      ((static_cast<size_t>(a.layer) * a.n_slots + b) * a.s_max) * row_stride +
      static_cast<size_t>(h) * HD + d0;
  for (int j0 = lo_key + warp * KPI; j0 <= hi_key; j0 += WARPS * KPI) {
    float klo[KPI][EPL], khi[KPI][EPL], vlo[KPI][EPL], vhi[KPI][EPL];
#pragma unroll
    for (int u = 0; u < KPI; ++u) {
      const int j = min(j0 + u, hi_key);  // rows past hi_key are masked below
      const size_t off = slot_base + static_cast<size_t>(j) * row_stride;
      load_row<MODE, EPL>(a.k, off, klo[u], khi[u]);
      load_row<MODE, EPL>(a.v, off, vlo[u], vhi[u]);
    }
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      const bool upper = MODE == INT4 && i >= NH / 2;
      float s[KPI];
      float smax = m[i];
#pragma unroll
      for (int u = 0; u < KPI; ++u) {
        float part = 0.0f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part = fmaf(qr[i][e], upper ? khi[u][e] : klo[u][e], part);
        float sc = warp_sum(part) * a.sm_scale;
        if (a.soft_cap > 0.0f) sc = a.soft_cap * tanhf(sc / a.soft_cap);
        s[u] = j0 + u <= hi_key ? sc : -INFINITY;
        smax = fmaxf(smax, s[u]);
      }
      const float corr = expf(m[i] - smax);
      l[i] *= corr;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[i][e] *= corr;
#pragma unroll
      for (int u = 0; u < KPI; ++u) {
        const float p = expf(s[u] - smax);
        l[i] += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[i][e] = fmaf(p, upper ? vhi[u][e] : vlo[u][e], acc[i][e]);
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
    const float sink = a.sinks != nullptr ? a.sinks[qhead(i)] : -INFINITY;
    mx = fmaxf(mx, sink);
    float den = a.sinks != nullptr ? expf(sink - mx) : 0.0f, num = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = sm_m[w][i] == -INFINITY ? 0.0f : expf(sm_m[w][i] - mx);
      den = fmaf(sm_l[w][i], f, den);
      num = fmaf(sm_acc[w][i][d], f, num);
    }
    a.out[(static_cast<size_t>(b) * hq + qhead(i)) * HD + d] =
        __float2bfloat16_rn(den > 0.0f ? num / den : 0.0f);
  }
}

template <int MODE, int EPL, int NH>
cudaError_t launch_one(const Args& a, cudaStream_t stream) {
  decode_attention_kernel<MODE, EPL, NH><<<dim3(a.n_slots, a.hc), THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

// heads per block: groups ∈ {1, 2, 4, 8}, doubled for the int4 pairs
template <int MODE, int EPL>
cudaError_t launch_nh(const Args& a, int groups, cudaStream_t stream) {
  constexpr int F = MODE == INT4 ? 2 : 1;
  switch (groups) {
    case 1: return launch_one<MODE, EPL, F>(a, stream);
    case 2: return launch_one<MODE, EPL, 2 * F>(a, stream);
    case 4: return launch_one<MODE, EPL, 4 * F>(a, stream);
    case 8: return launch_one<MODE, EPL, 8 * F>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int MODE>
int launch(const Args& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 64: return static_cast<int>(launch_nh<MODE, 2>(a, a.groups, stream));
    case 128: return static_cast<int>(launch_nh<MODE, 4>(a, a.groups, stream));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

Args make_args(const void* q, const void* k, const void* v, const int32_t* pos,
               const float* sinks, void* out, int layer, int n_slots, int s_max,
               int s_used, int hc, int groups, float sm_scale, int window, int chunk,
               float soft_cap) {
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = k;
  a.v = v;
  a.pos = pos;
  a.sinks = sinks;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.layer = layer;
  a.n_slots = n_slots;
  a.s_max = s_max;
  a.s_used = s_used;
  a.hc = hc;
  a.groups = groups;
  a.window = window;
  a.chunk = chunk;
  a.sm_scale = sm_scale;
  a.soft_cap = soft_cap;
  return a;
}

}  // namespace

extern "C" {

// K4.  q, out: (B, Hq, hd) bf16; k, v: (L, B, s_max, Hkv, hd) bf16
// (int8 = 0) or int8 (int8 = 1); pos: (B,) int32, each < s_used; sinks:
// (Hq,) fp32 or null.  window/chunk 0 and soft_cap 0 switch those off.
// hd must be 64 or 128 and Hq/Hkv 1, 2, 4 or 8.
int contiguous_attention(const void* q, const void* k, const void* v, const int32_t* pos,
                         const float* sinks, void* out, int layer, int n_slots,
                         int s_max, int s_used, int n_kv, int groups, int hd, int int8,
                         float sm_scale, int window, int chunk, float soft_cap,
                         cudaStream_t stream) {
  if (s_used <= 0 || s_used > s_max || n_kv <= 0 || groups <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(q, k, v, pos, sinks, out, layer, n_slots, s_max, s_used, n_kv,
                     groups, sm_scale, window, chunk, soft_cap);
  return int8 ? launch<INT8>(a, hd, stream) : launch<BF16>(a, hd, stream);
}

// K7.  k, v: (L, B, s_max, Hkv/2, hd) int8 head-pair nibble-packed;
// n_pairs = Hkv/2; the rest as K4.
int contiguous_attention_p4(const void* q, const void* k, const void* v,
                            const int32_t* pos, const float* sinks, void* out, int layer,
                            int n_slots, int s_max, int s_used, int n_pairs, int groups,
                            int hd, float sm_scale, int window, int chunk,
                            float soft_cap, cudaStream_t stream) {
  if (s_used <= 0 || s_used > s_max || n_pairs <= 0 || groups <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(q, k, v, pos, sinks, out, layer, n_slots, s_max, s_used, n_pairs,
                     groups, sm_scale, window, chunk, soft_cap);
  return launch<INT4>(a, hd, stream);
}

const char* gptq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
