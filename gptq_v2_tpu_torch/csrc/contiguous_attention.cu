// K4 and K7: one-token decode attention over the contiguous KV cache, split
// over the keys (flash-decoding) with a fixed-order merge.
//
// K4 replaces gptq_v2_tpu/ops/contiguous_attention.py::_kernel (grid
// _call, entry contiguous_decode_attention): bf16 or int8 cache
// (L, B, S, Hkv, hd).  Plain PyTorch version:
// ops/contiguous_attention.py::contiguous_decode_attention_ref.
// K7 replaces ::_kernel_p4 (grid _call_p4, entry
// contiguous_decode_attention_p4): the head-pair nibble-packed int4 cache
// (L, B, S, Hkv/2, hd), byte [p, d] holding kv head p in its low nibble and
// kv head p + Hkv/2 in its high nibble, both sign-extended.  Plain version:
// ::contiguous_decode_attention_xla4.  The split-merge algebra in plain
// torch: ::contiguous_decode_attention_split_ref.
//
// Bound on the H100: bytes.  A decode step reads each visible K/V row once
// and does about NH operations per byte (NH q heads share a row), far below
// the card's ~20 fp32 operations per byte of HBM.  So the design is about
// blocks and bytes in flight:
//
// * Split.  One block per (slot b, kv head h, split z) for K4, per (slot b,
//   head pair p, split z) for K7; each serves every q head that reads its
//   rows: the `groups` GQA heads of h (K4), or those of p and of p + Hkv/2
//   (K7: each packed byte is read once for both nibbles).  A slot's visible
//   keys are [lo, hi], hi = min(pos, s_used - 1), lo raised by the sliding
//   window (j > pos - window) and the chunk (j // chunk == pos // chunk).
//   Split z holds keys [lo + 64 z, lo + 64 z + 63] ∩ [lo, hi].  Splits are
//   anchored at the slot's own lo, so a slot's split boundaries, and its
//   output bits, depend only on its own position, window and chunk: not on
//   B, s_bucket or the other slots.  The grid's split count comes from host
//   integers only, ceil(min(s_used, window, chunk) / 64); blocks past a
//   slot's range write an empty partial (m = -inf, l = 0) and return.
//   64 keys a split: Llama-2-7B's 16 head pairs at B = 1, S = 512 give 128
//   K7 blocks (256 for K4) on 132 SMs, a bf16 split's K and V rows
//   (32 KB at hd 128) fit static shared memory with room for 5 blocks an
//   SM, and at S = 4096 the partials (hd + 2 floats per q head and split)
//   stay under 13% of the int4 rows' bytes.
// * Group counts.  A block serves GB q heads of each kv head it reads, GB
//   the largest divisor of groups = Hq/Hkv that is at most 8, so every
//   group count runs (Qwen2.5-7B's 7, GLM-4's 16).  Above 8 the group is
//   cut into groups/GB chunks, one block each, and a chunk's blocks read
//   the same K/V rows (from L2 after the first): at NH = 16 bf16 heads the
//   block's static shared memory would pass 48 KB (ks 17 408, vs 16 384,
//   qs 8 192, sc 8 192, ps 4 096 bytes).  Heads never mix inside a block,
//   so a head's output bits do not depend on GB.
// * Bytes in flight.  The block stages its split's K rows and then its V
//   rows into shared memory with 16-byte cp.async, two commit groups, one
//   row per 256 (bf16) or 128 (int8, int4 pairs) bytes of the lanes: a
//   warp's step is sized by bytes, so narrower rows bring more keys a step,
//   and the whole split (up to 32 KB) is in flight at once.  Scores start
//   when K has landed, while V is still in flight.
// * Scores (fp32; bf16, int8 and int4 products are exact in fp32): two
//   threads per key, each over half of hd for all NH heads, K read from
//   rows padded by 16 bytes (conflict-free 16-byte reads of 8 keys at
//   once), q as fp32 in shared memory (a broadcast); the halves are added,
//   scaled and soft-capped.  Then per head an exact softmax over the split:
//   m = max, p = exp(s - m) in fp32, l = Σ p.  p stays fp32 for PV.
// * PV: each thread owns one d for all NH heads over the split's keys (two
//   key halves added in order at hd 64), one byte of V per lane, p as a
//   broadcast.  The split writes (m, l, acc[hd]) per q head to the scratch
//   the wrapper allocates.
// * Merge: a second kernel in the same C call (no tickets, no atomics, so
//   a launch is graph-capturable and bit-repeatable), one block per (slot,
//   q head), one thread per d: M = max over splits and the sink logit;
//   den = exp(sink - M) + Σ l_z exp(m_z - M), num = Σ acc_z exp(m_z - M),
//   in split order 0…n-1, empty splits skipped; out = num / den, or 0 for
//   a row with no visible key.  The sink joins exactly once, here.  The
//   max is a block reduction and each split's factor exp(m_z - M) is
//   formed once in shared memory, so only the in-order fold is serial, and
//   its loads of acc are issued 16 at a time ahead of the fold.
//
// The k-scale is folded into q by the caller and the v-scale applied to
// the output, so the kernel sees raw int8/int4 codes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int THREADS = 128;  // 4 warps
constexpr int KPS = 64;       // keys per split
static_assert(THREADS == 2 * KPS, "scores take two threads a key");

enum Mode { BF16 = 0, INT8 = 1, INT4 = 2 };

struct Args {
  const __nv_bfloat16* q;  // (B, Hq, hd)
  const unsigned char* k;  // (L, B, S_max, Hc, hd) of bf16 or int8
  const unsigned char* v;
  const int32_t* pos;      // (B,)
  const float* sinks;      // (Hq,) or null
  __nv_bfloat16* out;      // (B, Hq, hd)
  float* part_m;           // (B, Hq, n_splits)
  float* part_l;           // (B, Hq, n_splits)
  float* part_acc;         // (B, Hq, n_splits, hd)
  int layer, n_slots, s_max, s_used, hc, groups, window, chunk, n_splits;
  int n_chunks;  // blocks a kv head (pair): groups / GB
  float sm_scale, soft_cap;  // soft_cap <= 0: off
};

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

__device__ __forceinline__ void key_range(const Args& a, int b, int& lo, int& hi) {
  const int pos = a.pos[b];
  hi = min(pos, a.s_used - 1);
  lo = 0;
  if (a.window > 0) lo = max(lo, pos - a.window + 1);
  if (a.chunk > 0) lo = max(lo, (pos / a.chunk) * a.chunk);
}

// NH q heads per block: GB of the group of kv head h (K4), or GB of each of
// the pair's two groups (K7, low-nibble heads first); GB divides groups
template <int MODE, int HD, int NH>
__global__ void __launch_bounds__(THREADS) split_kernel(Args a) {
  constexpr int GB = MODE == INT4 ? NH / 2 : NH;
  constexpr int ROW = HD * (MODE == BF16 ? 2 : 1);  // bytes of one kv head's (pair's) row
  constexpr int CPR = ROW / 16;                     // 16-byte chunks a row
  constexpr int EPC = MODE == BF16 ? 8 : 16;        // d's a chunk
  constexpr int KROW = ROW + 16;                    // padded: 8 keys' chunk c in 8 bank groups
  constexpr int KG = THREADS / HD;                  // PV key groups: 1 (hd 128) or 2 (hd 64)
  __shared__ __align__(16) unsigned char ks[KPS * KROW];
  __shared__ __align__(16) unsigned char vs[KPS * ROW];
  __shared__ __align__(16) float qs[NH][HD];
  __shared__ float sc[2][NH][KPS];
  __shared__ __align__(16) float ps[KPS][NH];
  __shared__ float red[KG > 1 ? NH : 1][HD];

  const int b = blockIdx.x, h = blockIdx.y / a.n_chunks, z = blockIdx.z;
  const int g0 = (blockIdx.y % a.n_chunks) * GB;  // the chunk's first head of a group
  const int t = threadIdx.x;
  const int hq = (MODE == INT4 ? 2 * a.hc : a.hc) * a.groups;
  // global q head of local head i
  auto qhead = [&](int i) {
    if (MODE == INT4) return (h + (i / GB) * a.hc) * a.groups + g0 + i % GB;
    return h * a.groups + g0 + i;
  };
  auto part = [&](int i) {
    return (static_cast<size_t>(b) * hq + qhead(i)) * a.n_splits + z;
  };

  int lo, hi;
  key_range(a, b, lo, hi);
  const int j0 = lo + z * KPS;
  const int n = min(KPS, hi - j0 + 1);
  if (n <= 0) {  // past the slot's keys: an empty partial
    for (int i = t; i < NH; i += THREADS) {
      a.part_m[part(i)] = -INFINITY;
      a.part_l[part(i)] = 0.0f;
    }
    return;
  }

  const size_t key_stride = static_cast<size_t>(a.hc) * ROW;
  const size_t base =
      ((static_cast<size_t>(a.layer) * a.n_slots + b) * a.s_max + j0) * key_stride +
      static_cast<size_t>(h) * ROW;
  for (int c = t; c < n * CPR; c += THREADS) {  // chunk c % CPR of key c / CPR
    const size_t src = base + (c / CPR) * key_stride + (c % CPR) * 16;
    cp_async16(ks + (c / CPR) * KROW + (c % CPR) * 16, a.k + src);
  }
  cp_async_commit();
  for (int c = t; c < n * CPR; c += THREADS)
    cp_async16(vs + c * 16, a.v + base + (c / CPR) * key_stride + (c % CPR) * 16);
  cp_async_commit();
  for (int c = t; c < NH * HD; c += THREADS) {
    const size_t src = (static_cast<size_t>(b) * hq + qhead(c / HD)) * HD + c % HD;
    qs[c / HD][c % HD] = __bfloat162float(a.q[src]);
  }
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
          x = (sc[0][i][jj] + sc[1][i][jj]) * a.sm_scale;
          if (a.soft_cap > 0.0f) x = a.soft_cap * tanhf(x / a.soft_cap);
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
        a.part_m[part(i)] = mx;
        a.part_l[part(i)] = l;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // PV: thread (d, key group) for every head, keys in order
  {
    const int d = t % HD, kg = t / HD;
    const int k_end = min(n, (kg + 1) * (KPS / KG));
    float acc[NH];
#pragma unroll
    for (int i = 0; i < NH; ++i) acc[i] = 0.0f;
    for (int jj = kg * (KPS / KG); jj < k_end; ++jj) {
      float vlo, vhi = 0.0f;
      load_elem<MODE>(vs + jj * ROW + d * (MODE == BF16 ? 2 : 1), vlo, vhi);
#pragma unroll
      for (int i = 0; i < NH; ++i)
        acc[i] = fmaf(ps[jj][i], MODE == INT4 && i >= NH / 2 ? vhi : vlo, acc[i]);
    }
    if (KG > 1) {
      if (kg == 1) {
#pragma unroll
        for (int i = 0; i < NH; ++i) red[i][d] = acc[i];
      }
      __syncthreads();
      if (kg == 0) {
#pragma unroll
        for (int i = 0; i < NH; ++i) acc[i] += red[i][d];
      }
    }
    if (kg == 0) {
#pragma unroll
      for (int i = 0; i < NH; ++i) a.part_acc[part(i) * HD + d] = acc[i];
    }
  }
}

// one block per (slot, q head), one thread per d.  The max over the splits
// is a block reduction (exact in any order) whose loads also keep the
// first MERGE_Z splits' m and l in shared memory; each split's factor
// exp(m_z - M) is formed once there, MERGE_Z splits at a time; then every
// thread folds l_z and acc_z[d] in split order, its loads of acc issued
// MERGE_BATCH at a time ahead of their fold.
constexpr int MERGE_Z = 256;
constexpr int MERGE_BATCH = 16;

template <int HD>
__global__ void __launch_bounds__(HD) merge_kernel(Args a, int hq) {
  __shared__ float fz[MERGE_Z], lz[MERGE_Z], wmax[HD / 32];
  const int b = blockIdx.x, qh = blockIdx.y, d = threadIdx.x;
  const size_t base = (static_cast<size_t>(b) * hq + qh) * a.n_splits;
  float mx = -INFINITY;
  for (int z = d; z < a.n_splits; z += HD) {
    const float m = a.part_m[base + z];
    mx = fmaxf(mx, m);
    if (z < MERGE_Z) {  // read back by this thread for the first chunk
      fz[z] = m;
      lz[z] = a.part_l[base + z];
    }
  }
  mx = warp_max(mx);
  if (d % 32 == 0) wmax[d / 32] = mx;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < HD / 32; ++w) mx = fmaxf(mx, wmax[w]);
  const float sink = a.sinks != nullptr ? a.sinks[qh] : -INFINITY;
  mx = fmaxf(mx, sink);
  float den = a.sinks != nullptr ? expf(sink - mx) : 0.0f, num = 0.0f;
  for (int z0 = 0; z0 < a.n_splits; z0 += MERGE_Z) {
    const int nz = min(MERGE_Z, a.n_splits - z0);
    if (z0 > 0) __syncthreads();  // the previous chunk's factors are read
    for (int z = d; z < nz; z += HD) {
      const float m = z0 == 0 ? fz[z] : a.part_m[base + z0 + z];
      if (z0 > 0) lz[z] = a.part_l[base + z0 + z];
      // an empty split adds nothing; its acc was never written
      fz[z] = m == -INFINITY ? 0.0f : expf(m - mx);
    }
    __syncthreads();
    const float* acc = a.part_acc + (base + z0) * HD + d;
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
  a.out[(static_cast<size_t>(b) * hq + qh) * HD + d] =
      __float2bfloat16_rn(den > 0.0f ? num / den : 0.0f);
}

template <int MODE, int HD, int NH>
cudaError_t launch_one(const Args& a, cudaStream_t stream) {
  split_kernel<MODE, HD, NH>
      <<<dim3(a.n_slots, a.hc * a.n_chunks, a.n_splits), THREADS, 0, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int hq = (MODE == INT4 ? 2 * a.hc : a.hc) * a.groups;
  merge_kernel<HD><<<dim3(a.n_slots, hq), HD, 0, stream>>>(a, hq);
  return cudaGetLastError();
}

// heads per block: GB = the largest divisor of groups up to 8, doubled
// for the int4 pairs
int heads_per_block(int groups) {
  int gb = 8;
  while (groups % gb) --gb;
  return gb;
}

template <int MODE, int HD>
cudaError_t launch_nh(Args a, cudaStream_t stream) {
  constexpr int F = MODE == INT4 ? 2 : 1;
  const int gb = heads_per_block(a.groups);
  a.n_chunks = a.groups / gb;
  switch (gb) {
    case 1: return launch_one<MODE, HD, F>(a, stream);
    case 2: return launch_one<MODE, HD, 2 * F>(a, stream);
    case 3: return launch_one<MODE, HD, 3 * F>(a, stream);
    case 4: return launch_one<MODE, HD, 4 * F>(a, stream);
    case 5: return launch_one<MODE, HD, 5 * F>(a, stream);
    case 6: return launch_one<MODE, HD, 6 * F>(a, stream);
    case 7: return launch_one<MODE, HD, 7 * F>(a, stream);
    case 8: return launch_one<MODE, HD, 8 * F>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int MODE>
int launch(const Args& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 64: return static_cast<int>(launch_nh<MODE, 64>(a, stream));
    case 128: return static_cast<int>(launch_nh<MODE, 128>(a, stream));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the split count the grid needs: every slot's visible keys fit in
// min(s_used, window, chunk)
int splits_for(int s_used, int window, int chunk) {
  int span = s_used;
  if (window > 0) span = span < window ? span : window;
  if (chunk > 0) span = span < chunk ? span : chunk;
  return (span + KPS - 1) / KPS;
}

int make_args(Args& a, const void* q, const void* k, const void* v, const int32_t* pos,
              const float* sinks, void* out, void* scratch, int layer, int n_slots,
              int s_max, int s_used, int hc, int groups, int n_kv, int n_splits,
              float sm_scale, int window, int chunk, float soft_cap) {
  if (s_used <= 0 || s_used > s_max || hc <= 0 || groups <= 0 || n_slots <= 0 ||
      n_splits != splits_for(s_used, window, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t parts = static_cast<size_t>(n_slots) * n_kv * groups * n_splits;
  float* s = static_cast<float*>(scratch);
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const unsigned char*>(k);
  a.v = static_cast<const unsigned char*>(v);
  a.pos = pos;
  a.sinks = sinks;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.part_m = s;
  a.part_l = s + parts;
  a.part_acc = s + 2 * parts;
  a.layer = layer;
  a.n_slots = n_slots;
  a.s_max = s_max;
  a.s_used = s_used;
  a.hc = hc;
  a.groups = groups;
  a.window = window;
  a.chunk = chunk;
  a.n_splits = n_splits;
  a.n_chunks = 1;
  a.sm_scale = sm_scale;
  a.soft_cap = soft_cap;
  return 0;
}

}  // namespace

extern "C" {

// K4.  q, out: (B, Hq, hd) bf16; k, v: (L, B, s_max, Hkv, hd) bf16
// (int8 = 0) or int8 (int8 = 1), 16-byte aligned; pos: (B,) int32, each
// < s_used; sinks: (Hq,) fp32 or null; scratch: B·Hq·n_splits·(hd + 2)
// fp32, n_splits = ceil(min(s_used, window, chunk) / 64) (refused
// otherwise).  window/chunk 0 and soft_cap 0 switch those off.  hd must be
// 64 or 128; any Hq/Hkv.  Two kernels on `stream`: the splits, then the
// merge.
int contiguous_attention(const void* q, const void* k, const void* v, const int32_t* pos,
                         const float* sinks, void* out, void* scratch, int layer,
                         int n_slots, int s_max, int s_used, int n_kv, int groups, int hd,
                         int n_splits, int int8, float sm_scale, int window, int chunk,
                         float soft_cap, cudaStream_t stream) {
  Args a;
  const int err = make_args(a, q, k, v, pos, sinks, out, scratch, layer, n_slots, s_max,
                            s_used, n_kv, groups, n_kv, n_splits, sm_scale, window, chunk,
                            soft_cap);
  if (err) return err;
  return int8 ? launch<INT8>(a, hd, stream) : launch<BF16>(a, hd, stream);
}

// K7.  k, v: (L, B, s_max, Hkv/2, hd) int8 head-pair nibble-packed;
// n_pairs = Hkv/2; the rest as K4.
int contiguous_attention_p4(const void* q, const void* k, const void* v,
                            const int32_t* pos, const float* sinks, void* out, void* scratch,
                            int layer, int n_slots, int s_max, int s_used, int n_pairs,
                            int groups, int hd, int n_splits, float sm_scale, int window,
                            int chunk, float soft_cap, cudaStream_t stream) {
  Args a;
  const int err = make_args(a, q, k, v, pos, sinks, out, scratch, layer, n_slots, s_max,
                            s_used, n_pairs, groups, 2 * n_pairs, n_splits, sm_scale,
                            window, chunk, soft_cap);
  if (err) return err;
  return launch<INT4>(a, hd, stream);
}

const char* gptq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
