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
//   (32 KB at hd 128) leave room for 5 blocks an SM, and at S = 4096 the
//   partials (hd + 2 floats per q head and split) stay under 13% of the
//   int4 rows' bytes.
// * Head dims 64, 96, 128, 192 and 256 (Llama, Phi-3-mini, DeepSeek-V3's
//   128 + 64, Gemma).  The
//   split's K and V tiles are dynamic shared memory (split_attention.cuh):
//   a bf16 pair at hd 256 is 65 KB, past the 48 KB a block may hold
//   without opting in.  The 64-key split and its partials' layout are the
//   same at every head dim.
// * Group counts.  A block serves GB q heads of each kv head it reads, GB
//   the largest divisor of groups = Hq/Hkv that is at most 8, so every
//   group count runs (Qwen2.5-7B's 7, GLM-4's 16).  Above 8 the group is
//   cut into groups/GB chunks, one block each, and a chunk's blocks read
//   the same K/V rows (from L2 after the first): at NH = 16 bf16 heads the
//   block's shared memory would pass 48 KB (ks 17 408, vs 16 384,
//   qs 8 192, sc 8 192, ps 4 096 bytes; at hd 256 qs alone doubles).
//   Heads never mix inside a block, so a head's output bits do not
//   depend on GB.
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
//   key halves added in order at hd 64; threads 96-127 idle at hd 96; two
//   d's, t and t + 128, at hd 256, and at hd 192 for threads 0-63), one
//   element of V per lane, p as a broadcast.  The split writes (m, l, acc[hd]) per q head to the scratch
//   the wrapper allocates.
// * Merge: a second kernel in the same C call (no tickets, no atomics, so
//   a launch is graph-capturable and bit-repeatable), one block per (slot,
//   q head), one thread per d: M = max over splits and the sink logit;
//   den = exp(sink - M) + Σ l_z exp(m_z - M), num = Σ acc_z exp(m_z - M),
//   in split order 0…n-1, empty splits skipped; out = num / den, or 0 for
//   a row with no visible key.  The sink joins exactly once, here.
//
// The scores, softmax, PV and merge are split_attention.cuh's, shared with
// K6 (csrc/paged_attention.cu); this file stages a slot's rows.
//
// The k-scale is folded into q by the caller and the v-scale applied to
// the output, so the kernel sees raw int8/int4 codes.
#include "split_attention.cuh"

namespace {

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
__global__ void __launch_bounds__(THREADS, (blocks_per_sm<MODE, HD, NH>()))
    split_kernel(Args a) {
  constexpr int GB = MODE == INT4 ? NH / 2 : NH;
  using T = Tile<MODE, HD>;
  constexpr int ROW = T::ROW, CPR = T::CPR, KROW = T::KROW;
  extern __shared__ __align__(16) unsigned char tiles[];  // T::BYTES
  unsigned char* ks = tiles;
  unsigned char* vs = tiles + KPS * KROW;
  __shared__ __align__(16) float qs[NH][HD];

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
  split_body<MODE, HD, NH>(tiles, qs, n, a.sm_scale, a.soft_cap, a.part_m, a.part_l,
                           a.part_acc, part);
}

// one block per (slot, q head), one thread per d
template <int HD>
__global__ void __launch_bounds__(HD) merge_kernel(Args a, int hq) {
  const int b = blockIdx.x, qh = blockIdx.y;
  const size_t base = (static_cast<size_t>(b) * hq + qh) * a.n_splits;
  const float o = merge_splits<HD>(a.part_m, a.part_l, a.part_acc, base, a.n_splits, a.sinks,
                                   qh, 1.0f);
  a.out[(static_cast<size_t>(b) * hq + qh) * HD + threadIdx.x] = __float2bfloat16_rn(o);
}

template <int MODE, int HD, int NH>
cudaError_t launch_one(const Args& a, cudaStream_t stream) {
  constexpr int SMEM = Tile<MODE, HD>::BYTES;
  cudaError_t err = allow_smem<split_kernel<MODE, HD, NH>, SMEM>();
  if (err != cudaSuccess) return err;
  split_kernel<MODE, HD, NH>
      <<<dim3(a.n_slots, a.hc * a.n_chunks, a.n_splits), THREADS, SMEM, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int hq = (MODE == INT4 ? 2 * a.hc : a.hc) * a.groups;
  merge_kernel<HD><<<dim3(a.n_slots, hq), HD, 0, stream>>>(a, hq);
  return cudaGetLastError();
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
    case 96: return static_cast<int>(launch_nh<MODE, 96>(a, stream));
    case 128: return static_cast<int>(launch_nh<MODE, 128>(a, stream));
    case 192: return static_cast<int>(launch_nh<MODE, 192>(a, stream));
    case 256: return static_cast<int>(launch_nh<MODE, 256>(a, stream));
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
// 64, 96, 128, 192 or 256; any Hq/Hkv.  Two kernels on `stream`: the splits, then the
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
