// K6: ragged paged attention -- mixed prefill and decode rows over the page
// pool, split over the keys (flash-decoding) with a fixed-order merge.
//
// Replaces gptq_v2_tpu/ops/_ragged_sink_kernel.py::ragged_paged_attention_kernel
// (grid and pl.pallas_call in ragged_paged_attention), which also stands in
// for upstream jax.experimental...ragged_paged_attention (the same function
// with no sinks).  Plain PyTorch version:
// ops/paged_attention.py::paged_ragged_attention_reference; the split-merge
// algebra in plain torch: ::paged_ragged_attention_split_ref.
//
// Inputs: q (T, Hq, hd) bf16, rows grouped by sequence: sequence i owns rows
// [cu[i], cu[i+1]) for i < num_seqs, the last of them at position
// kv_lens[i] - 1; the pool (P, ps, C, hd), C = 2·Hkv, K of kv head h at
// combined index 2h and V at 2h+1, bf16 or int8 -- or, for int4, C = Hkv
// with combined index 2p holding K and 2p+1 holding V of the adjacent head
// pair (2p, 2p+1), head 2p in the low nibble; block tables (S, pps): key j
// of sequence i sits at page tables[i, j / ps], offset j % ps.
//
// Bound on the H100: bytes.  A row reads each visible K/V row of its
// sequence once and does about NH operations per byte (NH q heads share a
// row), far below the card's ~20 fp32 operations per byte of HBM.  So the
// design is about blocks and bytes in flight:
//
// * Split.  One block per (query row t, unit u, split z), a unit being a kv
//   head (bf16, int8) or an adjacent int4 pair, whose bytes are read once
//   for both heads.  The block serves every q head that reads the unit's
//   rows: the `groups` GQA heads of kv head u, or the 2·groups heads of the
//   pair (cut into chunks above 8 a group, below).  The block finds its
//   sequence in one round trip: thread i loads cu[i], cu[i+1] and
//   kv_lens[i] and the thread whose run holds t publishes them; rows at or
//   past cu[num_seqs] (pad rows) have no sequence.  The row's position is
//   tok_pos = kv_lens[seq] - n_new + local and its visible keys are
//   [lo, hi], hi = min(tok_pos, kv_lens[seq] - 1, pps·ps - 1), lo raised by
//   the sliding window (j > tok_pos - window): causal inside the
//   sequence's new run.  Split z holds keys [lo + 64 z, lo + 64 z + 63] ∩
//   [lo, hi].  Splits are anchored at the row's own lo, so a row's split
//   boundaries, and its output bits, depend only on its own sequence,
//   position and window: not on T, the other sequences or the table width.
//   The grid's split count comes from host integers only,
//   ceil(min(pps·ps, window) / 64); a block past its row's range (and
//   every block of a pad row) writes an empty partial (m = -inf, l = 0)
//   and returns.  At 64 keys a split, Llama-2-7B's B = 1 decode at S = 512
//   launches 256 blocks (32 before the split) on 132 SMs.
// * Group counts.  A block serves GB q heads of each kv head of its unit,
//   GB the largest divisor of groups = Hq/Hkv that is at most 8, so every
//   group count runs (Qwen2.5-7B's 7, GLM-4's 16).  Above 8 the group is
//   cut into groups/GB chunks, one block each (a bf16 block at NH = 16
//   would pass 48 KB of shared memory); a chunk's blocks read the
//   same rows.  Heads never mix inside a block, so a head's output bits do
//   not depend on GB.
// * Bytes in flight.  The split's page ids (at most 5 for 16-row pages: 64
//   keys anchored off a page boundary) are read from the block table once,
//   into shared memory, and each key's row offset formed there.  Then the
//   block stages the split's K rows and then its V rows with 16-byte
//   cp.async, two commit groups: in the pool a key's K and V rows of one
//   unit are adjacent, each a run of 16-byte chunks (256 bytes for bf16 at
//   hd 128, 128 for int8 and int4 pairs).  The whole split (up to 64 KB, at
//   hd 256) is in flight at once; scores start when K has landed, while V
//   is still in flight.
// * Head dims 64, 96, 128, 192 and 256 (Llama, Phi-3-mini, DeepSeek-V3's
//   128 + 64, Gemma).  The
//   split's K and V tiles are dynamic shared memory (split_attention.cuh):
//   a bf16 pair at hd 256 is 65 KB, past the 48 KB a block may hold
//   without opting in.  The 64-key split and its partials' layout are the
//   same at every head dim.
// * Scores (fp32; bf16, int8 and int4 products are exact in fp32): two
//   threads per key, each over half of hd for all NH heads, K read from
//   rows padded by 16 bytes (conflict-free 16-byte reads of 8 keys at
//   once), q as fp32 in shared memory (a broadcast); the halves are added,
//   scaled by qk_scale = sm_scale·k_scale and soft-capped.  Then per head
//   an exact softmax over the split: m = max, p = exp(s - m) in fp32,
//   l = Σ p.  p stays fp32 for PV (the TPU kernel and the plain version
//   round it to the value dtype).
// * PV: each thread owns one d for all NH heads over the split's keys (two
//   key halves added in order at hd 64; threads 96-127 idle at hd 96; two
//   d's, t and t + 128, at hd 256, and at hd 192 for threads 0-63), one
//   element of V per lane, p as a broadcast.  The split writes (m, l, acc[hd]) per q head to the scratch.
// * Merge: a second kernel in the same C call (no tickets, no atomics, so a
//   launch is graph-capturable and bit-repeatable), one block per (row, q
//   head), one thread per d: M = max over splits and the sink logit;
//   den = exp(sink - M) + Σ l_z exp(m_z - M), num = Σ acc_z exp(m_z - M),
//   in split order 0…n-1, empty splits skipped; out = num / den · v_scale,
//   or 0 for a row with no visible key (pad rows).  The sink joins exactly
//   once, here.
// * Scratch: the partials take rows · Hq · n_splits · (hd + 2) fp32, from
//   torch.empty in the wrapper, capped at SCRATCH_CAP = 64 MiB (a 512-row
//   prefill chunk at a 4096-key table would need 545 MB).  Where a call
//   needs more, the C entry runs the split/merge pair over consecutive
//   ranges of rows_per_range = max(1, SCRATCH_CAP / (Hq · n_splits ·
//   (hd + 2) · 4)) rows on one stream, reusing the scratch; a range of rows
//   changes no row's bits.
//
// The scores, softmax, PV and merge are split_attention.cuh's, shared with
// K4/K7 (csrc/contiguous_attention.cu); this file finds a row's sequence
// and stages its split's rows from the pool.
//
// Scalar int8 k/v scales arrive as arguments (qk_scale, v_scale), as in the
// TPU kernel; per-head int4 scales are folded outside
// (serving/decode.py::fold_paged_kv_scales) and arrive as 1.0, so the
// kernel sees raw int8/int4 codes.  A prefill chunk still reads its
// prefix once per row of the chunk (from L2); tiles of rows of one
// sequence sharing each K/V page, with QKᵀ and PV on the tensor cores,
// are the redesign that removes that.
#include "split_attention.cuh"

namespace {

constexpr size_t SCRATCH_CAP = size_t(64) << 20;  // bytes of partials per launch

struct Args {
  const __nv_bfloat16* q;   // (T, Hq, hd)
  const unsigned char* kv;  // (P, ps, 2·n_units, hd) of bf16 or int8
  const int32_t* kv_lens;   // (S,)
  const int32_t* tables;    // (S, pps)
  const int32_t* cu;        // (S + 1,)
  const int32_t* num_seqs;  // (1,)
  const float* sinks;       // (Hq,) or null
  __nv_bfloat16* out;       // (T, Hq, hd)
  float* part_m;            // (rows_per_range, Hq, n_splits)
  float* part_l;            // (rows_per_range, Hq, n_splits)
  float* part_acc;          // (rows_per_range, Hq, n_splits, hd)
  int row0;                 // first row of this launch's range
  int n_seqs, pages_per_seq, page_size, n_units, groups, window, n_splits;
  int n_chunks;  // blocks a unit: groups / GB
  float qk_scale, v_scale, soft_cap;  // soft_cap <= 0: off
};

// NH q heads per block: GB of the group of kv head u, or GB of each of the
// int4 pair's two groups (the low nibble's head first); GB divides groups
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
  __shared__ size_t koff[KPS];   // byte offset of each key's K row of this unit
  __shared__ int32_t pages[KPS];  // the split's page ids, in order
  __shared__ int row_info[4];     // the row's sequence (-1: a pad row), run start, n_new, kv_len

  const int b = blockIdx.x, u = blockIdx.y / a.n_chunks, z = blockIdx.z;
  const int g0 = (blockIdx.y % a.n_chunks) * GB;  // the chunk's first head of a group
  const int t = threadIdx.x;
  const int row = a.row0 + b;
  const int hq = (MODE == INT4 ? 2 * a.n_units : a.n_units) * a.groups;
  // global q head of local head i: kv head u (or 2u, 2u + 1 of a pair)
  auto qhead = [&](int i) {
    if (MODE == INT4) return (2 * u + i / GB) * a.groups + g0 + i % GB;
    return u * a.groups + g0 + i;
  };
  auto part = [&](int i) {
    return (static_cast<size_t>(b) * hq + qhead(i)) * a.n_splits + z;
  };

  // the row's sequence in one round trip: every thread's loads go out together
  if (t == 0) row_info[0] = -1;
  __syncthreads();
  const int active = a.num_seqs[0];
  for (int i = t; i < a.n_seqs; i += THREADS) {
    const int c0 = a.cu[i], c1 = a.cu[i + 1], len = a.kv_lens[i];
    if (i < active && c0 <= row && row < c1) {  // runs are disjoint: one thread at most
      row_info[0] = i;
      row_info[1] = c0;
      row_info[2] = c1 - c0;
      row_info[3] = len;
    }
  }
  __syncthreads();
  const int seq = row_info[0];
  int lo = 0, hi = -1;
  if (seq >= 0) {
    const int n_new = row_info[2], kv_len = row_info[3];
    const int tok_pos = kv_len - n_new + (row - row_info[1]);
    hi = min(min(tok_pos, kv_len - 1), a.pages_per_seq * a.page_size - 1);
    lo = a.window > 0 ? max(0, tok_pos - a.window + 1) : 0;
  }
  const int j0 = lo + z * KPS;
  const int n = min(KPS, hi - j0 + 1);
  if (n <= 0) {  // past the row's keys, or a pad row: an empty partial
    for (int i = t; i < NH; i += THREADS) {
      a.part_m[part(i)] = -INFINITY;
      a.part_l[part(i)] = 0.0f;
    }
    return;
  }

  // the split's page ids, once, then each key's row offset
  const int ps_ = a.page_size;
  const int pg0 = j0 / ps_;
  const int n_pg = (j0 + n - 1) / ps_ - pg0 + 1;
  const int32_t* table = a.tables + static_cast<size_t>(seq) * a.pages_per_seq;
  for (int i = t; i < n_pg; i += THREADS) pages[i] = table[pg0 + i];
  __syncthreads();
  const size_t row_stride = static_cast<size_t>(2 * a.n_units) * ROW;
  const size_t page_stride = static_cast<size_t>(ps_) * row_stride;
  if (t < n) {
    const int j = j0 + t;
    koff[t] = static_cast<size_t>(pages[j / ps_ - pg0]) * page_stride +
              static_cast<size_t>(j % ps_) * row_stride + static_cast<size_t>(2 * u) * ROW;
  }
  __syncthreads();

  for (int c = t; c < n * CPR; c += THREADS)  // chunk c % CPR of key c / CPR
    cp_async16(ks + (c / CPR) * KROW + (c % CPR) * 16, a.kv + koff[c / CPR] + (c % CPR) * 16);
  cp_async_commit();
  for (int c = t; c < n * CPR; c += THREADS)  // V follows K in the pool
    cp_async16(vs + c * 16, a.kv + koff[c / CPR] + ROW + (c % CPR) * 16);
  cp_async_commit();
  for (int c = t; c < NH * HD; c += THREADS) {
    const size_t src = (static_cast<size_t>(row) * hq + qhead(c / HD)) * HD + c % HD;
    qs[c / HD][c % HD] = __bfloat162float(a.q[src]);
  }
  split_body<MODE, HD, NH>(tiles, qs, n, a.qk_scale, a.soft_cap, a.part_m, a.part_l,
                           a.part_acc, part);
}

// one block per (row, q head), one thread per d
template <int HD>
__global__ void __launch_bounds__(HD) merge_kernel(Args a, int hq) {
  const int b = blockIdx.x, qh = blockIdx.y;
  const size_t base = (static_cast<size_t>(b) * hq + qh) * a.n_splits;
  const float o = merge_splits<HD>(a.part_m, a.part_l, a.part_acc, base, a.n_splits, a.sinks,
                                   qh, a.v_scale);
  a.out[(static_cast<size_t>(a.row0 + b) * hq + qh) * HD + threadIdx.x] = __float2bfloat16_rn(o);
}

// the split/merge pair over rows [0, n_rows), rows_per_range at a time
template <int MODE, int HD, int NH>
cudaError_t launch_one(Args a, int n_rows, int rows_per_range, cudaStream_t stream) {
  const int hq = (MODE == INT4 ? 2 * a.n_units : a.n_units) * a.groups;
  constexpr int SMEM = Tile<MODE, HD>::BYTES;
  const cudaError_t smem_err = allow_smem<split_kernel<MODE, HD, NH>, SMEM>();
  if (smem_err != cudaSuccess) return smem_err;
  for (int r0 = 0; r0 < n_rows; r0 += rows_per_range) {
    const int nr = n_rows - r0 < rows_per_range ? n_rows - r0 : rows_per_range;
    a.row0 = r0;
    split_kernel<MODE, HD, NH>
        <<<dim3(nr, a.n_units * a.n_chunks, a.n_splits), THREADS, SMEM, stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    merge_kernel<HD><<<dim3(nr, hq), HD, 0, stream>>>(a, hq);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int MODE, int HD>
cudaError_t launch_nh(Args a, int n_rows, int rpr, cudaStream_t stream) {
  constexpr int F = MODE == INT4 ? 2 : 1;
  const int gb = heads_per_block(a.groups);
  a.n_chunks = a.groups / gb;
  switch (gb) {
    case 1: return launch_one<MODE, HD, F>(a, n_rows, rpr, stream);
    case 2: return launch_one<MODE, HD, 2 * F>(a, n_rows, rpr, stream);
    case 3: return launch_one<MODE, HD, 3 * F>(a, n_rows, rpr, stream);
    case 4: return launch_one<MODE, HD, 4 * F>(a, n_rows, rpr, stream);
    case 5: return launch_one<MODE, HD, 5 * F>(a, n_rows, rpr, stream);
    case 6: return launch_one<MODE, HD, 6 * F>(a, n_rows, rpr, stream);
    case 7: return launch_one<MODE, HD, 7 * F>(a, n_rows, rpr, stream);
    case 8: return launch_one<MODE, HD, 8 * F>(a, n_rows, rpr, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int MODE>
cudaError_t launch_hd(const Args& a, int n_rows, int rpr, int hd, cudaStream_t stream) {
  switch (hd) {
    case 64: return launch_nh<MODE, 64>(a, n_rows, rpr, stream);
    case 96: return launch_nh<MODE, 96>(a, n_rows, rpr, stream);
    case 128: return launch_nh<MODE, 128>(a, n_rows, rpr, stream);
    case 192: return launch_nh<MODE, 192>(a, n_rows, rpr, stream);
    case 256: return launch_nh<MODE, 256>(a, n_rows, rpr, stream);
    default: return cudaErrorInvalidValue;
  }
}

// the split count the grid needs: every row's visible keys fit in
// min(pps·ps, window)
int splits_for(int span, int window) {
  if (window > 0 && window < span) span = window;
  return (span + KPS - 1) / KPS;
}

}  // namespace

extern "C" {

// K6.  q, out: (n_rows, Hq, hd) bf16; kv: (P, page_size, 2·n_units, hd)
// bf16 (mode 0), int8 (mode 1) or adjacent-pair int4 (mode 2), n_units =
// Hkv (modes 0, 1) or Hkv/2 (mode 2), 16-byte aligned; kv_lens: (n_seqs,),
// tables: (n_seqs, pages_per_seq), cu: (n_seqs + 1,), num_seqs: (1,), all
// int32; sinks: (Hq,) fp32 or null.  qk_scale = sm_scale·k_scale; window 0
// and soft_cap 0 switch those off.  hd must be 64, 96, 128, 192 or 256; any
// Hq/Hkv.
// n_splits must be ceil(min(pages_per_seq·page_size, window) /
// 64); scratch holds rows_per_range·Hq·n_splits·(hd + 2) fp32, and
// rows_per_range must be 1 or keep that within 64 MiB (refused otherwise).
// Per range of rows_per_range rows, two kernels on `stream`: the splits,
// then the merge.
int paged_attention(const void* q, const void* kv, const int32_t* kv_lens,
                    const int32_t* tables, const int32_t* cu, const int32_t* num_seqs,
                    const float* sinks, void* out, void* scratch, int n_rows, int n_seqs,
                    int pages_per_seq, int page_size, int n_units, int groups, int hd,
                    int mode, int n_splits, int rows_per_range, float qk_scale,
                    float v_scale, float soft_cap, int window, cudaStream_t stream) {
  if (n_rows <= 0 || n_seqs <= 0 || pages_per_seq <= 0 || page_size <= 0 || n_units <= 0 ||
      groups <= 0 || rows_per_range <= 0 ||
      n_splits != splits_for(pages_per_seq * page_size, window))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t hq = static_cast<size_t>(mode == INT4 ? 2 * n_units : n_units) * groups;
  const size_t parts = static_cast<size_t>(rows_per_range) * hq * n_splits;
  if (rows_per_range > 1 && parts * (hd + 2) * sizeof(float) > SCRATCH_CAP)
    return static_cast<int>(cudaErrorInvalidValue);
  float* s = static_cast<float*>(scratch);
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.kv = static_cast<const unsigned char*>(kv);
  a.kv_lens = kv_lens;
  a.tables = tables;
  a.cu = cu;
  a.num_seqs = num_seqs;
  a.sinks = sinks;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.part_m = s;
  a.part_l = s + parts;
  a.part_acc = s + 2 * parts;
  a.row0 = 0;
  a.n_seqs = n_seqs;
  a.pages_per_seq = pages_per_seq;
  a.page_size = page_size;
  a.n_units = n_units;
  a.groups = groups;
  a.window = window;
  a.n_splits = n_splits;
  a.n_chunks = 1;
  a.qk_scale = qk_scale;
  a.v_scale = v_scale;
  a.soft_cap = soft_cap;
  switch (mode) {
    case BF16: return static_cast<int>(launch_hd<BF16>(a, n_rows, rows_per_range, hd, stream));
    case INT8: return static_cast<int>(launch_hd<INT8>(a, n_rows, rows_per_range, hd, stream));
    case INT4: return static_cast<int>(launch_hd<INT4>(a, n_rows, rows_per_range, hd, stream));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* gptq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
