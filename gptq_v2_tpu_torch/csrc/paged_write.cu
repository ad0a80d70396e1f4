// K9: the paged KV row write.
//
// Replaces gptq_v2_tpu/ops/paged_write.py::_write_kernel (entry
// paged_write_rows): one token's combined K/V row (2·Hkv, hd) -- (Hkv, hd)
// bytes for adjacent-pair int4 pages -- is copied into the page pool at
// kv[layer, pages[t], offsets[t]], in place.  The TPU kernel issues one
// HBM-to-HBM DMA per row from a scalar-prefetched (page, offset) table and
// only serves decode writes, because row DMAs are latency-bound there; on
// the H100 a row copy is a plain coalesced load/store, so every paged write
// (decode, phased prefill, the ragged flat write) goes through here.
// Plain PyTorch version: ops/paged_write.py::paged_write_reference (the
// indexed store kv[layer, pages, offsets] = rows).
//
// One block per token row: it reads its (page, offset) and copies the row
// as 16-byte words, consecutive threads on consecutive words (a 7B bf16
// row is 16 KB = 1024 words, 8 per thread of 128).  Rows whose page or
// offset is out of range are not written (the indexed store would fault
// instead).  Rows aimed at the same slot (pad rows on the trash page, page
// 0 offset 0) race, word by word: the slot ends up holding words of any of
// them, as a scatter may; nothing reads the trash page.
//
// Bound on the H100: bytes, each row read once and written once (2·T·row
// bytes).  At decode sizes (8 rows, 128 KB) that is ~0.04 µs of HBM time,
// so launch latency (a few µs) dominates; one launch per layer and step is
// the floor this design keeps.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
    paged_write_kernel(uint4* __restrict__ kv, const uint4* __restrict__ rows,
                       const int32_t* __restrict__ pages, const int32_t* __restrict__ offsets,
                       int layer, int n_pages, int page_size, int vecs_per_row) {
  const int t = blockIdx.x;
  const int page = pages[t], off = offsets[t];
  if (page < 0 || page >= n_pages || off < 0 || off >= page_size) return;
  const size_t dst =
      ((static_cast<size_t>(layer) * n_pages + page) * page_size + off) * vecs_per_row;
  const uint4* src = rows + static_cast<size_t>(t) * vecs_per_row;
  for (int i = threadIdx.x; i < vecs_per_row; i += THREADS) kv[dst + i] = src[i];
}

}  // namespace

extern "C" {

// kv: (L, n_pages, page_size, row) in any dtype, row = vecs_per_row 16-byte
// words; rows: (n_rows, row) of the same dtype; pages, offsets: (n_rows,)
// int32.  All pointers 16-byte aligned.
int paged_write(void* kv, const void* rows, const int32_t* pages, const int32_t* offsets,
                int layer, int n_pages, int page_size, int n_rows, int vecs_per_row,
                cudaStream_t stream) {
  if (n_rows <= 0 || n_pages <= 0 || page_size <= 0 || vecs_per_row <= 0 || layer < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(kv) | reinterpret_cast<uintptr_t>(rows)) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  paged_write_kernel<<<n_rows, THREADS, 0, stream>>>(
      static_cast<uint4*>(kv), static_cast<const uint4*>(rows), pages, offsets, layer,
      n_pages, page_size, vecs_per_row);
  return static_cast<int>(cudaGetLastError());
}

const char* gptq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
