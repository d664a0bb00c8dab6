// scan_insert / scan_delete: the sequential insert and delete walks of the
// scan backend, one shard per CTA.
//
// Replaces the reference's lax.scan cores, not a pallas_call:
// repro/core/filter.py::_insert_one (walked by bulk_insert, :146, and by
// repro/distributed/elastic.py::insert_pairs, :125) and the per-key body
// of repro/core/filter.py::bulk_delete (:240).  Semantics are in
// repro_torch/kernels/scan.py; the plain versions there are held against
// these kernels bit for bit.
//
// Each lane's eviction chain reads the table the previous lane left, so a
// shard's lanes are one dependent walk: one thread of one CTA walks them
// in order (the wrapper has compacted the valid lanes, keeping their
// order), and every shard of the stack is a one-thread CTA of its own in
// the same launch.  The chain's history (the buckets it visited, at most max_disp)
// lives in dynamic shared memory for the lossless rollback.  The bound is
// the chain's latency (one dependent row read a step), not bytes.
#include "ocf_common.cuh"

namespace {

// First empty slot of a row -> its index, or -1.
__device__ __forceinline__ int first_empty(const uint32_t* row, int bs) {
  for (int j = 0; j < bs; ++j)
    if (row[j] == 0u) return j;
  return -1;
}

__device__ __forceinline__ bool place(uint32_t* row, int bs, uint32_t f) {
  const int j = first_empty(row, bs);
  if (j < 0) return false;
  row[j] = f;
  return true;
}

__global__ void scan_insert_kernel(uint32_t* __restrict__ tables, int buffer,
                                   int bs, uint32_t n,
                                   uint32_t* __restrict__ stashes, int slots,
                                   const uint32_t* __restrict__ a,
                                   const uint32_t* __restrict__ b,
                                   const long long* __restrict__ offsets,
                                   uint8_t* __restrict__ ok, int pair_mode,
                                   int fp_bits, int max_disp) {
  extern __shared__ uint32_t hist[];
  const int s = blockIdx.x;
  uint32_t* t = tables + (size_t)s * buffer * bs;
  uint32_t* st = stashes ? stashes + (size_t)s * 2 * slots : nullptr;
  for (long long k = offsets[s]; k < offsets[s + 1]; ++k) {
    uint32_t f, i1;
    if (pair_mode) {
      f = b[k];
      i1 = a[k] % n;
    } else {
      f = ocf::fingerprint(a[k], b[k], fp_bits);
      i1 = ocf::index_hash(a[k], b[k], n);
    }
    const uint32_t i2 = ocf::alt_index(i1, f, n);
    bool done = place(t + (size_t)i1 * bs, bs, f) ||
                place(t + (size_t)i2 * bs, bs, f);
    if (!done) {
      uint32_t i = i2, cur = f;
      int step = 0;
      while (!done && step < max_disp) {
        const int j = step % bs;
        const uint32_t old = t[(size_t)i * bs + j];
        t[(size_t)i * bs + j] = cur;
        hist[step] = i;
        cur = old;
        i = ocf::alt_index(i, cur, n);
        done = place(t + (size_t)i * bs, bs, cur);
        ++step;
      }
      if (!done) {
        for (int idx = step - 1; idx >= 0; --idx) {
          uint32_t* slot = t + (size_t)hist[idx] * bs + idx % bs;
          const uint32_t old = *slot;
          *slot = cur;
          cur = old;
        }
        if (st) {
          for (int e = 0; e < slots; ++e) {
            if (st[e] == 0u) {
              st[e] = f;
              st[slots + e] = i2;
              done = true;
              break;
            }
          }
        }
      }
    }
    ok[k] = done ? 1 : 0;
  }
}

__global__ void scan_delete_kernel(uint32_t* __restrict__ tables, int buffer,
                                   int bs, uint32_t n,
                                   const uint32_t* __restrict__ hi,
                                   const uint32_t* __restrict__ lo,
                                   const long long* __restrict__ offsets,
                                   uint8_t* __restrict__ ok, int fp_bits) {
  const int s = blockIdx.x;
  uint32_t* t = tables + (size_t)s * buffer * bs;
  for (long long k = offsets[s]; k < offsets[s + 1]; ++k) {
    const uint32_t f = ocf::fingerprint(hi[k], lo[k], fp_bits);
    const uint32_t i1 = ocf::index_hash(hi[k], lo[k], n);
    const uint32_t i2 = ocf::alt_index(i1, f, n);
    bool done = false;
    for (int c = 0; c < 2 && !done; ++c) {
      uint32_t* row = t + (size_t)(c ? i2 : i1) * bs;
      for (int j = 0; j < bs; ++j) {
        if (row[j] == f) {
          row[j] = 0u;
          done = true;
          break;
        }
      }
    }
    ok[k] = done ? 1 : 0;
  }
}

}  // namespace

extern "C" int ocf_scan_insert(void* tables, int buffer, int bucket_size,
                               unsigned int n_buckets, void* stashes,
                               int slots, const void* a, const void* b,
                               const void* offsets, void* ok, int n_shards,
                               int pair_mode, int fp_bits, int max_disp,
                               void* stream) {
  const size_t smem = (size_t)(max_disp > 0 ? max_disp : 1) * 4;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (n_shards > 0) {
    scan_insert_kernel<<<n_shards, 1, smem, (cudaStream_t)stream>>>(
        (uint32_t*)tables, buffer, bucket_size, n_buckets,
        (uint32_t*)stashes, slots, (const uint32_t*)a, (const uint32_t*)b,
        (const long long*)offsets, (uint8_t*)ok, pair_mode, fp_bits,
        max_disp);
  }
  return (int)cudaGetLastError();
}

extern "C" int ocf_scan_delete(void* tables, int buffer, int bucket_size,
                               unsigned int n_buckets, const void* hi,
                               const void* lo, const void* offsets, void* ok,
                               int n_shards, int fp_bits, void* stream) {
  if (n_shards > 0) {
    scan_delete_kernel<<<n_shards, 1, 0, (cudaStream_t)stream>>>(
        (uint32_t*)tables, buffer, bucket_size, n_buckets,
        (const uint32_t*)hi, (const uint32_t*)lo, (const long long*)offsets,
        (uint8_t*)ok, fp_bits);
  }
  return (int)cudaGetLastError();
}
