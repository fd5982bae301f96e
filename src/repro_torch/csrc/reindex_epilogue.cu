// The SCR rank epilogue: batched searchsorted and the reindex rename.
//
// Replaces repro/kernels/reindex_epilogue.py rank_search_tiles (left/right
// rank of int32 queries in a sorted stream: CSC pointer builds,
// first-occurrence ranks, order compaction) and reindex_rename_tiles (rank,
// run-head hit test and slot_to_new gather: the whole ReindexMap.lookup).
//
// The TPU kernels pin the whole sorted stream in VMEM for every query
// tile. A Hopper SM cannot hold a 2^27-long stream, so the stream stays in
// device memory and each thread bisects it for one query: the same
// (lo, hi, mid = (lo + hi) >> 1) rounds as the reference's unrolled
// search, so results match it exactly, SENTINEL queries and SENTINEL tails
// included. Neighbouring queries tend to walk the same pivots, so the
// first rounds are L2 hits. Bound: device-memory bytes of the queries and
// the output (each probe is a dependent 4-byte load, so in practice it is
// latency-bound at log2(n) probes per query).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kSentinel = 0x7FFFFFFF;
constexpr int kThreads = 256;

__device__ __forceinline__ int rank_of(const int32_t* __restrict__ arr,
                                       int n, int32_t q, bool right) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int32_t p = arr[mid];
    if (right ? (p <= q) : (p < q)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void rank_kernel(const int32_t* __restrict__ arr, int n,
                            const int32_t* __restrict__ queries,
                            int32_t* __restrict__ out, int nq, int right) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  out[i] = rank_of(arr, n, queries[i], right != 0);
}

__global__ void rename_kernel(const int32_t* __restrict__ arr,
                              const int32_t* __restrict__ table, int n,
                              const int32_t* __restrict__ queries,
                              int32_t* __restrict__ out, int nq) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const int32_t q = queries[i];
  const int r = min(max(rank_of(arr, n, q, false), 0), n - 1);
  const bool hit = arr[r] == q && q != kSentinel;
  out[i] = hit ? table[r] : kSentinel;
}

}  // namespace

extern "C" int rank_search(const void* arr, int n, const void* queries,
                           void* out, int nq, int right, void* stream) {
  rank_kernel<<<(nq + kThreads - 1) / kThreads, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(arr), n,
      static_cast<const int32_t*>(queries), static_cast<int32_t*>(out), nq,
      right);
  return (int)cudaGetLastError();
}

extern "C" int rename_lookup(const void* arr, const void* table, int n,
                             const void* queries, void* out, int nq,
                             void* stream) {
  rename_kernel<<<(nq + kThreads - 1) / kThreads, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(arr), static_cast<const int32_t*>(table), n,
      static_cast<const int32_t*>(queries), static_cast<int32_t*>(out), nq);
  return (int)cudaGetLastError();
}
