// The fused merge ladder: every merge rung of sorted runs of `run` up to
// super-blocks of `block` elements, in one launch.
//
// Replaces repro/kernels/merge.py fused_merge_rounds (keys-only and pair
// variants; the UPE "merging" stage). The TPU kernel loads one 65,536-pair
// super-block into VMEM and runs every rung there; 512 KiB in and out does
// not fit the 227 KB of shared memory one Hopper CTA can use, so the rung
// schedule does not carry over. What does carry over is the result: a
// ladder of stable merges of consecutive runs, earlier runs winning ties,
// is the stable sort of the super-block, whatever its fan-ins. So each
// element's output slot is its own index in its run plus its rank in every
// sibling run of the super-block (right rank against earlier runs, left
// rank against later ones: repro/core/ordering.py merge_sorted_k), and the
// whole super-block is written once, by a conflict-free scatter. One
// thread per element; the sibling runs are bisected in device memory,
// where a 256 KiB super-block of keys stays in L2, and neighbouring
// threads (neighbouring keys of one run) walk the same pivots. Bound:
// device-memory bytes (each key and value read once and written once);
// the (block / run - 1) * log2(run) dependent L2 probes per element make
// it latency-bound in practice.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <bool kHasVals>
__global__ void __launch_bounds__(kThreads)
merge_rank_kernel(const int32_t* __restrict__ keys,
                  const int32_t* __restrict__ vals,
                  int32_t* __restrict__ out_keys,
                  int32_t* __restrict__ out_vals, int n, int run,
                  int block) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int b0 = i - i % block;
  const int r = (i - b0) / run;
  const int32_t key = keys[i];
  int pos = i - b0 - r * run;
  const int n_runs = block / run;
  for (int s = 0; s < n_runs; ++s) {
    if (s == r) continue;
    const int32_t* sib = keys + b0 + (size_t)s * run;
    const bool right = s < r;  // an earlier run's equal keys go first
    int lo = 0, hi = run;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const int32_t p = sib[mid];
      if (right ? (p <= key) : (p < key)) lo = mid + 1; else hi = mid;
    }
    pos += lo;
  }
  out_keys[b0 + pos] = key;
  if (kHasVals) out_vals[b0 + pos] = vals[i];
}

}  // namespace

extern "C" int fused_merge(const void* keys, const void* vals, void* out_keys,
                           void* out_vals, int n, int run, int block,
                           void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vals != nullptr) {
    merge_rank_kernel<true><<<blocks, kThreads, 0, s>>>(
        static_cast<const int32_t*>(keys), static_cast<const int32_t*>(vals),
        static_cast<int32_t*>(out_keys), static_cast<int32_t*>(out_vals), n,
        run, block);
  } else {
    merge_rank_kernel<false><<<blocks, kThreads, 0, s>>>(
        static_cast<const int32_t*>(keys), nullptr,
        static_cast<int32_t*>(out_keys), nullptr, n, run, block);
  }
  return (int)cudaGetLastError();
}
