// The SCR set-count: counts[t] = #{x in elements : x < targets[t]}.
//
// Replaces repro/kernels/set_count.py set_count_less (the comparator array
// + adder tree of the Reshaper, paper Fig. 13): the count-based CSC pointer
// build of the unfused epilogue. It must not rely on sorted input, so it
// is all-pairs, T * E comparisons. The TPU kernel tiles [T, E] comparator
// blocks through VMEM and carries each target block's partial counts
// across the sequential element-block grid axis. Hopper CTAs run in no
// order and cannot carry state, so the element axis becomes a loop inside
// the CTA instead: one CTA owns kThreads * kPerThread targets, each thread
// keeps its kPerThread targets and int32 counts in registers, and the CTA
// streams every element block of kTile through shared memory. One 16-byte
// shared load (a broadcast: every thread reads the same four elements)
// feeds 4 * kPerThread compare-adds. Bound: operations — T * E compares at
// the card's 32-bit rate; device memory sees only the elements (once per
// CTA, from L2 after the first) and the targets and counts.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 4;
constexpr int kTile = 2048;
constexpr int32_t kInt32Max = 0x7FFFFFFF;

__global__ void __launch_bounds__(kThreads)
set_count_kernel(const int32_t* __restrict__ elems, int n_elems,
                 const int32_t* __restrict__ targets, int n_targets,
                 int32_t* __restrict__ counts) {
  __shared__ __align__(16) int32_t s_e[kTile];
  const int t0 = blockIdx.x * kThreads * kPerThread + threadIdx.x;
  int32_t t[kPerThread];
  int c[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int ti = t0 + j * kThreads;
    t[j] = ti < n_targets ? targets[ti] : 0;
    c[j] = 0;
  }
  for (int e0 = 0; e0 < n_elems; e0 += kTile) {
    for (int i = threadIdx.x; i < kTile; i += kThreads)
      s_e[i] = e0 + i < n_elems ? elems[e0 + i] : kInt32Max;
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kTile; i += 4) {
      const int4 x = *reinterpret_cast<const int4*>(&s_e[i]);
#pragma unroll
      for (int j = 0; j < kPerThread; ++j)
        c[j] += (x.x < t[j]) + (x.y < t[j]) + (x.z < t[j]) + (x.w < t[j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int ti = t0 + j * kThreads;
    if (ti < n_targets) counts[ti] = c[j];
  }
}

}  // namespace

extern "C" int set_count_less(const void* elems, int n_elems,
                              const void* targets, int n_targets,
                              void* counts, void* stream) {
  const int per_cta = kThreads * kPerThread;
  set_count_kernel<<<(n_targets + per_cta - 1) / per_cta, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(elems), n_elems,
      static_cast<const int32_t*>(targets), n_targets,
      static_cast<int32_t*>(counts));
  return (int)cudaGetLastError();
}
