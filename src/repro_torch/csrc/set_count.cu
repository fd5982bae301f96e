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
//
// filter_tree_lookup replaces repro/kernels/set_count.py filter_tree_lookup
// (the Reindexer's equality comparators + OR tree): for each target, the
// payload of the unique key equal to it, or -1, and a hit flag. Same
// schedule as the count: a thread keeps kPerThread targets and their
// encoded results in registers while the CTA streams (key, payload + 1)
// tiles through shared memory; a hit encodes payload + 1, reduced by max
// (at most one key matches, so max is the OR), and 0 means a miss, as in
// the TPU kernel. The ragged last tile is padded as the twin
// (core/set_count.py filter_lookup, blocks of kTile) pads it: INT32_MIN
// keys with payload 0. Bound: operations, T * E compares.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 4;
constexpr int kTile = 2048;
constexpr int32_t kInt32Max = 0x7FFFFFFF;
constexpr int32_t kInt32Min = -kInt32Max - 1;

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

__global__ void __launch_bounds__(kThreads)
filter_kernel(const int32_t* __restrict__ keys,
              const int32_t* __restrict__ payloads, int n_keys,
              const int32_t* __restrict__ targets, int n_targets,
              int32_t* __restrict__ out, uint8_t* __restrict__ hit) {
  __shared__ __align__(16) int32_t s_k[kTile];
  __shared__ __align__(16) int32_t s_p[kTile];
  const int t0 = blockIdx.x * kThreads * kPerThread + threadIdx.x;
  int32_t t[kPerThread];
  int32_t enc[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int ti = t0 + j * kThreads;
    t[j] = ti < n_targets ? targets[ti] : 0;
    enc[j] = 0;
  }
  for (int e0 = 0; e0 < n_keys; e0 += kTile) {
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool live = e0 + i < n_keys;
      s_k[i] = live ? keys[e0 + i] : kInt32Min;
      // payload + 1 wraps in int32 as the reference's does
      s_p[i] = live ? (int32_t)((uint32_t)payloads[e0 + i] + 1u) : 1;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kTile; i += 4) {
      const int4 k = *reinterpret_cast<const int4*>(&s_k[i]);
      const int4 p = *reinterpret_cast<const int4*>(&s_p[i]);
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        int32_t a = enc[j];
        a = max(a, k.x == t[j] ? p.x : 0);
        a = max(a, k.y == t[j] ? p.y : 0);
        a = max(a, k.z == t[j] ? p.z : 0);
        a = max(a, k.w == t[j] ? p.w : 0);
        enc[j] = a;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int ti = t0 + j * kThreads;
    if (ti < n_targets) {
      out[ti] = enc[j] > 0 ? enc[j] - 1 : -1;
      hit[ti] = enc[j] > 0;
    }
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

extern "C" int filter_tree_lookup(const void* keys, const void* payloads,
                                  int n_keys, const void* targets,
                                  int n_targets, void* out, void* hit,
                                  void* stream) {
  const int per_cta = kThreads * kPerThread;
  filter_kernel<<<(n_targets + per_cta - 1) / per_cta, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(payloads),
      n_keys, static_cast<const int32_t*>(targets), n_targets,
      static_cast<int32_t*>(out), static_cast<uint8_t*>(hit));
  return (int)cudaGetLastError();
}
