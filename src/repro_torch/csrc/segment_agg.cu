// The GNN aggregation over the dst-sorted edge layout:
// out[v, :] = sum of msgs[e, :] over the edges e with dst[e] == v.
//
// Replaces repro/kernels/segment_agg.py segment_sum_sorted, which runs a
// [V-block x E-block] one-hot matmul on the MXU for every tile whose dst
// range overlaps the node block. Hopper needs no one-hot: dst is sorted,
// so node v's edges are the span [lower_bound(v), lower_bound(v + 1)) of
// dst. A CTA owns a group of consecutive nodes: its threads first bisect
// the group's span bounds in parallel (one bisection per node, kept in
// shared memory), then each thread sums (node, column) outputs over the
// span in edge order: no atomics, so the same inputs give the same bits on
// every launch (batched and sequential serving both run this kernel and
// must agree bit for bit). The threads are laid out as (columns x nodes):
// up to 256 neighbouring columns of one row, so message reads and output
// writes are coalesced, and for narrow rows (the D = 1 degree stream) many
// nodes at once. dst entries >= n_nodes (the SENTINEL tail) fall outside
// every span, so neither they nor their message rows are read. Bound:
// device-memory bytes — every live message row (dst < n_nodes) read once,
// every output row written once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinNodes = 16;  // nodes per CTA when a row fills the CTA

__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ a,
                                           int n, int32_t v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const int32_t* __restrict__ dst, int n_edges,
                   const float* __restrict__ msgs, int d,
                   float* __restrict__ out, int n_nodes, int group) {
  __shared__ int bounds[kThreads];  // group + 1 <= kThreads
  const int v0 = blockIdx.x * group;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i <= group; i += kThreads)
    bounds[i] = lower_bound(dst, n_edges, min(v0 + i, n_nodes));
  __syncthreads();
  for (int g = threadIdx.y; g < group && v0 + g < n_nodes; g += blockDim.y) {
    const int lo = bounds[g], hi = bounds[g + 1];
    float* row = out + (size_t)(v0 + g) * d;
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      float acc = 0.0f;
      for (int e = lo; e < hi; ++e) acc += msgs[(size_t)e * d + c];
      row[c] = acc;
    }
  }
}

}  // namespace

extern "C" int segment_sum_sorted(const void* dst, int n_edges,
                                  const void* msgs, int d, void* out,
                                  int n_nodes, void* stream) {
  int tx = 1;
  while (tx < d && tx < kThreads) tx <<= 1;
  const dim3 threads(tx, kThreads / tx);
  // group + 1 span bounds, at most one bisection per thread
  const int group = threads.y > kMinNodes ? (int)threads.y - 1 : kMinNodes;
  segment_sum_kernel<<<(n_nodes + group - 1) / group, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(dst), n_edges,
      static_cast<const float*>(msgs), d, static_cast<float*>(out), n_nodes,
      group);
  return (int)cudaGetLastError();
}
