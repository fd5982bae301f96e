// The GNN aggregation over the dst-sorted edge layout:
//   out[v, :] = sum of x[row(e), :] over the edges e with dst[e] == v
// with row(e) = e (x is the [E, D] message stream) or, given a gather
// index, row(e) = rows[e] clamped into [0, n_x - 1] (the forward's
// gather_src, folded in: GraphSAGE's [E, D] messages are never written);
// with ``mean`` each output row is divided by max(count, 1), its edge
// count (the degree: no stream of ones is summed).
//
// Replaces repro/kernels/segment_agg.py segment_sum_sorted, which runs a
// [V-block x E-block] one-hot matmul on the MXU for every tile whose dst
// range overlaps the node block. Hopper needs no one-hot: dst is sorted,
// so node v's edges are the span [lower_bound(v), lower_bound(v + 1)) of
// dst, and entries >= n_nodes (the SENTINEL tail) fall outside every span:
// neither they nor their rows are read. Two launches a call:
// - the bounds pass (segment_bounds_kernel), a thread an edge, no search:
//   with d(e) = min(dst[e], n) (d(-1) = -1, d(E) = n), edge e is the first
//   edge of every node in (d(e - 1), d(e)] and writes ptr[v] = e there
//   (short gaps by the thread, long ones by its CTA together, coalesced).
//   The one edge whose gap reaches n, the tail's, writes only two numbers:
//   the tail's first node T and its pointer P. The nodes past the last
//   live edge (most of a sampled subgraph's) are never written;
// - the sum: the pointer segment sum's body (span_sum.cuh, shared with
//   ptr_scan.cu) over that array, reading P for every node from T on. Its
//   summation order is fixed by a span's length alone, so two launches, a
//   lane batched and alone, and the two sums on the same spans give the
//   same bits, with no atomics. It is launched as the pass's programmatic
//   dependent: its launch overlaps the pass, and its CTAs wait in place
//   for the pass's writes.
// Bound: device-memory bytes — the live dst entries read once, every row
// the spans name read once, every output row written once.
#include <cuda_runtime.h>
#include <stdint.h>

#include "span_sum.cuh"

namespace {

using namespace span_sum;

constexpr int kShortGap = 32;  // a gap this long or shorter: its thread
constexpr int kEdges = 4;      // edges a thread of the bounds pass

// griddepcontrol (PTX, sm_90): the sum's CTAs may be scheduled while the
// bounds pass still runs, and wait for its writes before their first read
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_for_primary() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// ptr [n + 3]: ptr[v] for every v below the tail T, ptr[n + 1] = T,
// ptr[n + 2] = P. Edges e in [0, n_dst], kEdges a thread, a CTA's
// kThreads apart so that each round of loads is coalesced.
__global__ void __launch_bounds__(kThreads)
segment_bounds_kernel(const int32_t* __restrict__ dst, int n_dst, int n,
                      int32_t* __restrict__ ptr) {
  __shared__ int n_long;
  __shared__ int3 longs[kThreads * kEdges];  // (first node, last node, edge)
  launch_dependents();
  if (threadIdx.x == 0) n_long = 0;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kEdges; ++j) {
    const int e = (blockIdx.x * kEdges + j) * kThreads + threadIdx.x;
    if (e > n_dst) break;
    const int prev = e > 0 ? min(__ldg(dst + e - 1), n) : -1;
    const int cur = e < n_dst ? min(__ldg(dst + e), n) : n;
    if (prev < cur) {
      if (cur == n) {
        ptr[n + 1] = prev + 1;
        ptr[n + 2] = e;
      } else if (cur - prev <= kShortGap) {
        for (int v = prev + 1; v <= cur; ++v) ptr[v] = e;
      } else {
        longs[atomicAdd(&n_long, 1)] = make_int3(prev + 1, cur, e);
      }
    }
  }
  __syncthreads();
  for (int k = 0; k < n_long; ++k) {
    const int3 g = longs[k];
    for (int v = g.x + threadIdx.x; v <= g.y; v += kThreads) ptr[v] = g.z;
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ x, int n_x, int d,
                   const int32_t* __restrict__ rows,
                   const int32_t* __restrict__ ptr, int n_out, int mean,
                   float* __restrict__ out, int tile_rows, int ny) {
  wait_for_primary();
  span_sum_body<V, true>(x, n_x, d, rows, ptr, n_out, mean, out, tile_rows,
                         ny);
}

template <int V>
cudaError_t launch(const int32_t* dst, int n_edges, const float* x, int n_x,
                   int d, const int32_t* rows, int mean, float* out,
                   int n_nodes, int32_t* ptr, cudaStream_t s) {
  int sms = 0;
  cudaError_t e = card_sms(&sms);
  if (e != cudaSuccess) return e;
  segment_bounds_kernel<<<n_edges / (kThreads * kEdges) + 1, kThreads, 0,
                          s>>>(dst, n_edges, n_nodes, ptr);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const SpanGrid g = span_grid<V>(n_nodes, d, sms);
  // programmatic dependent launch: the sum's launch overlaps the pass
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)g.ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, segment_sum_kernel<V>, x, n_x, d, rows,
                            (const int32_t*)ptr, n_nodes, mean, out,
                            g.tile_rows, g.ny);
}

}  // namespace

// dst [n_edges] int32, sorted ascending; x [n_x, d] float32 row-major;
// rows [n_edges] int32, or null (then row(e) = e and n_x = n_edges); out
// [n_nodes, d] float32; scratch [n_nodes + 3] int32 (the bounds pass's
// pointers and tail). Returns the launch's cudaError_t, 0 on success.
extern "C" int segment_sum_sorted(const void* dst, int n_edges,
                                  const void* x, int n_x, int d,
                                  const void* rows, int mean, void* out,
                                  int n_nodes, void* scratch, void* stream) {
  if (n_nodes <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ds = static_cast<const int32_t*>(dst);
  const float* xf = static_cast<const float*>(x);
  const int32_t* r = static_cast<const int32_t*>(rows);
  float* o = static_cast<float*>(out);
  int32_t* sc = static_cast<int32_t*>(scratch);
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(out);
  cudaError_t e;
  if (d % 2 == 0 && align % 8 == 0)
    e = launch<2>(ds, n_edges, xf, n_x, d, r, mean, o, n_nodes, sc, s);
  else
    e = launch<1>(ds, n_edges, xf, n_x, d, r, mean, o, n_nodes, sc, s);
  return (int)e;
}
