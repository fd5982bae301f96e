// The GNN forward's pointer segment sum as direct span sums, in one launch:
//   out[i, :] = sum over e in [ptr[i], ptr[i + 1]) of x[row(e), :]
// with row(e) = e, or, given a gather index, row(e) = rows[e] clamped into
// [0, n_x - 1] (the clamp of the forward's gather_src); with ``mean`` each
// output row is divided by max(ptr[i + 1] - ptr[i], 1).
//
// Replaces no TPU kernel: the reference computes this in jnp
// (repro/models/gnn.py _ptr_seg_sum, a cumsum over axis 0 and two takes).
// Bound: device-memory bytes — the rows the spans name read once, the
// output written once (at a request's layer 1 the [N, D] output is most of
// them). A sampled subgraph's spans are short (at most the fanout), so
// each output element is read straight from its own span: no prefix, no
// carry, no scratch, no atomics, and no row at or past ptr[N] is read.
// Given ``rows``, the gather is folded in: the [E, D] message stream of
// GraphSAGE's mean is never written. The body, its summation order and its
// layout are span_sum.cuh's, shared with the segment sum over dst-sorted
// edges (segment_agg.cu).
#include <cuda_runtime.h>
#include <stdint.h>

#include "span_sum.cuh"

namespace {

using namespace span_sum;

template <int V>
__global__ void __launch_bounds__(kThreads)
span_sum_kernel(const float* __restrict__ x, int n_x, int d,
                const int32_t* __restrict__ rows,
                const int32_t* __restrict__ ptr, int n_out, int mean,
                float* __restrict__ out, int tile_rows, int ny) {
  span_sum_body<V, false>(x, n_x, d, rows, ptr, n_out, mean, out, tile_rows,
                          ny);
}

template <int V>
cudaError_t launch(const float* x, int n_x, int d, const int32_t* rows,
                   const int32_t* ptr, int n_out, int mean, float* out,
                   cudaStream_t s) {
  int sms = 0;
  cudaError_t e = card_sms(&sms);
  if (e != cudaSuccess) return e;
  const SpanGrid g = span_grid<V>(n_out, d, sms);
  span_sum_kernel<V><<<(unsigned)g.ctas, kThreads, 0, s>>>(
      x, n_x, d, rows, ptr, n_out, mean, out, g.tile_rows, g.ny);
  return cudaGetLastError();
}

}  // namespace

// x [n_x, d] float32 row-major; rows [E] int32, or null (then row(e) = e
// and E = n_x); ptr [n_ptr] int32, sorted, every entry in [0, E]; out
// [n_ptr - 1, d] float32. No scratch. Returns the launch's cudaError_t, 0
// on success.
extern "C" int ptr_seg_sum(const void* x, int n_x, int d, const void* rows,
                           const void* ptr, int n_ptr, int mean, void* out,
                           void* stream) {
  const int n_out = n_ptr - 1;
  if (n_out <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int32_t* r = static_cast<const int32_t*>(rows);
  const int32_t* p = static_cast<const int32_t*>(ptr);
  float* o = static_cast<float*>(out);
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(out);
  cudaError_t e;
  if (d % 2 == 0 && align % 8 == 0)
    e = launch<2>(xf, n_x, d, r, p, n_out, mean, o, s);
  else
    e = launch<1>(xf, n_x, d, r, p, n_out, mean, o, s);
  return (int)e;
}
