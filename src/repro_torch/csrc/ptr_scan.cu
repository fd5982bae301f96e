// The GNN forward's pointer segment sum as a column scan:
// out[i, :] = cs[ptr[i + 1], :] - cs[ptr[i], :], where cs is the float32
// prefix sum of msgs [E, D] along E with a zero row in front.
//
// Replaces no TPU kernel: the reference computes this in jnp
// (repro/models/gnn.py _ptr_seg_sum, a cumsum over axis 0 and two takes),
// which the port first ran as a torch.cumsum over a transposed copy of the
// whole [E, D] message stream. Hopper scans the columns in place: threads
// run across columns, so every row is read coalesced, and rows are cut
// into chunks of a fixed size (chosen by shape alone, so a lane computes
// the same bits batched and alone; no atomics). Four steps, one launch
// each, all on the caller's stream:
//   1. chunk_total_kernel: each chunk's column sums, from 0, in row order;
//   2. chunk_carry_kernel: a sequential exclusive scan of the totals per
//      column, in place (the carry into each chunk below ptr[N]);
//   3. chunk_rescan_kernel: each chunk summed again in the same order from
//      0 (so its last local sum equals its total bit for bit) and
//      carry + local written at every pointer position in the chunk, once
//      per run of equal pointers (its first index, ``first[p - 1]``,
//      marked by mark_kernel over a -1 fill);
//   4. difference_kernel: out[i] = V(ptr[i + 1]) - V(ptr[i]), V(0) = 0,
//      a CTA a contiguous span of output rows, written element by element.
// The [E + 1, D] prefix is never written: only the rows at pointer
// positions (a table indexed like ptr). Rows at and past ptr[N], the
// largest pointer, affect no output and are not read. Bound: device-memory
// bytes — the rows below ptr[N] read, the output written; steps 1 and 3
// read those rows twice.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;  // threads of a CTA, one column each
constexpr int kDiffThreads = 256;   // the difference kernel's CTA
constexpr int kMaxDiffRows = 1024;  // its rows a CTA, at most
constexpr int kDiffSpan = 8192;     // its floats a CTA, about

__global__ void __launch_bounds__(256)
mark_kernel(const int32_t* __restrict__ ptr, int n_ptr,
            int32_t* __restrict__ first) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_ptr) return;
  const int p = ptr[j];
  if (p >= 1 && (j == 0 || ptr[j - 1] != p)) first[p - 1] = j;
}

__global__ void __launch_bounds__(kCols)
chunk_total_kernel(const float* __restrict__ msgs, int n_rows, int d,
                   int chunk, const int32_t* __restrict__ ptr, int n_ptr,
                   float* __restrict__ totals) {
  const int c = blockIdx.y * kCols + threadIdx.x;
  const int r0 = blockIdx.x * chunk;
  const int lim = min(n_rows, ptr[n_ptr - 1]);
  if (c >= d || r0 >= lim) return;
  const int r1 = min(r0 + chunk, lim);
  float acc = 0.0f;
  const float* col = msgs + (size_t)r0 * d + c;
#pragma unroll 16
  for (int r = r0; r < r1; ++r, col += d) acc += __ldg(col);
  totals[(size_t)blockIdx.x * d + c] = acc;
}

__global__ void __launch_bounds__(kCols)
chunk_carry_kernel(float* __restrict__ totals, int n_rows, int d, int chunk,
                   const int32_t* __restrict__ ptr, int n_ptr) {
  const int c = blockIdx.x * kCols + threadIdx.x;
  if (c >= d) return;
  // only the chunks below ptr[N] are summed and rescanned
  const int lim = min(n_rows, ptr[n_ptr - 1]);
  const int n_chunks = (lim + chunk - 1) / chunk;
  float carry = 0.0f;
  float* t = totals + c;
#pragma unroll 16
  for (int k = 0; k < n_chunks; ++k, t += d) {
    const float v = *t;
    *t = carry;
    carry += v;
  }
}

__global__ void __launch_bounds__(kCols)
chunk_rescan_kernel(const float* __restrict__ msgs, int n_rows, int d,
                    int chunk, const int32_t* __restrict__ ptr, int n_ptr,
                    const float* __restrict__ carries,
                    const int32_t* __restrict__ first,
                    float* __restrict__ table) {
  const int c = blockIdx.y * kCols + threadIdx.x;
  const int r0 = blockIdx.x * chunk;
  const int lim = min(n_rows, ptr[n_ptr - 1]);
  if (c >= d || r0 >= lim) return;
  const int r1 = min(r0 + chunk, lim);
  const float carry = carries[(size_t)blockIdx.x * d + c];
  float acc = 0.0f;
  const float* col = msgs + (size_t)r0 * d + c;
#pragma unroll 8
  for (int r = r0; r < r1; ++r, col += d) {
    acc += __ldg(col);
    const int j = __ldg(first + r);
    if (j >= 0) table[(size_t)j * d + c] = carry + acc;
  }
}

__global__ void __launch_bounds__(kDiffThreads)
difference_kernel(const int32_t* __restrict__ ptr, int n_out, int d,
                  const int32_t* __restrict__ first,
                  const float* __restrict__ table, float* __restrict__ out,
                  int rows_per_cta) {
  // a CTA writes rows [i0, i0 + rows) of out, one contiguous span of
  // rows * d floats, element by element (coalesced whatever d is). Each
  // row's two table rows (-1: the zero prefix at position 0) are looked
  // up once, into shared memory.
  __shared__ int lo_row[kMaxDiffRows], hi_row[kMaxDiffRows];
  const int i0 = blockIdx.x * rows_per_cta;
  const int rows = min(rows_per_cta, n_out - i0);
  for (int i = threadIdx.x; i < rows; i += kDiffThreads) {
    const int a = ptr[i0 + i], b = ptr[i0 + i + 1];
    lo_row[i] = a ? first[a - 1] : -1;
    hi_row[i] = b ? first[b - 1] : -1;
  }
  __syncthreads();
  float* dst = out + (size_t)i0 * d;
  const int span = rows * d;
#pragma unroll 4
  for (int t = threadIdx.x; t < span; t += kDiffThreads) {
    const int i = t / d, c = t - i * d;
    const int ja = lo_row[i], jb = hi_row[i];
    const float va = ja >= 0 ? table[(size_t)ja * d + c] : 0.0f;
    const float vb = jb >= 0 ? table[(size_t)jb * d + c] : 0.0f;
    dst[t] = vb - va;
  }
}

}  // namespace

// msgs [n_rows, d] float32 row-major; ptr [n_ptr] int32, sorted, every
// entry in [0, n_rows]; out [n_ptr - 1, d]. Scratch from the caller:
// first [n_rows] int32, totals [ceil(n_rows / chunk), d] float32, table
// [n_ptr, d] float32. Returns the first launch error (cudaError_t), 0 on
// success.
extern "C" int ptr_seg_sum(const void* msgs, int n_rows, int d,
                           const void* ptr, int n_ptr, int chunk, void* out,
                           void* first, void* totals, void* table,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(msgs);
  const int32_t* p = static_cast<const int32_t*>(ptr);
  int32_t* f = static_cast<int32_t*>(first);
  float* tot = static_cast<float*>(totals);
  float* tab = static_cast<float*>(table);
  const int col_blocks = (d + kCols - 1) / kCols;
  const int n_out = n_ptr - 1;
  if (n_out <= 0 || d <= 0) return 0;
  if (n_rows > 0) {
    const int n_chunks = (n_rows + chunk - 1) / chunk;
    cudaError_t e = cudaMemsetAsync(f, 0xFF, sizeof(int32_t) * n_rows, s);
    if (e != cudaSuccess) return (int)e;
    mark_kernel<<<(n_ptr + 255) / 256, 256, 0, s>>>(p, n_ptr, f);
    chunk_total_kernel<<<dim3(n_chunks, col_blocks), kCols, 0, s>>>(
        m, n_rows, d, chunk, p, n_ptr, tot);
    chunk_carry_kernel<<<col_blocks, kCols, 0, s>>>(tot, n_rows, d, chunk,
                                                    p, n_ptr);
    chunk_rescan_kernel<<<dim3(n_chunks, col_blocks), kCols, 0, s>>>(
        m, n_rows, d, chunk, p, n_ptr, tot, f, tab);
  }
  const int rows = max(1, min(kMaxDiffRows, kDiffSpan / d));
  difference_kernel<<<(n_out + rows - 1) / rows, kDiffThreads, 0, s>>>(
      p, n_out, d, f, tab, static_cast<float*>(out), rows);
  return (int)cudaGetLastError();
}
