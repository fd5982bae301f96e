// The span-sum body shared by the pointer segment sum (ptr_scan.cu) and
// the segment sum over dst-sorted edges (segment_agg.cu):
//   out[i, :] = sum over e in [p(i), p(i + 1)) of x[row(e), :]
// with row(e) = e, or, given a gather index, row(e) = rows[e] clamped into
// [0, n_x - 1]; with ``mean`` each output row is divided by
// max(p(i + 1) - p(i), 1) (IEEE division; the build uses no fast math).
// p is a pointer array: given as ptr (ptr_seg_sum), or p(i) =
// lower_bound(dst, i) over a sorted dst as segment_sum_sorted's bounds
// pass writes it, with its tail given by two numbers (kTail below). Every
// kernel source is its own library (kernels/_build.py), so each includes
// this header.
//
// Summation order, fixed by the span's length alone (so two launches give
// the same bits, a lane gives the same bits batched and alone, and both
// callers give the same bits on the same spans): a span of len rows is cut
// into K adjacent pieces of P = max(kPiece, ceil(len / kMaxPieces)) rows
// (the last one shorter); each piece is summed from 0 in row order; the K
// piece sums are combined adjacent pair by adjacent pair, level by level
// (an odd last one carries up). Every partial is the sum of a contiguous
// sub-range of the span.
//
// Layout: the output rows are cut into tiles; a column vector (V floats:
// 2 where D and the alignment allow) of an output row is an element.
// Short spans (len <= kSerialRows, the serve path's): a tile's elements
// are cut into contiguous shares, one a CTA; a thread an element (narrow
// D: many segments a warp; wide D: a segment over warps), so loads along a
// row and the output's stores are coalesced; the share's pointers are
// staged in shared memory first. Long spans: all the tile's CTAs take one
// 32-byte sector of columns of each long span of the tile in turn, their
// threads as (piece block, column); a thread sums an aligned block of 2^m
// pieces as it sums a short span, a register stack giving the pairwise
// combination, and the blocks are combined pairwise in shared memory,
// which is the same order.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace span_sum {

constexpr int kThreads = 256;
constexpr int kPiece = 32;        // rows of a piece, at least
constexpr int kMaxPieces = 1024;  // pieces of a span, at most
constexpr int kSerialRows = 256;  // a span this long or shorter: a thread
constexpr int kSerialLevels = 3;  // log2(kSerialRows / kPiece)
constexpr int kMaxElems = 16;  // a thread's short-span elements, at most
constexpr int kShare = kMaxElems * kThreads;  // a CTA's elements, at most
constexpr int kAhead = 4;  // a thread's loads in flight
// pieces of a thread's block in a long span, at most 2^kBlockLevels: at
// least kThreads / 8 blocks run in parallel (long_cols)
constexpr int kBlockLevels = 5;
static_assert(kMaxPieces <= (kThreads / 8) << kBlockLevels,
              "a long span's blocks must fit the CTA");
template <int V> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };

__device__ __forceinline__ void zero(float& v) { v = 0.0f; }
__device__ __forceinline__ void zero(float2& v) { v = make_float2(0.f, 0.f); }
__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float quot(float a, float q) { return a / q; }
__device__ __forceinline__ float2 quot(float2 a, float q) {
  return make_float2(a.x / q, a.y / q);
}

__device__ __forceinline__ int piece_rows(int len) {
  return max(kPiece, (len + kMaxPieces - 1) / kMaxPieces);
}

__device__ __forceinline__ int row_of(const int32_t* __restrict__ rows,
                                      int e, int n_x) {
  return rows ? min(max(__ldg(rows + e), 0), n_x - 1) : e;
}

// The pairwise combination's stack, by recursion on the level so that
// every index is a constant and the stack stays in registers: push a sum of
// 2^L pieces (the q-th of its level's run), combining it with the pending
// one of its level when q is odd; fold the pending sums of a count of nk
// pieces right to left (the odd last ones carry up).
template <int L, int LEVELS, typename T>
__device__ __forceinline__ void push(T (&stack)[LEVELS + 1], T v, int q) {
  if constexpr (L <= LEVELS) {
    if ((q >> L) & 1)
      push<L + 1, LEVELS>(stack, add(stack[L], v), q);
    else
      stack[L] = v;
  }
}

template <int L, int LEVELS, typename T>
__device__ __forceinline__ void fold(const T (&stack)[LEVELS + 1], int nk,
                                     T& acc, bool& have) {
  if constexpr (L <= LEVELS) {
    if ((nk >> L) & 1) {
      acc = have ? add(stack[L], acc) : stack[L];
      have = true;
    }
    fold<L + 1, LEVELS>(stack, nk, acc, have);
  }
}

template <int LEVELS, typename T>
__device__ __forceinline__ T folded(const T (&stack)[LEVELS + 1], int nk) {
  T acc;
  zero(acc);
  bool have = false;
  fold<0, LEVELS>(stack, nk, acc, have);
  return acc;
}

// Rows [e0, e1) at column vector c, in pieces of P rows from e0 (at most
// 2^LEVELS of them): each piece summed from 0 in row order, the loads
// issued kAhead rows ahead of the adds; the pieces combined pairwise.
template <int V, int LEVELS>
__device__ __forceinline__ typename Vec<V>::T piece_sum(
    const typename Vec<V>::T* __restrict__ xc, int C, int n_x,
    const int32_t* __restrict__ rows, int e0, int e1, int P) {
  using T = typename Vec<V>::T;
  T stack[LEVELS + 1];
  const int nk = (e1 - e0 + P - 1) / P;
  for (int q = 0; q < nk; ++q) {
    const int r1 = min(e0 + (q + 1) * P, e1);
    T v;
    zero(v);
    int e = e0 + q * P;
    for (; e + kAhead <= r1; e += kAhead) {
      T got[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
        got[u] = __ldg(xc + (size_t)row_of(rows, e + u, n_x) * C);
#pragma unroll
      for (int u = 0; u < kAhead; ++u) v = add(v, got[u]);
    }
    for (; e < r1; ++e)
      v = add(v, __ldg(xc + (size_t)row_of(rows, e, n_x) * C));
    push<0, LEVELS>(stack, v, q);
  }
  return folded<LEVELS>(stack, nk);
}

// A long span's column vectors a CTA: one 32-byte sector of each row, so
// that as many CTAs as the width allows share the span's rows, each read
// whole sectors.
template <int V>
__host__ __device__ constexpr int long_cols() { return 8 / V; }

// The sums of one CTA: tile blockIdx.x / ny, share blockIdx.x % ny (a
// tile's ny CTAs are launched together). ``index`` is the pointer array
// [n_out + 1]; kTail: p(i) = index[i] below a tail T and P from T on, with
// T = index[n_out + 1] and P = index[n_out + 2] (the entries from T on are
// not written). A tile's short spans are its elements [rows, D / V] cut
// into ny contiguous shares (see span_grid), the share's pointers staged
// in shared memory first (one coalesced load; the pointer loads, not the
// bytes, would bound the mostly empty spans of a sampled subgraph); its
// long spans are summed by all ny CTAs of the tile, long_cols<V>() column
// vectors each.
template <int V, bool kTail>
__device__ __forceinline__ void span_sum_body(
    const float* __restrict__ x, int n_x, int d,
    const int32_t* __restrict__ rows, const int32_t* __restrict__ index,
    int n_out, int mean, float* __restrict__ out, int tile_rows, int ny) {
  using T = typename Vec<V>::T;
  __shared__ int32_t sptr[kShare + 2];  // the share's pointers
  __shared__ T part[kThreads];         // a long span's block sums
  const int C = d / V;
  const T* xv = reinterpret_cast<const T*>(x);
  T* dst = reinterpret_cast<T*>(out);
  const int y = blockIdx.x % ny;
  const int i0 = (blockIdx.x / ny) * tile_rows;
  const int i1 = min(i0 + tile_rows, n_out);
  int tail = 0, tail_ptr = 0;
  if constexpr (kTail) {
    tail = __ldg(index + n_out + 1);
    tail_ptr = __ldg(index + n_out + 2);
  }
  auto bound = [&](int i) {
    if constexpr (kTail) return i >= tail ? tail_ptr : __ldg(index + i);
    else return __ldg(index + i);
  };

  // short spans: this CTA's share of the tile's elements (tile_rows * C
  // stays below 2^31, and a share holds at most kShare: see span_grid)
  const int span = (i1 - i0) * C;
  const int share = (span + ny - 1) / ny;
  const int t0 = y * share, t1 = min(span, t0 + share);
  if (t0 < t1) {
    const int lo = t0 / C, n_rows = (t1 - 1) / C - lo + 1;
    for (int k = threadIdx.x; k <= n_rows; k += kThreads)
      sptr[k] = bound(i0 + lo + k);
    __syncthreads();
    // element t = (lo + k) * C + c, stepped by kThreads without a division
    const int dk = kThreads / C, dc = kThreads % C;
    int k = (t0 + threadIdx.x) / C - lo, c = (t0 + threadIdx.x) % C;
    for (int t = t0 + threadIdx.x; t < t1; t += kThreads) {
      const int a = sptr[k], b = sptr[k + 1], len = b - a;
      if (len <= kSerialRows) {
        T s;
        zero(s);
        if (len) {
          s = piece_sum<V, kSerialLevels>(xv + c, C, n_x, rows, a, b,
                                          kPiece);
          if (mean) s = quot(s, (float)len);
        }
        dst[(size_t)i0 * C + t] = s;
      }
      k += dk;
      c += dc;
      if (c >= C) {
        c -= C;
        ++k;
      }
    }
  }

  // long spans: each in turn, by every CTA of the tile (none where the
  // tile's spans hold kSerialRows rows in all)
  int any = 0;
  if (bound(i1) - bound(i0) > kSerialRows)
    for (int k = i0 + threadIdx.x; k < i1; k += kThreads)
      any |= bound(k + 1) - bound(k) > kSerialRows;
  if (!__syncthreads_or(any)) return;
  const int cw = min(C, long_cols<V>());
  const int R = kThreads / cw;  // a long span's piece blocks in parallel
  const int r = threadIdx.x / cw;
  const int c = y * cw + threadIdx.x % cw;
  const bool active = r < R && c < C;
  for (int i = i0; i < i1; ++i) {
    const int a = bound(i), b = bound(i + 1), len = b - a;
    if (len <= kSerialRows) continue;
    const int P = piece_rows(len), K = (len + P - 1) / P;
    int m = 0;
    while (((K + (1 << m) - 1) >> m) > R) ++m;
    const int nb = (K + (1 << m) - 1) >> m;
    if (active && r < nb) {
      const int e0 = a + (r << m) * P;
      part[threadIdx.x] = piece_sum<V, kBlockLevels>(
          xv + c, C, n_x, rows, e0, min(e0 + (P << m), b), P);
    }
    __syncthreads();
    for (int s = 1; s < nb; s <<= 1) {
      if (active && r % (2 * s) == 0 && r + s < nb)
        part[threadIdx.x] = add(part[threadIdx.x],
                                part[threadIdx.x + s * cw]);
      __syncthreads();
    }
    if (active && r == 0) {
      T v = part[threadIdx.x];
      if (mean) v = quot(v, (float)len);
      dst[(size_t)i * C + c] = v;
    }
  }
}

// The card's SMs, asked once a process (0 and the error on failure).
inline cudaError_t card_sms(int* sms) {
  static int cached = 0;
  if (!cached) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount,
                                 dev);
    if (e != cudaSuccess) return e;
  }
  *sms = cached;
  return cudaSuccess;
}

struct SpanGrid {
  int tile_rows, ny;
  int64_t ctas;
};

// The tiles of n_out output rows of width d: ny CTAs a tile, one
// long_cols<V>() sector of columns each for the long spans. A share of C /
// 8 elements a thread, at least 2 and at most kMaxElems (a tile holds at
// most kShare * ny elements, a share at most kShare + ny): fewer where
// rows are narrow, so that
// the seeds' spans, the longest, at the front, spread over more CTAs;
// fewer still where that would leave fewer than 4 CTAs an SM.
template <int V>
SpanGrid span_grid(int n_out, int d, int sms) {
  const int C = d / V;
  const int ny = (C + long_cols<V>() - 1) / long_cols<V>();
  const int64_t want = (int64_t)std::min(std::max(C / 8, 2), kMaxElems)
                       * kThreads;
  const int64_t full = std::max<int64_t>(1, want * ny / C);
  const int64_t spread = ((int64_t)n_out * ny + 4 * sms - 1) / (4 * sms);
  const int64_t tile = std::max<int64_t>(1, std::min(full, spread));
  return SpanGrid{(int)tile, ny, (n_out + tile - 1) / tile * ny};
}

}  // namespace span_sum
