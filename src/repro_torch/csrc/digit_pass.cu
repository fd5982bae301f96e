// One stable LSD digit pass of the global_radix Ordering, as two kernels,
// and the UPE chunk sort of the chunked_merge Ordering, which reuses the
// digit pass's in-tile partition for every pass.
//
// Replaces the two pallas_call kernels of repro/kernels/radix_sort.py
// global_digit_pass: the tiled partition + histogram (keys-only and pair
// variants) and the rank-gather of output-slot sources. The [T, B] table
// scan between them and the final gather stay plain torch ops.
//
// digit_partition_hist: one CTA per tile. The TPU kernel partitions a
// VMEM-resident tile with a one-hot prefix sum and a bisection per slot;
// here each warp owns a contiguous segment of the tile and ranks its
// elements among equal digits with __match_any_sync, so a tile costs two
// passes over its keys (count, then place) and O(warps * buckets) shared
// counters. The placed tile is staged in dynamic shared memory (4096 pairs
// take 32 KiB) and written back coalesced. Output order inside a bucket is
// warp-segment order, then position in the segment: the in-tile order,
// which is what makes the pass stable. Bound: device-memory bytes (each
// key and value read twice, once per pass, the second time mostly from L2,
// and written once).
//
// digit_rank_gather: one thread per output slot j. b is the last bucket
// whose global base is <= j, r = j - gbase[b], t the first tile whose
// inclusive count of bucket b reaches r + 1 (bisection over the [T, B]
// table, which lives in global memory and L2: 2 MiB per table at 2^27
// elements), and the source is t*tile + lbase[t,b] + r - excl[t,b] — the
// rank arithmetic of repro/core/set_partition.py rank_gather_sources.
// Bound: the int32 store of the output; the table reads hit L2.
//
// chunk_sort: replaces repro/kernels/radix_sort.py radix_sort_chunks and
// radix_sort_chunks_keys (the UPE "splitting" stage): a stable LSD radix
// sort of every chunk of (key, value) pairs, ceil(key_bits / radix_bits)
// passes. The TPU kernel holds its chunk in VMEM for all passes; here one
// CTA holds its chunk in dynamic shared memory, ping-ponging between two
// buffers (4096 pairs in and out: 64 KiB), and runs partition_tile once
// per digit, so device memory sees each key and value read once and
// written once whatever the pass count. Bound: those bytes; the passes
// themselves are shared-memory traffic and warp votes, so the kernel sits
// well above the byte bound (one CTA per chunk, about one CTA per SM at
// 2^19 pairs).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPartThreads = 256;
constexpr int kPartWarps = kPartThreads / 32;

// Stable partition of one tile [0, tile) by digit (key >> shift) & (B - 1)
// from in_keys (in_vals) into the shared-memory buffers out_keys (out_vals).
// The inputs may live in global or shared memory. cnt [warps][B], total [B]
// and base [B] are shared scratch; on return total holds the tile's bucket
// counts and base their exclusive scan. Ends with a barrier.
template <bool kHasVals>
__device__ void partition_tile(const int32_t* in_keys, const int32_t* in_vals,
                               int32_t* out_keys, int32_t* out_vals,
                               int32_t* cnt, int32_t* total, int32_t* base,
                               int tile, int shift, int n_buckets) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int mask = n_buckets - 1;
  const unsigned lanes_below = (1u << lane) - 1u;
  // contiguous warp segments, a multiple of 32 long, in tile order
  const int seg = ((tile + kPartWarps - 1) / kPartWarps + 31) / 32 * 32;
  const int begin = min(warp * seg, tile);
  const int end = min(begin + seg, tile);

  for (int i = threadIdx.x; i < kPartWarps * n_buckets; i += blockDim.x)
    cnt[i] = 0;
  __syncthreads();

  // pass 1: per-warp bucket counts (one leader per digit group adds)
  for (int i0 = begin; i0 < end; i0 += 32) {
    const int i = i0 + lane;
    const bool valid = i < end;
    const int d = valid ? ((in_keys[i] >> shift) & mask) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (valid && lane == __ffs(peers) - 1)
      cnt[warp * n_buckets + d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // bucket totals, then the exclusive scan over buckets (warp 0)
  for (int b = threadIdx.x; b < n_buckets; b += blockDim.x) {
    int h = 0;
    for (int w = 0; w < kPartWarps; ++w) h += cnt[w * n_buckets + b];
    total[b] = h;
  }
  __syncthreads();
  if (warp == 0) {
    const int per = (n_buckets + 31) / 32;
    const int b0 = min(lane * per, n_buckets);
    const int b1 = min(b0 + per, n_buckets);
    int s = 0;
    for (int b = b0; b < b1; ++b) s += total[b];
    int incl = s;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    int acc = incl - s;
    for (int b = b0; b < b1; ++b) {
      base[b] = acc;
      acc += total[b];
    }
  }
  __syncthreads();
  // per-warp start offsets
  for (int b = threadIdx.x; b < n_buckets; b += blockDim.x) {
    int run = base[b];
    for (int w = 0; w < kPartWarps; ++w) {
      const int c = cnt[w * n_buckets + b];
      cnt[w * n_buckets + b] = run;
      run += c;
    }
  }
  __syncthreads();

  // pass 2: stable placement
  for (int i0 = begin; i0 < end; i0 += 32) {
    const int i = i0 + lane;
    const bool valid = i < end;
    const int32_t k = valid ? in_keys[i] : 0;
    const int d = valid ? ((k >> shift) & mask) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (valid) {
      const int pos = cnt[warp * n_buckets + d] + __popc(peers & lanes_below);
      out_keys[pos] = k;
      if (kHasVals) out_vals[pos] = in_vals[i];
    }
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1)
      cnt[warp * n_buckets + d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
}

template <bool kHasVals>
__global__ void __launch_bounds__(kPartThreads)
partition_hist_kernel(const int32_t* __restrict__ keys,
                      const int32_t* __restrict__ vals,
                      int32_t* __restrict__ out_keys,
                      int32_t* __restrict__ out_vals,
                      int32_t* __restrict__ lbase_out,
                      int32_t* __restrict__ hist_out,
                      int tile, int shift, int n_buckets) {
  extern __shared__ int32_t smem[];
  int32_t* s_keys = smem;                                 // [tile]
  int32_t* s_vals = smem + tile;                          // [tile] (pairs)
  int32_t* cnt = smem + (kHasVals ? 2 : 1) * tile;        // [warps][B]
  int32_t* total = cnt + kPartWarps * n_buckets;          // [B]
  int32_t* base = total + n_buckets;                      // [B]
  const size_t off = (size_t)blockIdx.x * (size_t)tile;

  partition_tile<kHasVals>(keys + off, kHasVals ? vals + off : nullptr,
                           s_keys, s_vals, cnt, total, base, tile, shift,
                           n_buckets);
  // publish the tile's table rows, then write the placed tile coalesced
  for (int b = threadIdx.x; b < n_buckets; b += blockDim.x) {
    lbase_out[(size_t)blockIdx.x * n_buckets + b] = base[b];
    hist_out[(size_t)blockIdx.x * n_buckets + b] = total[b];
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    out_keys[off + i] = s_keys[i];
    if (kHasVals) out_vals[off + i] = s_vals[i];
  }
}

// The UPE chunk sort: one CTA sorts one chunk, resident in shared memory
// for all n_passes LSD digit passes (ping-pong between two buffers).
template <bool kHasVals>
__global__ void __launch_bounds__(kPartThreads)
chunk_sort_kernel(const int32_t* __restrict__ keys,
                  const int32_t* __restrict__ vals,
                  int32_t* __restrict__ out_keys,
                  int32_t* __restrict__ out_vals, int chunk, int n_passes,
                  int radix_bits) {
  extern __shared__ int32_t smem[];
  const int n_buckets = 1 << radix_bits;
  int32_t* k0 = smem;                                     // [chunk]
  int32_t* k1 = smem + chunk;                             // [chunk]
  int32_t* v0 = smem + 2 * chunk;                         // [chunk] (pairs)
  int32_t* v1 = smem + 3 * chunk;                         // [chunk] (pairs)
  int32_t* cnt = smem + (kHasVals ? 4 : 2) * chunk;       // [warps][B]
  int32_t* total = cnt + kPartWarps * n_buckets;          // [B]
  int32_t* base = total + n_buckets;                      // [B]
  const size_t off = (size_t)blockIdx.x * (size_t)chunk;

  for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
    k0[i] = keys[off + i];
    if (kHasVals) v0[i] = vals[off + i];
  }
  __syncthreads();
  for (int p = 0; p < n_passes; ++p) {
    partition_tile<kHasVals>(k0, v0, k1, v1, cnt, total, base, chunk,
                             p * radix_bits, n_buckets);
    int32_t* t = k0; k0 = k1; k1 = t;
    t = v0; v0 = v1; v1 = t;
  }
  for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
    out_keys[off + i] = k0[i];
    if (kHasVals) out_vals[off + i] = v0[i];
  }
}

__global__ void rank_gather_kernel(const int32_t* __restrict__ gbase,
                                   const int32_t* __restrict__ incl,
                                   const int32_t* __restrict__ excl,
                                   const int32_t* __restrict__ lbase,
                                   int32_t* __restrict__ out, int n,
                                   int n_tiles, int tile, int n_buckets) {
  extern __shared__ int32_t s_gbase[];
  for (int i = threadIdx.x; i < n_buckets; i += blockDim.x)
    s_gbase[i] = gbase[i];
  __syncthreads();
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  // b = last bucket with gbase[b] <= j (gbase is non-decreasing)
  int lo = 0, hi = n_buckets;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_gbase[mid] <= j) lo = mid + 1; else hi = mid;
  }
  const int b = lo - 1;
  const int r = j - s_gbase[b];
  // t = first tile whose inclusive count of bucket b is >= r + 1
  lo = 0;
  hi = n_tiles;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (incl[(size_t)mid * n_buckets + b] < r + 1) lo = mid + 1; else hi = mid;
  }
  const size_t e = (size_t)lo * n_buckets + b;
  out[j] = lo * tile + lbase[e] + r - excl[e];
}

}  // namespace

extern "C" size_t digit_partition_smem_bytes(int tile, int n_buckets,
                                             int has_vals) {
  return sizeof(int32_t) * ((size_t)(has_vals ? 2 : 1) * tile +
                            (size_t)(kPartWarps + 2) * n_buckets);
}

extern "C" int digit_partition_hist(const void* keys, const void* vals,
                                    void* out_keys, void* out_vals,
                                    void* lbase, void* hist, int n_tiles,
                                    int tile, int shift, int n_buckets,
                                    void* stream) {
  const size_t smem = digit_partition_smem_bytes(tile, n_buckets,
                                                 vals != nullptr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vals != nullptr) {
    cudaFuncSetAttribute(partition_hist_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    partition_hist_kernel<true><<<n_tiles, kPartThreads, smem, s>>>(
        static_cast<const int32_t*>(keys), static_cast<const int32_t*>(vals),
        static_cast<int32_t*>(out_keys), static_cast<int32_t*>(out_vals),
        static_cast<int32_t*>(lbase), static_cast<int32_t*>(hist), tile,
        shift, n_buckets);
  } else {
    cudaFuncSetAttribute(partition_hist_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    partition_hist_kernel<false><<<n_tiles, kPartThreads, smem, s>>>(
        static_cast<const int32_t*>(keys), nullptr,
        static_cast<int32_t*>(out_keys), nullptr,
        static_cast<int32_t*>(lbase), static_cast<int32_t*>(hist), tile,
        shift, n_buckets);
  }
  return (int)cudaGetLastError();
}

extern "C" size_t chunk_sort_smem_bytes(int chunk, int n_buckets,
                                        int has_vals) {
  return sizeof(int32_t) * ((size_t)(has_vals ? 4 : 2) * chunk +
                            (size_t)(kPartWarps + 2) * n_buckets);
}

extern "C" int chunk_sort(const void* keys, const void* vals, void* out_keys,
                          void* out_vals, int n_chunks, int chunk,
                          int n_passes, int radix_bits, void* stream) {
  const size_t smem = chunk_sort_smem_bytes(chunk, 1 << radix_bits,
                                            vals != nullptr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vals != nullptr) {
    cudaFuncSetAttribute(chunk_sort_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    chunk_sort_kernel<true><<<n_chunks, kPartThreads, smem, s>>>(
        static_cast<const int32_t*>(keys), static_cast<const int32_t*>(vals),
        static_cast<int32_t*>(out_keys), static_cast<int32_t*>(out_vals),
        chunk, n_passes, radix_bits);
  } else {
    cudaFuncSetAttribute(chunk_sort_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    chunk_sort_kernel<false><<<n_chunks, kPartThreads, smem, s>>>(
        static_cast<const int32_t*>(keys), nullptr,
        static_cast<int32_t*>(out_keys), nullptr, chunk, n_passes,
        radix_bits);
  }
  return (int)cudaGetLastError();
}

extern "C" int digit_rank_gather(const void* gbase, const void* incl,
                                 const void* excl, const void* lbase,
                                 void* out, int n, int n_tiles, int tile,
                                 int n_buckets, void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  rank_gather_kernel<<<blocks, threads, sizeof(int32_t) * n_buckets,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(gbase), static_cast<const int32_t*>(incl),
      static_cast<const int32_t*>(excl), static_cast<const int32_t*>(lbase),
      static_cast<int32_t*>(out), n, n_tiles, tile, n_buckets);
  return (int)cudaGetLastError();
}
