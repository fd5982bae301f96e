// One stable LSD digit pass of the global_radix Ordering, as two kernels,
// and the UPE chunk sort of the chunked_merge Ordering, which keeps each
// chunk in registers for all its digit passes.
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
// digit_hist + digit_scatter: the card's own design of the same stable
// pass, the textbook GPU LSD pass (a histogram, a scan, a scatter) in
// place of the TPU's partition, bisection and gather. No path launches the
// two kernels above any more; they stay as the reference's one-to-one
// counterparts. Both hold a card tile in registers as the chunk sort
// does (kWarps warps of 32 lanes, kItems items a lane, item j of lane l of
// warp w at w * 32 * kItems + j * 32 + l). digit_hist_kernel: each item
// adds one to its warp's counter of its digit by a shared-memory atomic
// (the order of counting is free; one ballot a digit bit, as the scatter
// ranks, took twice as long at 7 bits), and the CTA writes its counts
// bucket-major, counts[b * T + t], so that one exclusive
// cumsum of the flat [B * T] array (plain torch, as the reference's table
// math is jnp) gives every (bucket, tile) its global output offset.
// digit_scatter_kernel: finds the lanes that share a digit by one
// __ballot_sync a digit bit, ranks each item among its warp's items of the
// same digit in index order, scans the per-warp counters in (bucket, warp)
// order, stages the tile bucket-major in shared memory and writes staged
// slot s of bucket b to offset[b * T + t] + s - base[b]: consecutive
// threads write consecutive addresses of a bucket's run. The order inside
// a bucket is the in-tile order, so the pass is stable. The card's tile is
// its own choice (the stable partition of the whole array does not depend
// on it; the instantiation is the chunk sort's smallest shape that holds
// it); the last tile may be shorter: the histogram skips its missing
// items, the scatter gives them the last digit, so that they rank after
// every real item, and never stores them. Device memory sees keys read
// twice (the histogram and the scatter), values read once, both written
// once: 20 bytes a pair, 12 a key. Bound: those bytes.
//
// chunk_sort: replaces repro/kernels/radix_sort.py radix_sort_chunks and
// radix_sort_chunks_keys (the UPE "splitting" stage): a stable sort of
// every chunk of (key, value) pairs by the unsigned value of key bits
// [0, n_bits), n_bits = min(32, ceil(key_bits / radix_bits) * radix_bits):
// the bits the TPU kernel's ceil(key_bits / radix_bits) LSD passes cover.
// Any schedule of stable digit passes over exactly those bits gives the
// same permutation, so this kernel takes its own: ceil(n_bits / 8) passes,
// widths as even as they can be (7, 7, 6 over 20 bits). One CTA a chunk,
// kWarps warps of 32 lanes, kItems items a lane, held in registers for
// every pass: item j of lane l of warp w is item w * 32 * kItems + j * 32
// + l of the chunk (warp-blocked, lane-striped), so loads, read-backs and
// stores are coalesced and conflict-free. A pass ranks each item among
// its warp's items of the same digit by one __ballot_sync per digit bit
// (the lanes that share the digit), item rounds in order, so a lower
// index ranks first; per-warp bucket counters in shared memory, one
// block-wide exclusive scan of them in (bucket, warp) order, one scatter
// into shared memory and a read-back in the arrangement's order. Items
// past a chunk that is not a multiple of 32 * kWarps * kItems take the
// last digit in every pass: they rank after every real item and are never
// stored. Device memory sees each key and value read once and written
// once; shared memory holds the scatter buffer and the counters only.
// Bound: those bytes.
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

// The chunk sort's digit schedule: ceil(n_bits / 8) passes whose widths
// differ by at most one bit, the wider first (kernels/radix_sort.py
// chunk_digit_schedule mirrors it).
__host__ __device__ __forceinline__ int sort_passes(int n_bits) {
  return n_bits > 8 ? (n_bits + 7) / 8 : 1;
}
__host__ __device__ __forceinline__ int pass_width(int n_bits, int passes,
                                                  int p) {
  return n_bits / passes + (p < n_bits % passes ? 1 : 0);
}

// Exclusive scan, in place, of the per-warp bucket counters cnt[w * stride
// + d] in (bucket d, warp w) order over nb buckets: each bucket's warps in
// warp order, after every lower bucket. s_wsum [kWarps] is scratch. Has
// one barrier inside; the caller puts one before and after.
template <int kWarps>
__device__ __forceinline__ void scan_counters(int32_t* cnt, int stride, int nb,
                                              int32_t* s_wsum) {
  constexpr int kThreads = kWarps * 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = nb * kWarps;
  const int per = (m + kThreads - 1) / kThreads;
  const int f0 = threadIdx.x * per;
  int sum = 0;
  for (int q = 0; q < per; ++q) {
    const int f = f0 + q;
    if (f < m) sum += cnt[(f % kWarps) * stride + f / kWarps];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += x;
  }
  if (lane == 31) s_wsum[warp] = incl;
  __syncthreads();
  int run = incl - sum;
  for (int w = 0; w < warp; ++w) run += s_wsum[w];
  for (int q = 0; q < per; ++q) {
    const int f = f0 + q;
    if (f < m) {
      int32_t* c = &cnt[(f % kWarps) * stride + f / kWarps];
      const int x = *c;
      *c = run;
      run += x;
    }
  }
}

// The UPE chunk sort: one CTA sorts one chunk of at most 32 * kWarps *
// kItems items, its keys (and values) in registers for every pass.
template <int kWarps, int kItems, bool kHasVals>
__global__ void __launch_bounds__(kWarps * 32)
chunk_sort_kernel(const int32_t* __restrict__ keys,
                  const int32_t* __restrict__ vals,
                  int32_t* __restrict__ out_keys,
                  int32_t* __restrict__ out_vals, int chunk, int n_bits) {
  constexpr int kThreads = kWarps * 32;
  extern __shared__ int32_t smem[];
  const int passes = sort_passes(n_bits);
  const int stride = (1 << pass_width(n_bits, passes, 0)) + 1;  // padded
  int32_t* cnt = smem;                                    // [kWarps][stride]
  int32_t* s_wsum = cnt + kWarps * stride;                // [kWarps]
  int32_t* s_k = s_wsum + kWarps;                         // [chunk]
  int32_t* s_v = s_k + chunk;                             // [chunk] (pairs)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lanes_below = (1u << lane) - 1u;
  const size_t off = (size_t)blockIdx.x * (size_t)chunk;
  const int i0 = warp * 32 * kItems + lane;  // item j is i0 + 32 j
  int32_t* my = cnt + warp * stride;

  int32_t k[kItems], v[kItems];
  int rank[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = i0 + 32 * j;
    k[j] = i < chunk ? keys[off + i] : 0;
    if (kHasVals) v[j] = i < chunk ? vals[off + i] : 0;
  }
  int shift = 0;
  for (int p = 0; p < passes; ++p) {
    const int width = pass_width(n_bits, passes, p);
    const unsigned dmask = (1u << width) - 1u;
    const int nb = 1 << width;
    for (int b = lane; b < nb; b += 32) my[b] = 0;
    // the lanes that share each item's digit: one ballot a digit bit, all
    // items' ballots of a bit together
    unsigned d[kItems], peers[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      d[j] = i0 + 32 * j < chunk ? ((uint32_t)k[j] >> shift) & dmask : dmask;
      peers[j] = 0xffffffffu;
    }
    for (int b = 0; b < width; ++b) {
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const unsigned bit = (d[j] >> b) & 1u;
        const unsigned bal = __ballot_sync(0xffffffffu, bit);
        peers[j] &= bit ? bal : ~bal;
      }
    }
    __syncwarp();
    // rank among the warp's items of the same digit, in index order
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const unsigned lower = peers[j] & lanes_below;
      const int before = my[d[j]];
      rank[j] = before + __popc(lower);
      __syncwarp();
      if (!lower) my[d[j]] = before + __popc(peers[j]);
      __syncwarp();
    }
    __syncthreads();
    scan_counters<kWarps>(cnt, stride, nb, s_wsum);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (i0 + 32 * j < chunk) {
        const int pos = my[d[j]] + rank[j];
        s_k[pos] = k[j];
        if (kHasVals) s_v[pos] = v[j];
      }
    }
    __syncthreads();
    if (p + 1 < passes) {
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int i = i0 + 32 * j;
        if (i < chunk) {
          k[j] = s_k[i];
          if (kHasVals) v[j] = s_v[i];
        }
      }
    }
    shift += width;
  }
  for (int i = threadIdx.x; i < chunk; i += kThreads) {
    out_keys[off + i] = s_k[i];
    if (kHasVals) out_vals[off + i] = s_v[i];
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

// The lanes of the warp whose item j has the same digit as this lane's:
// one ballot a digit bit, all items' ballots of a bit together.
template <int kItems>
__device__ __forceinline__ void ballot_peers(const unsigned (&d)[kItems],
                                             unsigned (&peers)[kItems],
                                             int width) {
  for (int b = 0; b < width; ++b) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const unsigned bit = (d[j] >> b) & 1u;
      const unsigned bal = __ballot_sync(0xffffffffu, bit);
      peers[j] &= bit ? bal : ~bal;
    }
  }
}

// The digit counts of one card tile, written bucket-major:
// counts[b * n_tiles + t].
template <int kWarps, int kItems>
__global__ void __launch_bounds__(kWarps * 32)
digit_hist_kernel(const int32_t* __restrict__ keys,
                  int32_t* __restrict__ counts, int n, int tile, int shift,
                  int width) {
  constexpr int kThreads = kWarps * 32;
  extern __shared__ int32_t cnt[];  // [kWarps][stride]
  const int nb = 1 << width;
  const int stride = nb + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t off = (size_t)blockIdx.x * (size_t)tile;
  const int len = min(tile, n - (int)(blockIdx.x * tile));
  const int i0 = warp * 32 * kItems + lane;
  int32_t* my = cnt + warp * stride;
  for (int b = lane; b < nb; b += 32) my[b] = 0;
  int d[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = i0 + 32 * j;
    d[j] = i < len ? ((keys[off + i] >> shift) & (nb - 1)) : -1;
  }
  __syncwarp();
  // the order of counting is free: one shared atomic an item
#pragma unroll
  for (int j = 0; j < kItems; ++j)
    if (d[j] >= 0) atomicAdd(&my[d[j]], 1);
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += kThreads) {
    int h = 0;
    for (int w = 0; w < kWarps; ++w) h += cnt[w * stride + b];
    counts[(size_t)b * gridDim.x + blockIdx.x] = h;
  }
}

// The stable scatter of one card tile to its global slots: offsets[b * T
// + t] is where the tile's run of bucket b starts in the output.
template <int kWarps, int kItems, bool kHasVals>
__global__ void __launch_bounds__(kWarps * 32)
digit_scatter_kernel(const int32_t* __restrict__ keys,
                     const int32_t* __restrict__ vals,
                     const int32_t* __restrict__ offsets,
                     int32_t* __restrict__ out_keys,
                     int32_t* __restrict__ out_vals, int n, int tile,
                     int shift, int width) {
  constexpr int kThreads = kWarps * 32;
  extern __shared__ int32_t smem[];
  const int nb = 1 << width;
  const int stride = nb + 1;  // padded
  const unsigned dmask = (unsigned)nb - 1u;
  int32_t* cnt = smem;                      // [kWarps][stride]
  int32_t* s_wsum = cnt + kWarps * stride;  // [kWarps]
  int32_t* s_dst = s_wsum + kWarps;         // [nb]
  int32_t* s_k = s_dst + nb;                // [tile]
  int32_t* s_v = s_k + tile;                // [tile] (pairs)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lanes_below = (1u << lane) - 1u;
  const size_t off = (size_t)blockIdx.x * (size_t)tile;
  const int len = min(tile, n - (int)(blockIdx.x * tile));
  const int i0 = warp * 32 * kItems + lane;
  int32_t* my = cnt + warp * stride;
  for (int b = lane; b < nb; b += 32) my[b] = 0;

  int32_t k[kItems], v[kItems];
  unsigned d[kItems], peers[kItems];
  int rank[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = i0 + 32 * j;
    k[j] = i < len ? keys[off + i] : 0;
    if (kHasVals) v[j] = i < len ? vals[off + i] : 0;
    // an item past the tile takes the last digit: it ranks after every
    // real item and is never stored
    d[j] = i < len ? (unsigned)(k[j] >> shift) & dmask : dmask;
    peers[j] = 0xffffffffu;
  }
  ballot_peers<kItems>(d, peers, width);
  __syncwarp();
  // rank among the warp's items of the same digit, in index order
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const unsigned lower = peers[j] & lanes_below;
    const int before = my[d[j]];
    rank[j] = before + __popc(lower);
    __syncwarp();
    if (!lower) my[d[j]] = before + __popc(peers[j]);
    __syncwarp();
  }
  __syncthreads();
  scan_counters<kWarps>(cnt, stride, nb, s_wsum);
  __syncthreads();
  // warp 0's start of bucket b is the bucket's base in the tile
  for (int b = threadIdx.x; b < nb; b += kThreads)
    s_dst[b] = offsets[(size_t)b * gridDim.x + blockIdx.x] - cnt[b];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (i0 + 32 * j < len) {
      const int pos = my[d[j]] + rank[j];
      s_k[pos] = k[j];
      if (kHasVals) s_v[pos] = v[j];
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < len; s += kThreads) {
    const int32_t key = s_k[s];
    const int dst = s_dst[(unsigned)(key >> shift) & dmask] + s;
    out_keys[dst] = key;
    if (kHasVals) out_vals[dst] = s_v[s];
  }
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

// The chunk sort's instantiations, by the chunks they hold: (warps,
// items a lane), the smallest that holds the chunk is launched
// (kernels/radix_sort.py CHUNK_SORT_SHAPES mirrors it; pairs up to 16384).
constexpr int kSortShapes[][2] = {{1, 4},  {4, 4},  {8, 8},  {16, 8},
                                  {32, 8}, {32, 16}, {32, 32}};
constexpr int kNumSortShapes = sizeof(kSortShapes) / sizeof(kSortShapes[0]);
constexpr int kMaxPairChunk = 32 * 32 * 16;

// the instantiation that sorts chunks of ``chunk``, or -1
static int sort_shape(int chunk, bool has_vals) {
  for (int s = 0; s < kNumSortShapes; ++s) {
    const int cap = 32 * kSortShapes[s][0] * kSortShapes[s][1];
    if (chunk <= cap) return has_vals && cap > kMaxPairChunk ? -1 : s;
  }
  return -1;
}

extern "C" size_t chunk_sort_smem_bytes(int chunk, int n_bits,
                                        int has_vals) {
  const int s = sort_shape(chunk, has_vals);
  if (s < 0 || n_bits < 1 || n_bits > 32) return 0;
  const int nb = 1 << pass_width(n_bits, sort_passes(n_bits), 0);
  return sizeof(int32_t) * ((size_t)kSortShapes[s][0] * (nb + 2) +
                            (size_t)(has_vals ? 2 : 1) * chunk);
}

template <int kWarps, int kItems, bool kHasVals>
static int launch_chunk_sort(const void* keys, const void* vals,
                             void* out_keys, void* out_vals, int n_chunks,
                             int chunk, int n_bits, size_t smem,
                             cudaStream_t s) {
  auto* kernel = chunk_sort_kernel<kWarps, kItems, kHasVals>;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  kernel<<<n_chunks, kWarps * 32, smem, s>>>(
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(vals),
      static_cast<int32_t*>(out_keys), static_cast<int32_t*>(out_vals),
      chunk, n_bits);
  return (int)cudaGetLastError();
}

template <bool kHasVals>
static int chunk_sort_by_shape(int shape, const void* keys, const void* vals,
                               void* out_keys, void* out_vals, int n_chunks,
                               int chunk, int n_bits, size_t smem,
                               cudaStream_t s) {
#define CHUNK_SORT_CASE(i, w, it)                                         \
  case i:                                                                 \
    return launch_chunk_sort<w, it, kHasVals>(keys, vals, out_keys,       \
                                              out_vals, n_chunks, chunk,  \
                                              n_bits, smem, s);
  switch (shape) {
    CHUNK_SORT_CASE(0, 1, 4)
    CHUNK_SORT_CASE(1, 4, 4)
    CHUNK_SORT_CASE(2, 8, 8)
    CHUNK_SORT_CASE(3, 16, 8)
    CHUNK_SORT_CASE(4, 32, 8)
    CHUNK_SORT_CASE(5, 32, 16)
  }
  if constexpr (!kHasVals) {
    if (shape == 6)
      return launch_chunk_sort<32, 32, false>(keys, vals, out_keys, out_vals,
                                              n_chunks, chunk, n_bits, smem,
                                              s);
  }
#undef CHUNK_SORT_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" int chunk_sort(const void* keys, const void* vals, void* out_keys,
                          void* out_vals, int n_chunks, int chunk,
                          int n_bits, void* stream) {
  const bool has_vals = vals != nullptr;
  const size_t smem = chunk_sort_smem_bytes(chunk, n_bits, has_vals);
  if (!smem || n_chunks < 0 || chunk < 1) return (int)cudaErrorInvalidValue;
  if (!n_chunks) return (int)cudaSuccess;
  const int shape = sort_shape(chunk, has_vals);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return has_vals ? chunk_sort_by_shape<true>(shape, keys, vals, out_keys,
                                              out_vals, n_chunks, chunk,
                                              n_bits, smem, s)
                  : chunk_sort_by_shape<false>(shape, keys, nullptr, out_keys,
                                               nullptr, n_chunks, chunk,
                                               n_bits, smem, s);
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

// The digit pass's tile: at most kMaxDigitTile, held by the chunk sort's
// smallest shape from (4, 4) on that holds it (kernels/radix_sort.py
// digit_pass_shape mirrors it).
constexpr int kMaxDigitTile = 16384;

static int digit_shape(int tile) {
  if (tile < 1 || tile > kMaxDigitTile) return -1;
  const int s = sort_shape(tile, false);
  return s < 1 ? 1 : s;
}

static bool digit_args_ok(int n, int tile, int width) {
  return n >= 0 && digit_shape(tile) >= 0 && width >= 1 && width <= 8;
}

extern "C" size_t digit_hist_smem_bytes(int tile, int width) {
  const int s = digit_shape(tile);
  if (s < 0 || width < 1 || width > 8) return 0;
  return sizeof(int32_t) * (size_t)kSortShapes[s][0] * ((1 << width) + 1);
}

extern "C" size_t digit_scatter_smem_bytes(int tile, int width,
                                           int has_vals) {
  const int s = digit_shape(tile);
  if (s < 0 || width < 1 || width > 8) return 0;
  const size_t warps = kSortShapes[s][0], nb = (size_t)1 << width;
  return sizeof(int32_t) * (warps * (nb + 1) + warps + nb +
                            (size_t)(has_vals ? 2 : 1) * tile);
}

template <int kWarps, int kItems>
static int launch_digit_hist(const void* keys, void* counts, int n,
                             int tile, int shift, int width, size_t smem,
                             cudaStream_t s) {
  const int n_tiles = (int)(((size_t)n + tile - 1) / tile);
  digit_hist_kernel<kWarps, kItems><<<n_tiles, kWarps * 32, smem, s>>>(
      static_cast<const int32_t*>(keys), static_cast<int32_t*>(counts), n,
      tile, shift, width);
  return (int)cudaGetLastError();
}

extern "C" int digit_hist(const void* keys, void* counts, int n, int tile,
                          int shift, int width, void* stream) {
  if (!digit_args_ok(n, tile, width)) return (int)cudaErrorInvalidValue;
  if (!n) return (int)cudaSuccess;
  const size_t smem = digit_hist_smem_bytes(tile, width);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DIGIT_HIST_CASE(i, w, it) \
  case i:                         \
    return launch_digit_hist<w, it>(keys, counts, n, tile, shift, width, \
                                    smem, s);
  switch (digit_shape(tile)) {
    DIGIT_HIST_CASE(1, 4, 4)
    DIGIT_HIST_CASE(2, 8, 8)
    DIGIT_HIST_CASE(3, 16, 8)
    DIGIT_HIST_CASE(4, 32, 8)
    DIGIT_HIST_CASE(5, 32, 16)
  }
#undef DIGIT_HIST_CASE
  return (int)cudaErrorInvalidValue;
}

template <int kWarps, int kItems, bool kHasVals>
static int launch_digit_scatter(const void* keys, const void* vals,
                                const void* offsets, void* out_keys,
                                void* out_vals, int n, int tile, int shift,
                                int width, size_t smem, cudaStream_t s) {
  auto* kernel = digit_scatter_kernel<kWarps, kItems, kHasVals>;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const int n_tiles = (int)(((size_t)n + tile - 1) / tile);
  kernel<<<n_tiles, kWarps * 32, smem, s>>>(
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(vals),
      static_cast<const int32_t*>(offsets), static_cast<int32_t*>(out_keys),
      static_cast<int32_t*>(out_vals), n, tile, shift, width);
  return (int)cudaGetLastError();
}

template <bool kHasVals>
static int digit_scatter_by_shape(const void* keys, const void* vals,
                                  const void* offsets, void* out_keys,
                                  void* out_vals, int n, int tile, int shift,
                                  int width, size_t smem, cudaStream_t s) {
#define DIGIT_SCATTER_CASE(i, w, it)                                       \
  case i:                                                                  \
    return launch_digit_scatter<w, it, kHasVals>(keys, vals, offsets,      \
                                                 out_keys, out_vals, n,    \
                                                 tile, shift, width, smem, \
                                                 s);
  switch (digit_shape(tile)) {
    DIGIT_SCATTER_CASE(1, 4, 4)
    DIGIT_SCATTER_CASE(2, 8, 8)
    DIGIT_SCATTER_CASE(3, 16, 8)
    DIGIT_SCATTER_CASE(4, 32, 8)
    DIGIT_SCATTER_CASE(5, 32, 16)
  }
#undef DIGIT_SCATTER_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" int digit_scatter(const void* keys, const void* vals,
                             const void* offsets, void* out_keys,
                             void* out_vals, int n, int tile, int shift,
                             int width, void* stream) {
  if (!digit_args_ok(n, tile, width)) return (int)cudaErrorInvalidValue;
  if (!n) return (int)cudaSuccess;
  const bool has_vals = vals != nullptr;
  const size_t smem = digit_scatter_smem_bytes(tile, width, has_vals);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return has_vals
             ? digit_scatter_by_shape<true>(keys, vals, offsets, out_keys,
                                            out_vals, n, tile, shift, width,
                                            smem, s)
             : digit_scatter_by_shape<false>(keys, nullptr, offsets,
                                             out_keys, nullptr, n, tile,
                                             shift, width, smem, s);
}
