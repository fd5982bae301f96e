// The SCR set-count: counts[t] = #{x in elements : x < targets[t]}.
//
// Replaces repro/kernels/set_count.py set_count_less (the comparator array
// + adder tree of the Reshaper, paper Fig. 13): the count-based CSC pointer
// build of the unfused epilogue. The TPU kernel does all T * E compares in
// [T, E] comparator tiles, carrying each target block's partial counts
// across the sequential element-block grid axis. The function may not
// assume sorted elements, but it need not compare every pair: two
// launches, in the order of the wrapper's one call.
//
// tile_sort_kernel (C entry set_count_tile_sort): one CTA per tile of
// kSortTile elements sorts the tile in shared memory by a bitonic network
// on signed int32 compares (no key-range assumption: negatives and
// INT32_MIN / INT32_MAX order as themselves), the ragged last tile padded
// with INT32_MAX, which is never below a target. It writes the sorted tile
// to the scratch buffer and the tile's min and max to ``bounds``.
//
// set_count_kernel (C entry set_count_count): one CTA owns kThreads *
// kPerThread targets in registers. It first classifies kThreads tiles at
// a time against the CTA's target range [tmin, tmax]: a tile whose max is
// below tmin adds its live count to every target with no load, a tile
// whose min is at or above tmax adds nothing, and the rest go on a shared
// list. For a listed tile each thread does the same test per target
// (t > max: the live count; t <= min: nothing); only when __syncthreads_or
// says some target lies in (min, max] does the CTA copy the tile into
// shared memory, and those threads bisect it for the lower bound of t.
// Integer sums in registers, no atomics on the counts, no cross-CTA
// state: the result is the same bits on every launch, for any element
// order.
//
// The scratch (n_tiles * kSortTile sorted elements, 2 * n_tiles bounds)
// is the caller's; both entries take its lengths and refuse a buffer
// shorter than this file's kSortTile needs. With a non-null ``work``
// (unsigned long long[4], zeroed by the caller) the kernels also count
// the work they do on these inputs: [0] the sort's compares, [1] the
// count pass's compares (tile and target range tests, kSortLog2 per
// bisection), [2] bisections, [3] tiles copied to shared memory. A null
// ``work`` runs the instantiations that count nothing.
//
// Bound: bytes, each input read once and the output written once. The
// work depends on the data: the sort is n_tiles * 78 compare-exchange
// stages of kSortTile / 2 pairs; the count bisects once per (target,
// tile) pair whose tile straddles the target. On the sorted serve path a
// CTA's 512 consecutive targets straddle one or two tiles; on shuffled
// elements every tile straddles every CTA's range, T * (E / kSortTile) *
// kSortLog2 lookups against T * E compares all-pairs.
//
// filter_tree_lookup replaces repro/kernels/set_count.py filter_tree_lookup
// (the Reindexer's equality comparators + OR tree): for each target,
// enc = the max over keys equal to it of payload + 1 (int32 wrap-around),
// 0 where none is; out = enc - 1 and hit where enc > 0, else -1. The TPU
// kernel compares all pairs; here a hash build and probe, two launches in
// the order of the wrapper's one call, O(E + T) work:
//
// filter_build_kernel (C entry filter_hash_build, which first fills the
// caller's table with bytes 0xFF): one thread a key; an open-addressing
// table of 2^bits int2 slots (key, enc), 2^bits >= 2 E, whose empty slot
// is all ones (the key -1, the enc -1, a miss). A multiplicative hash
// picks a group of kGroup slots (one 32-byte sector); a thread reads the
// group from L2 in one go and claims the first empty slot by a 64-bit
// atomicCAS of (key, payload + 1), or raises the enc of its key's slot by
// atomicMax, then goes on group by group (linear probing over groups). A
// set key never changes, so a key read as another's is final; a slot read
// as empty is only tried. A key equal to the empty key -1 goes to the one
// slot after the table. Integer max is order-independent, so the
// encodings are the same bits on every launch (the layout is not), and
// duplicate keys keep their largest payload + 1, as the max of the TPU
// kernel's OR tree does.
//
// filter_probe_kernel (C entry filter_hash_probe): one thread a target,
// reading its groups from its hash until its key or an empty slot. The
// TPU kernel and the twin (core/set_count.py filter_lookup) pad a ragged
// last block of keys (E % kTile != 0) with INT32_MIN keys of payload 0,
// so there a target INT32_MIN takes at least enc 1. Bound: bytes, keys
// and payloads read once, targets read once, out and hit written once;
// the table (8 bytes a slot, 2-4 slots a key: 1 MiB at 65,536 keys,
// 8 MiB at 282,624) stays in L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 4;
constexpr int kTile = 2048;  // the key block the TPU kernel and twin pad to
constexpr int kFilterThreads = 256;
constexpr int32_t kFilterEmpty = -1;  // a key slot of bytes 0xFF
constexpr unsigned long long kEmptySlot = ~0ull;  // (key -1, enc -1)
constexpr int kGroupLog2 = 2;  // a probe reads 2^kGroupLog2 slots at once
constexpr int kGroup = 1 << kGroupLog2;
constexpr int kSortLog2 = 12;
constexpr int kSortTile = 1 << kSortLog2;  // kernels/set_count.py SORT_TILE
constexpr int kSortThreads = 512;
constexpr int32_t kInt32Max = 0x7FFFFFFF;
constexpr int32_t kInt32Min = -kInt32Max - 1;

// the sum of x over the warp, added to *dst by lane 0
__device__ __forceinline__ void warp_count(unsigned long long* dst,
                                           unsigned x) {
  x = __reduce_add_sync(0xffffffffu, x);
  if ((threadIdx.x & 31) == 0 && x) atomicAdd(dst, (unsigned long long)x);
}

template <bool kCount>
__global__ void __launch_bounds__(kSortThreads)
tile_sort_kernel(const int32_t* __restrict__ elems, int n_elems,
                 int32_t* __restrict__ sorted, int32_t* __restrict__ bounds,
                 unsigned long long* __restrict__ work) {
  __shared__ int32_t s[kSortTile];
  const size_t base = (size_t)blockIdx.x * kSortTile;
  unsigned n_cmp = 0;
  for (int i = threadIdx.x; i < kSortTile; i += kSortThreads)
    s[i] = base + i < (size_t)n_elems ? elems[base + i] : kInt32Max;
  __syncthreads();
  for (int k = 2; k <= kSortTile; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < kSortTile / 2; i += kSortThreads) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = lo + j;
        const int32_t a = s[lo], b = s[hi];
        if ((a > b) == ((lo & k) == 0)) {  // ascending where lo & k == 0
          s[lo] = b;
          s[hi] = a;
        }
        if constexpr (kCount) ++n_cmp;
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < kSortTile; i += kSortThreads)
    sorted[base + i] = s[i];
  if (threadIdx.x == 0) {
    bounds[2 * blockIdx.x] = s[0];
    bounds[2 * blockIdx.x + 1] = s[kSortTile - 1];
  }
  if constexpr (kCount) warp_count(&work[0], n_cmp);
}

// number of elements of the sorted tile s below t, for min < t <= max
// (so the answer lies in [1, kSortTile - 1]): binary lifting
__device__ __forceinline__ int lower_bound(const int32_t* s, int32_t t) {
  int pos = 0;
#pragma unroll
  for (int step = kSortTile / 2; step > 0; step >>= 1)
    if (s[pos + step - 1] < t) pos += step;
  return pos;
}

// the elements of tile i that are not INT32_MAX padding
__device__ __forceinline__ int live_count(int i, int n_elems) {
  return (int)min((long long)kSortTile,
                  (long long)n_elems - (long long)i * kSortTile);
}

template <bool kCount>
__global__ void __launch_bounds__(kThreads)
set_count_kernel(const int32_t* __restrict__ sorted,
                 const int32_t* __restrict__ bounds, int n_tiles, int n_elems,
                 const int32_t* __restrict__ targets, int n_targets,
                 int32_t* __restrict__ counts,
                 unsigned long long* __restrict__ work) {
  __shared__ __align__(16) int32_t s_e[kSortTile];
  __shared__ int s_list[kThreads];
  __shared__ int s_n;
  __shared__ int32_t s_red[3][kThreads / 32];
  const int t0 = blockIdx.x * kThreads * kPerThread + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t t[kPerThread];
  int c[kPerThread];
  int32_t lo = kInt32Max, hi = kInt32Min;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int ti = t0 + j * kThreads;
    t[j] = ti < n_targets ? targets[ti] : kInt32Min;  // never inside a tile
    c[j] = 0;
    if (ti < n_targets) {
      lo = min(lo, t[j]);
      hi = max(hi, t[j]);
    }
  }
  // the CTA's target range [tmin, tmax]
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if (lane == 0) {
    s_red[0][warp] = lo;
    s_red[1][warp] = hi;
  }
  __syncthreads();
  int32_t tmin = s_red[0][0], tmax = s_red[1][0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) {
    tmin = min(tmin, s_red[0][w]);
    tmax = max(tmax, s_red[1][w]);
  }

  int below = 0;  // live elements of the tiles wholly below tmin
  unsigned n_cmp = 0, n_bisect = 0, n_copy = 0;
  for (int c0 = 0; c0 < n_tiles; c0 += kThreads) {
    if (threadIdx.x == 0) s_n = 0;
    __syncthreads();
    const int i = c0 + threadIdx.x;
    if (i < n_tiles) {
      const int32_t mn = bounds[2 * i], mx = bounds[2 * i + 1];
      if (mx < tmin)
        below += live_count(i, n_elems);
      else if (mn < tmax)
        s_list[atomicAdd(&s_n, 1)] = i;  // list order does not change sums
      if constexpr (kCount) n_cmp += mx < tmin ? 1 : 2;
    }
    __syncthreads();
    const int n_list = s_n;
    for (int li = 0; li < n_list; ++li) {
      const int tile = s_list[li];
      const int32_t mn = bounds[2 * tile], mx = bounds[2 * tile + 1];
      const int live = live_count(tile, n_elems);
      unsigned inside = 0;  // bit j: t[j] in (min, max]
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        if (t[j] > mx)
          c[j] += live;
        else if (t[j] > mn)
          inside |= 1u << j;
        if constexpr (kCount) n_cmp += t[j] > mx ? 1 : 2;
      }
      if (__syncthreads_or(inside != 0)) {
        const int4* src =
            reinterpret_cast<const int4*>(sorted + (size_t)tile * kSortTile);
        for (int v = threadIdx.x; v < kSortTile / 4; v += kThreads)
          reinterpret_cast<int4*>(s_e)[v] = src[v];
        if constexpr (kCount) n_copy += threadIdx.x == 0;
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kPerThread; ++j)
          if (inside >> j & 1u) {
            c[j] += lower_bound(s_e, t[j]);
            if constexpr (kCount) {
              ++n_bisect;
              n_cmp += kSortLog2;
            }
          }
        __syncthreads();
      }
    }
  }
  // every target is above the tiles counted in ``below``
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    below += __shfl_xor_sync(0xffffffffu, below, off);
  if (lane == 0) s_red[2][warp] = below;
  __syncthreads();
  below = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) below += s_red[2][w];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int ti = t0 + j * kThreads;
    if (ti < n_targets) counts[ti] = c[j] + below;
  }
  if constexpr (kCount) {
    warp_count(&work[1], n_cmp);
    warp_count(&work[2], n_bisect);
    warp_count(&work[3], n_copy);
  }
}

// the group of key k in a table of 2^bits groups (Fibonacci hashing;
// kernels/set_count.py filter_hash mirrors it)
__device__ __forceinline__ unsigned filter_hash(int32_t k, int bits) {
  return ((uint32_t)k * 0x9E3779B1u) >> (32 - bits);
}

__global__ void __launch_bounds__(kFilterThreads)
filter_build_kernel(const int32_t* __restrict__ keys,
                    const int32_t* __restrict__ payloads, int n_keys,
                    int2* __restrict__ table, int bits) {
  const int i = blockIdx.x * kFilterThreads + threadIdx.x;
  if (i >= n_keys) return;
  const int32_t k = keys[i];
  // payload + 1 wraps in int32 as the reference's does
  const int32_t enc = (int32_t)((uint32_t)payloads[i] + 1u);
  if (k == kFilterEmpty) {
    atomicMax(&table[1u << bits].y, enc);
    return;
  }
  const unsigned long long mine =
      (unsigned long long)(uint32_t)enc << 32 | (uint32_t)k;
  const unsigned gmask = (1u << (bits - kGroupLog2)) - 1u;
  for (unsigned g = filter_hash(k, bits - kGroupLog2);;
       g = (g + 1u) & gmask) {
    int2* grp = table + (size_t)g * kGroup;
    const int4 a = __ldcg(reinterpret_cast<const int4*>(grp));
    const int4 b = __ldcg(reinterpret_cast<const int4*>(grp) + 1);
    const int32_t seen[kGroup] = {a.x, a.z, b.x, b.z};
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      int32_t key = seen[q];
      if (key == kFilterEmpty) {
        const unsigned long long prev = atomicCAS(
            reinterpret_cast<unsigned long long*>(&grp[q]), kEmptySlot, mine);
        if (prev == kEmptySlot) return;
        key = (int32_t)(uint32_t)prev;  // taken meanwhile
      }
      if (key == k) {
        atomicMax(&grp[q].y, enc);
        return;
      }
    }
  }
}

__global__ void __launch_bounds__(kFilterThreads)
filter_probe_kernel(const int2* __restrict__ table, int bits, bool ragged,
                    const int32_t* __restrict__ targets, int n_targets,
                    int32_t* __restrict__ out, uint8_t* __restrict__ hit) {
  const int i = blockIdx.x * kFilterThreads + threadIdx.x;
  if (i >= n_targets) return;
  const int32_t t = targets[i];
  int32_t enc = -1;
  if (t == kFilterEmpty) {
    enc = table[1u << bits].y;
  } else {
    const unsigned gmask = (1u << (bits - kGroupLog2)) - 1u;
    for (unsigned g = filter_hash(t, bits - kGroupLog2);;
         g = (g + 1u) & gmask) {
      const int4* grp =
          reinterpret_cast<const int4*>(table + (size_t)g * kGroup);
      const int4 a = grp[0], b = grp[1];
      const int32_t key[kGroup] = {a.x, a.z, b.x, b.z};
      const int32_t val[kGroup] = {a.y, a.w, b.y, b.w};
      bool done = false;  // the first slot holding t or empty ends it
#pragma unroll
      for (int q = kGroup - 1; q >= 0; --q)
        if (key[q] == t || key[q] == kFilterEmpty) {
          done = true;
          enc = key[q] == t ? val[q] : -1;
        }
      if (done) break;
    }
  }
  if (ragged && t == kInt32Min) enc = max(enc, 1);  // the padding's key
  out[i] = enc > 0 ? enc - 1 : -1;
  hit[i] = enc > 0;
}

}  // namespace

// the tiles of n_elems elements, or -1 when the scratch (``sorted_len``
// ints of sorted tiles, ``bounds_len`` of bounds) is too short for them
static int tiles_of(int n_elems, long long sorted_len, long long bounds_len) {
  const long long n_tiles = ((long long)n_elems + kSortTile - 1) / kSortTile;
  return n_elems >= 0 && sorted_len >= n_tiles * kSortTile &&
                 bounds_len >= 2 * n_tiles
             ? (int)n_tiles
             : -1;
}

extern "C" int set_count_tile_sort(const void* elems, int n_elems,
                                   void* sorted, long long sorted_len,
                                   void* bounds, long long bounds_len,
                                   void* work, void* stream) {
  const int n_tiles = tiles_of(n_elems, sorted_len, bounds_len);
  if (n_tiles < 0) return (int)cudaErrorInvalidValue;
  if (!n_tiles) return (int)cudaSuccess;
  auto* w = static_cast<unsigned long long*>(work);
  auto* kernel = w ? tile_sort_kernel<true> : tile_sort_kernel<false>;
  kernel<<<n_tiles, kSortThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(elems), n_elems,
      static_cast<int32_t*>(sorted), static_cast<int32_t*>(bounds), w);
  return (int)cudaGetLastError();
}

extern "C" int set_count_count(const void* sorted, long long sorted_len,
                               const void* bounds, long long bounds_len,
                               int n_elems, const void* targets,
                               int n_targets, void* counts, void* work,
                               void* stream) {
  const int n_tiles = tiles_of(n_elems, sorted_len, bounds_len);
  if (n_tiles < 0 || n_targets < 0) return (int)cudaErrorInvalidValue;
  if (!n_targets) return (int)cudaSuccess;
  auto* w = static_cast<unsigned long long*>(work);
  auto* kernel = w ? set_count_kernel<true> : set_count_kernel<false>;
  const int per_cta = kThreads * kPerThread;
  kernel<<<(n_targets + per_cta - 1) / per_cta, kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sorted),
      static_cast<const int32_t*>(bounds), n_tiles, n_elems,
      static_cast<const int32_t*>(targets), n_targets,
      static_cast<int32_t*>(counts), w);
  return (int)cudaGetLastError();
}

// log2 of the filter table's slots for n_keys keys: 2^bits >= 2 n_keys,
// at least two groups (kernels/set_count.py filter_table_bits mirrors it)
static int filter_bits(int n_keys) {
  int bits = kGroupLog2 + 1;
  while ((1LL << bits) < 2LL * n_keys) ++bits;
  return bits;
}

// the table (``table_len`` int2 slots) holds 2^bits + 1 slots for n_keys
static bool filter_table_fits(int n_keys, long long table_len) {
  return n_keys >= 0 && table_len >= (1LL << filter_bits(n_keys)) + 1;
}

extern "C" int filter_hash_build(const void* keys, const void* payloads,
                                 int n_keys, void* table, long long table_len,
                                 void* stream) {
  if (!filter_table_fits(n_keys, table_len)) return (int)cudaErrorInvalidValue;
  const int bits = filter_bits(n_keys);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc = cudaMemsetAsync(
      table, 0xFF, sizeof(int2) * ((size_t(1) << bits) + 1), s);
  if (rc != cudaSuccess) return (int)rc;
  if (!n_keys) return (int)cudaSuccess;
  filter_build_kernel<<<(n_keys + kFilterThreads - 1) / kFilterThreads,
                        kFilterThreads, 0, s>>>(
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(payloads),
      n_keys, static_cast<int2*>(table), bits);
  return (int)cudaGetLastError();
}

extern "C" int filter_hash_probe(const void* table, long long table_len,
                                 int n_keys, const void* targets,
                                 int n_targets, void* out, void* hit,
                                 void* stream) {
  if (!filter_table_fits(n_keys, table_len) || n_targets < 0)
    return (int)cudaErrorInvalidValue;
  if (!n_targets) return (int)cudaSuccess;
  filter_probe_kernel<<<(n_targets + kFilterThreads - 1) / kFilterThreads,
                        kFilterThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int2*>(table), filter_bits(n_keys),
      n_keys % kTile != 0, static_cast<const int32_t*>(targets), n_targets,
      static_cast<int32_t*>(out), static_cast<uint8_t*>(hit));
  return (int)cudaGetLastError();
}
