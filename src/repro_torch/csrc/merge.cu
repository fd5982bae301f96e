// The merge ladder as merge-path passes: every rung of sorted runs, from
// the chunk sort's runs up to the whole array, one pass of two kernels at a
// time.
//
// Replaces repro/kernels/merge.py fused_merge_rounds (keys-only and pair
// variants; the UPE "merging" stage) and the rungs above its super-block,
// which the reference runs at the jnp level (repro/core/ordering.py
// merge_rounds; no Pallas call). The TPU kernel loads one 65,536-pair
// super-block into VMEM and runs every rung there; 512 KiB in and out does
// not fit the 227 KB of shared memory one Hopper CTA can use. What carries
// over is the result: any ladder of stable merges of consecutive runs,
// earlier runs winning ties, is the stable sort by key, whatever its
// fan-ins. So a fan-in-k rung runs here as ceil(log2 k) passes that each
// merge consecutive pairs of sub-runs inside every group of k runs (a pass
// whose last sub-run has no partner copies it), as the caller's list of
// (group, sub-run) passes says.
//
// A pass is the merge path of Green, Odeh and Birk (as in CUB's
// DeviceMergeSort and ModernGPU): merge_partition_kernel bisects, for each
// output tile of a pair, the diagonal of the tile's first
// slot into its co-rank in the pair's first run (A winning ties), one
// thread a tile boundary, into the caller's scratch; merge_tile_kernel, one
// CTA a tile, loads its A and B slices into shared memory, bisects each
// thread's own diagonal there, merges its items serially into registers
// and writes the tile back through shared memory. Every element is read
// once and written once a pass, with no atomics: bound by device-memory
// bytes, and deterministic. The tile is 256 threads x 4 pairs or x 8 keys:
// of seven shapes (128 to 512 threads, 2 to 16 items; tools/merge_tiles.py
// on an H100 80GB HBM3 at 700 W) the fastest for pairs at the convert's
// 2^27 and within 1% of the fastest at a request's 2^19, pairs and keys;
// 16 keys a thread take 8% off keys at 2^27, which no path sorts, and add
// 8% at 2^19.
#include <cuda_runtime.h>
#include <stdint.h>

// Threads of a tile CTA and items a thread, with values and keys alone;
// -D at build time for a probe.
#ifndef MERGE_THREADS
#define MERGE_THREADS 256
#endif
#ifndef MERGE_ITEMS_PAIRS
#define MERGE_ITEMS_PAIRS 4
#endif
#ifndef MERGE_ITEMS_KEYS
#define MERGE_ITEMS_KEYS 8
#endif

namespace {

constexpr int kThreads = MERGE_THREADS;
constexpr int kPartThreads = 256;

// output elements a tile, and the shared words of one tile array (one pad
// word every 32)
template <bool kHasVals>
constexpr int kItems = kHasVals ? MERGE_ITEMS_PAIRS : MERGE_ITEMS_KEYS;
template <bool kHasVals>
constexpr int kTile = kThreads * kItems<kHasVals>;

// A pass over groups of `group` elements, merging consecutive sub-runs of
// `r` in pairs: pair p of a group starts at p * 2r; its A is the first
// min(r, rest) elements, its B the next min(r, rest - |A|) (empty for a
// last sub-run with no partner).
struct Pass {
  int group, r, pairs_per_group, tiles_per_pair;

  __device__ __forceinline__ void pair(long long q, long long* base, int* la,
                                       int* lb) const {
    const long long g = q / pairs_per_group;
    const int p = (int)(q - g * pairs_per_group);
    const int rest = group - p * 2 * r;
    *base = g * group + (long long)p * 2 * r;
    *la = min(r, rest);
    *lb = min(r, rest - *la);
  }
};

// The co-rank of diagonal d: how many of A's elements are among the first
// d outputs of the stable merge of A and B, A's equal keys first.
template <typename Ptr>
__device__ __forceinline__ int merge_path(Ptr a, int la, Ptr b, int lb,
                                          int d) {
  int lo = max(0, d - lb), hi = min(d, la);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= b[d - 1 - mid]) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <int kTileSize>
__global__ void __launch_bounds__(kPartThreads)
merge_partition_kernel(const int32_t* __restrict__ keys, int* __restrict__ part,
                       Pass pass, long long n_bounds) {
  const long long i = (long long)blockIdx.x * kPartThreads + threadIdx.x;
  if (i >= n_bounds) return;
  const long long q = i / (pass.tiles_per_pair + 1);
  const int t = (int)(i - q * (pass.tiles_per_pair + 1));
  long long base;
  int la, lb;
  pass.pair(q, &base, &la, &lb);
  const int d = (int)min((long long)t * kTileSize, (long long)(la + lb));
  part[i] = merge_path(keys + base, la, keys + base + la, lb, d);
}

template <bool kHasVals>
__global__ void __launch_bounds__(kThreads)
merge_tile_kernel(const int32_t* __restrict__ keys,
                  const int32_t* __restrict__ vals,
                  int32_t* __restrict__ out_keys,
                  int32_t* __restrict__ out_vals,
                  const int* __restrict__ part, Pass pass) {
  constexpr int kIt = kItems<kHasVals>;
  constexpr int kT = kTile<kHasVals>;
  constexpr int kPad = kT + kT / 32;
  __shared__ int32_t sk[kPad];
  __shared__ int32_t sv[kHasVals ? kPad : 1];
  const long long q = blockIdx.x / pass.tiles_per_pair;
  const int t = (int)(blockIdx.x - q * pass.tiles_per_pair);
  long long base;
  int la, lb;
  pass.pair(q, &base, &la, &lb);
  const int d0 = t * kT;
  if (d0 >= la + lb) return;  // a short last pair: the whole CTA leaves
  const int cnt = min(kT, la + lb - d0);
  const int* bounds = part + q * (pass.tiles_per_pair + 1) + t;
  const int a0 = bounds[0], na = bounds[1] - a0;
  const int b0 = d0 - a0, nb = cnt - na;
  const int32_t* ka = keys + base + a0;
  const int32_t* kb = keys + base + la + b0;

  // the tile's A slice then its B slice, coalesced
#pragma unroll
  for (int j = 0; j < kIt; ++j) {
    const int i = j * kThreads + threadIdx.x;
    if (i < cnt) {
      sk[i] = i < na ? ka[i] : kb[i - na];
      if constexpr (kHasVals) {
        sv[i] = i < na ? vals[base + a0 + i]
                       : vals[base + la + b0 + i - na];
      }
    }
  }
  __syncthreads();

  // this thread's kIt outputs: its diagonal, then a serial merge
  const int d = min((int)threadIdx.x * kIt, cnt);
  int ai = merge_path(sk, na, sk + na, nb, d);
  int bi = d - ai;
  int32_t xa = ai < na ? sk[ai] : 0;
  int32_t xb = bi < nb ? sk[na + bi] : 0;
  int32_t ok[kIt];
  int src[kIt];
#pragma unroll
  for (int j = 0; j < kIt; ++j) {
    const bool take_a = ai < na && (bi >= nb || xa <= xb);
    ok[j] = take_a ? xa : xb;
    src[j] = take_a ? ai : na + bi;
    if (take_a) {
      ++ai;
      if (ai < na) xa = sk[ai];
    } else {
      ++bi;
      if (bi < nb) xb = sk[na + bi];
    }
  }
  int32_t ov[kIt];
  if constexpr (kHasVals) {
#pragma unroll
    for (int j = 0; j < kIt; ++j)
      ov[j] = d + j < cnt ? sv[src[j]] : 0;
  }
  __syncthreads();

  // back through shared memory in output order (padded: thread-major
  // writes of 4 or 8 a thread hit every bank once), then coalesced stores
#pragma unroll
  for (int j = 0; j < kIt; ++j) {
    const int x = (int)threadIdx.x * kIt + j;
    if (x < cnt) {
      sk[x + (x >> 5)] = ok[j];
      if constexpr (kHasVals) sv[x + (x >> 5)] = ov[j];
    }
  }
  __syncthreads();
  int32_t* ok_out = out_keys + base + d0;
#pragma unroll
  for (int j = 0; j < kIt; ++j) {
    const int x = j * kThreads + threadIdx.x;
    if (x < cnt) {
      ok_out[x] = sk[x + (x >> 5)];
      if constexpr (kHasVals) out_vals[base + d0 + x] = sv[x + (x >> 5)];
    }
  }
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

template <bool kHasVals>
int run_passes(const int32_t* src_k, const int32_t* src_v, int32_t* out_k,
               int32_t* out_v, int32_t* tmp_k, int32_t* tmp_v, int* part,
               long long part_len, int n, const int* groups,
               const int* subruns, int n_passes, cudaStream_t s) {
  constexpr int kT = kTile<kHasVals>;
  for (int i = 0; i < n_passes; ++i) {
    const int group = groups[i], r = subruns[i];
    if (r <= 0 || group <= r || group > n || n % group != 0)
      return (int)cudaErrorInvalidValue;
    const long long bounds = (long long)(n / group) *
                             ceil_div(group, 2LL * r) *
                             (ceil_div(2LL * r, kT) + 1);
    if (bounds > part_len) return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < n_passes; ++i) {
    const bool to_out = (n_passes - 1 - i) % 2 == 0;
    int32_t* dst_k = to_out ? out_k : tmp_k;
    int32_t* dst_v = to_out ? out_v : tmp_v;
    Pass pass;
    pass.group = groups[i];
    pass.r = subruns[i];
    pass.pairs_per_group = (int)ceil_div(pass.group, 2LL * pass.r);
    pass.tiles_per_pair = (int)ceil_div(2LL * pass.r, kT);
    const long long pairs =
        (long long)(n / pass.group) * pass.pairs_per_group;
    const long long n_bounds = pairs * (pass.tiles_per_pair + 1);
    merge_partition_kernel<kT>
        <<<(unsigned)ceil_div(n_bounds, kPartThreads), kPartThreads, 0, s>>>(
            src_k, part, pass, n_bounds);
    merge_tile_kernel<kHasVals>
        <<<(unsigned)(pairs * pass.tiles_per_pair), kThreads, 0, s>>>(
            src_k, src_v, dst_k, dst_v, part, pass);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src_k = dst_k;
    src_v = dst_v;
  }
  return (int)cudaSuccess;
}

}  // namespace

// Runs `n_passes` merge-path passes over `n` keys (and values, or null):
// pass i merges, in groups of groups[i] elements, consecutive pairs of
// sub-runs of subruns[i]. The first pass reads the input, which stays
// untouched; the passes ping-pong between the tmp and out buffers so that
// the last writes out (tmp may be null for one pass). `part` holds the
// tile boundaries of one pass: part_len ints, at least
// n / group * ceil(group / 2r) * (ceil(2r / tile) + 1) for every pass
// (kernels/merge.py MERGE_TILE is the smaller tile); a shorter one is
// refused.
extern "C" int merge_passes(const void* keys, const void* vals,
                            void* out_keys, void* out_vals, void* tmp_keys,
                            void* tmp_vals, void* part, long long part_len,
                            int n, const int* groups, const int* subruns,
                            int n_passes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n_passes <= 0 ||
      (vals != nullptr && out_vals == nullptr) ||
      (n_passes > 1 &&
       (tmp_keys == nullptr || (vals != nullptr && tmp_vals == nullptr))))
    return (int)cudaErrorInvalidValue;
  auto k = [](const void* p) { return static_cast<const int32_t*>(p); };
  auto w = [](void* p) { return static_cast<int32_t*>(p); };
  if (vals != nullptr) {
    return run_passes<true>(k(keys), k(vals), w(out_keys), w(out_vals),
                            w(tmp_keys), w(tmp_vals), static_cast<int*>(part),
                            part_len, n, groups, subruns, n_passes, s);
  }
  return run_passes<false>(k(keys), nullptr, w(out_keys), nullptr,
                           w(tmp_keys), nullptr, static_cast<int*>(part),
                           part_len, n, groups, subruns, n_passes, s);
}
