// The UPE set-partition: a stable partition of each block of values by a
// bool condition (selected values first, then the rest, both in input
// order), plus the selected count of each block.
//
// Replaces repro/kernels/prefix_partition.py prefix_partition, where each
// grid step holds one block in VMEM and runs the log-depth adder network
// (prefix sums of the condition and of its complement) and a relocation
// router (a bisection per output slot, then a gather). Here a CTA holds a
// tile of kTile elements in registers, kItems a thread (one 16-byte load
// of values and one 4-byte load of flags where the alignment allows,
// scalar loads at a ragged edge), and needs no router: one ballot a slot
// ranks each element among its warp's selected ones, one barrier shares the
// warp totals, and every element then knows how many selected elements come
// before it (s): it goes to slot s if selected and to n_sel + (i - s) if
// not, inside its block. The partitioned tile is staged in shared memory
// and stored coalesced. Blocks of at most kTile share a CTA, as many whole
// blocks as a tile holds (their bounds' ranks read back after one more
// barrier); a larger block is walked tile by tile with carried counts,
// its selected count taken first from its flags alone. Bound: bytes —
// values and flags read once, values and counts written once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;

// elements [4t, 4t + 4) of the kItems-wide slots of the tile at g (cnt
// elements) into v / f; flags past cnt are 0
__device__ __forceinline__ void load_tile(const int32_t* __restrict__ vals,
                                          const uint8_t* __restrict__ cond,
                                          int64_t g, int cnt,
                                          int32_t (&v)[kItems],
                                          bool (&f)[kItems]) {
  const int i = threadIdx.x * kItems;
  const int32_t* pv = vals + g + i;
  const uint8_t* pc = cond + g + i;
  if (i + kItems <= cnt && (reinterpret_cast<uintptr_t>(pv) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(pc) & 3) == 0) {
    const int4 w = __ldg(reinterpret_cast<const int4*>(pv));
    const uint32_t c = __ldg(reinterpret_cast<const unsigned int*>(pc));
    v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
#pragma unroll
    for (int j = 0; j < kItems; ++j) f[j] = (c >> (8 * j)) & 0xff;
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const bool live = i + j < cnt;
      v[j] = live ? __ldg(pv + j) : 0;
      f[j] = live && __ldg(pc + j) != 0;
    }
  }
}

// pre[j]: the selected elements of the tile before slot j of this thread;
// returns the tile's selected count. One barrier; s_warp may be rewritten
// only after another barrier.
__device__ __forceinline__ int tile_ranks(const bool (&f)[kItems],
                                          int (&pre)[kItems],
                                          int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  int before = 0, total = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const unsigned bal = __ballot_sync(0xffffffffu, f[j]);
    before += __popc(bal & lt);
    total += __popc(bal);
  }
  if (lane == 0) s_warp[warp] = total;
  __syncthreads();
  int tile = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int x = s_warp[w];
    before += w < warp ? x : 0;
    tile += x;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    pre[j] = before;
    before += f[j];
  }
  return tile;
}

// stage[0, cnt) -> out[g, g + cnt), 16 bytes a thread where aligned
__device__ __forceinline__ void store_tile(const int32_t* stage,
                                           int32_t* __restrict__ out,
                                           int64_t g, int cnt) {
  const int i = threadIdx.x * kItems;
  int32_t* po = out + g + i;
  if (i + kItems <= cnt && (reinterpret_cast<uintptr_t>(po) & 15) == 0) {
    *reinterpret_cast<int4*>(po) =
        make_int4(stage[i], stage[i + 1], stage[i + 2], stage[i + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      if (i + j < cnt) po[j] = stage[i + j];
  }
}

// Blocks of at most kTile elements: CTA b takes blocks [b * per, b * per +
// per) of the nb blocks.
__global__ void __launch_bounds__(kThreads)
partition_blocks_kernel(const int32_t* __restrict__ vals,
                        const uint8_t* __restrict__ cond, int block, int nb,
                        int per, int32_t* __restrict__ out,
                        int32_t* __restrict__ n_sel_out) {
  __shared__ int s_warp[kWarps];
  __shared__ int bound[kTile + 1];  // selected elements before block k
  __shared__ int32_t stage[kTile];
  const int b0 = blockIdx.x * per;
  const int nblk = min(per, nb - b0);
  const int cnt = nblk * block;
  const int64_t g = (int64_t)b0 * block;
  int32_t v[kItems];
  bool f[kItems];
  int pre[kItems];
  load_tile(vals, cond, g, cnt, v, f);
  const int total = tile_ranks(f, pre, s_warp);
  const int i0 = threadIdx.x * kItems;
#pragma unroll
  for (int j = 0; j < kItems; ++j)
    if (i0 + j < cnt && (i0 + j) % block == 0) bound[(i0 + j) / block] = pre[j];
  if (threadIdx.x == 0) bound[nblk] = total;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = i0 + j;
    if (i >= cnt) break;
    const int k = i / block, start = k * block;
    const int s = pre[j] - bound[k];  // selected before i in its block
    const int sel = bound[k + 1] - bound[k];
    stage[start + (f[j] ? s : sel + (i - start - s))] = v[j];
  }
  __syncthreads();
  store_tile(stage, out, g, cnt);
  for (int k = threadIdx.x; k < nblk; k += kThreads)
    n_sel_out[b0 + k] = bound[k + 1] - bound[k];
}

// A block larger than kTile: CTA b walks block b tile by tile, its selected
// count first (the flags alone, 4 a load where aligned), then each tile's
// selected elements to the front run and the rest after the block's
// n_sel, both carried from tile to tile.
__global__ void __launch_bounds__(kThreads)
partition_wide_kernel(const int32_t* __restrict__ vals,
                      const uint8_t* __restrict__ cond, int block,
                      int32_t* __restrict__ out,
                      int32_t* __restrict__ n_sel_out) {
  __shared__ int s_warp[kWarps];
  __shared__ int32_t stage[kTile];
  const int64_t base = (int64_t)blockIdx.x * block;
  int n_sel = 0;
  for (int t0 = 0; t0 < block; t0 += kTile) {
    const int i = t0 + threadIdx.x * kItems;
    const uint8_t* pc = cond + base + i;
    if (i + kItems <= block && (reinterpret_cast<uintptr_t>(pc) & 3) == 0) {
      const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(pc));
#pragma unroll
      for (int j = 0; j < kItems; ++j) n_sel += ((w >> (8 * j)) & 0xff) != 0;
    } else {
      for (int j = 0; j < kItems && i + j < block; ++j)
        n_sel += __ldg(pc + j) != 0;
    }
  }
  n_sel = __reduce_add_sync(0xffffffffu, n_sel);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = n_sel;
  __syncthreads();
  n_sel = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) n_sel += s_warp[w];
  __syncthreads();  // s_warp is rewritten by the first tile's ranks

  int sel_done = 0, rest_done = 0;
  for (int t0 = 0; t0 < block; t0 += kTile) {
    const int cnt = min(kTile, block - t0);
    int32_t v[kItems];
    bool f[kItems];
    int pre[kItems];
    load_tile(vals, cond, base + t0, cnt, v, f);
    const int total = tile_ranks(f, pre, s_warp);
    const int i0 = threadIdx.x * kItems;
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      if (i0 + j < cnt)
        stage[f[j] ? pre[j] : total + (i0 + j - pre[j])] = v[j];
    __syncthreads();
    for (int k = threadIdx.x; k < cnt; k += kThreads)
      out[base + (k < total ? sel_done + k
                            : n_sel + rest_done + (k - total))] = stage[k];
    sel_done += total;
    rest_done += cnt - total;
    __syncthreads();  // stage and s_warp are rewritten by the next tile
  }
  if (threadIdx.x == 0) n_sel_out[blockIdx.x] = n_sel;
}

}  // namespace

extern "C" int prefix_partition(const void* vals, const void* cond, int n,
                                int block, void* out, void* n_sel,
                                void* stream) {
  if (block < 1 || n % block) return (int)cudaErrorInvalidValue;
  const int nb = n / block;
  if (!nb) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* v = static_cast<const int32_t*>(vals);
  const uint8_t* c = static_cast<const uint8_t*>(cond);
  int32_t* o = static_cast<int32_t*>(out);
  int32_t* ns = static_cast<int32_t*>(n_sel);
  if (block <= kTile) {
    const int per = kTile / block;
    partition_blocks_kernel<<<(nb + per - 1) / per, kThreads, 0, s>>>(
        v, c, block, nb, per, o, ns);
  } else {
    partition_wide_kernel<<<nb, kThreads, 0, s>>>(v, c, block, o, ns);
  }
  return (int)cudaGetLastError();
}
