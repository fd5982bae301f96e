// The UPE set-partition: a stable partition of each block of values by a
// bool condition (selected values first, then the rest, both in input
// order), plus the selected count of each block.
//
// Replaces repro/kernels/prefix_partition.py prefix_partition, where each
// grid step holds one block in VMEM and runs the log-depth adder network
// (prefix sums of the condition and of its complement) and a relocation
// router (a bisection per output slot, then a gather). Here one CTA owns
// one block and needs no router: it counts the block's selected elements,
// then walks the block in chunks of kThreads elements, one per thread, and
// scans each chunk's flags with a warp ballot plus a per-warp prefix in
// shared memory. Every element then knows how many selected elements come
// before it (s), so it writes itself to slot s if selected and to
// n_sel + (i - s) if not: a scatter inside the block that keeps both
// groups in order. Reads are coalesced (each chunk is contiguous); the
// condition is read twice, the second time from L1/L2. Bound: bytes —
// values and flags read once, values and counts written once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
prefix_partition_kernel(const int32_t* __restrict__ vals,
                        const uint8_t* __restrict__ cond, int block,
                        int32_t* __restrict__ out,
                        int32_t* __restrict__ n_sel_out) {
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t base = (size_t)blockIdx.x * block;
  const int32_t* v = vals + base;
  const uint8_t* c = cond + base;
  int32_t* o = out + base;

  // the block's selected count
  int cnt = 0;
  for (int i = threadIdx.x; i < block; i += kThreads) cnt += c[i] != 0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  if (lane == 0) s_warp[warp] = cnt;
  __syncthreads();
  int n_sel = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) n_sel += s_warp[w];
  __syncthreads();

  int sel_before = 0;  // selected elements before this chunk
  for (int c0 = 0; c0 < block; c0 += kThreads) {
    const int i = c0 + threadIdx.x;
    const bool live = i < block;
    const bool f = live && c[i] != 0;
    const unsigned bal = __ballot_sync(0xffffffffu, f);
    if (lane == 0) s_warp[warp] = __popc(bal);
    __syncthreads();
    int wpre = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int x = s_warp[w];
      wpre += w < warp ? x : 0;
      total += x;
    }
    if (live) {
      const int s = sel_before + wpre + __popc(bal & ((1u << lane) - 1u));
      o[f ? s : n_sel + (i - s)] = v[i];
    }
    sel_before += total;
    __syncthreads();  // s_warp is rewritten by the next chunk
  }
  if (threadIdx.x == 0) n_sel_out[blockIdx.x] = n_sel;
}

}  // namespace

extern "C" int prefix_partition(const void* vals, const void* cond, int n,
                                int block, void* out, void* n_sel,
                                void* stream) {
  if (block < 1 || n % block) return (int)cudaErrorInvalidValue;
  prefix_partition_kernel<<<n / block, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(vals), static_cast<const uint8_t*>(cond),
      block, static_cast<int32_t*>(out), static_cast<int32_t*>(n_sel));
  return (int)cudaGetLastError();
}
