// One-token decode attention over a KV cache (flash-decoding):
//   out[b, h, :] = softmax_s(cap(q[b, h] . k[b, h / G, s] * dh^-0.5))
//                  . v[b, h / G, s, :]
// over the live positions s of slot b: s < cache_len[b] (and s >=
// cache_len[b] - window with a window), G = H / Hkv query heads a kv head.
// The cache is bf16, or int8 with a float32 scale a (slot, head, position)
// row, read as float(bf16(int8 * scale)): the reference dequantizes to
// bf16 before it widens to float32, and so does this kernel.
//
// Replaces no TPU kernel: the reference computes this in jnp
// (repro/models/attention.py decode_attention, the decode step's cache
// attention). Bound: device-memory bytes. A decode step reads each live
// cache row once and does 4 dh flops a row a query head, far below the
// card's 295 flops a byte; the plain form writes and reads bf16 and
// float32 copies of the whole cache besides.
//
// Design: one CTA a (split, slot, kv head, pair of query heads), 3 CTAs
// an SM; a split is `split` cache positions, fixed by the cache's length
// S alone (kernels/decode_attention.py split_size). The split's live rows
// are one contiguous byte range of [B, Hkv, S, dh], streamed through a
// ring of kStages chunks of kChunk rows in shared memory by cp.async:
// first every k chunk, then every v chunk, kStages - 1 chunks (32 KB of an
// int8 cache at dh 256) in flight at any time, so the v rows arrive while
// the scores are computed. A chunk is copied in 16-byte units where the
// rows and the cache's address allow it, else in 4- or 1-byte units (the
// VEC template parameter; the wrapper picks it). 16 threads read a row,
// each a segment of 16 elements with one or two 16-byte shared loads: for
// the scores, the 2 heads' dot products of a thread's 4 rows (8 sums) are
// finished by a fixed butterfly that halves the values at each step; for
// p . v each thread keeps 2 x 16 column sums over its rows, and the 16
// row groups are added in order at the end. The split's softmax runs
// once, between the k and v chunks, over its scores in shared memory. The
// k loop and the v loop are apart, so q and the column sums never hold
// registers at once (80 registers: 3 CTAs an SM).
//
// Dequantization: a byte goes into the mantissa of 2^23 by __byte_perm
// and the bias is subtracted (exact, no I2F); the float32 product with the
// scale rounds as the reference's; one cvt.rn.bf16x2 (F2FP) rounds it to
// bf16 with no unpacking: 6 instructions an element a side with the two
// heads' FMAs (tools/decode_variants.py times the alternatives: two
// products an F2FP, a bit-exact rounding on the FP32 pipe, I2F).
//
// Each split writes its partial (m, l, acc) in float32; a split with no
// live position writes nothing and exits. The second launch (a
// programmatic dependent of the first) combines each (slot, head)'s live
// splits in split order by the log-sum-exp rule of
// repro/dist/collectives.py and divides by max(l, 1e-30). So a slot's bits
// depend on its own cache rows and length only, and no float atomic is
// used.
//
// Partial mode (decode_attention_partial, a rank's sequence slice of a
// cache cut over ranks): the combine writes the slice's float32 (m, l,
// acc) — the largest score, the exponentials' sum, and the unnormalised
// p . v — for the ranks' own log-sum-exp combine
// (dist/collectives.py sharded_decode_attention_seq). A slot whose slice
// holds no live position (cache_len 0) gives m = -inf, l = 0, acc = 0,
// which every combine weighs by exp(-inf) = 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 16;                  // threads a row
constexpr int kGroups = kThreads / kLanes;  // rows read at once
constexpr int kSeg = 16;                    // elements a thread a row
constexpr int kChunk = 64;                  // rows a ring stage
constexpr int kRows = kChunk / kGroups;     // rows a thread a chunk
constexpr int kStages = 3;
constexpr int kMinBlocks = 3;  // CTAs an SM (__launch_bounds__)
constexpr int kG = 2;  // query heads a CTA
constexpr int kMaxG = 8;
constexpr int kMaxDh = kLanes * kSeg;
constexpr int kMaxSplit = 2048;  // kernels/decode_attention.py MAX_SPLIT
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

static_assert(kRows * kG * 2 == kLanes, "the score butterfly halves a "
              "row group's sums down to one a lane pair");
static_assert(kMaxDh == 256, "dh up to 256");

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// griddepcontrol (PTX, sm_90): the combine's CTAs may be scheduled while
// the splits run, and wait for their writes before their first read
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_for_primary() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// one VEC-byte unit from global to shared memory: cp.async for 16 and 4
// bytes (completed by cp_async_wait), a plain copy for 1
template <int VEC>
__device__ __forceinline__ void copy_unit(char* dst, const char* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (VEC == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
                 "l"(src) : "memory");
  else if constexpr (VEC == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s),
                 "l"(src) : "memory");
  else
    *dst = *src;
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// `rows` rows of `rowbytes` bytes from src (contiguous) to dst, a row
// every `stride` bytes, in VEC-byte units by all threads: one contiguous
// range where the rows are not padded (no division a unit)
template <int VEC>
__device__ __forceinline__ void copy_rows(char* dst, const char* src,
                                          int rows, int rowbytes, int stride,
                                          int t) {
  if (stride == rowbytes) {
    const int n = rows * rowbytes / VEC;
#pragma unroll 4
    for (int i = t; i < n; i += kThreads)
      copy_unit<VEC>(dst + i * VEC, src + (size_t)i * VEC);
    return;
  }
  const int upr = rowbytes / VEC;
  const int n = rows * upr;
  for (int i = t; i < n; i += kThreads) {
    const int r = i / upr, u = i - r * upr;
    copy_unit<VEC>(dst + r * stride + u * VEC,
                   src + (size_t)r * rowbytes + u * VEC);
  }
}

// the 4 int8 of w, dequantized through bf16: a byte goes into the
// mantissa of 2^23 and the bias is subtracted (exact), the float32
// product with the scale rounds as the reference's, and cvt.rn.bf16x2
// rounds it to nearest even bf16 into the high half of a word whose low
// half is bf16(0) = 0: that word is the bf16 widened to float32
__device__ __forceinline__ void dequant4(uint32_t w, float s, float* x) {
  w ^= 0x80808080u;  // each byte c + 128, unsigned
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float c = __fsub_rn(
        __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650u | i)),
        8388736.f);  // 2^23 + c + 128, less 2^23 + 128
    const __nv_bfloat162 h = __floats2bfloat162_rn(0.f, __fmul_rn(c, s));
    x[i] = __uint_as_float(*reinterpret_cast<const uint32_t*>(&h));
  }
}

// the kSeg elements of a thread's segment as 32-bit words, 16 bytes a
// shared load
template <typename KVT>
struct SegWords {
  static constexpr int kN = kSeg * (int)sizeof(KVT) / 4;
  static_assert(kN % 4 == 0, "segments of 16k bytes");
  uint32_t w[kN];
  __device__ __forceinline__ SegWords(const char* p) {
#pragma unroll
    for (int h = 0; h < kN / 4; ++h) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[h];
      w[4 * h] = u.x, w[4 * h + 1] = u.y, w[4 * h + 2] = u.z,
      w[4 * h + 3] = u.w;
    }
  }
};

// a thread's segment of a row in shared memory (kSeg elements from
// element j * kSeg) as float32
__device__ __forceinline__ void segment(const int8_t* row, int j, float s,
                                        float (&x)[kSeg]) {
  const SegWords<int8_t> sw(reinterpret_cast<const char*>(row + j * kSeg));
#pragma unroll
  for (int i = 0; i < sw.kN; ++i) dequant4(sw.w[i], s, x + 4 * i);
}
__device__ __forceinline__ void segment_bf16(const __nv_bfloat16* row, int j,
                                             float (&x)[kSeg]) {
  const SegWords<__nv_bfloat16> sw(
      reinterpret_cast<const char*>(row + j * kSeg));
#pragma unroll
  for (int i = 0; i < sw.kN; ++i) {
    x[2 * i] = __uint_as_float(sw.w[i] << 16);
    x[2 * i + 1] = __uint_as_float(sw.w[i] & 0xFFFF0000u);
  }
}

// row r of a stage as float32 segment j; elements past dh read as 0
// (their shared bytes are another row's or never written)
template <typename KVT>
__device__ __forceinline__ void read_row(const char* stage, int stride,
                                         const float* scales, int r, int j,
                                         int dh, float (&x)[kSeg]) {
  const char* row = stage + r * stride;
  if constexpr (sizeof(KVT) == 1) {
    segment(reinterpret_cast<const int8_t*>(row), j, scales[r], x);
  } else {
    segment_bf16(reinterpret_cast<const __nv_bfloat16*>(row), j, x);
  }
  if ((j + 1) * kSeg > dh) {
#pragma unroll
    for (int e = 0; e < kSeg; ++e)
      if (j * kSeg + e >= dh) x[e] = 0.f;
  }
}

// the V = kLanes / 2 sums v[i * kG + g] (row i, head g) of a row group's
// kLanes lanes, a fixed butterfly: at offsets V, V / 2, ..., 2 a lane
// keeps half of its values and adds its partner's copy of them; returns
// value (lane >> 1), held by lanes 2k and 2k + 1
template <int V>
__device__ __forceinline__ float butterfly(float (&v)[V], int lane) {
#pragma unroll
  for (int n = V; n > 1; n >>= 1) {
    const bool hi = lane & n;
#pragma unroll
    for (int m = 0; m < n / 2; ++m) {
      const float keep = hi ? v[m + n / 2] : v[m];
      const float send = hi ? v[m] : v[m + n / 2];
      v[m] = keep + __shfl_xor_sync(0xffffffffu, send, n);
    }
  }
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

template <typename QT, typename KVT, int VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
decode_split_kernel(const QT* __restrict__ q, const KVT* __restrict__ k,
                    const KVT* __restrict__ v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int32_t* __restrict__ cache_len, int H, int Hkv,
                    int S, int dh, int has_window, int window, int has_cap,
                    float cap, float scale, int split, int n_splits,
                    float* __restrict__ m_part, float* __restrict__ l_part,
                    float* __restrict__ acc_part) {
  extern __shared__ __align__(16) char smem[];
  __shared__ float scale_s[kStages][kChunk];
  __shared__ float red_m[kG][kWarps], red_l[kG][kWarps];
  launch_dependents();

  const int bk = blockIdx.y;  // slot * Hkv + kv head
  const int b = bk / Hkv, kvh = bk % Hkv;
  const int G = H / Hkv;
  const int g0 = blockIdx.z * kG, ng = min(kG, G - g0);
  const int len = cache_len[b];
  const int lo = has_window ? max(0, len - window) : 0;
  const int hi = min(len, S);
  const int s0 = blockIdx.x * split;
  const int a = max(s0, lo), e = min(min(s0 + split, S), hi);
  if (a >= e) return;  // no live position: the combine skips this split

  const int rowbytes = dh * (int)sizeof(KVT);
  const int stride = (rowbytes + 15) / 16 * 16;  // 16-byte aligned rows
  const int stage_bytes = kChunk * stride;
  float* p_s = reinterpret_cast<float*>(smem + kStages * stage_bytes);
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int rg = t / kLanes, j = t % kLanes;
  const bool seg = j * kSeg < dh;  // this thread's segment exists
  const size_t rows0 = (size_t)bk * S;  // cache row of position 0

  // the split's k chunks, then its v chunks: item it < nch is k chunk it
  const int n = e - a, nch = (n + kChunk - 1) / kChunk, items = 2 * nch;
  auto issue = [&](int it) {
    if (it < items) {
      const bool isv = it >= nch;
      const int c0 = a + (isv ? it - nch : it) * kChunk;
      const int rows = min(kChunk, e - c0);
      const int st = it % kStages;
      copy_rows<VEC>(smem + st * stage_bytes,
                     reinterpret_cast<const char*>(isv ? v : k) +
                         (rows0 + c0) * rowbytes,
                     rows, rowbytes, stride, t);
      if constexpr (sizeof(KVT) == 1) {
        if (t < rows)
          copy_unit<4>(reinterpret_cast<char*>(&scale_s[st][t]),
                       reinterpret_cast<const char*>(
                           (isv ? v_scale : k_scale) + rows0 + c0 + t));
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  // item it landed, and the stage of item it - 1 is free for item it +
  // kStages - 1; returns item it's stage
  auto next = [&](int it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(it + kStages - 1);
    return smem + (it % kStages) * stage_bytes;
  };

  // scores: a row group's kLanes lanes a row, kG heads, kRows rows a
  // thread; q of the CTA's heads scaled once, this thread's segment (the k
  // loop and the v loop apart, so that q and the column sums never hold
  // registers at once)
  {
    float qv[kG][kSeg];
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int i = 0; i < kSeg; ++i) {
        const int d = j * kSeg + i;
        qv[g][i] = g < ng && d < dh
                       ? widen(q[((size_t)b * H + (size_t)kvh * G + g0 + g) *
                                     dh + d]) * scale
                       : 0.f;
      }
    for (int it = 0; it < nch; ++it) {
      const char* stage = next(it);
      const int off = it * kChunk;  // p_s index of the chunk's row 0
      const int rows = min(kChunk, n - off);
      float part[kRows * kG];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = rg + i * kGroups;
        part[i * kG] = part[i * kG + 1] = 0.f;
        if (seg && r < rows) {
          float x[kSeg];
          read_row<KVT>(stage, stride, scale_s[it % kStages], r, j, dh, x);
#pragma unroll
          for (int d = 0; d < kSeg; ++d)
#pragma unroll
            for (int g = 0; g < kG; ++g)
              part[i * kG + g] = fmaf(qv[g][d], x[d], part[i * kG + g]);
        }
      }
      const float sc = butterfly<kRows * kG>(part, j);
      const int i = j >> 2, g = (j >> 1) & 1, r = rg + i * kGroups;
      if ((j & 1) == 0 && g < ng && r < rows)
        p_s[g * split + off + r] = has_cap ? cap * tanhf(sc / cap) : sc;
    }
  }

  // the split's softmax: maximum, exponentials, their sum
  __syncthreads();
  float m_g[kG], l_g[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    float x = kNegInf;
    if (g < ng)
      for (int s = t; s < n; s += kThreads) x = fmaxf(x, p_s[g * split + s]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    if (lane == 0) red_m[g][warp] = x;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m_g[g] = red_m[g][0];
    for (int w = 1; w < kWarps; ++w) m_g[g] = fmaxf(m_g[g], red_m[g][w]);
    float sum = 0.f;
    if (g < ng)
      for (int s = t; s < n; s += kThreads) {
        const float p = expf(p_s[g * split + s] - m_g[g]);
        p_s[g * split + s] = p;
        sum += p;
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) red_l[g][warp] = sum;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    l_g[g] = red_l[g][0];
    for (int w = 1; w < kWarps; ++w) l_g[g] += red_l[g][w];
  }

  // p . v: a thread's kSeg columns over its rows, in row order
  float acc[kG][kSeg];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int i = 0; i < kSeg; ++i) acc[g][i] = 0.f;
  for (int it = nch; it < items; ++it) {
    const char* stage = next(it);
    const int off = (it - nch) * kChunk;
    const int rows = min(kChunk, n - off);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = rg + i * kGroups;
      if (seg && r < rows) {
        float x[kSeg];
        read_row<KVT>(stage, stride, scale_s[it % kStages], r, j, dh, x);
        float p[kG];
#pragma unroll
        for (int g = 0; g < kG; ++g) p[g] = p_s[g * split + off + r];
#pragma unroll
        for (int d = 0; d < kSeg; ++d)
#pragma unroll
          for (int g = 0; g < kG; ++g)
            acc[g][d] = fmaf(p[g], x[d], acc[g][d]);
      }
    }
  }

  // the 16 row groups' column sums added in row-group order; the ring is
  // free once every copy has landed
  cp_async_wait<0>();
  __syncthreads();
  float* red_acc = reinterpret_cast<float*>(smem);  // [kGroups][kG][dh]
  if (seg) {
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int i = 0; i < kSeg; ++i)
        if (j * kSeg + i < dh)
          red_acc[(rg * kG + g) * dh + j * kSeg + i] = acc[g][i];
  }
  __syncthreads();
  const size_t part0 =
      ((size_t)b * H + (size_t)kvh * G + g0) * n_splits + blockIdx.x;
  for (int idx = t; idx < ng * dh; idx += kThreads) {
    const int g = idx / dh, d = idx % dh;
    float s = red_acc[g * dh + d];
    for (int r = 1; r < kGroups; ++r) s += red_acc[(r * kG + g) * dh + d];
    acc_part[(part0 + (size_t)g * n_splits) * dh + d] = s;
  }
#pragma unroll
  for (int g = 0; g < kG; ++g)
    if (t == g && g < ng) {
      m_part[part0 + (size_t)g * n_splits] = m_g[g];
      l_part[part0 + (size_t)g * n_splits] = l_g[g];
    }
}

// one CTA a (slot, query head), a thread a column: the live splits
// combined in split order, out = sum acc e^(m - M) / max(sum l e^(m - M),
// 1e-30); a slot with no live position reads 0. kPartial: out is the
// float32 sum acc e^(m - M) itself, and m_out, l_out get M and sum l
// e^(m - M) (-inf and 0 with no live position)
template <typename OT, bool kPartial>
__global__ void decode_combine_kernel(const float* __restrict__ m_part,
                                      const float* __restrict__ l_part,
                                      const float* __restrict__ acc_part,
                                      const int32_t* __restrict__ cache_len,
                                      int H, int S, int has_window,
                                      int window, int split, int n_splits,
                                      int dh, OT* __restrict__ out,
                                      float* __restrict__ m_out,
                                      float* __restrict__ l_out) {
  const size_t bh = blockIdx.x;
  const int d = threadIdx.x;
  const int len = cache_len[bh / H];
  const int lo = has_window ? max(0, len - window) : 0;
  const int hi = min(len, S);
  wait_for_primary();
  if (d >= dh) return;
  if (lo >= hi) {
    narrow(out + bh * dh + d, 0.f);
    if constexpr (kPartial) {
      if (d == 0) m_out[bh] = __int_as_float(0xff800000), l_out[bh] = 0.f;
    }
    return;
  }
  const int i0 = lo / split, i1 = (hi - 1) / split;
  const float* m = m_part + bh * n_splits;
  const float* l = l_part + bh * n_splits;
  float mg = m[i0];
  for (int i = i0 + 1; i <= i1; ++i) mg = fmaxf(mg, m[i]);
  float l_sum = 0.f, acc = 0.f;
  for (int i = i0; i <= i1; ++i) {
    const float corr = expf(m[i] - mg);
    l_sum += l[i] * corr;
    acc += acc_part[(bh * n_splits + i) * dh + d] * corr;
  }
  if constexpr (kPartial) {
    out[bh * dh + d] = acc;
    if (d == 0) m_out[bh] = mg, l_out[bh] = l_sum;
  } else {
    narrow(out + bh * dh + d, acc / fmaxf(l_sum, 1e-30f));
  }
}

template <typename QT, typename KVT, int VEC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int32_t* len,
                   int B, int H, int Hkv, int S, int dh, int has_window,
                   int window, int has_cap, float cap, float scale, int split,
                   float* m, float* l, float* acc, void* out, float* m_out,
                   float* l_out, cudaStream_t st) {
  const int n_splits = (S + split - 1) / split;
  const int stride = (dh * (int)sizeof(KVT) + 15) / 16 * 16;
  const int smem = kStages * kChunk * stride + kG * split * 4;
  auto split_kernel = decode_split_kernel<QT, KVT, VEC>;
  // once an instantiation, at its first (eager) launch: the most it can
  // take, so that a captured launch sets nothing
  static const cudaError_t set = cudaFuncSetAttribute(
      split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kStages * kChunk * kMaxDh * (int)sizeof(KVT) + kG * kMaxSplit * 4);
  cudaError_t e = set;
  if (e != cudaSuccess) return e;
  const int G = H / Hkv;
  const dim3 grid((unsigned)n_splits, (unsigned)(B * Hkv),
                  (unsigned)((G + kG - 1) / kG));
  split_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k),
      static_cast<const KVT*>(v), ks, vs, len, H, Hkv, S, dh, has_window,
      window, has_cap, cap, scale, split, n_splits, m, l, acc);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  // programmatic dependent launch: the combine's launch overlaps the splits
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * H));
  cfg.blockDim = dim3((unsigned)((dh + 31) / 32 * 32));
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (m_out)
    return cudaLaunchKernelEx(&cfg, decode_combine_kernel<float, true>,
                              (const float*)m, (const float*)l,
                              (const float*)acc, len, H, S, has_window,
                              window, split, n_splits, dh,
                              static_cast<float*>(out), m_out, l_out);
  return cudaLaunchKernelEx(&cfg, decode_combine_kernel<QT, false>,
                            (const float*)m, (const float*)l,
                            (const float*)acc, len, H, S, has_window, window,
                            split, n_splits, dh, static_cast<QT*>(out),
                            (float*)nullptr, (float*)nullptr);
}

template <typename QT, typename KVT>
cudaError_t launch_vec(int vec, const void* q, const void* k, const void* v,
                       const float* ks, const float* vs, const int32_t* len,
                       int B, int H, int Hkv, int S, int dh, int has_window,
                       int window, int has_cap, float cap, float scale,
                       int split, float* m, float* l, float* acc, void* out,
                       float* m_out, float* l_out, cudaStream_t st) {
  if (vec == 16)
    return launch<QT, KVT, 16>(q, k, v, ks, vs, len, B, H, Hkv, S, dh,
                               has_window, window, has_cap, cap, scale, split,
                               m, l, acc, out, m_out, l_out, st);
  if (vec == 4)
    return launch<QT, KVT, 4>(q, k, v, ks, vs, len, B, H, Hkv, S, dh,
                              has_window, window, has_cap, cap, scale, split,
                              m, l, acc, out, m_out, l_out, st);
  return launch<QT, KVT, 1>(q, k, v, ks, vs, len, B, H, Hkv, S, dh,
                            has_window, window, has_cap, cap, scale, split, m,
                            l, acc, out, m_out, l_out, st);
}

}  // namespace

namespace {

cudaError_t run(const void* q, int q_bf16, const void* k, const void* v,
                int kv_int8, const void* k_scale, const void* v_scale,
                const void* cache_len, int B, int H, int Hkv, int S, int dh,
                int has_window, int window, int has_cap, float cap,
                float scale, int split, int vec, void* m_part, void* l_part,
                void* acc_part, void* out, float* m_out, float* l_out,
                void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || dh <= 0) return cudaSuccess;
  if (H % Hkv || H / Hkv > kMaxG || dh > kMaxDh || B * Hkv > 65535 ||
      split < kChunk || split > kMaxSplit || split % kChunk)
    return cudaErrorInvalidValue;
  const uintptr_t bytes = (uintptr_t)dh * (kv_int8 ? 1 : 2);
  if ((vec != 16 && vec != 4 && vec != 1) ||
      (((uintptr_t)k | (uintptr_t)v | bytes) % (uintptr_t)vec))
    return cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int32_t* len = static_cast<const int32_t*>(cache_len);
  float* m = static_cast<float*>(m_part);
  float* l = static_cast<float*>(l_part);
  float* acc = static_cast<float*>(acc_part);
  if (q_bf16 && kv_int8)
    return launch_vec<__nv_bfloat16, int8_t>(
        vec, q, k, v, ks, vs, len, B, H, Hkv, S, dh, has_window, window,
        has_cap, cap, scale, split, m, l, acc, out, m_out, l_out, st);
  if (q_bf16)
    return launch_vec<__nv_bfloat16, __nv_bfloat16>(
        vec, q, k, v, nullptr, nullptr, len, B, H, Hkv, S, dh, has_window,
        window, has_cap, cap, scale, split, m, l, acc, out, m_out, l_out,
        st);
  if (kv_int8)
    return launch_vec<float, int8_t>(vec, q, k, v, ks, vs, len, B, H, Hkv, S,
                                     dh, has_window, window, has_cap, cap,
                                     scale, split, m, l, acc, out, m_out,
                                     l_out, st);
  return launch_vec<float, __nv_bfloat16>(
      vec, q, k, v, nullptr, nullptr, len, B, H, Hkv, S, dh, has_window,
      window, has_cap, cap, scale, split, m, l, acc, out, m_out, l_out, st);
}

}  // namespace

// q [B, H, 1, dh] float32 (q_bf16 = 0) or bf16; k, v [B, Hkv, S, dh] bf16
// (kv_int8 = 0) or int8 with k_scale, v_scale [B, Hkv, S] float32;
// cache_len [B] int32, each at least 1; out [B, H, 1, dh] in q's type.
// split: positions a CTA, a multiple of 64 up to 2048; vec: the copy unit
// in bytes (16, 4 or 1), which must divide dh's bytes and both cache
// addresses. Scratch: m_part, l_part [B * H * n_splits], acc_part [B * H *
// n_splits * dh] float32, n_splits = ceil(S / split). H % Hkv == 0,
// H / Hkv <= 8, dh <= 256, B * Hkv <= 65535. Two launches (the splits, the
// combine); returns the first failing call's cudaError_t, 0 on success.
extern "C" int decode_attention(const void* q, int q_bf16, const void* k,
                                const void* v, int kv_int8,
                                const void* k_scale, const void* v_scale,
                                const void* cache_len, int B, int H, int Hkv,
                                int S, int dh, int has_window, int window,
                                int has_cap, float cap, float scale,
                                int split, int vec, void* m_part,
                                void* l_part, void* acc_part, void* out,
                                void* stream) {
  return (int)run(q, q_bf16, k, v, kv_int8, k_scale, v_scale, cache_len, B,
                  H, Hkv, S, dh, has_window, window, has_cap, cap, scale,
                  split, vec, m_part, l_part, acc_part, out, nullptr,
                  nullptr, stream);
}

// Partial mode: decode_attention's arguments with no window, cache_len
// each at least 0, and in place of out the slice's float32 partials: m, l
// [B * H] and acc [B * H * dh] (unnormalised). Two launches.
extern "C" int decode_attention_partial(
    const void* q, int q_bf16, const void* k, const void* v, int kv_int8,
    const void* k_scale, const void* v_scale, const void* cache_len, int B,
    int H, int Hkv, int S, int dh, int has_cap, float cap, float scale,
    int split, int vec, void* m_part, void* l_part, void* acc_part,
    void* m_out, void* l_out, void* acc_out, void* stream) {
  return (int)run(q, q_bf16, k, v, kv_int8, k_scale, v_scale, cache_len, B,
                  H, Hkv, S, dh, 0, 0, has_cap, cap, scale, split, vec,
                  m_part, l_part, acc_part, acc_out,
                  static_cast<float*>(m_out), static_cast<float*>(l_out),
                  stream);
}
