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
// Design: one CTA a (split, slot, kv head); a split is kSplit cache
// positions, fixed by the cache's length alone. The CTA reads each live k
// and v row of its split once for all G query heads: a warp a position for
// the scores (lane d reads elements d, d + 32, ...; the G dot products
// summed by a fixed butterfly), then a thread a column of v. Each split
// writes its partial (m, l, acc) in float32; a split with no live position
// writes l = 0, m = -1e30, acc = 0, which the combine weighs by
// exp(-1e30 - M) = 0, as the reference weighs its masked terms. The second
// launch combines each (slot, head)'s splits in split order by the
// log-sum-exp rule of repro/dist/collectives.py and divides by
// max(l, 1e-30). So a slot's bits depend on its own cache rows and length
// only, and no float atomic is used.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = 256;  // cache positions a CTA (kernels/decode_attention.py SPLIT)
constexpr int kMaxG = 8;     // query heads a kv head
constexpr int kMaxDh = 256;
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// one cache element as float32: bf16 widened, or int8 dequantized through
// bf16 (float32 product, rounded to nearest even bf16, widened)
__device__ __forceinline__ float cache_elem(const __nv_bfloat16* c, size_t i,
                                            float) {
  return __bfloat162float(c[i]);
}
__device__ __forceinline__ float cache_elem(const int8_t* c, size_t i,
                                            float scale) {
  return __bfloat162float(__float2bfloat16_rn((float)c[i] * scale));
}

template <typename QT, typename KVT>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const QT* __restrict__ q, const KVT* __restrict__ k,
                    const KVT* __restrict__ v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int32_t* __restrict__ cache_len, int H, int Hkv,
                    int S, int dh, int has_window, int window, int has_cap,
                    float cap, float scale, int n_splits,
                    float* __restrict__ m_part, float* __restrict__ l_part,
                    float* __restrict__ acc_part) {
  __shared__ float q_s[kMaxG * kMaxDh];
  __shared__ float p_s[kMaxG][kSplit];
  __shared__ float red[kMaxG][kWarps];
  __shared__ float acc_s[kMaxG][kThreads];

  const int split = blockIdx.x;
  const int bk = blockIdx.y;  // slot * Hkv + kv head
  const int b = bk / Hkv, kvh = bk % Hkv;
  const int G = H / Hkv;
  const int len = cache_len[b];
  const int lo = has_window ? max(0, len - window) : 0;
  const int hi = min(len, S);
  const int s0 = split * kSplit;
  const int a = max(s0, lo), e = min(min(s0 + kSplit, S), hi);
  // partial row of query head kvh * G + g
  const size_t part0 = ((size_t)b * H + (size_t)kvh * G) * n_splits + split;
  const int t = threadIdx.x;

  if (a >= e) {  // no live position in this split
    for (int g = t; g < G; g += kThreads) {
      m_part[part0 + (size_t)g * n_splits] = kNegInf;
      l_part[part0 + (size_t)g * n_splits] = 0.f;
    }
    for (int i = t; i < G * dh; i += kThreads) {
      const int g = i / dh, d = i % dh;
      acc_part[(part0 + (size_t)g * n_splits) * dh + d] = 0.f;
    }
    return;
  }

  for (int i = t; i < G * dh; i += kThreads) {
    const int g = i / dh, d = i % dh;
    q_s[i] = widen(q[((size_t)b * H + (size_t)kvh * G + g) * dh + d]) * scale;
  }
  __syncthreads();

  // scores: a warp a position, lanes over the head width
  const int warp = t / 32, lane = t % 32;
  const size_t rows0 = (size_t)bk * S;  // cache row of position 0
  for (int s = a + warp; s < e; s += kWarps) {
    const float ks = k_scale ? k_scale[rows0 + s] : 1.f;
    const size_t base = (rows0 + s) * dh;
    float part[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) part[g] = 0.f;
    for (int d = lane; d < dh; d += 32) {
      const float kd = cache_elem(k, base + d, ks);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) part[g] = fmaf(q_s[g * dh + d], kd, part[g]);
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      float x = part[g];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
      if (lane == 0) p_s[g][s - s0] = has_cap ? cap * tanhf(x / cap) : x;
    }
  }
  __syncthreads();

  // softmax of each query head over the split's live positions: a thread a
  // position (kThreads == kSplit), block maximum, exponentials, block sum
  const int i = t;
  const bool live = s0 + i >= a && s0 + i < e;
  for (int g = 0; g < G; ++g) {
    float x = live ? p_s[g][i] : kNegInf;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
    if (lane == 0) red[g][warp] = x;
  }
  __syncthreads();
  float m_g[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m_g[g] = kNegInf;
    if (g < G)
      for (int w = 0; w < kWarps; ++w) m_g[g] = fmaxf(m_g[g], red[g][w]);
  }
  __syncthreads();
  for (int g = 0; g < G; ++g) {
    float p = 0.f;
    if (live) {
      p = expf(p_s[g][i] - m_g[g]);
      p_s[g][i] = p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      p += __shfl_xor_sync(0xffffffffu, p, off);
    if (lane == 0) red[g][warp] = p;
  }
  __syncthreads();
  if (t < G) {
    float l = 0.f;
    for (int w = 0; w < kWarps; ++w) l += red[t][w];
    m_part[part0 + (size_t)t * n_splits] = m_g[t];
    l_part[part0 + (size_t)t * n_splits] = l;
  }

  // p . v: a thread a column, the positions shared among kThreads / dh
  // threads a column and their sums added in thread order
  const int nsub = kThreads / dh;
  const int d = t % dh, sub = t / dh;
  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
  if (sub < nsub) {
#pragma unroll 4
    for (int s = a + sub; s < e; s += nsub) {
      const float vd = cache_elem(v, (rows0 + s) * dh + d,
                                  v_scale ? v_scale[rows0 + s] : 1.f);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] = fmaf(p_s[g][s - s0], vd, acc[g]);
    }
  }
  if (nsub > 1) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) acc_s[g][t] = acc[g];
    __syncthreads();
    if (sub == 0) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G)
          for (int j = 1; j < nsub; ++j) acc[g] += acc_s[g][j * dh + d];
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) acc_part[(part0 + (size_t)g * n_splits) * dh + d] = acc[g];
  }
}

// one CTA a (slot, query head), a thread a column: the splits combined in
// split order, out = sum acc e^(m - M) / max(sum l e^(m - M), 1e-30)
template <typename QT>
__global__ void decode_combine_kernel(const float* __restrict__ m_part,
                                      const float* __restrict__ l_part,
                                      const float* __restrict__ acc_part,
                                      int n_splits, int dh,
                                      QT* __restrict__ out) {
  const size_t bh = blockIdx.x;
  const int d = threadIdx.x;
  if (d >= dh) return;
  const float* m = m_part + bh * n_splits;
  const float* l = l_part + bh * n_splits;
  float mg = m[0];
  for (int i = 1; i < n_splits; ++i) mg = fmaxf(mg, m[i]);
  float l_sum = 0.f, acc = 0.f;
  for (int i = 0; i < n_splits; ++i) {
    const float corr = expf(m[i] - mg);
    l_sum += l[i] * corr;
    acc += acc_part[(bh * n_splits + i) * dh + d] * corr;
  }
  narrow(out + bh * dh + d, acc / fmaxf(l_sum, 1e-30f));
}

template <typename QT, typename KVT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int32_t* len,
                   int B, int H, int Hkv, int S, int dh, int has_window,
                   int window, int has_cap, float cap, float scale,
                   float* m, float* l, float* acc, void* out,
                   cudaStream_t st) {
  const int n_splits = (S + kSplit - 1) / kSplit;
  const dim3 grid((unsigned)n_splits, (unsigned)(B * Hkv));
  decode_split_kernel<QT, KVT><<<grid, kThreads, 0, st>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k),
      static_cast<const KVT*>(v), ks, vs, len, H, Hkv, S, dh, has_window,
      window, has_cap, cap, scale, n_splits, m, l, acc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int threads = (dh + 31) / 32 * 32;
  decode_combine_kernel<QT><<<(unsigned)(B * H), threads, 0, st>>>(
      m, l, acc, n_splits, dh, static_cast<QT*>(out));
  return cudaGetLastError();
}

}  // namespace

// q [B, H, 1, dh] float32 (q_bf16 = 0) or bf16; k, v [B, Hkv, S, dh] bf16
// (kv_int8 = 0) or int8 with k_scale, v_scale [B, Hkv, S] float32;
// cache_len [B] int32, each at least 1; out [B, H, 1, dh] in q's type.
// Scratch: m_part, l_part [B * H * n_splits], acc_part [B * H * n_splits *
// dh] float32, n_splits = ceil(S / 256). H % Hkv == 0, H / Hkv <= 8,
// dh <= 256, B * Hkv <= 65535. Two launches (the splits, the combine);
// returns the first failing launch's cudaError_t, 0 on success.
extern "C" int decode_attention(const void* q, int q_bf16, const void* k,
                                const void* v, int kv_int8,
                                const void* k_scale, const void* v_scale,
                                const void* cache_len, int B, int H, int Hkv,
                                int S, int dh, int has_window, int window,
                                int has_cap, float cap, float scale,
                                void* m_part, void* l_part, void* acc_part,
                                void* out, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || dh <= 0) return 0;
  if (H % Hkv || H / Hkv > kMaxG || dh > kMaxDh || B * Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int32_t* len = static_cast<const int32_t*>(cache_len);
  float* m = static_cast<float*>(m_part);
  float* l = static_cast<float*>(l_part);
  float* acc = static_cast<float*>(acc_part);
  cudaError_t e;
  if (q_bf16 && kv_int8)
    e = launch<__nv_bfloat16, int8_t>(q, k, v, ks, vs, len, B, H, Hkv, S, dh,
                                      has_window, window, has_cap, cap, scale,
                                      m, l, acc, out, st);
  else if (q_bf16)
    e = launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, nullptr, nullptr, len,
                                             B, H, Hkv, S, dh, has_window,
                                             window, has_cap, cap, scale, m,
                                             l, acc, out, st);
  else if (kv_int8)
    e = launch<float, int8_t>(q, k, v, ks, vs, len, B, H, Hkv, S, dh,
                              has_window, window, has_cap, cap, scale, m, l,
                              acc, out, st);
  else
    e = launch<float, __nv_bfloat16>(q, k, v, nullptr, nullptr, len, B, H,
                                     Hkv, S, dh, has_window, window, has_cap,
                                     cap, scale, m, l, acc, out, st);
  return (int)e;
}
