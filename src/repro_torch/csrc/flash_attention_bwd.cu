// Flash attention backward: dQ, and dK / dV summed over each kv head's
// group of query heads, for causal / sliding-window / logit-softcapped
// attention with grouped kv heads.
//
// Replaces repro/kernels/flash_attention.py flash_attention_bwd: its two
// Pallas passes _dq_kernel (flash_dq_kernel here) and _dkv_kernel
// (flash_dkv_kernel here). Both recompute the probabilities of one tile
// from the forward's saved log-sum-exp instead of keeping any [Sq, Skv]
// tile in device memory:
//   s_cap = softcap(q . k * scale),  p = exp(s_cap - lse) where live, else 0
//   dv += p^T dout,  dp = dout v^T,  ds = p (dp - delta) (1 - t^2),
//   t = s_cap / cap (no factor without a cap), ds = 0 where masked,
//   dq += ds k,  dk += ds^T (q scale),  dq is written times scale.
// delta = sum(dout * out) per query row comes in, computed by the caller
// (the reference computes it outside its Pallas kernels too). A row that
// has no live key at all (a window < 1, or q_offset past the last key;
// never on the model's paths) gets zero gradients here.
//
// The TPU kernels walk a (bh, tile, tile) grid in order and carry their
// float32 accumulators in VMEM across the minor axis. Hopper CTAs run in
// no order, so the minor axis moves inside the CTA:
//   flash_dq_kernel: one CTA owns a 64-row query tile of one (batch,
//     head); its Q (times scale) and dO tiles stay in shared memory while
//     32-row K and V tiles stream through, only over the kv tiles that
//     hold a live pair (the forward's tile range); dq is accumulated in
//     float32 registers (64 per thread at dh 256) and written once.
//   flash_dkv_kernel: one CTA owns a 32-row kv tile of one (batch, kv
//     head); its K and V tiles stay in shared memory while it walks the G
//     query heads of its group and, for each, the 64-row query tiles that
//     hold a live pair with the tile (from its own diagonal to
//     kv_end + window). dK and dV are accumulated in float32 registers
//     (2 x 64 per thread at dh 256) and each kv head's sum is written
//     once. The reference works on k and v repeated per query head and
//     its wrapper sums the G copies; here the group sum stays inside the
//     CTA, so there are no float atomics and no second pass, and two
//     launches on the same inputs give the same bits.
// Kv head h / (H / Hkv) is read in place, as in the forward.
//
// Bound: operations. Per live (query, key) pair and query head, dq does
// S, dP and dQ (6 dh FLOPs) and dk/dv does S, dP, dV and dK (8 dh); the
// bytes are far fewer at the model's shapes. This version runs scalar
// float32 FMAs out of shared memory, like the forward; tensor cores
// (mma.sync, wgmma) are a later version's work.
//
// Shared memory (float32, rows padded by 4 floats so that the float4
// reads of 8 distinct rows fall on distinct banks), at dh 256:
//   dq:  Q, dO [64][dh + 4], K, V [32][dh + 4], dS [64][33], lse, delta:
//        208,640 bytes;
//   dkv: K, V [32][dh + 4], Q, dO [64][dh + 4], P, dS [64][33], lse,
//        delta: 217,088 bytes;
// both under the 227 KB opt-in, set with cudaFuncSetAttribute; one CTA of
// 8 warps per SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQTile = 64;  // query rows per tile (the forward's tile)
constexpr int kKTile = 32;  // kv rows per tile
constexpr int kThreads = 256;
constexpr int kSStride = kKTile + 1;  // P / dS tile row stride

__device__ __forceinline__ void unpack(const uint4& u, const float*,
                                       float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, const __nv_bfloat16*,
                                       float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ void store_out(float x, float* p) { *p = x; }
__device__ __forceinline__ void store_out(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(x);
}

// ROWS x DH elements of T (row-major, contiguous) -> float rows of
// DH + 4 in shared memory, times ``mul``; 16-byte loads.
template <typename T, int DH, int ROWS>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          float* dst, float mul) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = DH / kVec;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += kThreads) {
    const int r = i / kPerRow, d = (i % kPerRow) * kVec;
    const uint4 u = *reinterpret_cast<const uint4*>(src + r * DH + d);
    float f[kVec];
    unpack(u, static_cast<const T*>(nullptr), f);
#pragma unroll
    for (int e = 0; e < kVec; e += 4) {
      *reinterpret_cast<float4*>(dst + r * (DH + 4) + d + e) =
          make_float4(f[e] * mul, f[e + 1] * mul, f[e + 2] * mul,
                      f[e + 3] * mul);
    }
  }
}

// Thread (tx, ty) of a 64 x 32 (query, key) tile owns rows ty + 16 i
// (i < 4) and keys tx + 16 c (c < 2): s = Q K^T and dp = dO V^T there.
template <int DH>
__device__ __forceinline__ void tile_products(const float* sQ,
                                              const float* sdO,
                                              const float* sK,
                                              const float* sV, int tx,
                                              int ty, float s[4][2],
                                              float dp[4][2]) {
  constexpr int kS = DH + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 2; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 2
  for (int d = 0; d < DH; d += 4) {
    float4 kv[2], vv[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      kv[c] = *reinterpret_cast<const float4*>(sK + (tx + 16 * c) * kS + d);
      vv[c] = *reinterpret_cast<const float4*>(sV + (tx + 16 * c) * kS + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 qv =
          *reinterpret_cast<const float4*>(sQ + (ty + 16 * i) * kS + d);
      const float4 ov =
          *reinterpret_cast<const float4*>(sdO + (ty + 16 * i) * kS + d);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float a = s[i][c], b = dp[i][c];
        a = fmaf(qv.x, kv[c].x, a);
        a = fmaf(qv.y, kv[c].y, a);
        a = fmaf(qv.z, kv[c].z, a);
        a = fmaf(qv.w, kv[c].w, a);
        b = fmaf(ov.x, vv[c].x, b);
        b = fmaf(ov.y, vv[c].y, b);
        b = fmaf(ov.z, vv[c].z, b);
        b = fmaf(ov.w, vv[c].w, b);
        s[i][c] = a;
        dp[i][c] = b;
      }
    }
  }
}

struct Mask {
  int causal, has_window, window, has_cap;
  float cap;
};

// s -> p and dp -> ds in place, for the query rows at q_lo + ty + 16 i and
// the keys at k_lo + tx + 16 c; lse and delta are the rows' (shared).
__device__ __forceinline__ void tile_softmax_grad(Mask mk, int q_lo,
                                                  int k_lo, int tx, int ty,
                                                  const float* sL,
                                                  const float* sD,
                                                  float s[4][2],
                                                  float dp[4][2]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qpos = q_lo + r;
    const float lse = sL[r], delta = sD[r];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int kpos = k_lo + tx + 16 * c;
      const bool live = (!mk.causal || qpos >= kpos) &&
                        (!mk.has_window || qpos - kpos < mk.window);
      float x = s[i][c];
      if (mk.has_cap) x = mk.cap * tanhf(x / mk.cap);
      const float p = live ? expf(x - lse) : 0.f;
      float ds = p * (dp[i][c] - delta);
      if (mk.has_cap) {
        const float t = x / mk.cap;
        ds *= 1.f - t * t;
      }
      s[i][c] = p;
      dp[i][c] = live ? ds : 0.f;
    }
  }
}

template <typename T, int DH>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * kQTile * (DH + 4) + 2 * kKTile * (DH + 4) +
                          kQTile * kSStride + 2 * kQTile);
}

template <typename T, int DH>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * kKTile * (DH + 4) + 2 * kQTile * (DH + 4) +
                          2 * kQTile * kSStride + 2 * kQTile);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int H,
                int Hkv, int Sq, int Skv, Mask mk, float scale,
                int q_offset) {
  constexpr int kS = DH + 4;
  constexpr int kCols = DH / 16;  // dq columns per thread
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sdO = sQ + kQTile * kS;
  float* sK = sdO + kQTile * kS;
  float* sV = sK + kKTile * kS;
  float* sDS = sV + kKTile * kS;
  float* sL = sDS + kQTile * kSStride;
  float* sD = sL + kQTile;

  const int n_qt = Sq / kQTile;
  const int qt = n_qt - 1 - blockIdx.x;  // longest causal rows first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int bkv = b * Hkv + h / (H / Hkv);
  const size_t row0 = (size_t)bh * Sq + (size_t)qt * kQTile;
  const T* kp = k + (size_t)bkv * Skv * DH;
  const T* vp = v + (size_t)bkv * Skv * DH;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<T, DH, kQTile>(q + row0 * DH, sQ, scale);
  load_tile<T, DH, kQTile>(dout + row0 * DH, sdO, 1.f);
  if (threadIdx.x < kQTile) {
    sL[threadIdx.x] = lse[row0 + threadIdx.x];
    sD[threadIdx.x] = delta[row0 + threadIdx.x];
  }

  // the kv tiles holding at least one live pair of this query tile
  const int q_lo = q_offset + qt * kQTile, q_hi = q_lo + kQTile - 1;
  int j_begin = 0, j_end = Skv / kKTile;
  if (mk.causal) j_end = min(j_end, q_hi < 0 ? 0 : q_hi / kKTile + 1);
  if (mk.has_window) {
    const long long kv_min = (long long)q_lo - mk.window + 1;
    if (kv_min > 0) {
      const long long first = kv_min / kKTile;
      j_begin = first < j_end ? (int)first : j_end;
    }
  }

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  for (int jt = j_begin; jt < j_end; ++jt) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, DH, kKTile>(kp + (size_t)jt * kKTile * DH, sK, 1.f);
    load_tile<T, DH, kKTile>(vp + (size_t)jt * kKTile * DH, sV, 1.f);
    __syncthreads();

    float s[4][2], dp[4][2];
    tile_products<DH>(sQ, sdO, sK, sV, tx, ty, s, dp);
    tile_softmax_grad(mk, q_lo, jt * kKTile, tx, ty, sL, sD, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        sDS[(ty + 16 * i) * kSStride + tx + 16 * c] = dp[i][c];
    __syncthreads();  // the dS tile is complete

    // dq[r][col] += sum_j dS[r][j] K[j][col]
#pragma unroll 4
    for (int j = 0; j < kKTile; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = sDS[(ty + 16 * i) * kSStride + j];
#pragma unroll
      for (int cd = 0; cd < kCols; ++cd) {
        const float kk = sK[j * kS + tx + 16 * cd];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cd] = fmaf(ds[i], kk, acc[i][cd]);
      }
    }
  }

  T* dqp = dq + row0 * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int cd = 0; cd < kCols; ++cd)
      store_out(acc[i][cd] * scale, dqp + (ty + 16 * i) * DH + tx + 16 * cd);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int H, int Hkv, int Sq, int Skv,
                 Mask mk, float scale, int q_offset) {
  constexpr int kS = DH + 4;
  constexpr int kCols = DH / 16;  // dk / dv columns per thread
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + kKTile * kS;
  float* sQ = sV + kKTile * kS;
  float* sdO = sQ + kQTile * kS;
  float* sP = sdO + kQTile * kS;
  float* sDS = sP + kQTile * kSStride;
  float* sL = sDS + kQTile * kSStride;
  float* sD = sL + kQTile;

  const int jt = blockIdx.x;  // causal: the first kv tiles see most rows
  const int bkv = blockIdx.y;
  const int b = bkv / Hkv, hk = bkv % Hkv;
  const int G = H / Hkv;
  const size_t krow0 = (size_t)bkv * Skv + (size_t)jt * kKTile;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<T, DH, kKTile>(k + krow0 * DH, sK, 1.f);
  load_tile<T, DH, kKTile>(v + krow0 * DH, sV, 1.f);

  // the query tiles holding at least one live pair with this kv tile:
  // from the tile of the diagonal (causal) to the tile of k_hi + window
  const int k_lo = jt * kKTile, k_hi = k_lo + kKTile - 1;
  const int n_qt = Sq / kQTile;
  int i_begin = 0, i_end = n_qt;
  if (mk.causal && k_lo - q_offset > 0)
    i_begin = min(n_qt, (k_lo - q_offset) / kQTile);
  if (mk.has_window) {
    const long long last = (long long)k_hi + mk.window - 1 - q_offset;
    i_end = last < 0 ? 0 : (int)min((long long)n_qt, last / kQTile + 1);
  }

  float dka[2][kCols], dva[2][kCols];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dka[r][c] = dva[r][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const size_t bh = (size_t)b * H + (size_t)hk * G + g;
    for (int it = i_begin; it < i_end; ++it) {
      const size_t row0 = bh * Sq + (size_t)it * kQTile;
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, DH, kQTile>(q + row0 * DH, sQ, scale);
      load_tile<T, DH, kQTile>(dout + row0 * DH, sdO, 1.f);
      if (threadIdx.x < kQTile) {
        sL[threadIdx.x] = lse[row0 + threadIdx.x];
        sD[threadIdx.x] = delta[row0 + threadIdx.x];
      }
      __syncthreads();

      float s[4][2], dp[4][2];
      tile_products<DH>(sQ, sdO, sK, sV, tx, ty, s, dp);
      tile_softmax_grad(mk, q_offset + it * kQTile, k_lo, tx, ty, sL, sD,
                        s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          sP[(ty + 16 * i) * kSStride + tx + 16 * c] = s[i][c];
          sDS[(ty + 16 * i) * kSStride + tx + 16 * c] = dp[i][c];
        }
      __syncthreads();  // the P and dS tiles are complete

      // kv row ty + 16 r: dv += sum_i P[i][row] dO[i][:],
      //                   dk += sum_i dS[i][row] (Q scale)[i][:]
#pragma unroll 2
      for (int i = 0; i < kQTile; ++i) {
        float p[2], ds[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          p[r] = sP[i * kSStride + ty + 16 * r];
          ds[r] = sDS[i * kSStride + ty + 16 * r];
        }
#pragma unroll
        for (int cd = 0; cd < kCols; ++cd) {
          const float o = sdO[i * kS + tx + 16 * cd];
          const float qq = sQ[i * kS + tx + 16 * cd];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            dva[r][cd] = fmaf(p[r], o, dva[r][cd]);
            dka[r][cd] = fmaf(ds[r], qq, dka[r][cd]);
          }
        }
      }
    }
  }

  T* dkp = dk + krow0 * DH;
  T* dvp = dv + krow0 * DH;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int cd = 0; cd < kCols; ++cd) {
      const int off = (ty + 16 * r) * DH + tx + 16 * cd;
      store_out(dka[r][cd], dkp + off);
      store_out(dva[r][cd], dvp + off);
    }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B, H, Hkv, Sq, Skv;
  Mask mk;
  float scale;
  int q_offset;
  cudaStream_t stream;
};

template <typename T, int DH>
int launch_dq(const Args& a) {
  const size_t smem = dq_smem_bytes<T, DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.Sq / kQTile, a.B * a.H);
  flash_dq_kernel<T, DH><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dq), a.H, a.Hkv, a.Sq, a.Skv, a.mk,
      a.scale, a.q_offset);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_dkv(const Args& a) {
  const size_t smem = dkv_smem_bytes<T, DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.Skv / kKTile, a.B * a.Hkv);
  flash_dkv_kernel<T, DH><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.Hkv,
      a.Sq, a.Skv, a.mk, a.scale, a.q_offset);
  return (int)cudaGetLastError();
}

template <bool DQ, typename T>
int dispatch(int dh, const Args& a) {
#define FLASH_BWD_CASE(D) \
  case D:                 \
    return DQ ? launch_dq<T, D>(a) : launch_dkv<T, D>(a);
  switch (dh) {
    FLASH_BWD_CASE(16)
    FLASH_BWD_CASE(32)
    FLASH_BWD_CASE(64)
    FLASH_BWD_CASE(128)
    FLASH_BWD_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_BWD_CASE
}

template <bool DQ>
int run(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dq, void* dk, void* dv,
        int B, int H, int Hkv, int Sq, int Skv, int dh, int is_bf16,
        int causal, int has_window, int window, int has_cap, float cap,
        float scale, int q_offset, void* stream) {
  if (Sq % kQTile || Skv % kKTile || Hkv <= 0 || H % Hkv)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout,
               static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, dk, dv, B, H, Hkv, Sq,
               Skv, Mask{causal, has_window, window, has_cap, cap}, scale,
               q_offset, static_cast<cudaStream_t>(stream)};
  return is_bf16 ? dispatch<DQ, __nv_bfloat16>(dh, a)
                 : dispatch<DQ, float>(dh, a);
}

}  // namespace

extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int H, int Hkv,
    int Sq, int Skv, int dh, int is_bf16, int causal, int has_window,
    int window, int has_cap, float cap, float scale, int q_offset,
    void* stream) {
  return run<true>(q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, H,
                   Hkv, Sq, Skv, dh, is_bf16, causal, has_window, window,
                   has_cap, cap, scale, q_offset, stream);
}

extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int Hkv, int Sq, int Skv, int dh, int is_bf16, int causal,
    int has_window, int window, int has_cap, float cap, float scale,
    int q_offset, void* stream) {
  return run<false>(q, k, v, dout, lse, delta, nullptr, dk, dv, B, H, Hkv,
                    Sq, Skv, dh, is_bf16, causal, has_window, window,
                    has_cap, cap, scale, q_offset, stream);
}
