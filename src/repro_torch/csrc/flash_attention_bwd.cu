// Flash attention backward: dQ, and dK / dV summed over each kv head's
// group of query heads, for causal / sliding-window / logit-softcapped
// attention with grouped kv heads.
//
// Replaces repro/kernels/flash_attention.py flash_attention_bwd: its two
// Pallas passes _dq_kernel (flash_dq_mma_kernel in bf16, flash_dq_kernel
// in float32) and _dkv_kernel (flash_dkv_mma_kernel, flash_dkv_kernel).
// Both recompute the probabilities of one tile from the forward's saved
// log-sum-exp instead of keeping any [Sq, Skv] tile in device memory:
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
// no order, so the minor axis moves inside the CTA: a dq CTA owns a
// 64-row query tile of one (batch, head) and streams the kv tiles that
// hold a live pair with it (the forward's tile range), longest causal
// rows first; a dk/dv CTA owns a kv tile of one (batch, kv head) and
// walks the G query heads of its group and, for each, the query tiles
// that hold a live pair with it (from its own diagonal to kv_end +
// window), first kv tiles (which see the most rows) first. The group sum
// stays inside the CTA, so there are no float atomics and no second pass,
// and two launches on the same inputs give the same bits. Kv head
// h / (H / Hkv) is read in place, as in the forward.
//
// Any Sq and Skv: the last query tile and kv tile may be ragged. Rows past
// the end are loaded as zeros and never read (cp.async with a src-size of
// 0 in bf16), as are lse and delta past Sq; keys at or past Skv and query
// rows at or past Sq are dead pairs (p = dS = 0), so they add nothing to
// dK / dV or dQ, and their rows are not stored.
//
// Bound: operations. Per live (query, key) pair and query head, dq does
// S, dP and dQ (6 dh FLOPs) and dk/dv does S, dP, dV and dK (8 dh), against
// the card's bf16 tensor-core rate; the bytes are far fewer at the
// model's shapes.
//
// bf16, on mma.sync.m16n8k16 (bf16 x bf16 -> float32) under the forward's
// precision rules (flash_mma.cuh): each product over dh (S, dP) is one
// MMA from zero per 16-wide k-step, the k-steps summed with Kahan
// compensation; each tile's contribution to dQ, dK or dV is an MMA chain
// from zero over that tile, added to a float32 accumulator, so no float32
// state rides an MMA chain across tiles; P and dS enter the MMAs as bf16
// hi + lo halves (a single bf16 rounding of dS reads up to 2.0 of the
// tolerance against the reference, of P up to 1.13:
// tests/test_torch_flash_bwd.py test_bf16_bwd_split_holds_the_card_
// tolerance). 4 warps of 128 threads; rows padded by 8 bf16 so that
// every ldmatrix phase falls on distinct banks.
//   flash_dq_mma_kernel: the warps' rows are query rows (M), as in the
//     forward. Q and dO stay bf16 in shared memory; K and V tiles of 32
//     rows are double-buffered by cp.async. S = Q K^T and dP = dO V^T give
//     dS, which stays in registers as the A operand of dQ += dS K, K read
//     by ldmatrix.trans.
//   flash_dkv_mma_kernel: the tiles are transposed, S^T = K Q^T and
//     dP^T = V dO^T with kv rows as M, so P^T and dS^T land in registers
//     as the A operands of dV += P^T dO and dK += dS^T Q (dO and Q by
//     ldmatrix.trans) with no trip through shared memory; lse and delta
//     are indexed by column. Q, dO, lse and delta tiles of kQN query rows
//     (16 at dh 256, else 32) are double-buffered by cp.async; the CTA's
//     K and V stay in shared memory.
// Registers at dh 256: dK and dV of 16 kv rows a warp would take 2 x 128
// float32 registers a thread, over the 255 limit, and dQ alone (128, as
// the forward's O) left ptxas 8-16 bytes short. So from dh 128 on both
// kernels' warps work in pairs over the same 16 rows: one warp of a pair
// computes S, the other dP, each over all of dh with its own Kahan sums;
// they swap the float32 sums through shared memory (n / 2 floats a thread
// for an n-row tile); both then form the same P and dS, and each keeps
// the accumulators of half of the dh columns (dQ 64, or dK + dV 64 + 64
// registers at dh 256; ptxas reports no spills). A CTA then holds 32 rows
// of its own side, 64 below dh 128, where each warp computes both
// products and keeps every column. Shared memory at dh 256, two CTAs per
// SM (the registers' limit): dq (dh + 8) (4 x 32 + 8 x 32) + 4 x 2048
// bytes = 109,568; dk/dv (dh + 8) (4 x 32 + 8 x 16) + 4 (64 + 1024) =
// 71,936.
//
// float32: flash_dq_kernel and flash_dkv_kernel, scalar float32 FMAs out
// of shared memory (tensor cores would change float32 arithmetic), as the
// forward keeps flash_fwd_kernel. Shared memory (float32, rows padded by
// 4 floats so that the float4 reads of 8 distinct rows fall on distinct
// banks), at dh 256:
//   dq:  Q, dO [64][dh + 4], K, V [32][dh + 4], dS [64][33], lse, delta:
//        208,640 bytes;
//   dkv: K, V [32][dh + 4], Q, dO [64][dh + 4], P, dS [64][33], lse,
//        delta: 217,088 bytes;
// both under the 227 KB opt-in, set with cudaFuncSetAttribute; one CTA of
// 8 warps per SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

using namespace flash_mma;

struct Mask {
  int causal, has_window, window, has_cap;
  float cap;
};

// ---------------------------------------------------------------- float32
constexpr int kQTile = 64;  // query rows per tile (the forward's tile)
constexpr int kKTile = 32;  // kv rows per tile
constexpr int kThreads = 256;
constexpr int kSStride = kKTile + 1;  // P / dS tile row stride

// ROWS x DH float32 (row-major, contiguous) -> rows of DH + 4 in shared
// memory, times ``mul``; 16-byte loads; rows at or past ``valid`` are
// zero-filled and not read.
template <int DH, int ROWS>
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          float* dst, float mul, int valid) {
  constexpr int kPerRow = DH / 4;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += kThreads) {
    const int r = i / kPerRow, d = (i % kPerRow) * 4;
    const float4 f = r < valid
        ? *reinterpret_cast<const float4*>(src + r * DH + d)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * (DH + 4) + d) =
        make_float4(f.x * mul, f.y * mul, f.z * mul, f.w * mul);
  }
}

// lse and delta of ``valid`` rows from ``row0`` into shared memory, 0 past
template <int ROWS>
__device__ __forceinline__ void load_rows_stats(const float* lse,
                                                const float* delta,
                                                size_t row0, int valid,
                                                float* sL, float* sD) {
  if (threadIdx.x < ROWS) {
    const bool live = (int)threadIdx.x < valid;
    sL[threadIdx.x] = live ? lse[row0 + threadIdx.x] : 0.f;
    sD[threadIdx.x] = live ? delta[row0 + threadIdx.x] : 0.f;
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

// s -> p and dp -> ds in place, for the query rows at q_lo + ty + 16 i and
// the keys at k_lo + tx + 16 c; lse and delta are the rows' (shared).
// Query rows at or past q_rows and keys at or past k_rows are dead.
__device__ __forceinline__ void tile_softmax_grad(Mask mk, int q_lo,
                                                  int k_lo, int q_rows,
                                                  int k_rows, int tx, int ty,
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
                        (!mk.has_window || qpos - kpos < mk.window) &&
                        r < q_rows && tx + 16 * c < k_rows;
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

template <int DH>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * kQTile * (DH + 4) + 2 * kKTile * (DH + 4) +
                          kQTile * kSStride + 2 * kQTile);
}

template <int DH>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * kKTile * (DH + 4) + 2 * kQTile * (DH + 4) +
                          2 * kQTile * kSStride + 2 * kQTile);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq,
                int H, int Hkv, int Sq, int Skv, Mask mk, float scale,
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

  const int n_qt = (Sq + kQTile - 1) / kQTile;
  const int qt = n_qt - 1 - blockIdx.x;  // longest causal rows first
  const int q_rows = min(kQTile, Sq - qt * kQTile);  // the last ragged
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int bkv = b * Hkv + h / (H / Hkv);
  const size_t row0 = (size_t)bh * Sq + (size_t)qt * kQTile;
  const float* kp = k + (size_t)bkv * Skv * DH;
  const float* vp = v + (size_t)bkv * Skv * DH;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<DH, kQTile>(q + row0 * DH, sQ, scale, q_rows);
  load_tile<DH, kQTile>(dout + row0 * DH, sdO, 1.f, q_rows);
  load_rows_stats<kQTile>(lse, delta, row0, q_rows, sL, sD);

  // the kv tiles holding at least one live pair of this query tile
  const int q_lo = q_offset + qt * kQTile, q_hi = q_lo + q_rows - 1;
  int j_begin = 0, j_end = (Skv + kKTile - 1) / kKTile;
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
    const int k_rows = min(kKTile, Skv - jt * kKTile);
    __syncthreads();  // the previous tile's readers are done
    load_tile<DH, kKTile>(kp + (size_t)jt * kKTile * DH, sK, 1.f, k_rows);
    load_tile<DH, kKTile>(vp + (size_t)jt * kKTile * DH, sV, 1.f, k_rows);
    __syncthreads();

    float s[4][2], dp[4][2];
    tile_products<DH>(sQ, sdO, sK, sV, tx, ty, s, dp);
    tile_softmax_grad(mk, q_lo, jt * kKTile, q_rows, k_rows, tx, ty, sL, sD,
                      s, dp);
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

  float* dqp = dq + row0 * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (ty + 16 * i >= q_rows) continue;
#pragma unroll
    for (int cd = 0; cd < kCols; ++cd)
      dqp[(ty + 16 * i) * DH + tx + 16 * cd] = acc[i][cd] * scale;
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int H, int Hkv, int Sq, int Skv,
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
  const int k_rows = min(kKTile, Skv - jt * kKTile);  // the last ragged
  const size_t krow0 = (size_t)bkv * Skv + (size_t)jt * kKTile;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<DH, kKTile>(k + krow0 * DH, sK, 1.f, k_rows);
  load_tile<DH, kKTile>(v + krow0 * DH, sV, 1.f, k_rows);

  // the query tiles holding at least one live pair with this kv tile:
  // from the tile of the diagonal (causal) to the tile of k_hi + window
  const int k_lo = jt * kKTile, k_hi = k_lo + k_rows - 1;
  const int n_qt = (Sq + kQTile - 1) / kQTile;
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
      const int q_rows = min(kQTile, Sq - it * kQTile);
      __syncthreads();  // the previous tile's readers are done
      load_tile<DH, kQTile>(q + row0 * DH, sQ, scale, q_rows);
      load_tile<DH, kQTile>(dout + row0 * DH, sdO, 1.f, q_rows);
      load_rows_stats<kQTile>(lse, delta, row0, q_rows, sL, sD);
      __syncthreads();

      float s[4][2], dp[4][2];
      tile_products<DH>(sQ, sdO, sK, sV, tx, ty, s, dp);
      tile_softmax_grad(mk, q_offset + it * kQTile, k_lo, q_rows, k_rows,
                        tx, ty, sL, sD, s, dp);
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

  float* dkp = dk + krow0 * DH;
  float* dvp = dv + krow0 * DH;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (ty + 16 * r >= k_rows) continue;
#pragma unroll
    for (int cd = 0; cd < kCols; ++cd) {
      const int off = (ty + 16 * r) * DH + tx + 16 * cd;
      dkp[off] = dka[r][cd];
      dvp[off] = dva[r][cd];
    }
  }
}

// ---------------------------------------------------------------- bf16
// Tile rows. From dh 128 on, each kernel's warps work in pairs over the
// same 16 rows (one computes S, the other dP, and each keeps half of the
// output columns), so a CTA of 4 warps holds 32 rows of its own side
// (query rows for dq, kv rows for dk/dv), else 64. The other side's tile
// (dq's kv tile kN, dk/dv's query tile kQN) is 32 rows, 16 for dk/dv at
// dh 256, where its dK and dV take 128 registers a thread.
#define FLASH_TILE(name, type, value) \
  template <int DH>                   \
  __host__ __device__ constexpr type name() { return value; }
FLASH_TILE(mma_pairs, bool, DH >= 128)
FLASH_TILE(mma_own_rows, int, DH >= 128 ? 32 : 64)
FLASH_TILE(dq_kv_rows, int, 32)
FLASH_TILE(dkv_q_rows, int, DH == 256 ? 16 : 32)
#undef FLASH_TILE

// floats of the pairs' swap buffer: 4 warps x (n / 2) floats x 32 lanes
template <int DH, int kN>
__host__ __device__ constexpr int swap_floats() {
  return mma_pairs<DH>() ? 64 * kN : 0;
}

template <int DH>
constexpr size_t dq_mma_smem_bytes() {
  constexpr int kN = dq_kv_rows<DH>();
  return sizeof(__nv_bfloat16) * (DH + 8) * (2 * mma_own_rows<DH>() + 4 * kN) +
         sizeof(float) * swap_floats<DH, kN>();
}

template <int DH>
constexpr size_t dkv_mma_smem_bytes() {
  constexpr int kQN = dkv_q_rows<DH>();
  return sizeof(__nv_bfloat16) * (DH + 8) *
             (2 * mma_own_rows<DH>() + 4 * kQN) +
         sizeof(float) * (4 * kQN + swap_floats<DH, kQN>());
}

// s = S and dp = dP of this warp's 16 rows over kNT * 8 columns, each
// Kahan-summed over all of dh (kahan_product): (sa, sb) are S's A and B
// lane addresses, (da, db) dP's. With pairs each warp computes one (even
// warps S, odd warps dP) and the two swap their float32 sums through sX
// (conflict-free: one float of each lane at a time).
template <int DH, int kNT, bool kPair>
__device__ __forceinline__ void tile_products_mma(
    uint32_t sa, uint32_t sb, uint32_t da, uint32_t db, float* sX,
    float (&s)[kNT][4], float (&dp)[kNT][4]) {
  if (!kPair) {
    kahan_product<DH, kNT>(sa, sb, s);
    kahan_product<DH, kNT>(da, db, dp);
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int role = warp & 1;
  float x[kNT][4];
  kahan_product<DH, kNT>(role ? da : sa, role ? db : sb, x);
  float* mine = sX + warp * (kNT * 4 * 32) + lane;
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mine[(j * 4 + e) * 32] = x[j][e];
  __syncthreads();  // both halves of every pair are in
  const float* other = sX + (warp ^ 1) * (kNT * 4 * 32) + lane;
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float y = other[(j * 4 + e) * 32];
      s[j][e] = role ? y : x[j][e];
      dp[j][e] = role ? x[j][e] : y;
    }
}

// p and ds of one score element from its S and dP sums: softcap, mask,
// p = exp(s_cap - lse), ds = p (dp - delta) (1 - t^2), both 0 when dead
__device__ __forceinline__ void softmax_grad(Mask mk, float rcap, float scale,
                                             bool live, float lse,
                                             float delta, float& s,
                                             float& dp) {
  float x = s * scale, tf = 1.f;
  if (mk.has_cap) {
    x = mk.cap * tanhf(div_by(x, mk.cap, rcap));
    const float t = div_by(x, mk.cap, rcap);
    tf = 1.f - t * t;
  }
  const float p = live ? expf(x - lse) : 0.f;
  s = p;
  dp = p * (dp - delta) * tf;
}

__device__ __forceinline__ bool live_pair(Mask mk, int dpos) {
  return (!mk.causal || dpos >= 0) && (!mk.has_window || dpos < mk.window);
}

template <int DH, int kN>
__global__ void __launch_bounds__(kMmaThreads, 1)
flash_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int H, int Hkv, int Sq,
                    int Skv, Mask mk, float scale, int q_offset) {
  constexpr bool kPair = mma_pairs<DH>();
  constexpr int kM = mma_own_rows<DH>();      // query rows a CTA
  constexpr int kCols = kPair ? DH / 2 : DH;  // dQ columns a warp
  constexpr int kStride = DH + 8;  // bf16 per shared row
  constexpr int kNT = kN / 8;      // score n-tiles per warp
  constexpr int kDT = kCols / 8;   // dQ n-tiles per warp
  constexpr uint32_t kRowBytes = kStride * 2, kBufBytes = kN * kRowBytes;
  extern __shared__ __align__(16) unsigned char smem_dq[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_dq);
  __nv_bfloat16* sdO = sQ + kM * kStride;
  __nv_bfloat16* sK = sdO + kM * kStride;     // [2][kN][kStride]
  __nv_bfloat16* sV = sK + 2 * kN * kStride;  // [2][kN][kStride]
  float* sX = reinterpret_cast<float*>(sV + 2 * kN * kStride);  // the swap

  const int n_qt = (Sq + kM - 1) / kM;
  const int qt = n_qt - 1 - blockIdx.x;  // longest causal rows first
  const int q_rows = min(kM, Sq - qt * kM);  // the last tile ragged
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int bkv = b * Hkv + h / (H / Hkv);
  const size_t row0 = (size_t)bh * Sq + (size_t)qt * kM;
  const __nv_bfloat16* kp = k + (size_t)bkv * Skv * DH;
  const __nv_bfloat16* vp = v + (size_t)bkv * Skv * DH;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;  // fragment row, column pair
  const int wrow = (kPair ? warp >> 1 : warp) * 16;  // the warp's rows
  const int col0 = (kPair ? warp & 1 : 0) * kCols;   // its dQ columns

  // the kv tiles holding at least one live pair of this query tile
  const int q_lo = q_offset + qt * kM, q_hi = q_lo + q_rows - 1;
  int j_begin = 0, j_end = (Skv + kN - 1) / kN;
  if (mk.causal) j_end = min(j_end, q_hi < 0 ? 0 : q_hi / kN + 1);
  if (mk.has_window) {
    const long long kv_min = (long long)q_lo - mk.window + 1;
    if (kv_min > 0) {
      const long long first = kv_min / kN;
      j_begin = first < j_end ? (int)first : j_end;
    }
  }

  const uint32_t sq_addr = smem_addr(sQ), sdo_addr = smem_addr(sdO),
                 sk_addr = smem_addr(sK), sv_addr = smem_addr(sV);
  copy_rows<DH, kM>(sq_addr, q + row0 * DH, q_rows);
  copy_rows<DH, kM>(sdo_addr, dout + row0 * DH, q_rows);
  if (j_begin < j_end) {
    const int rows = min(kN, Skv - j_begin * kN);
    copy_rows<DH, kN>(sk_addr, kp + (size_t)j_begin * kN * DH, rows);
    copy_rows<DH, kN>(sv_addr, vp + (size_t)j_begin * kN * DH, rows);
  }
  cp_async_commit();

  // this thread's rows w0 and w0 + 8; past Sq they are zero rows, not
  // stored, and read no lse or delta
  const int w0 = wrow + g;
  const bool st0 = w0 < q_rows, st1 = w0 + 8 < q_rows;
  const float lse0 = st0 ? lse[row0 + w0] : 0.f;
  const float lse1 = st1 ? lse[row0 + w0 + 8] : 0.f;
  const float dl0 = st0 ? delta[row0 + w0] : 0.f;
  const float dl1 = st1 ? delta[row0 + w0 + 8] : 0.f;

  // this lane's ldmatrix row addresses: A from Q and dO, B from K and V,
  // B from K by .trans (the warp's columns)
  const uint32_t q_addr = a_lane<DH>(sq_addr, wrow);
  const uint32_t do_addr = a_lane<DH>(sdo_addr, wrow);
  const uint32_t k_addr = b_lane<DH>(sk_addr), v_addr = b_lane<DH>(sv_addr);
  const uint32_t kt_addr = bt_lane<DH>(sk_addr) + col0 * 2;

  float acc[kDT][4];
#pragma unroll
  for (int d = 0; d < kDT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  const int r0 = q_lo + w0;
  const float rcap = mk.has_cap ? rcp_approx(mk.cap) : 1.f;

  for (int jt = j_begin; jt < j_end; ++jt) {
    const int buf = (jt - j_begin) & 1;
    if (jt + 1 < j_end) {
      const int rows = min(kN, Skv - (jt + 1) * kN);
      copy_rows<DH, kN>(sk_addr + (buf ^ 1) * kBufBytes,
                        kp + (size_t)(jt + 1) * kN * DH, rows);
      copy_rows<DH, kN>(sv_addr + (buf ^ 1) * kBufBytes,
                        vp + (size_t)(jt + 1) * kN * DH, rows);
    }
    cp_async_commit();
    cp_async_wait<1>();  // Q, dO and tile jt have landed
    __syncthreads();

    // S = Q K^T and dP = dO V^T, then dS in place of dP (dead pairs 0),
    // as bf16 hi / lo A fragments of dQ += dS K. __syncwarp() in the
    // phases below keeps ptxas from hoisting the next phase's loads, as
    // in the forward.
    float s[kNT][4], dp[kNT][4];
    tile_products_mma<DH, kNT, kPair>(q_addr, k_addr + buf * kBufBytes,
                                      do_addr, v_addr + buf * kBufBytes, sX,
                                      s, dp);
    const int k0 = jt * kN, k_rows = Skv - k0;
    const bool masked = (mk.causal && k0 + kN - 1 > q_lo) ||
                        (mk.has_window && q_hi - k0 >= mk.window) ||
                        k_rows < kN;
    const int dq0 = r0 - k0 - 2 * tq;  // q_pos - kv_pos of element (0, 0)
    uint32_t dsh[kN / 16][4], dsl[kN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = 2 * kk + hf;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool live =
              !masked || (live_pair(mk, dq0 + (e >> 1) * 8 - j * 8 - (e & 1))
                          && j * 8 + 2 * tq + (e & 1) < k_rows);
          softmax_grad(mk, rcap, scale, live, (e >> 1) ? lse1 : lse0,
                       (e >> 1) ? dl1 : dl0, s[j][e], dp[j][e]);
        }
        split_bf16(dp[j][0], dp[j][1], dsh[kk][2 * hf], dsl[kk][2 * hf]);
        split_bf16(dp[j][2], dp[j][3], dsh[kk][2 * hf + 1],
                   dsl[kk][2 * hf + 1]);
      }
      __syncwarp();
    }

    // dQ += dS K over the warp's columns, K by ldmatrix.trans: this
    // tile's product from zero, added to the float32 accumulator
    const uint32_t cKt = kt_addr + buf * kBufBytes;
#pragma unroll
    for (int dn = 0; dn < kDT / 2; ++dn) {
      float t[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, cKt + kk * 16 * kRowBytes + dn * 32);
        mma_bf16(t[0], dsh[kk], bb[0], bb[1]);
        mma_bf16(t[0], dsl[kk], bb[0], bb[1]);
        mma_bf16(t[1], dsh[kk], bb[2], bb[3]);
        mma_bf16(t[1], dsl[kk], bb[2], bb[3]);
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[2 * dn + hf][e] += t[hf][e];
      __syncwarp();
    }
    __syncthreads();  // the next iteration refills this buffer and swap
  }
  cp_async_wait<0>();

  __nv_bfloat16* o0 = dq + (row0 + w0) * DH + col0 + 2 * tq;
  __nv_bfloat16* o1 = o0 + 8 * DH;
#pragma unroll
  for (int d = 0; d < kDT; ++d) {
    if (st0)
      *reinterpret_cast<__nv_bfloat162*>(o0 + d * 8) = __floats2bfloat162_rn(
          acc[d][0] * scale, acc[d][1] * scale);
    if (st1)
      *reinterpret_cast<__nv_bfloat162*>(o1 + d * 8) = __floats2bfloat162_rn(
          acc[d][2] * scale, acc[d][3] * scale);
  }
}

template <int DH, int kQN>
__global__ void __launch_bounds__(kMmaThreads, 1)
flash_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int H, int Hkv, int Sq,
                     int Skv, Mask mk, float scale, int q_offset) {
  constexpr bool kPair = mma_pairs<DH>();
  constexpr int kM = mma_own_rows<DH>();      // kv rows a CTA
  constexpr int kCols = kPair ? DH / 2 : DH;  // dK / dV columns a warp
  constexpr int kStride = DH + 8;
  constexpr int kNT = kQN / 8;    // score n-tiles (queries) per warp
  constexpr int kDT = kCols / 8;  // dK / dV n-tiles per warp
  constexpr uint32_t kRowBytes = kStride * 2, kBufBytes = kQN * kRowBytes;
  extern __shared__ __align__(16) unsigned char smem_dkv[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_dkv);
  __nv_bfloat16* sV = sK + kM * kStride;
  __nv_bfloat16* sQ = sV + kM * kStride;        // [2][kQN][kStride]
  __nv_bfloat16* sdO = sQ + 2 * kQN * kStride;  // [2][kQN][kStride]
  float* sL = reinterpret_cast<float*>(sdO + 2 * kQN * kStride);  // [2][kQN]
  float* sD = sL + 2 * kQN;                                        // [2][kQN]
  float* sX = sD + 2 * kQN;  // the pairs' swap

  const int jt = blockIdx.x;  // causal: the first kv tiles see most rows
  const int bkv = blockIdx.y;
  const int b = bkv / Hkv, hk = bkv % Hkv;
  const int G = H / Hkv;
  const int k_lo = jt * kM, k_rows = min(kM, Skv - k_lo);  // last ragged
  const size_t krow0 = (size_t)bkv * Skv + k_lo;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;  // fragment row, column pair
  const int wrow = (kPair ? warp >> 1 : warp) * 16;  // the warp's kv rows
  const int col0 = (kPair ? warp & 1 : 0) * kCols;   // its dK, dV columns

  // the query tiles holding at least one live pair with this kv tile:
  // from the tile of the diagonal (causal) to the tile of k_hi + window
  const int k_hi = k_lo + k_rows - 1;
  const int n_qt = (Sq + kQN - 1) / kQN;
  int i_begin = 0, i_end = n_qt;
  if (mk.causal && k_lo - q_offset > 0)
    i_begin = min(n_qt, (k_lo - q_offset) / kQN);
  if (mk.has_window) {
    const long long last = (long long)k_hi + mk.window - 1 - q_offset;
    i_end = last < 0 ? 0 : (int)min((long long)n_qt, last / kQN + 1);
  }
  const int nq = max(0, i_end - i_begin);
  const int n_steps = G * nq;  // (query head of the group, query tile)

  const uint32_t sk_addr = smem_addr(sK), sv_addr = smem_addr(sV),
                 sq_addr = smem_addr(sQ), sdo_addr = smem_addr(sdO),
                 sl_addr = smem_addr(sL), sd_addr = smem_addr(sD);
  // step st's Q, dO rows and their lse, delta into buffer bf
  auto stage = [&](int st, int bf) {
    const int it = i_begin + st % nq;
    const size_t row0 =
        ((size_t)b * H + (size_t)hk * G + st / nq) * Sq + (size_t)it * kQN;
    const int rows = min(kQN, Sq - it * kQN);
    copy_rows<DH, kQN>(sq_addr + bf * kBufBytes, q + row0 * DH, rows);
    copy_rows<DH, kQN>(sdo_addr + bf * kBufBytes, dout + row0 * DH, rows);
    if (threadIdx.x < 2 * kQN) {
      const int r = threadIdx.x % kQN;
      const bool live = r < rows;
      const bool is_l = threadIdx.x < kQN;
      cp_async4((is_l ? sl_addr : sd_addr) + (bf * kQN + r) * 4,
                (is_l ? lse : delta) + row0 + (live ? r : 0), live ? 4 : 0);
    }
  };
  copy_rows<DH, kM>(sk_addr, k + krow0 * DH, k_rows);
  copy_rows<DH, kM>(sv_addr, v + krow0 * DH, k_rows);
  if (n_steps > 0) stage(0, 0);
  cp_async_commit();

  // this lane's ldmatrix row addresses: A from K and V (the warp's kv
  // rows), B from Q and dO, B from Q and dO by .trans (the warp's columns)
  const uint32_t ka_addr = a_lane<DH>(sk_addr, wrow);
  const uint32_t va_addr = a_lane<DH>(sv_addr, wrow);
  const uint32_t qb_addr = b_lane<DH>(sq_addr), dob_addr = b_lane<DH>(sdo_addr);
  const uint32_t qt_addr = bt_lane<DH>(sq_addr) + col0 * 2;
  const uint32_t dot_addr = bt_lane<DH>(sdo_addr) + col0 * 2;

  float dka[kDT][4], dva[kDT][4];
#pragma unroll
  for (int d = 0; d < kDT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;
  const int kv0 = k_lo + wrow + g;  // kv position of fragment row g
  const float rcap = mk.has_cap ? rcp_approx(mk.cap) : 1.f;

  for (int st = 0; st < n_steps; ++st) {
    const int buf = st & 1;
    if (st + 1 < n_steps) stage(st + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // K, V and step st have landed
    __syncthreads();
    const int q0 = (i_begin + st % nq) * kQN;  // query index of column 0
    const int q_rows = Sq - q0;
    const float* cL = sL + buf * kQN;
    const float* cD = sD + buf * kQN;

    // S^T = K Q^T and dP^T = V dO^T, then P^T and dS^T in place (dead
    // pairs 0), both as bf16 hi / lo A fragments; lse and delta by column
    float s[kNT][4], dp[kNT][4];
    tile_products_mma<DH, kNT, kPair>(ka_addr, qb_addr + buf * kBufBytes,
                                      va_addr, dob_addr + buf * kBufBytes,
                                      sX, s, dp);
    const int qp0 = q_offset + q0;  // query position of column 0
    const bool masked = (mk.causal && qp0 < k_lo + kM - 1) ||
                        (mk.has_window && qp0 + kQN - 1 - k_lo >= mk.window) ||
                        q_rows < kQN || k_rows < kM;
    const int dq0 = qp0 + 2 * tq - kv0;  // q_pos - kv_pos of element (0, 0)
    uint32_t ph[kQN / 16][4], pl[kQN / 16][4];
    uint32_t dsh[kQN / 16][4], dsl[kQN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kQN / 16; ++kk) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = 2 * kk + hf;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + 2 * tq + (e & 1);
          const bool live =
              !masked || (live_pair(mk, dq0 + j * 8 + (e & 1) - (e >> 1) * 8)
                          && col < q_rows && wrow + g + (e >> 1) * 8 < k_rows);
          softmax_grad(mk, rcap, scale, live, cL[col], cD[col], s[j][e],
                       dp[j][e]);
        }
        split_bf16(s[j][0], s[j][1], ph[kk][2 * hf], pl[kk][2 * hf]);
        split_bf16(s[j][2], s[j][3], ph[kk][2 * hf + 1], pl[kk][2 * hf + 1]);
        split_bf16(dp[j][0], dp[j][1], dsh[kk][2 * hf], dsl[kk][2 * hf]);
        split_bf16(dp[j][2], dp[j][3], dsh[kk][2 * hf + 1],
                   dsl[kk][2 * hf + 1]);
      }
      __syncwarp();
    }

    // dV += P^T dO and dK += dS^T Q over the warp's columns, dO and Q by
    // ldmatrix.trans: this step's products from zero, added to the
    // float32 accumulators
    const uint32_t cdo = dot_addr + buf * kBufBytes;
    const uint32_t cq = qt_addr + buf * kBufBytes;
#pragma unroll
    for (int dn = 0; dn < kDT / 2; ++dn) {
      float tv[2][4] = {}, tk[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kQN / 16; ++kk) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, cdo + kk * 16 * kRowBytes + dn * 32);
        mma_bf16(tv[0], ph[kk], bb[0], bb[1]);
        mma_bf16(tv[0], pl[kk], bb[0], bb[1]);
        mma_bf16(tv[1], ph[kk], bb[2], bb[3]);
        mma_bf16(tv[1], pl[kk], bb[2], bb[3]);
        ldmatrix_x4_trans(bb, cq + kk * 16 * kRowBytes + dn * 32);
        mma_bf16(tk[0], dsh[kk], bb[0], bb[1]);
        mma_bf16(tk[0], dsl[kk], bb[0], bb[1]);
        mma_bf16(tk[1], dsh[kk], bb[2], bb[3]);
        mma_bf16(tk[1], dsl[kk], bb[2], bb[3]);
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dva[2 * dn + hf][e] += tv[hf][e];
          dka[2 * dn + hf][e] += tk[hf][e];
        }
      __syncwarp();
    }
    __syncthreads();  // the next step refills this buffer and the swap
  }
  cp_async_wait<0>();

  const int r0 = wrow + g;
  const bool st0 = r0 < k_rows, st1 = r0 + 8 < k_rows;
  const size_t off = (krow0 + r0) * DH + col0 + 2 * tq;
#pragma unroll
  for (int d = 0; d < kDT; ++d) {
    if (st0) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + d * 8) =
          __floats2bfloat162_rn(dka[d][0] * scale, dka[d][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + d * 8) =
          __floats2bfloat162_rn(dva[d][0], dva[d][1]);
    }
    if (st1) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * DH + d * 8) =
          __floats2bfloat162_rn(dka[d][2] * scale, dka[d][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * DH + d * 8) =
          __floats2bfloat162_rn(dva[d][2], dva[d][3]);
    }
  }
}

// ------------------------------------------------------------- launches
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

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int DH>
int launch_dq(const Args& a, int is_bf16) {
  using bf16 = __nv_bfloat16;
  const int rows = is_bf16 ? mma_own_rows<DH>() : kQTile;
  const dim3 grid((a.Sq + rows - 1) / rows, a.B * a.H);
  if (is_bf16) {
    const size_t smem = dq_mma_smem_bytes<DH>();
    constexpr int kN = dq_kv_rows<DH>();
    if (int err = prepare(flash_dq_mma_kernel<DH, kN>, smem)) return err;
    flash_dq_mma_kernel<DH, kN><<<grid, kMmaThreads, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        a.lse, a.delta, static_cast<bf16*>(a.dq), a.H, a.Hkv, a.Sq, a.Skv,
        a.mk, a.scale, a.q_offset);
  } else {
    const size_t smem = dq_smem_bytes<DH>();
    if (int err = prepare(flash_dq_kernel<DH>, smem)) return err;
    flash_dq_kernel<DH><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.lse, a.delta, static_cast<float*>(a.dq), a.H, a.Hkv, a.Sq, a.Skv,
        a.mk, a.scale, a.q_offset);
  }
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dkv(const Args& a, int is_bf16) {
  using bf16 = __nv_bfloat16;
  const int rows = is_bf16 ? mma_own_rows<DH>() : kKTile;
  const dim3 grid((a.Skv + rows - 1) / rows, a.B * a.Hkv);
  if (grid.x == 0) return 0;  // no keys: dk and dv are empty
  if (is_bf16) {
    const size_t smem = dkv_mma_smem_bytes<DH>();
    constexpr int kQN = dkv_q_rows<DH>();
    if (int err = prepare(flash_dkv_mma_kernel<DH, kQN>, smem)) return err;
    flash_dkv_mma_kernel<DH, kQN><<<grid, kMmaThreads, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        a.lse, a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
        a.H, a.Hkv, a.Sq, a.Skv, a.mk, a.scale, a.q_offset);
  } else {
    const size_t smem = dkv_smem_bytes<DH>();
    if (int err = prepare(flash_dkv_kernel<DH>, smem)) return err;
    flash_dkv_kernel<DH><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.lse, a.delta, static_cast<float*>(a.dk),
        static_cast<float*>(a.dv), a.H, a.Hkv, a.Sq, a.Skv, a.mk, a.scale,
        a.q_offset);
  }
  return (int)cudaGetLastError();
}

template <bool DQ>
int dispatch(int dh, const Args& a, int is_bf16) {
#define FLASH_BWD_CASE(D) \
  case D:                 \
    return DQ ? launch_dq<D>(a, is_bf16) : launch_dkv<D>(a, is_bf16);
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
  if (Sq <= 0 || Skv < 0 || Hkv <= 0 || H % Hkv)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout,
               static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, dk, dv, B, H, Hkv, Sq,
               Skv, Mask{causal, has_window, window, has_cap, cap}, scale,
               q_offset, static_cast<cudaStream_t>(stream)};
  return dispatch<DQ>(dh, a, is_bf16);
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
