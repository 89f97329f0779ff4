// The fp32 instance of the flash tile: one thread block of online-softmax
// attention, 64 query rows of one (batch, head) against that head's keys,
// 32 keys per tile, products on the fp32 FMA units. Shared by
// flash_attention.cu and flash_attention_cache.cu; the bf16 instance, the
// one the serving path runs, is the tensor-core tile of
// flash_tile_bf16.cuh.
//
// Why fp32 stays on FMA: fp32 runs the small reference VLM (phase 3 of
// chip_smoke.py), whose greedy tokens on the card must equal the CPU's,
// and a native OCR recognizer served in float32 (head_dim 16), whose
// texts must equal the CPU's. That needs fp32 scores and probabilities;
// the tensor cores take at best TF32 (10-bit mantissa) for fp32
// operands, which would round Q, K, P and V. Speed does not matter there.
//
// Replaces, like the bf16 tile, the body of the Pallas kernels
// _flash_kernel and _flash_cache_kernel (lumen_tpu/ops/attention.py:97,
// 249): the Pallas grid's sequential key axis is the loop over key tiles
// inside this block.
//
// Layout: 256 threads, four per query row (neighbouring lanes of one
// warp, so row reductions are two shuffles). Each thread keeps its row's
// scaled query in registers and scores every fourth key of the tile; for
// P @ V it owns every fourth output dimension. K and V tiles are staged
// in shared memory (padded rows: no bank conflicts between the four key
// rows read at once), the tile's probabilities in a [64][33] matrix.
#pragma once

#include "common.cuh"

namespace lumen {

constexpr int kFlashBQ = 64;       // query rows per block
constexpr int kFlashBK = 32;       // keys per tile
constexpr int kFlashTPR = 4;       // threads per query row
constexpr int kFlashThreads = kFlashBQ * kFlashTPR;

// q/o: this (b, h)'s [sq, D] slice; k/v: its [sk, D] slice.
// Key j is visible to query i iff j < kv_valid and (not causal or
// j <= q_off + i) -- the mask of both JAX kernels.
template <int D>
__device__ __forceinline__ void flash_tile_fp32(const float* __restrict__ q,
                                                const float* __restrict__ k,
                                                const float* __restrict__ v, float* __restrict__ o,
                                                int sq, int sk, int q0, int q_off, int kv_valid,
                                                bool causal, float scale) {
  constexpr int BQ = kFlashBQ, BK = kFlashBK, TPR = kFlashTPR;
  constexpr int KPT = BK / TPR;  // keys scored per thread per tile
  constexpr int DPT = D / TPR;   // output dims owned per thread
  static_assert(D % TPR == 0, "head_dim: a multiple of the threads a row");
  __shared__ float sK[BK][D + 1];
  __shared__ float sV[BK][D + 1];
  __shared__ float sP[BQ][BK + 1];

  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int t = tid % TPR;
  const int qi = q0 + r;
  const bool row_valid = qi < sq;
  const int q_abs = q_off + qi;

  float qreg[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qreg[d] = row_valid ? q[(size_t)qi * D + d] * scale : 0.f;

  // Keys past this bound are masked for every row of the block: the
  // live slots, and for causal blocks the diagonal of the block's last
  // row. Dead tiles are never loaded.
  int kend = kv_valid < sk ? kv_valid : sk;
  if (causal) {
    const int diag = q_off + q0 + BQ;
    kend = diag < kend ? diag : kend;
  }

  float m = kNegInf, l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  for (int kb = 0; kb < kend; kb += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BK * D; idx += kFlashThreads) {
      const int j = idx / D, d = idx % D;
      const int kp = kb + j;
      float kk = 0.f, vv = 0.f;
      if (kp < sk) {
        kk = k[(size_t)kp * D + d];
        vv = v[(size_t)kp * D + d];
      }
      sK[j][d] = kk;
      sV[j][d] = vv;
    }
    __syncthreads();

    float s[KPT];
    float tmax = kNegInf;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int j = jj * TPR + t;
      const int kp = kb + j;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qreg[d], sK[j][d], dot);
      const bool live = kp < kv_valid && kp < sk && (!causal || kp <= q_abs);
      s[jj] = live ? dot : kNegInf;
      tmax = fmaxf(tmax, s[jj]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const float p = expf(s[jj] - m_new);
      sP[r][jj * TPR + t] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = alpha * l + psum;
    m = m_new;
    __syncwarp();  // the row's four lanes see each other's probabilities

#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
    for (int j = 0; j < BK; ++j) {
      const float p = sP[r][j];
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p, sV[j][i * TPR + t], acc[i]);
    }
  }

  if (row_valid) {
    const float denom = fmaxf(l, 1e-20f);
#pragma unroll
    for (int i = 0; i < DPT; ++i) o[(size_t)qi * D + i * TPR + t] = acc[i] / denom;
  }
}

}  // namespace lumen
