// The 2-byte instances of the flash tile (bf16 and fp16), on the tensor
// cores: one thread block of online-softmax attention over one (batch,
// head), FA2-style, with one fixed block shape. flash_attention_cache.cu
// (prefill chunks against the contiguous KV scratch) runs it;
// flash_attention runs its fork, flash_plan_bf16.cuh, which picks a plan
// for each call. The element type T (__nv_bfloat16 or __half) changes
// only the mma form and the two roundings (P and the output): the fp16
// instance runs the bf16 one's block shape and operations. The fp32
// instance stays on the FMA units (flash_tile_fp32.cuh says why).
//
// Replaces the body of the Pallas kernel _flash_cache_kernel
// (lumen_tpu/ops/attention.py:249). The Pallas
// grid's sequential key axis, which carried the running max/sum/output in
// VMEM scratch from one grid step to the next, is the loop over key tiles
// inside this block (Hopper blocks run in no order).
//
// Design (head_dim D = 64 on the VLM and CLIP paths, 128 on the Qwen2-MoE
// decoder's, 16 on the native OCR recognizer's):
// - A block holds kFlashWarps row groups of 16 query rows. Each row group
//   has kFlashSplit warps; warp s of a group takes key tiles s, s +
//   kFlashSplit, ... with its own online softmax, and the group's warps
//   are merged in a fixed order at the end (below). A warp loads its Q
//   fragments (16 x D of T: 16 registers a thread for D = 64) once,
//   through shared memory and ldmatrix, and keeps them.
// - Keys come in tiles of 64, copied with 16-byte cp.async into a ring of
//   kFlashStages tile slots in (dynamic) shared memory, a step of
//   kFlashSplit tiles at a time: the next step is in flight while this one
//   is computed. Rows are padded to D + 8 elements (144 B), which makes every
//   ldmatrix phase touch 32 distinct banks. Rows at or past kend (below)
//   are zero-filled without a read.
// - S = Q K^T: mma.sync m16n8k16 T -> fp32, K's B fragments by ldmatrix
//   (a [key][D] row is already the .col layout). 8 n8 tiles x D/16 k-steps.
//   One ldmatrix.x4 fills two k-steps of a score tile; at D = 16 (one
//   k-step) it fills one k-step of two neighbouring score tiles instead.
//   Rows of 16 + 8 elements (48 B) put the 8 rows of an ldmatrix phase on 8
//   distinct 4-bank groups, so that width is conflict-free too.
// - Scores are scaled in fp32 by scale * log2(e) and exponentiated with
//   exp2f, so Q, K and the scores are never rounded; the only rounding
//   beyond the fp32 sums is P's to T (next point). Only tiles that cross
//   a bound (kv_valid, sk, or the causal diagonal of the warp's rows) are
//   masked, in registers, with the -1e30 of common.cuh; interior tiles are
//   not. Row max and sum shuffle within the 4-lane quad that holds a row.
// - P V with P in registers: the C fragments of two neighbouring n8 score
//   tiles are the A fragment of one k16 step, so the unnormalised P is
//   rounded to T in registers and never touches shared memory. V's B
//   fragments come from ldmatrix.trans.
// - O accumulates in fp32 registers (D / 2 a thread). Merge: warps 1 ..
//   kFlashSplit - 1 of a row group leave (max, sum, O) in shared memory and
//   warp 0 folds them in, in that order, lane by lane (the same lane holds
//   the same fragment). The epilogue divides by max(l, 1e-20), rounds to
//   T once, and stores 16-byte vectors through the Q/O staging rows.
// - Tile skipping as in the fp32 tile: no tile at or past kend = min(
//   kv_valid, sk, the block's causal diagonal) is loaded, and a warp skips
//   the tiles wholly above its own rows' diagonal (their P is exactly 0).
// A row's output depends only on its own query, its (b, h)'s keys and
// the two ints, in a fixed order of operations: no atomics, no reduction
// across blocks.
//
// What bounds it on the H100, at the serving path's shapes ([1,14,256|63,
// 64] chunks against 256-265 live keys): the bound is ~0.0005 ms of bytes,
// and the tensor cores would take ~0.0001 ms for the FLOPs. The floor is
// latency: a warp walks its share of the 4-5 key tiles one after another
// (copy, 64 MMAs, softmax), plus the launch; the key split halves that
// chain and lets two warps share each SM sub-partition. The tile already
// runs at a quarter of masked SDPA's time there. What flash_attention's
// redesign measured for this card applies to it too (PERF.md): a 1-D
// cp.async.bulk of the K/V rows was 3-5x slower than 16-byte cp.async,
// and exp2 on the FMA pipe did not pay; a tile with all its score tiles
// computed wants a branch-free instance. Its own redesign is queued in
// ROADMAP.md's order of work.
#pragma once

#include "common.cuh"

namespace lumen {

// Row groups per block (16 query rows each), warps per row group (key
// split), and tile slots of the K/V ring. Chosen by measurement at the
// serving path's shapes (PERF.md).
constexpr int kFlashWarps = 2;
constexpr int kFlashSplit = 2;
constexpr int kFlashStages = 4;
constexpr int kFlashMmaRows = 16 * kFlashWarps;  // query rows per block
constexpr int kFlashMmaThreads = 32 * kFlashWarps * kFlashSplit;
constexpr int kFlashMmaKeys = 64;  // keys per tile

// Dynamic shared memory of the tile: the K and V rings and the Q/O rows,
// each row padded to D + 8 2-byte elements.
template <int D>
constexpr int flash_mma_smem_bytes() {
  return (2 * kFlashStages * kFlashMmaKeys + kFlashMmaRows) * (D + 8) * 2;
}

// q/o: this (b, h)'s [sq, D] slice; k/v: its [sk, D] slice; q0: the
// block's first query row. Key j is visible to query i iff j < kv_valid,
// j < sk and (not causal or j <= q_off + i) -- the mask of both JAX kernels.
// Launch with kFlashMmaThreads threads and flash_mma_smem_bytes<D>() of
// dynamic shared memory. T: __nv_bfloat16 or __half.
template <typename T, int D>
__device__ __forceinline__ void flash_tile_mma(const T* __restrict__ q, const T* __restrict__ k,
                                               const T* __restrict__ v, T* __restrict__ o, int sq,
                                               int sk, int q0, int q_off, int kv_valid, bool causal,
                                               float scale) {
  static_assert(sizeof(T) == 2, "a 2-byte element type");
  static_assert(D % 16 == 0 && D <= 128, "head_dim: a multiple of 16, at most 128");
  static_assert(D % 32 == 0 || D == 16, "an odd count of k16 steps is taken at D = 16 only");
  constexpr int BK = kFlashMmaKeys, ST = kFlashStages, SPLIT = kFlashSplit;
  constexpr int STEPS = ST / SPLIT;  // steps of SPLIT tiles the ring holds
  static_assert(ST % SPLIT == 0 && STEPS >= 2, "the ring holds a step in flight beside this one");
  constexpr int S = D + 8;    // padded row, elements
  constexpr int CH = D / 8;   // 16-byte chunks per row
  constexpr int KS = D / 16;  // k16 steps of Q K^T
  constexpr int NT = BK / 8;  // n8 score tiles per key tile
  constexpr int DT = D / 8;   // n8 output tiles
  constexpr int MERGE = 2 + 2 + 4 * DT;  // floats a lane hands over: m, l, O
  static_assert((SPLIT - 1) * kFlashWarps * MERGE * 32 * 4 <= ST * BK * S * 2,
                "the merge reuses the K ring");
  extern __shared__ __align__(16) unsigned char flash_smem[];
  auto sK = reinterpret_cast<T(*)[BK][S]>(flash_smem);  // [ST][BK][S]
  auto sV = sK + ST;
  auto sQO = reinterpret_cast<T(*)[S]>(sV + ST);  // [kFlashMmaRows][S]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int grp = warp % kFlashWarps;  // row group
  const int part = warp / kFlashWarps;  // key tiles part, part + SPLIT, ...
  const int w0 = q0 + grp * 16;         // the group's first query row
  const int lim = kv_valid < sk ? kv_valid : sk;

  // Keys at or past kend are masked for every row of the block; kend_w
  // bounds the tiles this warp computes (none if all its rows are past sq).
  int kend = lim;
  if (causal) kend = min(kend, q_off + q0 + kFlashMmaRows);
  int kend_w = w0 < sq ? kend : 0;
  if (causal) kend_w = min(kend_w, q_off + w0 + 16);
  const int ntiles = kend > 0 ? (kend + BK - 1) / BK : 0;

  // Step u: tiles u * SPLIT .. + SPLIT - 1, tile t in ring slot t % ST, as
  // one cp.async group (empty past the last tile: the count stays uniform).
  auto load_step = [&](int u) {
    for (int c = tid; c < SPLIT * BK * CH; c += kFlashMmaThreads) {
      const int t = u * SPLIT + c / (BK * CH), j = c / CH % BK, d = (c % CH) * 8;
      if (t < ntiles) {
        const int key = t * BK + j;
        const bool live = key < kend;
        const size_t off = live ? (size_t)key * D + d : 0;
        cp_async_16(&sK[t % ST][j][d], k + off, live);
        cp_async_16(&sV[t % ST][j][d], v + off, live);
      }
    }
    cp_async_commit();
  };

  // Q (rows past sq zero), then the first STEPS - 1 steps behind it.
  for (int c = tid; c < kFlashMmaRows * CH; c += kFlashMmaThreads) {
    const int r = c / CH, d = (c % CH) * 8;
    const bool live = q0 + r < sq;
    cp_async_16(&sQO[r][d], q + (live ? (size_t)(q0 + r) * D + d : 0), live);
  }
  cp_async_commit();
#pragma unroll
  for (int u = 0; u < STEPS - 1; ++u) load_step(u);
  cp_async_wait<STEPS - 1>();  // Q has landed
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldmatrix_x4(qf[kk], &sQO[grp * 16 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);

  const float sl2 = scale * 1.4426950408889634f;  // scale * log2(e)
  float m[2] = {kNegInf, kNegInf};  // running max of rows gid and gid + 8 (log2 units)
  float l[2] = {0.f, 0.f};          // this thread's share of their running sums
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int nsteps = (ntiles + SPLIT - 1) / SPLIT;
  for (int u = 0; u < nsteps; ++u) {
    cp_async_wait<STEPS - 2>();  // step u has landed; later ones may be in flight
    // Every warp is done with step u - 1, so its slots take step u + STEPS - 1.
    __syncthreads();
    load_step(u + STEPS - 1);
    const int t = u * SPLIT + part;
    const int kb = t * BK, st = t % ST;
    if (kb < kend_w) {
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      if constexpr (KS % 2 == 0) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int kk = 0; kk < KS; kk += 2) {
            uint32_t b[4];  // b[0..1]: k-step kk, b[2..3]: kk + 1
            ldmatrix_x4(b, &sK[st][n * 8 + (lane & 7)][kk * 16 + (lane >> 3) * 8]);
            mma_16816<T>(s[n], qf[kk], b);
            mma_16816<T>(s[n], qf[kk + 1], b + 2);
          }
      } else {
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          uint32_t b[4];  // b[0..1]: score tile n, b[2..3]: n + 1 (the one k-step)
          ldmatrix_x4(b, &sK[st][(n + (lane >> 4)) * 8 + (lane & 7)][((lane >> 3) & 1) * 8]);
          mma_16816<T>(s[n], qf[0], b);
          mma_16816<T>(s[n + 1], qf[0], b + 2);
        }
      }
      // Scale; mask only a tile that crosses a bound for some row of the warp.
      const bool interior = kb + BK <= lim && (!causal || kb + BK - 1 <= q_off + w0);
      if (interior) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] *= sl2;
      } else {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kb + n * 8 + 2 * tig + (e & 1);
            const int row = w0 + gid + (e >> 1) * 8;
            const bool live = key < lim && (!causal || key <= q_off + row);
            s[n][e] = live ? s[n][e] * sl2 : kNegInf;
          }
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = kNegInf;
#pragma unroll
        for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        alpha[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
      // P = exp2(s - m), unnormalised, rounded to T straight into the A
      // fragments of P V: score tiles 2kk and 2kk + 1 make k-step kk.
      uint32_t pf[NT / 2][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float p0 = exp2f(s[n][0] - m[0]), p1 = exp2f(s[n][1] - m[0]);
        const float p2 = exp2f(s[n][2] - m[1]), p3 = exp2f(s[n][3] - m[1]);
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        pf[n / 2][(n % 2) * 2] = pack2<T>(p0, p1);
        pf[n / 2][(n % 2) * 2 + 1] = pack2<T>(p2, p3);
      }
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
        for (int j = 0; j < DT; j += 2) {
          uint32_t b[4];  // b[0..1]: output tile j, b[2..3]: j + 1
          ldmatrix_x4_trans(
              b, &sV[st][kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8][j * 8 + (lane >> 4) * 8]);
          mma_16816<T>(acc[j], pf[kk], b);
          mma_16816<T>(acc[j + 1], pf[kk], b + 2);
        }
      }
    }
  }

  // Merge the row group's key parts into part 0, in the order 1 .. SPLIT -
  // 1, through the (now idle) K ring: [part - 1][grp][field][lane] floats.
  if (SPLIT > 1) {
    float* xs = reinterpret_cast<float*>(flash_smem);
    __syncthreads();  // every warp is done with the ring
    if (part > 0) {
      float* x = xs + ((part - 1) * kFlashWarps + grp) * MERGE * 32 + lane;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        x[i * 32] = m[i];
        x[(2 + i) * 32] = l[i];
      }
#pragma unroll
      for (int j = 0; j < DT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[(4 + 4 * j + e) * 32] = acc[j][e];
    }
    __syncthreads();
    if (part > 0) return;
    for (int p = 1; p < SPLIT; ++p) {
      const float* x = xs + ((p - 1) * kFlashWarps + grp) * MERGE * 32 + lane;
      float a[2], b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float mp = x[i * 32];
        const float m_new = fmaxf(m[i], mp);
        a[i] = exp2f(m[i] - m_new);
        b[i] = exp2f(mp - m_new);
        m[i] = m_new;
        l[i] = l[i] * a[i] + x[(2 + i) * 32] * b[i];
      }
#pragma unroll
      for (int j = 0; j < DT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][e] = acc[j][e] * a[e >> 1] + x[(4 + 4 * j + e) * 32] * b[e >> 1];
    }
  }

  // Epilogue: the quad's sums, one division and one rounding to T, then
  // 16-byte stores through the group's own Q/O staging rows (read only by
  // the group's warps, before their first tile).
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-20f);
  }
  T* so = &sQO[grp * 16][0];
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int col = j * 8 + 2 * tig;
    *reinterpret_cast<uint32_t*>(so + gid * S + col) = pack2<T>(acc[j][0] / l[0], acc[j][1] / l[0]);
    *reinterpret_cast<uint32_t*>(so + (gid + 8) * S + col) =
        pack2<T>(acc[j][2] / l[1], acc[j][3] / l[1]);
  }
  __syncwarp();
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = c / CH, d = (c % CH) * 8;
    if (w0 + r < sq)
      *reinterpret_cast<uint4*>(o + (size_t)(w0 + r) * D + d) =
          *reinterpret_cast<const uint4*>(so + r * S + d);
  }
}

}  // namespace lumen
