// The 2-byte kernels of flash_attention (bf16 and fp16) on the tensor
// cores (mma.sync m16n8k16), with a launch plan chosen for each call from
// (sq, sk, head_dim, causal). A fork of flash_tile_bf16.cuh, which
// flash_attention_cache keeps unchanged. The element type T
// (__nv_bfloat16 or __half) changes only the mma form, the two roundings
// (P and the output) and the ones the row sums multiply: the plan is a
// function of the shape and of the 2-byte row alone, the same for both.
//
// Replaces the body of the Pallas kernel _flash_kernel
// (lumen_tpu/ops/attention.py:97). The Pallas grid's sequential key axis,
// which carried the running max/sum/output in VMEM scratch from one grid
// step to the next, is a loop over key tiles inside a warp (Hopper blocks
// run in no order).
//
// A warp owns 16 query rows (a row group): their Q rows staged in shared
// memory (A fragments by ldmatrix, a k-step at a time), S = Q K^T in fp32
// C fragments, P rounded to T straight into the A fragments of P V, O
// and the row sums in fp32 registers. The plan (FlashPlan) decides where K
// and V come from and how many rows and warps a block holds; it never
// depends on batch * heads, so a row's bits do not either.
//
// - Short path, sk <= 128 (the CLIP towers: 50 keys bidirectional, 77
//   causal, 768 or 512 (b, h) in a bulk batch). A block takes whole
//   sequences of one (b, h), up to 5 row groups, with K/V loaded once
//   into shared memory (27,648 B at 50 keys, 34,560 B at 77: rows padded
//   to D + 8 elements, zero past the keys in use); no ring, no key split,
//   32-key softmax steps. Bound: the bytes (q, k, v, o once, ~0.006 ms).
//   What limits it is blocks in flight, so ptxas must fit 4 blocks of 5
//   warps an SM (96 registers a thread): 5 resident at 50 keys, 4 at 77.
// - Long path, sk > 128: 16-row groups x kSplit key parts a block; K/V
//   tiles through a cp.async ring of kSplit * kSteps slots, a step of
//   kSplit tiles at a time, tile t to part t % kSplit, the parts merged in
//   a fixed order at the end; causal row blocks issued heaviest first (the
//   grid's y runs from the last rows down). By head_dim (FlashLong):
//   * 64, the VLM vision tower's [1, 12, 256, 64] (bytes 0.00047 ms; the
//     floor is latency, at SDPA's time): 2 row groups x 2 parts, 64-key
//     tiles, 4 slots;
//   * 128, the Qwen2-MoE decoder's causal [1, 16, 265, 128] (bytes 0.0013
//     ms): 1 row group x 3 parts, 32-key tiles, 6 slots (108,800 B, two
//     blocks an SM), so the heaviest row group walks 3 tiles a warp where
//     it walked 5; still above SDPA's time (PERF.md has the variants);
//   * 16, SVTR's [32, 4, 1920, 16] (472 M exp2, 0.113 ms on the SFU): 8
//     row groups, no split, 64-key tiles, 4 slots (30,720 B): a K/V tile
//     a block loads serves 128 rows, a quarter of the old L2 traffic.
//
// Both paths skip work rather than mask it: a warp computes only the n8
// score tiles below min(sk, its rows' causal diagonal) and the P V k16
// steps that cover them, and a tile with every score tile computed runs
// an instance without guards, so ptxas interleaves its mma chains. Only a
// tile crossing a bound is masked (with the -1e30 of common.cuh, after
// scaling). A tile that needs no mask takes the max of the unscaled
// scores and folds the scale into the exponent's FFMA, p = exp2(fma(s,
// scale * log2(e), -m)), on ex2.approx.ftz; the row sums come from the
// tensor cores (P V also multiplies P by a column of ones), which saves
// an FADD a pair. Measured and left out (PERF.md, the A/Bs of
// scripts/flash_plan_variants.py, which carries both as patches): exp2 on
// the FMA pipe for a share of the head_dim-16 pairs (a Cody-Waite split
// and a minimax cubic) is no faster, since the SFU does not bound these
// kernels (0.25 ms against its 0.11 at SVTR's widest call), so every exp2
// is ex2.approx; 1-D cp.async.bulk of the K/V rows into the padded slots
// (one copy a row, an mbarrier a ring step) was 3-5x slower than 16-byte
// cp.async.
//
// A row's output depends only on its own query, its (b, h)'s keys and the
// shape, in a fixed order of operations: no atomics, no reduction across
// blocks.
#pragma once

#include "common.cuh"

namespace lumen {

constexpr int kFlashShortKeys = 128;  // sk at or below it: the short path
constexpr int kFlashShortGroups = 5;  // short path: at most 5 row groups (80 rows) a block
constexpr int kFlashShortChunk = 32;  // short path: keys a warp's online-softmax step takes

// Long path: row groups a block, warps a row group (key split), ring
// steps, keys a tile, and blocks an SM that ptxas must leave registers for.
template <int D>
struct FlashLong;
template <>
struct FlashLong<16> {
  static constexpr int kGroups = 8, kSplit = 1, kSteps = 4, kKeys = 64, kMinBlocks = 2;
};
template <>
struct FlashLong<64> {
  static constexpr int kGroups = 2, kSplit = 2, kSteps = 2, kKeys = 64, kMinBlocks = 2;
};
template <>
struct FlashLong<128> {
  static constexpr int kGroups = 1, kSplit = 3, kSteps = 2, kKeys = 32, kMinBlocks = 1;
};
// Short path: blocks an SM that ptxas must leave registers for (one at D
// = 128, where Q and O alone take 96 registers a thread).
constexpr int kFlashShortMinBlocks = 4;

constexpr int kFlashShort = 0, kFlashLong = 1;

struct FlashPlan {
  int path;        // kFlashShort or kFlashLong
  int rows;        // query rows a block
  int split;       // warps a row group (key parts)
  int stages;      // ring slots (0 on the short path)
  int threads;
  int smem;        // dynamic shared memory, bytes
  int row_blocks;  // blocks a (b, h): the grid is (batch * heads, row_blocks)
  int reverse;     // causal with several row blocks: heaviest first
};

__host__ __device__ inline int flash_round16(int x) { return (x + 15) / 16 * 16; }

// The plan of a call: a function of the shape alone (never of batch *
// heads). Mirrored by lumen_tpu_torch/ops/attention.py:flash_plan.
template <int D>
FlashPlan flash_plan(int sq, int sk, bool causal) {
  constexpr int S = D + 8;  // padded row, 2-byte elements
  FlashPlan p;
  if (sk <= kFlashShortKeys) {
    p.path = kFlashShort;
    p.rows = flash_round16(sq) < 16 * kFlashShortGroups ? flash_round16(sq) : 16 * kFlashShortGroups;
    p.split = 1;
    p.stages = 0;
    p.smem = (2 * flash_round16(sk) + p.rows) * S * 2;
  } else {
    using L = FlashLong<D>;
    p.path = kFlashLong;
    p.rows = 16 * L::kGroups;
    p.split = L::kSplit;
    p.stages = L::kSplit * L::kSteps;
    p.smem = (2 * p.stages * L::kKeys + p.rows) * S * 2;
  }
  p.threads = 2 * p.rows * p.split;  // a warp per 16 rows and key part
  p.row_blocks = (sq + p.rows - 1) / p.rows;
  p.reverse = causal && p.row_blocks > 1;
  return p;
}

__device__ __forceinline__ float flash_exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The score tiles of flash_chunk: FULL = all NT, so every guard below is
// decided at compile time and ptxas can interleave the tiles' ldmatrix
// and mma chains; the other instance branches around each tile past
// ncomp. l is the row sums as an mma C fragment (c0 = c1: row gid, c2 =
// c3: row gid + 8): P V's k16 steps also multiply P by a column of ones,
// so the tensor cores sum the rounded P that the output is made of.
template <typename T, int D, int NT, bool FULL>
__device__ __forceinline__ void flash_chunk_tiles(const T* tQ, const T* tK, const T* tV,
                                                  int kb, int ncomp_rt, int sk, bool causal, int diag0,
                                                  float sl2, float (&m)[2], float (&l)[4],
                                                  float (&acc)[D / 8][4], int lane) {
  static_assert(NT % 2 == 0, "score tiles in pairs (a P V k16 step)");
  constexpr int S = D + 8, KS = D / 16, DT = D / 8;
  const int gid = lane / 4, tig = lane % 4;
  const int ncomp = FULL ? NT : ncomp_rt;
  const int kc = kb + 8 * ncomp;  // first key not computed
  const bool mask = kc > sk || (causal && kc - 1 > diag0);
  const bool fold = !mask && sl2 > 0.f;  // the max of s * sl2 is sl2 * max(s)

  float s[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
  // Q's A fragments come from the warp's 16 staged rows a k-step at a
  // time (ldmatrix), so they hold no registers between steps.
  const T* qrow = tQ + (lane & 15) * S + (lane >> 4) * 8;
  if constexpr (KS % 2 == 0) {
    // k-steps outside, at most 4 score tiles inside: independent
    // accumulator chains between two mma steps of one tile.
    constexpr int G = NT >= 8 ? NT / 2 : NT;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 2) {
      uint32_t a[2][4];
      ldmatrix_x4(a[0], qrow + kk * 16);
      ldmatrix_x4(a[1], qrow + kk * 16 + 16);
#pragma unroll
      for (int h = 0; h < NT; h += G) {
        uint32_t b[G][4];  // b[.][0..1]: k-step kk, b[.][2..3]: kk + 1
#pragma unroll
        for (int n = h; n < h + G; ++n)
          if (n < ncomp) ldmatrix_x4(b[n - h], tK + (n * 8 + (lane & 7)) * S + kk * 16 + (lane >> 3) * 8);
#pragma unroll
        for (int n = h; n < h + G; ++n)
          if (n < ncomp) mma_16816<T>(s[n], a[0], b[n - h]);
#pragma unroll
        for (int n = h; n < h + G; ++n)
          if (n < ncomp) mma_16816<T>(s[n], a[1], b[n - h] + 2);
      }
    }
  } else {
    uint32_t a[4];
    ldmatrix_x4(a, qrow);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      if (n < ncomp) {
        uint32_t b[4];  // b[0..1]: score tile n, b[2..3]: n + 1 (the one k-step)
        ldmatrix_x4(b, tK + ((n + (lane >> 4)) * 8 + (lane & 7)) * S + ((lane >> 3) & 1) * 8);
        mma_16816<T>(s[n], a, b);
        mma_16816<T>(s[n + 1], a, b + 2);
      }
    }
  }

  // Row max and the exponent x: interior tiles fold the scale into one
  // FFMA; a tile crossing a bound is scaled and masked first.
  float alpha[2];
  if (fold) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mx = fmaxf(mx, n < ncomp ? fmaxf(s[n][2 * i], s[n][2 * i + 1]) : kNegInf);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx * sl2);
      alpha[i] = flash_exp2_sfu(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = fmaf(s[n][e], sl2, -m[e >> 1]);
  } else {
    // keys below lim[i] are live for row gid + 8 i (relative to this tile)
    int lim[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) lim[i] = (causal ? min(sk, diag0 + gid + 8 * i + 1) : sk) - kb - 2 * tig;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = n * 8 + (e & 1) < lim[e >> 1] ? s[n][e] * sl2 : kNegInf;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mx = fmaxf(mx, n < ncomp ? fmaxf(s[n][2 * i], s[n][2 * i + 1]) : kNegInf);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = flash_exp2_sfu(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] -= m[e >> 1];
  }

  // P = exp2(x), unnormalised, rounded to T straight into the A
  // fragments of P V: score tiles 2kk and 2kk + 1 make k-step kk (a tile
  // not computed beside a computed one is 0).
  uint32_t pf[NT / 2][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n < ncomp) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = flash_exp2_sfu(s[n][e]);
      pf[n / 2][(n % 2) * 2] = pack2<T>(p[0], p[1]);
      pf[n / 2][(n % 2) * 2 + 1] = pack2<T>(p[2], p[3]);
    } else {
      pf[n / 2][(n % 2) * 2] = 0u;
      pf[n / 2][(n % 2) * 2 + 1] = 0u;
    }
  }
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    acc[j][0] *= alpha[0];
    acc[j][1] *= alpha[0];
    acc[j][2] *= alpha[1];
    acc[j][3] *= alpha[1];
  }
  l[0] *= alpha[0];
  l[1] *= alpha[0];
  l[2] *= alpha[1];
  l[3] *= alpha[1];
  const uint32_t ones[2] = {ones2<T>(), ones2<T>()};  // 1.0 pairs of T
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    if (2 * kk < ncomp) {
      mma_16816<T>(l, pf[kk], ones);
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        uint32_t b[4];  // b[0..1]: output tile j, b[2..3]: j + 1
        ldmatrix_x4_trans(b, tV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * S + j * 8 +
                                 (lane >> 4) * 8);
        mma_16816<T>(acc[j], pf[kk], b);
        mma_16816<T>(acc[j + 1], pf[kk], b + 2);
      }
    }
  }
}

// One warp's online-softmax step over the 8 * NT keys from kb, whose K and
// V rows start at tK / tV (row stride D + 8). kend_w: keys at or past
// it are masked for every row of the warp (min of sk and the warp's
// causal diagonal), so score tiles past it are not computed; diag0 =
// q_off + the warp's first row. m is in scaled (log2) units.
template <typename T, int D, int NT>
__device__ __forceinline__ void flash_chunk(const T* tQ, const T* tK, const T* tV,
                                            int kb, int kend_w, int sk, bool causal, int diag0,
                                            float sl2, float (&m)[2], float (&l)[4],
                                            float (&acc)[D / 8][4], int lane) {
  int ncomp = min(NT, (kend_w - kb + 7) / 8);  // score tiles computed
  if ((D / 16) % 2) ncomp = (ncomp + 1) & ~1;   // D = 16: in pairs (one ldmatrix.x4)
  if (ncomp == NT)
    flash_chunk_tiles<T, D, NT, true>(tQ, tK, tV, kb, ncomp, sk, causal, diag0, sl2, m, l, acc, lane);
  else
    flash_chunk_tiles<T, D, NT, false>(tQ, tK, tV, kb, ncomp, sk, causal, diag0, sl2, m, l, acc, lane);
}

// Epilogue of a warp: one division by max(l, 1e-20) and one rounding to T
// a value, then 16-byte stores through the warp's own 16 staged rows so
// (its Q, read by no other warp; every part of a key split has merged by
// now), rows w0 .. w0 + 15 of o that lie below sq.
template <typename T, int D>
__device__ __forceinline__ void flash_store(T* so, T* __restrict__ o, int w0,
                                            int sq, const float (&l)[4], const float (&acc)[D / 8][4],
                                            int lane) {
  constexpr int S = D + 8, CH = D / 8, DT = D / 8;
  const int gid = lane / 4, tig = lane % 4;
  const float l0 = fmaxf(l[0], 1e-20f), l1 = fmaxf(l[2], 1e-20f);
  __syncwarp();  // every lane is done reading Q
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int col = j * 8 + 2 * tig;
    *reinterpret_cast<uint32_t*>(so + gid * S + col) = pack2<T>(acc[j][0] / l0, acc[j][1] / l0);
    *reinterpret_cast<uint32_t*>(so + (gid + 8) * S + col) = pack2<T>(acc[j][2] / l1, acc[j][3] / l1);
  }
  __syncwarp();
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = c / CH, d = (c % CH) * 8;
    if (w0 + r < sq)
      *reinterpret_cast<uint4*>(o + (size_t)(w0 + r) * D + d) = *reinterpret_cast<const uint4*>(so + r * S + d);
  }
}

// Short path: one block = up to kFlashShortGroups row groups of one (b,
// h), rows q0 .. q0 + rows - 1 (rows = blockDim.x / 2), against all of
// its keys held in shared memory. Dynamic shared memory: (2 *
// round16(sk) + rows) * (D + 8) 2-byte elements (FlashPlan::smem).
template <typename T, int D>
__global__ void __launch_bounds__(32 * kFlashShortGroups, D == 128 ? 1 : kFlashShortMinBlocks)
    flash_short_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                           T* __restrict__ o, int sq, int sk, int causal, float scale) {
  static_assert(sizeof(T) == 2, "a 2-byte element type");
  static_assert(D % 16 == 0 && D <= 128, "head_dim: a multiple of 16, at most 128");
  static_assert(D % 32 == 0 || D == 16, "an odd count of k16 steps is taken at D = 16 only");
  constexpr int S = D + 8, CH = D / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char flash_smem[];
  const int kv_rows = flash_round16(sk);
  auto sK = reinterpret_cast<T(*)[S]>(flash_smem);  // [kv_rows][S]
  auto sV = sK + kv_rows;
  auto sQO = sV + kv_rows;  // [rows][S]: Q, then the output

  const size_t bh = blockIdx.x;
  const int rows = blockDim.x / 2;
  const int rb = causal && gridDim.y > 1 ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = rb * rows, q_off = sk - sq;
  q += bh * sq * D;
  k += bh * sk * D;
  v += bh * sk * D;
  o += bh * sq * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int w0 = q0 + warp * 16;

  // K/V rows the block uses: keys below kend, zero-filled up to the next
  // 16 (the last P V k16 step reads them as 0 x 0).
  int kend = sk;
  if (causal) kend = max(0, min(kend, q_off + q0 + rows));
  const int kload = flash_round16(kend);
  for (int c = tid; c < kload * CH; c += blockDim.x) {
    const int j = c / CH, d = (c % CH) * 8;
    const bool live = j < kend;
    const size_t off = live ? (size_t)j * D + d : 0;
    cp_async_16(&sK[j][d], k + off, live);
    cp_async_16(&sV[j][d], v + off, live);
  }
  for (int c = tid; c < rows * CH; c += blockDim.x) {  // Q, rows past sq zero
    const int r = c / CH, d = (c % CH) * 8;
    const bool live = q0 + r < sq;
    cp_async_16(&sQO[r][d], q + (live ? (size_t)(q0 + r) * D + d : 0), live);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (w0 >= sq) return;  // past the block's only barrier

  int kend_w = sk;
  if (causal) kend_w = min(kend_w, q_off + w0 + 16);
  const float sl2 = scale * 1.4426950408889634f;  // scale * log2(e)
  float m[2] = {kNegInf, kNegInf}, l[4] = {0.f, 0.f, 0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  T* so = &sQO[warp * 16][0];  // the warp's own rows
  for (int kb = 0; kb < kend_w; kb += kFlashShortChunk)
    flash_chunk<T, D, kFlashShortChunk / 8>(so, &sK[kb][0], &sV[kb][0], kb, kend_w, sk, causal != 0, q_off + w0,
                                         sl2, m, l, acc, lane);
  flash_store<T, D>(so, o, w0, sq, l, acc, lane);
}

// Long path: one block = kGroups row groups x kSplit key parts of one (b,
// h), keys through a ring of kSplit * kSteps slots of kKeys keys.
template <typename T, int D>
__global__ void __launch_bounds__(32 * FlashLong<D>::kGroups * FlashLong<D>::kSplit, FlashLong<D>::kMinBlocks)
    flash_long_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                          T* __restrict__ o, int sq, int sk, int causal, float scale) {
  static_assert(sizeof(T) == 2, "a 2-byte element type");
  static_assert(D % 16 == 0 && D <= 128, "head_dim: a multiple of 16, at most 128");
  static_assert(D % 32 == 0 || D == 16, "an odd count of k16 steps is taken at D = 16 only");
  using L = FlashLong<D>;
  constexpr int W = L::kGroups, SPLIT = L::kSplit, STEPS = L::kSteps, ST = SPLIT * STEPS;
  constexpr int BK = L::kKeys, ROWS = 16 * W, THREADS = 32 * W * SPLIT;
  constexpr int S = D + 8, CH = D / 8, DT = D / 8;
  constexpr int MERGE = 2 + 2 + 4 * DT;  // floats a lane hands over: m, l, O
  static_assert(STEPS >= 2, "the ring holds a step in flight beside this one");
  static_assert((SPLIT - 1) * W * MERGE * 32 * 4 <= ST * BK * S * 2, "the merge reuses the K ring");
  extern __shared__ __align__(16) unsigned char flash_smem[];
  auto sK = reinterpret_cast<T(*)[BK][S]>(flash_smem);  // [ST][BK][S]
  auto sV = sK + ST;
  auto sQO = reinterpret_cast<T(*)[S]>(sV + ST);  // [ROWS][S]

  const size_t bh = blockIdx.x;
  const int rb = causal && gridDim.y > 1 ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = rb * ROWS, q_off = sk - sq;
  q += bh * sq * D;
  k += bh * sk * D;
  v += bh * sk * D;
  o += bh * sq * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = warp % W;    // row group
  const int part = warp / W;   // key tiles part, part + SPLIT, ...
  const int w0 = q0 + grp * 16;

  // Keys at or past kend are masked for every row of the block; kend_w
  // bounds the tiles this warp computes (none if all its rows are past sq).
  int kend = sk;
  if (causal) kend = min(kend, q_off + q0 + ROWS);
  int kend_w = w0 < sq ? sk : 0;
  if (causal) kend_w = min(kend_w, q_off + w0 + 16);
  const int ntiles = kend > 0 ? (kend + BK - 1) / BK : 0;

  // Step u: tiles u * SPLIT .. + SPLIT - 1, tile t in ring slot t % ST, as
  // one cp.async group (empty past the last tile: the count stays uniform).
  auto load_step = [&](int u) {
    for (int c = tid; c < SPLIT * BK * CH; c += THREADS) {
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
  for (int c = tid; c < ROWS * CH; c += THREADS) {
    const int r = c / CH, d = (c % CH) * 8;
    const bool live = q0 + r < sq;
    cp_async_16(&sQO[r][d], q + (live ? (size_t)(q0 + r) * D + d : 0), live);
  }
  cp_async_commit();
#pragma unroll
  for (int u = 0; u < STEPS - 1; ++u) load_step(u);
  cp_async_wait<STEPS - 1>();  // Q has landed
  __syncthreads();
  T* so = &sQO[grp * 16][0];  // the group's own rows

  const float sl2 = scale * 1.4426950408889634f;  // scale * log2(e)
  float m[2] = {kNegInf, kNegInf}, l[4] = {0.f, 0.f, 0.f, 0.f};
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
    if (t * BK < kend_w)
      flash_chunk<T, D, BK / 8>(so, &sK[t % ST][0][0], &sV[t % ST][0][0], t * BK, kend_w, sk, causal != 0,
                             q_off + w0, sl2, m, l, acc, lane);
  }

  // Merge the row group's key parts into part 0, in the order 1 .. SPLIT -
  // 1, through the (now idle) K ring: [part - 1][grp][field][lane] floats.
  if constexpr (SPLIT > 1) {
    float* xs = reinterpret_cast<float*>(flash_smem);
    __syncthreads();  // every warp is done with the ring
    if (part > 0) {
      float* x = xs + ((part - 1) * W + grp) * MERGE * 32 + lane;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        x[i * 32] = m[i];
        x[(2 + i) * 32] = l[2 * i];
      }
#pragma unroll
      for (int j = 0; j < DT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[(4 + 4 * j + e) * 32] = acc[j][e];
    }
    __syncthreads();
    if (part > 0) return;
    for (int p = 1; p < SPLIT; ++p) {
      const float* x = xs + ((p - 1) * W + grp) * MERGE * 32 + lane;
      float a[2], b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float mp = x[i * 32];
        const float m_new = fmaxf(m[i], mp);
        a[i] = flash_exp2_sfu(m[i] - m_new);
        b[i] = flash_exp2_sfu(mp - m_new);
        m[i] = m_new;
        l[2 * i] = l[2 * i] * a[i] + x[(2 + i) * 32] * b[i];
      }
#pragma unroll
      for (int j = 0; j < DT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][e] = acc[j][e] * a[e >> 1] + x[(4 + 4 * j + e) * 32] * b[e >> 1];
    }
  }

  flash_store<T, D>(so, o, w0, sq, l, acc, lane);
}

}  // namespace lumen
