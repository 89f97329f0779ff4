// w8a16_matmul for the H100 (sm_90a): y = (x @ bf16(q)) * scale for the
// int8 decoder's projections at decode-sized row counts.
//
// Replaces the TPU kernel lumen_tpu/ops/quant_matmul.py:76 _w8a16_2d
// (body _kernel, :65). Same contract: x [M, K] bf16, q [K, N] int8
// (weight-only, symmetric, per output channel), scale [N] fp32; the dot
// runs on bf16 operands (s8 -> bf16 is exact for |w| <= 127) with fp32
// accumulation, scale is applied in fp32 once, and y [M, N] is rounded
// to bf16 once.
//
// What bounds it on the H100: bytes. At 8 decode rows the weights are
// almost all the traffic (gate_proj: 896 x 4864 B = 4.36 MB, ~1.3 us at
// 3.35 TB/s) and the arithmetic is 16 flops a weight byte, far below the
// ~295 the tensor cores need to be the limit. k_proj / v_proj (N = 128)
// are two blocks each: launch-bound.
//
// Design: one block of 128 threads per (64-column tile, 16-row tile).
// The TPU kernel kept all of x resident in VMEM; here x of down_proj at
// 40 rows (40 x 4864 x 2 B = 389 KB) would not fit a block, so each block
// loops over K in 128-deep chunks: it stages the chunk of x (16 rows,
// zero-padded past M) and of its own q tile in shared memory with
// 16-byte loads along K and N, prefetching the next chunk into registers
// while the tensor cores work on this one. Each of the four warps takes
// a 32-deep quarter of the chunk for all 64 columns: mma.sync m16n8k16
// (bf16 in, fp32 accumulate), with the B fragments converted s8 -> bf16
// in registers. The four partial sums are added in a fixed order at the
// end and scaled in fp32. Every weight byte is read once per row tile.
//
// A row's result depends only on that row of x: rows are padded to the
// 16-row tile and tensor-core rows are independent, so decode (8 rows)
// and a verify window (40 rows) give the same bits for the same row --
// the greedy identity of speculative decoding leans on this.
//
// Left for the redesign: split-K across blocks (down_proj at 8 rows is
// 14 blocks on 132 SMs), a deeper cp.async / TMA pipeline, wgmma.
#include "common.cuh"

namespace lumen {

constexpr int kQmThreads = 128;
constexpr int kQmRows = 16;    // row tile: one m16 MMA tile
constexpr int kQmCols = 64;    // column tile: 8 n8 MMA tiles
constexpr int kQmDepth = 128;  // K chunk staged per pass: 32 per warp
constexpr int kQmXStride = kQmDepth + 8;   // bf16; +16 B keeps A-fragment reads conflict-free
constexpr int kQmWStride = kQmCols + 16;   // bytes; +16 B keeps B-fragment reads conflict-free
constexpr int kQmXVecs = kQmRows * kQmDepth / 8 / kQmThreads;   // 16-byte loads per thread (2)
constexpr int kQmWVecs = kQmDepth * kQmCols / 16 / kQmThreads;  // 16-byte loads per thread (4)

// pack_bf16 and mma_bf16_16816 (the fragment layout is noted beside them)
// live in common.cuh, shared with the bf16 flash tile.

__global__ void __launch_bounds__(kQmThreads)
    w8a16_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ scale, __nv_bfloat16* __restrict__ y, int m, int k,
                 int n) {
  __shared__ __align__(16) __nv_bfloat16 sX[kQmRows][kQmXStride];
  __shared__ __align__(16) int8_t sW[kQmDepth][kQmWStride];
  __shared__ float sRed[4][kQmRows][kQmCols];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;  // MMA fragment coordinates
  const int n0 = blockIdx.x * kQmCols;
  const int m0 = blockIdx.y * kQmRows;
  const int chunks = (k + kQmDepth - 1) / kQmDepth;

  uint4 xr[kQmXVecs], wr[kQmWVecs];
  // Global -> registers for chunk c; rows past M and depth past K read as
  // zeros (K is a multiple of 8, so a 16-byte vector never straddles it).
  auto fetch = [&](int c) {
    const int k0 = c * kQmDepth;
#pragma unroll
    for (int i = 0; i < kQmXVecs; ++i) {
      const int v = tid + i * kQmThreads;
      const int r = v / (kQmDepth / 8), kk = (v % (kQmDepth / 8)) * 8;
      xr[i] = (m0 + r < m && k0 + kk < k)
                  ? *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * k + k0 + kk)
                  : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < kQmWVecs; ++i) {
      const int v = tid + i * kQmThreads;
      const int kk = v / (kQmCols / 16), nn = (v % (kQmCols / 16)) * 16;
      wr[i] = (k0 + kk < k)
                  ? *reinterpret_cast<const uint4*>(q + (size_t)(k0 + kk) * n + n0 + nn)
                  : make_uint4(0, 0, 0, 0);
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < kQmXVecs; ++i) {
      const int v = tid + i * kQmThreads;
      const int r = v / (kQmDepth / 8), kk = (v % (kQmDepth / 8)) * 8;
      *reinterpret_cast<uint4*>(&sX[r][kk]) = xr[i];
    }
#pragma unroll
    for (int i = 0; i < kQmWVecs; ++i) {
      const int v = tid + i * kQmThreads;
      const int kk = v / (kQmCols / 16), nn = (v % (kQmCols / 16)) * 16;
      *reinterpret_cast<uint4*>(&sW[kk][nn]) = wr[i];
    }
  };

  float acc[kQmCols / 8][4];
#pragma unroll
  for (int j = 0; j < kQmCols / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  fetch(0);
  stage();
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) fetch(c + 1);  // in flight while the MMAs run
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int kb = warp * 32 + ks * 16;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(&sX[gid][kb + 2 * tig]);
      a[1] = *reinterpret_cast<const uint32_t*>(&sX[gid + 8][kb + 2 * tig]);
      a[2] = *reinterpret_cast<const uint32_t*>(&sX[gid][kb + 2 * tig + 8]);
      a[3] = *reinterpret_cast<const uint32_t*>(&sX[gid + 8][kb + 2 * tig + 8]);
#pragma unroll
      for (int j = 0; j < kQmCols / 8; ++j) {
        const int col = j * 8 + gid;
        const int r0 = kb + 2 * tig;
        uint32_t b[2];
        b[0] = pack_bf16(static_cast<float>(sW[r0][col]), static_cast<float>(sW[r0 + 1][col]));
        b[1] = pack_bf16(static_cast<float>(sW[r0 + 8][col]), static_cast<float>(sW[r0 + 9][col]));
        mma_bf16_16816(acc[j], a, b);
      }
    }
    __syncthreads();  // every warp is done reading this chunk
    if (c + 1 < chunks) {
      stage();
      __syncthreads();
    }
  }

  // Fragment c0/c1: (row gid, cols 2*tig, 2*tig+1); c2/c3: row gid + 8.
#pragma unroll
  for (int j = 0; j < kQmCols / 8; ++j) {
    const int col = j * 8 + 2 * tig;
    sRed[warp][gid][col] = acc[j][0];
    sRed[warp][gid][col + 1] = acc[j][1];
    sRed[warp][gid + 8][col] = acc[j][2];
    sRed[warp][gid + 8][col + 1] = acc[j][3];
  }
  __syncthreads();
  for (int idx = tid; idx < kQmRows * kQmCols; idx += kQmThreads) {
    const int r = idx / kQmCols, col = idx % kQmCols;
    if (m0 + r >= m) continue;
    // Fixed order over the four K quarters: the same bits for a row
    // whatever else the call holds.
    const float sum = ((sRed[0][r][col] + sRed[1][r][col]) + sRed[2][r][col]) + sRed[3][r][col];
    y[(size_t)(m0 + r) * n + n0 + col] = __float2bfloat16(sum * scale[n0 + col]);
  }
}

}  // namespace lumen

extern "C" int lumen_w8a16_matmul(const void* x, const void* q, const void* scale, void* y, int m,
                                  int k, int n, void* stream) {
  if (m < 1 || k < 8 || k % 8 != 0 || n % lumen::kQmCols != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n / lumen::kQmCols, (m + lumen::kQmRows - 1) / lumen::kQmRows);
  lumen::w8a16_kernel<<<grid, lumen::kQmThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), m, k, n);
  return static_cast<int>(cudaGetLastError());
}
