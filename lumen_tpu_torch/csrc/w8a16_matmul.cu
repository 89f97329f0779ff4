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
// What bounds it on the H100: bytes, and at decode sizes the latency of
// reaching them. At 8 decode rows the weights are almost all the traffic
// (gate_proj: 896 x 4864 B = 4.36 MB, ~1.3 us at 3.35 TB/s) and the
// arithmetic is 16 flops a weight byte, far below the ~295 the tensor
// cores need to be the limit. To stream weights near the memory rate,
// ~2-3 MB has to be in flight across the card (Little's law at ~1 us of
// latency): one block per column tile walking all of K would keep a few
// KB in flight on 2-76 blocks.
//
// Design: blocks per (64-column tile, K part, group of 16-row tiles). K
// is cut into qm_parts(K, N) parts -- a function of K and N alone, never
// of M -- so that each projection puts ~100-300 blocks on the 132 SMs
// (down_proj: 14 tiles x 8 parts; q/o_proj 14 x 8; k/v_proj 2 x 8;
// gate/up_proj 76 x 4). A block takes one row tile, or every row tile of
// the call where one each would make more than kQmMaxBlocks blocks
// (gate/up_proj at 40 rows), so its weights are read once. It walks its
// part in 64-deep chunks through a ring of cp.async stages (6, or 4 for
// the wider blocks; x rows past M and depth past K zero-filled), so
// several chunks of its weights are in flight while the tensor cores
// work. Each of the four warps owns 16 of the 64 columns: mma.sync
// m16n8k16 (bf16 in, fp32 accumulate, A by ldmatrix). The B fragments are
// converted s8 -> bf16 in registers once a k-step for every row tile,
// with byte permutes and an fp32 add (s8x2_to_bf16x2) instead of the
// quarter-rate conversion instructions, which bounded the inner loop of
// the long K parts. The parts of a column tile are one thread-block
// cluster (at most 8 blocks, the portable size): each block leaves its
// fp32 partial in shared memory, and after a cluster barrier each block
// sums a slice of the tile over the parts' shared memory in part order 0,
// 1, 2, ... (distributed shared memory, no atomics), scales in fp32 and
// rounds to bf16 once. One launch, no workspace.
//
// A row's result depends only on that row of x: rows are padded to the
// 16-row tile, tensor-core rows are independent, and the K split and the
// order of every sum are fixed by (K, N), so decode (8 rows) and a verify
// window (40 rows) give the same bits for the same row -- the greedy
// identity of speculative decoding leans on this.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace lumen {

constexpr int kQmThreads = 128;
constexpr int kQmRows = 16;          // row tile: one m16 MMA tile
constexpr int kQmMaxRowTiles = 4;    // 64 rows: the routing limit (ops/quant_matmul.py)
constexpr int kQmCols = 64;          // column tile: 16 columns (2 n8 MMA tiles) a warp
constexpr int kQmDepth = 64;         // K chunk per ring stage: 4 k16 MMA steps
constexpr int kQmStages = 6;         // ring stages (chunks in flight) of a one-row-tile block
constexpr int kQmStagesWide = 4;     // ... of a block with more row tiles (more x a stage)
constexpr int kQmMaxParts = 8;       // K parts of a column tile: one cluster, portable size
constexpr int kQmTargetBlocks = 264;  // two blocks per SM of the H100's 132
constexpr int kQmMaxBlocks = 528;    // past this, a block takes every row tile of the call
constexpr int kQmXStride = kQmDepth + 8;  // bf16; +16 B keeps A-fragment reads conflict-free
constexpr int kQmWStride = kQmCols + 16;  // bytes; +16 B keeps B-fragment reads conflict-free
static_assert(kQmCols == 4 * 16 && kQmThreads == 128, "four warps of 16 columns (two n8 tiles)");

// K parts for a [K, N] weight: the largest power of two <= kQmMaxParts
// that is at most the chunks of K and brings N / 64 column tiles to
// kQmTargetBlocks. A function of K and N alone (never of M).
__host__ __device__ constexpr int qm_parts(int k, int n) {
  const int chunks = (k + kQmDepth - 1) / kQmDepth;
  const int tiles = n / kQmCols;
  const int want = (kQmTargetBlocks + tiles - 1) / tiles;
  int parts = 1;
  while (parts * 2 <= kQmMaxParts && parts * 2 <= chunks && parts * 2 <= want) parts *= 2;
  return parts;
}

// Row tiles a block takes: one, unless that makes more than kQmMaxBlocks
// blocks; then all of them (the weights read once, not once a row tile).
// Rows never share arithmetic, so this choice does not change any bits.
__host__ __device__ constexpr int qm_block_row_tiles(int m, int k, int n) {
  const int tiles = (m + kQmRows - 1) / kQmRows;
  return (n / kQmCols) * qm_parts(k, n) * tiles <= kQmMaxBlocks ? 1 : tiles;
}

// Ring stages of a block with RT row tiles: fewer when x fills more of
// each stage, so that the wide blocks of gate/up_proj at 40 rows (304)
// stay resident at once.
__host__ __device__ constexpr int qm_stages(int rt) { return rt == 1 ? kQmStages : kQmStagesWide; }

// Dynamic shared memory for RT row tiles a block: the ring's x and q
// stages, then the fp32 partial [RT * 16][64] the cluster sums.
__host__ __device__ constexpr int qm_smem_bytes(int rt) {
  return qm_stages(rt) * (rt * kQmRows * kQmXStride * 2 + kQmDepth * kQmWStride) +
         rt * kQmRows * kQmCols * 4;
}

// Two int8 weights of one column (bytes a and b of `biased`, each with its
// sign bit flipped: w + 128) as a bf16x2 B-fragment register, a in the low
// half. Exact for |w| <= 128, the bits of static_cast<float> then
// pack2<__nv_bfloat16>: the byte becomes the low mantissa byte of 2^23 (fp32 bits
// 0x4B0000xx), subtracting 2^23 + 128 in fp32 leaves w, and w's fp32 bits
// cut to their top half are its bf16 bits (w has at most 8 significant
// bits). Byte permutes and an fp32 add instead of int-to-float and
// float-to-bf16 conversions, which issue at a quarter of the rate.
template <int a, int b>
__device__ __forceinline__ uint32_t s8x2_to_bf16x2(uint32_t biased) {
  const float fa = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 | a)) - 8388736.f;
  const float fb = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 | b)) - 8388736.f;
  return __byte_perm(__float_as_uint(fa), __float_as_uint(fb), 0x7632);
}

// mma_16816 and ldmatrix_x4 (the fragment layout is noted beside them)
// live in common.cuh, shared with the flash tiles and the paged walk.
//
// Columns of a warp's 16 are interleaved over its two n8 MMA tiles: tile
// j's column n is the warp's column 2n + j, so the two bytes a thread
// needs from a weight row (one for each tile) are neighbours, one 16-bit
// load.

template <int RT>
__global__ void __launch_bounds__(kQmThreads)
    w8a16_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                 const float* __restrict__ scale, __nv_bfloat16* __restrict__ y, int m, int k,
                 int n) {
  constexpr int XR = RT * kQmRows;  // x rows a block stages
  constexpr int ST = qm_stages(RT);
  extern __shared__ __align__(16) unsigned char qm_smem[];
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(qm_smem);               // [stage][XR][kQmXStride]
  int8_t* sW = reinterpret_cast<int8_t*>(sX + ST * XR * kQmXStride);     // [stage][kQmDepth][kQmWStride]
  float* sPart = reinterpret_cast<float*>(sW + ST * kQmDepth * kQmWStride);  // [XR][kQmCols]

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;  // MMA fragment coordinates
  const int n0 = blockIdx.x * kQmCols;
  const int parts = gridDim.y;  // the cluster: one block per part
  const int part = blockIdx.y;
  const int m0 = blockIdx.z * XR;
  const int chunks = (k + kQmDepth - 1) / kQmDepth;
  const int c0 = part * chunks / parts;
  const int nc = (part + 1) * chunks / parts - c0;
  // This block's slice of the tile in the cluster's sum: elements
  // part * per + tid + i * 128, all in column tid % 64 (per is a multiple
  // of 128), so one scale a thread, read now, off the kernel's tail.
  const int per = XR * kQmCols / parts;
  const float sc = scale[n0 + tid % kQmCols];

  // Chunk c of x (XR rows, RT 16-byte vectors a thread) and of the q tile
  // (64 x 64 bytes, two vectors a thread) into ring stage st; rows past M
  // and depth past K are zero-filled (K is a multiple of 8, so a vector
  // never straddles it).
  auto issue = [&](int c, int st) {
    const int k0 = c * kQmDepth;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int v = tid + i * kQmThreads;
      const int r = v / (kQmDepth / 8), kk = (v % (kQmDepth / 8)) * 8;
      const bool live = m0 + r < m && k0 + kk < k;
      cp_async_16(sX + (st * XR + r) * kQmXStride + kk, live ? x + (size_t)(m0 + r) * k + k0 + kk : x,
                  live);
    }
#pragma unroll
    for (int i = 0; i < kQmDepth * kQmCols / 16 / kQmThreads; ++i) {
      const int v = tid + i * kQmThreads;
      const int kk = v / (kQmCols / 16), nn = (v % (kQmCols / 16)) * 16;
      const bool live = k0 + kk < k;
      cp_async_16(sW + (st * kQmDepth + kk) * kQmWStride + nn,
                  live ? q + (size_t)(k0 + kk) * n + n0 + nn : q, live);
    }
  };
  static_assert(kQmRows * kQmDepth / 8 == kQmThreads, "one x vector a thread and row tile");

  float acc[RT][2][4];
#pragma unroll
  for (int t = 0; t < RT; ++t)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;

#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < nc) issue(c0 + i, i);
    cp_async_commit();
  }
  for (int i = 0; i < nc; ++i) {
    cp_async_wait<ST - 2>();  // chunk i has landed (this thread's copies)
    __syncthreads();                 // ... everyone's; and stage i - 1 is free again
    if (i + ST - 1 < nc) issue(c0 + i + ST - 1, (i + ST - 1) % ST);
    cp_async_commit();
    const int st = i % ST;
    const __nv_bfloat16* xs = sX + st * XR * kQmXStride;
    const int8_t* wb = sW + st * kQmDepth * kQmWStride + warp * 16 + 2 * gid;
#pragma unroll
    for (int ks = 0; ks < kQmDepth / 16; ++ks) {
      const int kb = ks * 16;
      // Rows kb + 2tig, +1 (b0) and +8, +9 (b1), both of this thread's
      // columns: bytes (row, tile 0), (row, tile 1) of each 16-bit load.
      const int8_t* w = wb + (kb + 2 * tig) * kQmWStride;
      const uint32_t lo = (*reinterpret_cast<const uint16_t*>(w) |
                           (uint32_t)*reinterpret_cast<const uint16_t*>(w + kQmWStride) << 16) ^ 0x80808080u;
      const uint32_t hi = (*reinterpret_cast<const uint16_t*>(w + 8 * kQmWStride) |
                           (uint32_t)*reinterpret_cast<const uint16_t*>(w + 9 * kQmWStride) << 16) ^ 0x80808080u;
      uint32_t bf[2][2];  // converted once, used by every row tile
      bf[0][0] = s8x2_to_bf16x2<0, 2>(lo);
      bf[1][0] = s8x2_to_bf16x2<1, 3>(lo);
      bf[0][1] = s8x2_to_bf16x2<0, 2>(hi);
      bf[1][1] = s8x2_to_bf16x2<1, 3>(hi);
#pragma unroll
      for (int t = 0; t < RT; ++t) {
        uint32_t a[4];
        ldmatrix_x4(a, xs + (t * kQmRows + lane % 16) * kQmXStride + kb + (lane / 16) * 8);
        mma_16816<__nv_bfloat16>(acc[t][0], a, bf[0]);
        mma_16816<__nv_bfloat16>(acc[t][1], a, bf[1]);
      }
    }
  }
  cp_async_wait<0>();

  // Fragment c0/c1: (row gid, tile columns 2tig, 2tig + 1); c2/c3: row
  // gid + 8. Tile j's column c is the block's column warp * 16 + 2c + j.
#pragma unroll
  for (int t = 0; t < RT; ++t) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float* pr = sPart + (t * kQmRows + gid) * kQmCols + warp * 16 + 4 * tig + j;
      pr[0] = acc[t][j][0];
      pr[2] = acc[t][j][1];
      pr[8 * kQmCols] = acc[t][j][2];
      pr[8 * kQmCols + 2] = acc[t][j][3];
    }
  }
  cluster.sync();  // every part's partial is written and visible cluster-wide

  // This block's slice of the tile, summed over the parts in part order:
  // the same bits for a row whatever else the call holds. The parts'
  // values are read together, then added in order.
  for (int e = part * per + tid; e < (part + 1) * per; e += kQmThreads) {
    float v[kQmMaxParts];
#pragma unroll
    for (int p = 0; p < kQmMaxParts; ++p)
      v[p] = p < parts ? cluster.map_shared_rank(sPart, p)[e] : 0.f;
    float sum = v[0];
#pragma unroll
    for (int p = 1; p < kQmMaxParts; ++p)
      if (p < parts) sum += v[p];
    const int r = m0 + e / kQmCols;
    if (r < m) y[(size_t)r * n + n0 + e % kQmCols] = __float2bfloat16(sum * sc);
  }
  cluster.sync();  // keep this block's partial alive until every part has read it
}

template <int RT>
static int qm_launch(const void* x, const void* q, const void* scale, void* y, int m, int k, int n,
                     cudaStream_t stream) {
  const int parts = qm_parts(k, n);
  constexpr int smem = qm_smem_bytes(RT);
  const cudaError_t rc =
      cudaFuncSetAttribute(w8a16_kernel<RT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n / kQmCols, parts, (m + RT * kQmRows - 1) / (RT * kQmRows));
  cfg.blockDim = dim3(kQmThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = parts;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, w8a16_kernel<RT>, static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), m, k, n);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lumen

// The K split the kernel takes for a [K, N] weight (printed by
// chip_smoke.py beside the Python mirror's).
extern "C" int lumen_w8a16_parts(int k, int n) { return lumen::qm_parts(k, n); }

extern "C" int lumen_w8a16_matmul(const void* x, const void* q, const void* scale, void* y, int m,
                                  int k, int n, void* stream) {
  if (m < 1 || m > lumen::kQmMaxRowTiles * lumen::kQmRows || k < 8 || k % 8 != 0 ||
      n % lumen::kQmCols != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lumen::qm_block_row_tiles(m, k, n)) {
    case 1: return lumen::qm_launch<1>(x, q, scale, y, m, k, n, s);
    case 2: return lumen::qm_launch<2>(x, q, scale, y, m, k, n, s);
    case 3: return lumen::qm_launch<3>(x, q, scale, y, m, k, n, s);
    default: return lumen::qm_launch<4>(x, q, scale, y, m, k, n, s);
  }
}
