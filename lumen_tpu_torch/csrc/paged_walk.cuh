// The paged KV walk shared by paged_attention.cu (one decode token per
// row) and paged_attention_varq.cu (a W-token speculative verify window
// per row): the attention of window slot t of row b over the row's first
// kv_lens[b] + t keys, read page by page through the row's block table.
//
// q is [B, W, H, D] (W = 1 is the single-token layout [B, H, D]), k/v
// pages [P, KVH, page, D], block_tables [B, MAXP] int32, kv_lens [B]
// int32: the t = 0 visibility (the just-written token included). Keys
// at or past the longest live length of a block's slots are never read,
// so stale block-table entries (the dump page 0) cost nothing.
//
// A plan a call. paged_plan picks the block from (group = heads /
// kv_heads, head_dim, window, dtype) alone -- never from the batch, maxp
// or the lengths: the path, the span (key positions a block, aligned to
// absolute positions: span s holds keys [s * span, (s + 1) * span)), the
// KV heads a block, the window slots a block (the whole window where its
// rows fit in PagedShape::kRows, else equal slot groups), the query rows
// (KV heads x slots x group, every one a real query), the threads and the
// shared memory. The grid is (row x KV-head set x slot group, span); a
// block whose span starts at or past its slots' longest length exits at
// once. A block:
//   1. reads its span's page ids and the row's length (independent
//      loads), then copies the span's live K and V rows of its KV heads
//      into shared memory once for all its query rows, with 16-byte
//      cp.async all in flight at once (a page's KV heads lie side by side:
//      a set of heads is one contiguous run a page), and stages the rows;
//   2. scores, masks each row's keys at or past its own slot length,
//      takes each row's span max and sum, and accumulates P.V, on one of
//      two paths:
//      - tensor cores (bf16 or fp16 at a GQA group of two or more, the
//        dense decoder's 14/2 heads): one KV head a block, its group x W
//        query rows as 16-row tiles of the storage type, one tile a warp;
//        S = Q K^T and P V by mma.sync m16n8k16 with fp32 accumulation,
//        the row's max and sum over the quad of lanes that holds it, P
//        rounded to the storage type in registers as the A fragments of
//        P V (as flash_tile_bf16.cuh);
//      - FMA units (fp32, and bf16 or fp16 at a group of one, the Qwen2-MoE
//        decoder's 16/16 heads, where a 16-row tile would be 15 rows of
//        padding): several KV heads a block, so no thread works for a
//        padding row; a thread scores a key against up to kPagedRowGroup
//        rows of a head at once (each K load serving them all), a warp
//        takes a row's max and sum, and a thread accumulates P.V for 2
//        dimensions of up to kPagedRowGroup rows;
//   3. writes a row's output directly if the row has one live span; else
//      stores its partial (acc[D], m, l) -- one a query row and span --
//      in the fp32 workspace.
// One counter per (row, KV-head set, slot group) counts the live blocks
// in; the block that arrives last merges, for every query row of the
// block with more than one live span, its partials in span order 0, 1,
// ..., nlive(t) - 1, each rescaled to the row's largest span max (all of
// a row's loads in flight at once), writes the output and resets the
// counter to 0 for the next launch. No float atomics, no cap on the row
// length (the TPU kernels' maxp * page <= 8192 VMEM cap,
// lumen_tpu/ops/attention.py:967, has no counterpart), one launch a call.
//
// Determinism. A query row's output bits depend only on its q, its live
// keys and its length: each row's operations -- the span, the order of
// each dot product (FMA path: four fp32 chains over d mod 4, then (c0 +
// c1) + (c2 + c3)), the span's max and sum trees, the P.V order (keys in
// order; a key past the row's length adds p = 0 exactly), the merge
// order -- are the same in every plan of its (group, head_dim, dtype),
// whichever warp, block, KV heads or window slots share its block, and
// the explicit _rn intrinsics keep the compiler from contracting them
// differently in the two entry points. A tensor-core row's result does
// not depend on the other rows of its tile (chip_smoke.py checks it,
// bitwise). The plan uses the window only to pack rows into blocks. So a
// verify slot t computes exactly what a single-token step at length
// kv_lens + t does, the output does not change with maxp (the block-
// table bucket, which differs between a decode step and a verify turn) or
// the batch, and the greedy identity of speculative decoding does not
// hang on rounding.
#pragma once

#include "common.cuh"

namespace lumen {

// Per storage type and head_dim: the span (key positions a block), the
// query rows KV heads contribute to a slot on the FMA path (kv_heads a
// block = max(1, kHeadRows / group)), the query rows a block may take,
// and the most warps a block runs. Chosen by measurement (PERF.md;
// scripts/paged_walk_variants.py).
template <typename T, int D>
struct PagedShape;
template <>
struct PagedShape<__nv_bfloat16, 64> {
  static constexpr int kSpan = 64, kHeadRows = 4, kRows = 40, kWarps = 8;
};
template <>
struct PagedShape<__nv_bfloat16, 128> {
  static constexpr int kSpan = 64, kHeadRows = 2, kRows = 40, kWarps = 8;
};
// fp16 takes the bf16 shapes: the same bytes a row, the same mma tiles.
template <>
struct PagedShape<__half, 64> {
  static constexpr int kSpan = 64, kHeadRows = 4, kRows = 40, kWarps = 8;
};
template <>
struct PagedShape<__half, 128> {
  static constexpr int kSpan = 64, kHeadRows = 2, kRows = 40, kWarps = 8;
};
template <>
struct PagedShape<float, 64> {
  static constexpr int kSpan = 64, kHeadRows = 2, kRows = 40, kWarps = 8;
};
template <>
struct PagedShape<float, 128> {
  static constexpr int kSpan = 64, kHeadRows = 1, kRows = 40, kWarps = 8;
};

constexpr int kPagedRowGroup = 4;    // query rows a thread scores and accumulates at once (FMA path)
constexpr int kPagedMergeUnroll = 8;  // spans whose partials the merge loads together
constexpr int kPagedMaxThreads = 256;

template <int N>
struct PagedInt {
  static constexpr int value = N;
};

struct PagedPlan {
  int span, kv_heads, slots, slot_groups, rows, threads, smem, mma;
};

// Dynamic shared memory of a block. FMA path: the K and V rows of its KV
// heads (each row padded by 16 B), the fp32 query rows, the rows' scores
// (then probabilities) and their max and sum. Tensor-core path (one KV
// head): the K and V rows and the 2-byte query rows, padded to 16-row tiles.
template <typename T, int D>
__host__ __device__ constexpr int paged_smem_bytes(bool mma, int kv_heads, int rows) {
  constexpr int S = PagedShape<T, D>::kSpan;
  constexpr int ROW = D + 16 / static_cast<int>(sizeof(T));
  constexpr int kv_row = ROW * static_cast<int>(sizeof(T));
  return mma ? (2 * S + (rows + 15) / 16 * 16) * kv_row
             : 2 * kv_heads * S * kv_row + rows * (D + S + 2) * 4;
}

// The plan of a call: a function of (group, head_dim, window, dtype) alone.
// A 2-byte type (bf16, fp16) with a GQA group of two or more runs the
// tensor-core path (one KV head a block: a 16-row tile holds rows of one
// head); fp32, and a 2-byte type at a group of one, the FMA path (kHeadRows / group KV heads a block). The
// threads: a warp a 16-row tile (tensor cores) or a thread a (key, row
// group) and a (2 dimensions, row group) item (FMA), and one (row, 4
// dimensions) item a thread in the merge; four to kWarps warps.
template <typename T, int D>
__host__ __device__ constexpr PagedPlan paged_plan(int group, int window) {
  using Shape = PagedShape<T, D>;
  static_assert(32 * Shape::kWarps <= kPagedMaxThreads && Shape::kSpan % 32 == 0, "plan");
  PagedPlan p{};
  p.mma = sizeof(T) == 2 && group >= 2;
  p.span = Shape::kSpan;
  p.kv_heads = p.mma || Shape::kHeadRows / group < 1 ? 1 : Shape::kHeadRows / group;
  const int per_slot = p.kv_heads * group;
  const int slots_max = Shape::kRows / per_slot > 1 ? Shape::kRows / per_slot : 1;
  p.slot_groups = (window + slots_max - 1) / slots_max;
  p.slots = (window + p.slot_groups - 1) / p.slot_groups;
  p.rows = per_slot * p.slots;
  const int groups = (p.slots * group + kPagedRowGroup - 1) / kPagedRowGroup;  // row groups of a KV head
  const int items = p.kv_heads * groups * (Shape::kSpan > D / 2 ? Shape::kSpan : D / 2);
  const int work = p.mma ? (p.rows + 15) / 16 : (items + 31) / 32;
  const int merge = (p.rows * (D / 4) + 31) / 32;
  const int need = work > merge ? work : merge;
  const int warps = need < 4 ? 4 : need > Shape::kWarps ? Shape::kWarps : need;
  p.threads = 32 * warps;
  p.smem = paged_smem_bytes<T, D>(p.mma, p.kv_heads, p.rows);
  return p;
}

// The most dynamic shared memory any plan of an instance takes (group <=
// 8, so a slot's rows are at most max(kHeadRows, 8)): the launch opts into
// it, a constant of the instance, so concurrent launches never race on
// the attribute.
template <typename T, int D>
__host__ __device__ constexpr int paged_smem_max(bool mma) {
  using Shape = PagedShape<T, D>;
  constexpr int slot_rows = Shape::kHeadRows > 8 ? Shape::kHeadRows : 8;
  return paged_smem_bytes<T, D>(mma, Shape::kHeadRows, Shape::kRows > slot_rows ? Shape::kRows : slot_rows);
}

// Two consecutive elements as fp32, in one 4- or 8-byte load (the caller
// keeps the address aligned to it).
__device__ __forceinline__ void load2(const float* p, float* out) {
  const float2 f = *reinterpret_cast<const float2*>(p);
  out[0] = f.x;
  out[1] = f.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float* out) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  out[0] = f.x;
  out[1] = f.y;
}
__device__ __forceinline__ void load2(const __half* p, float* out) {
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(p));
  out[0] = f.x;
  out[1] = f.y;
}

// Query row r of a block (r = (kv head a block * slots + slot) * group +
// group member) -> its row of q / o ([B, W, H] flattened).
__device__ __forceinline__ size_t paged_qrow(int r, int nts, int group, int b, int window, int t0,
                                             int heads, int kvh0, int* ts_out) {
  const int gi = r % group;
  const int ts = (r / group) % nts;
  const int kh = r / (group * nts);
  *ts_out = ts;
  return ((size_t)b * window + t0 + ts) * heads + (size_t)(kvh0 + kh) * group + gi;
}

// One block of the walk (both paths): copy, score, softmax, P.V, store or
// write, count in, and (last block) merge.
template <typename T, int D, bool MMA>
__device__ __forceinline__ void paged_walk_block(
    const T* __restrict__ q, const T* __restrict__ k_pages, const T* __restrict__ v_pages,
    const int* __restrict__ block_tables, const int* __restrict__ kv_lens, T* __restrict__ o,
    float* __restrict__ ws, int* __restrict__ counters, int batch, int heads, int kv_heads, int page,
    int maxp, int window, float scale, int kvh_blk, int slots_blk, int slot_groups, int rows_blk) {
  constexpr int S = PagedShape<T, D>::kSpan;
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int RV = D / VEC;          // 16-byte copies per K or V row
  constexpr int ROW = D + VEC;         // row stride: +16 B keeps row reads conflict-free
  static_assert(S % 32 == 0 && D % 32 == 0, "layout");
  extern __shared__ __align__(16) unsigned char paged_smem[];
  T* sK = reinterpret_cast<T*>(paged_smem);  // [kvh_blk][S][ROW]
  T* sV = sK + (size_t)kvh_blk * S * ROW;    // [kvh_blk][S][ROW]
  __shared__ int sPid[S];
  __shared__ int sLast;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int unit = blockIdx.x;  // (b * sets + set) * slot_groups + slot group
  const int span = blockIdx.y;
  const int nspans = gridDim.y;
  const int group = heads / kv_heads;
  const int sets = (kv_heads + kvh_blk - 1) / kvh_blk;
  const int sg = unit % slot_groups;
  const int b = unit / slot_groups / sets;
  const int kvh0 = (unit / slot_groups % sets) * kvh_blk;
  const int nkh = min(kvh_blk, kv_heads - kvh0);  // KV heads of this set
  const int t0 = sg * slots_blk;
  const int nts = min(slots_blk, window - t0);  // window slots of this group
  const int rows = nkh * nts * group;
  const int start = span * S;
  const int cap = maxp * page;
  const int* row_bt = block_tables + (size_t)b * maxp;

  // The span's page ids and the row's length do not depend on each other.
  int pid = 0;
  if (tid < S) {
    const int pidx = (start + tid) / page;
    pid = pidx < maxp ? row_bt[pidx] : 0;
  }
  const int len0 = kv_lens[b];
  // Slot t sees the t tokens written after the t = 0 one; never more than
  // the table addresses (the scheduler keeps windows inside it).
  const int len_hi = min(len0 + t0 + nts - 1, cap);  // the group's longest slot
  if (start >= len_hi) return;  // the whole block: no live key in this span
  const int n_blk = min(S, len_hi - start);
  if (tid < S) sPid[tid] = tid < n_blk ? pid : -1;
  __syncthreads();

  // 1. The K and V rows of the span for the set's KV heads, all copies in
  //    flight at once (thread: key row j, 16-byte chunk c -- neighbouring
  //    threads on neighbouring 16 B of a row, then of the next row of the
  //    page; dead rows zero-filled, not read); then the query rows.
  const size_t head_stride = (size_t)page * D;  // one KV head of a page
  {
    const int c = (tid % RV) * VEC;
    for (int j = tid / RV; j < S; j += nthreads / RV) {
      const int p = sPid[j];
      const size_t off = p >= 0 ? ((size_t)p * kv_heads + kvh0) * head_stride +
                                      (size_t)((start + j) % page) * D + c
                                : 0;
      T* kd = sK + (size_t)j * ROW + c;
      T* vd = sV + (size_t)j * ROW + c;
      for (int kh = 0; kh < nkh; ++kh) {
        const size_t o_kh = p >= 0 ? off + kh * head_stride : 0;
        cp_async_16(kd + (size_t)kh * S * ROW, k_pages + o_kh, p >= 0);
        cp_async_16(vd + (size_t)kh * S * ROW, v_pages + o_kh, p >= 0);
      }
    }
  }
  const int warp = tid / 32, lane = tid % 32, nwarps = nthreads / 32;
  const size_t rows_all = (size_t)batch * window * heads;
  float* ws_acc = ws;                         // [rows_all][nspans][D]
  float* ws_ml = ws + rows_all * nspans * D;  // [rows_all][nspans][2]

  if constexpr (MMA) {
    // 2-3 on the tensor cores (bf16 or fp16, one KV head): the query rows
    // as 16-row tiles of T (rows past the block's zero), one tile a warp. S = Q K^T
    // by mma.sync m16n8k16 (K's B fragments by ldmatrix), the row's max and
    // sum over the 4-lane quad that holds it, P = exp(s - m) rounded to
    // T into the A fragments of P V (V's B fragments by ldmatrix.trans),
    // fp32 accumulation throughout. A row's result does not depend on the
    // other rows of its tile.
    constexpr int KS = D / 16, NT = S / 8, DT = D / 8;
    static_assert(KS % 2 == 0 && NT % 2 == 0 && DT % 2 == 0, "tiles");
    static_assert(sizeof(T) == 2, "the tensor-core path takes a 2-byte type");
    T* sQ = sV + (size_t)S * ROW;  // [rows padded to 16][ROW]
    const int rows16 = (rows + 15) / 16 * 16;
    for (int idx = tid; idx < rows16 * RV; idx += nthreads) {
      const int r = idx / RV, c = (idx % RV) * VEC;
      int ts;
      const size_t qr = r < rows ? paged_qrow(r, nts, group, b, window, t0, heads, kvh0, &ts) : 0;
      cp_async_16(sQ + (size_t)r * ROW + c, q + (r < rows ? qr * D + c : 0), r < rows);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const int gid = lane / 4, tig = lane % 4;
    for (int mt = warp; mt * 16 < rows; mt += nwarps) {
      int nrow[2], len[2];
      size_t qr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = mt * 16 + gid + 8 * i;
        int ts = 0;
        qr[i] = paged_qrow(r < rows ? r : 0, nts, group, b, window, t0, heads, kvh0, &ts);
        len[i] = min(len0 + t0 + ts, cap);
        nrow[i] = r < rows ? min(S, len[i] - start) : 0;  // the row's live keys in this span
      }
      uint32_t qf[KS][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldmatrix_x4(qf[kk], sQ + (size_t)(mt * 16 + (lane & 15)) * ROW + kk * 16 + (lane >> 4) * 8);
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; kk += 2) {
          uint32_t bk[4];  // bk[0..1]: k-step kk, bk[2..3]: kk + 1
          ldmatrix_x4(bk, sK + (size_t)(n * 8 + (lane & 7)) * ROW + kk * 16 + (lane >> 3) * 8);
          mma_16816<T>(s[n], qf[kk], bk);
          mma_16816<T>(s[n], qf[kk + 1], bk + 2);
        }
      }
      float m[2], l[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = kNegInf;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 2 * i; e < 2 * i + 2; ++e) {
            const int key = n * 8 + 2 * tig + (e & 1);
            s[n][e] = key < nrow[i] ? __fmul_rn(s[n][e], scale) : kNegInf;
            mx = fmaxf(mx, s[n][e]);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        m[i] = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        l[i] = 0.f;
      }
      uint32_t pf[NT / 2][4];  // score tiles 2kk and 2kk + 1 make k-step kk of P V
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float pe[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pe[e] = expf(__fsub_rn(s[n][e], m[e >> 1]));
          l[e >> 1] = __fadd_rn(l[e >> 1], pe[e]);
        }
        pf[n / 2][(n % 2) * 2] = pack2<T>(pe[0], pe[1]);
        pf[n / 2][(n % 2) * 2 + 1] = pack2<T>(pe[2], pe[3]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] = __fadd_rn(l[i], __shfl_xor_sync(0xffffffffu, l[i], 1));
        l[i] = __fadd_rn(l[i], __shfl_xor_sync(0xffffffffu, l[i], 2));
      }
      // P V in halves of at most 8 output tiles (64 dimensions), so the
      // head_dim-128 instance keeps its fragments in registers.
      constexpr int DH = DT > 8 ? 8 : DT;
#pragma unroll
      for (int h0 = 0; h0 < DT; h0 += DH) {
        float acc[DH][4];
#pragma unroll
        for (int j = 0; j < DH; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NT / 2; ++kk)
#pragma unroll
          for (int j = 0; j < DH; j += 2) {
            uint32_t bv[4];  // bv[0..1]: output tile h0 + j, bv[2..3]: h0 + j + 1
            ldmatrix_x4_trans(bv, sV + (size_t)(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ROW +
                                      (h0 + j) * 8 + (lane >> 4) * 8);
            mma_16816<T>(acc[j], pf[kk], bv);
            mma_16816<T>(acc[j + 1], pf[kk], bv + 2);
          }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (nrow[i] <= 0) continue;
          const int col = h0 * 8 + 2 * tig;
          if ((len[i] + S - 1) / S == 1) {  // one live span: the output itself
#pragma unroll
            for (int j = 0; j < DH; ++j)
              *reinterpret_cast<uint32_t*>(o + qr[i] * D + col + j * 8) =
                  pack2<T>(__fdiv_rn(acc[j][2 * i], l[i]), __fdiv_rn(acc[j][2 * i + 1], l[i]));
          } else {
            float* part = ws_acc + (qr[i] * nspans + span) * D + col;
#pragma unroll
            for (int j = 0; j < DH; ++j)
              *reinterpret_cast<float2*>(part + j * 8) = make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
            if (tig == 0 && h0 == 0)
              *reinterpret_cast<float2*>(ws_ml + (qr[i] * nspans + span) * 2) = make_float2(m[i], l[i]);
          }
        }
      }
    }
  } else {
    // 2-3 on the FMA units, rows of one KV head sharing each K and V load:
    // a thread scores one key against up to RG rows of a head at once
    // (four fp32 chains over d mod 4 a row), a warp takes a row's max and
    // sum over the span (lane i: keys i, i + 32, ...), and a thread
    // accumulates P.V for 2 dimensions of up to RG rows over the keys in
    // order. A row's keys past its own length have p = 0 exactly, so the
    // keys of the block's longer slots add nothing to it.
    constexpr int RG = kPagedRowGroup;
    constexpr int KPL = S / 32;  // keys a lane takes in the span's max and sum
    static_assert(RG >= 1 && RG <= 4, "row group");
    const int rh = nts * group;  // rows of one KV head
    float* sQ = reinterpret_cast<float*>(sV + (size_t)kvh_blk * S * ROW);  // [rows_blk][D]
    float* sS = sQ + (size_t)rows_blk * D;                                // [rows_blk][S]
    float* sML = sS + (size_t)rows_blk * S;                               // [rows_blk][2]
    cp_async_commit();
    for (int idx = tid; idx < rows * (D / 8); idx += nthreads) {
      const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
      int ts;
      const size_t qr = paged_qrow(r, nts, group, b, window, t0, heads, kvh0, &ts);
      float f[8];
      load8(q + qr * D + c, f);
      float4* dst = reinterpret_cast<float4*>(sQ + (size_t)r * D + c);
      dst[0] = make_float4(f[0], f[1], f[2], f[3]);
      dst[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
    cp_async_wait<0>();
    __syncthreads();
    auto live_keys = [&](int r) {  // the row's live keys in this span (<= 0: none)
      const int ts = (r / group) % nts;
      return min(S, min(len0 + t0 + ts, cap) - start);
    };
    // A head's rh rows in ngroups groups of nearly equal size: the first
    // rh % ngroups groups take one row more.
    const int ngroups = (rh + RG - 1) / RG;
    auto group_rows = [&](int kh, int rg, int* r0) {
      const int base = rh / ngroups, extra = rh % ngroups;
      *r0 = kh * rh + rg * base + min(rg, extra);
      return base + (rg < extra);
    };
    // Scores: item (head, row group, key); NR = the group's rows, whose
    // query loads and one K load serve the item.
    auto score = [&](auto nr_c, int r0, const T* krow, int j) {
      constexpr int NR = decltype(nr_c)::value;
      float c[NR][4];
#pragma unroll
      for (int g4 = 0; g4 < NR; ++g4)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[g4][e] = 0.f;
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += 8) {
        float kf[8];
        load8(krow + d0, kf);
#pragma unroll
        for (int g4 = 0; g4 < NR; ++g4) {
          const float* qrow = sQ + (size_t)(r0 + g4) * D + d0;
          const float4 qa = *reinterpret_cast<const float4*>(qrow);
          const float4 qb = *reinterpret_cast<const float4*>(qrow + 4);
          c[g4][0] = fmaf(qa.x, kf[0], c[g4][0]);
          c[g4][1] = fmaf(qa.y, kf[1], c[g4][1]);
          c[g4][2] = fmaf(qa.z, kf[2], c[g4][2]);
          c[g4][3] = fmaf(qa.w, kf[3], c[g4][3]);
          c[g4][0] = fmaf(qb.x, kf[4], c[g4][0]);
          c[g4][1] = fmaf(qb.y, kf[5], c[g4][1]);
          c[g4][2] = fmaf(qb.z, kf[6], c[g4][2]);
          c[g4][3] = fmaf(qb.w, kf[7], c[g4][3]);
        }
      }
#pragma unroll
      for (int g4 = 0; g4 < NR; ++g4) {
        const float dot = __fadd_rn(__fadd_rn(c[g4][0], c[g4][1]), __fadd_rn(c[g4][2], c[g4][3]));
        sS[(size_t)(r0 + g4) * S + j] = j < live_keys(r0 + g4) ? __fmul_rn(dot, scale) : kNegInf;
      }
    };
    for (int it = tid; it < nkh * ngroups * S; it += nthreads) {
      const int j = it % S, rg = it / S % ngroups, kh = it / (S * ngroups);
      int r0;
      const int nr = group_rows(kh, rg, &r0);
      const T* krow = sK + ((size_t)kh * S + j) * ROW;
      if (nr == RG) score(PagedInt<RG>{}, r0, krow, j);
      else if (nr == 1) score(PagedInt<1>{}, r0, krow, j);
      else if (nr == 2) score(PagedInt<(RG > 2 ? 2 : 1)>{}, r0, krow, j);
      else score(PagedInt<(RG > 3 ? 3 : 1)>{}, r0, krow, j);
    }
    __syncthreads();
    // The span's max and sum: a warp a row, a lane's keys in order, then
    // the warp's tree; p = exp(s - m) replaces the scores.
    for (int r = warp; r < rows; r += nwarps) {
      float* srow = sS + (size_t)r * S;
      float v[KPL];
      float mx = kNegInf;
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) {
        v[kk] = srow[lane + 32 * kk];
        mx = fmaxf(mx, v[kk]);
      }
      mx = warp_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) {
        v[kk] = expf(__fsub_rn(v[kk], mx));
        sum = __fadd_rn(sum, v[kk]);
        srow[lane + 32 * kk] = v[kk];
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        sML[2 * r] = mx;
        sML[2 * r + 1] = sum;
      }
    }
    __syncthreads();
    // P.V: item (head, row group, 2 dimensions); keys in order up to the
    // group's longest live count, rounded up to 4 (the rest have p = 0).
    auto pv = [&](auto nr_c, int r0, const T* vcol, int d) {
      constexpr int NR = decltype(nr_c)::value;
      int nmax = 0;
#pragma unroll
      for (int g4 = 0; g4 < NR; ++g4) nmax = max(nmax, live_keys(r0 + g4));
      float acc[NR][2];
#pragma unroll
      for (int g4 = 0; g4 < NR; ++g4) acc[g4][0] = acc[g4][1] = 0.f;
      for (int j = 0; j < nmax; j += 4) {
        float vf[4][2];
#pragma unroll
        for (int u = 0; u < 4; ++u) load2(vcol + (size_t)(j + u) * ROW, vf[u]);
#pragma unroll
        for (int g4 = 0; g4 < NR; ++g4) {
          const float4 p4 = *reinterpret_cast<const float4*>(sS + (size_t)(r0 + g4) * S + j);
          const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int e = 0; e < 2; ++e) acc[g4][e] = fmaf(pj[u], vf[u][e], acc[g4][e]);
        }
      }
#pragma unroll
      for (int g4 = 0; g4 < NR; ++g4) {
        const int r = r0 + g4;
        if (live_keys(r) <= 0) continue;
        int ts;
        const size_t qr = paged_qrow(r, nts, group, b, window, t0, heads, kvh0, &ts);
        const float m = sML[2 * r], l = sML[2 * r + 1];
        if ((min(len0 + t0 + ts, cap) + S - 1) / S == 1) {  // one live span: the output itself
          o[qr * D + d] = from_f<T>(__fdiv_rn(acc[g4][0], l));
          o[qr * D + d + 1] = from_f<T>(__fdiv_rn(acc[g4][1], l));
        } else {
          *reinterpret_cast<float2*>(ws_acc + (qr * nspans + span) * D + d) = make_float2(acc[g4][0], acc[g4][1]);
          if (d == 0) *reinterpret_cast<float2*>(ws_ml + (qr * nspans + span) * 2) = make_float2(m, l);
        }
      }
    };
    for (int it = tid; it < nkh * ngroups * (D / 2); it += nthreads) {
      const int d = (it % (D / 2)) * 2, rg = it / (D / 2) % ngroups, kh = it / ((D / 2) * ngroups);
      int r0;
      const int nr = group_rows(kh, rg, &r0);
      const T* vcol = sV + (size_t)kh * S * ROW + d;
      if (nr == RG) pv(PagedInt<RG>{}, r0, vcol, d);
      else if (nr == 1) pv(PagedInt<1>{}, r0, vcol, d);
      else if (nr == 2) pv(PagedInt<(RG > 2 ? 2 : 1)>{}, r0, vcol, d);
      else pv(PagedInt<(RG > 3 ? 3 : 1)>{}, r0, vcol, d);
    }
  }

  const int nlive_hi = (len_hi + S - 1) / S;  // live blocks of this (row, set, slot group)
  if (nlive_hi == 1) return;
  // Count the block in, and let the last one merge. The barrier orders
  // every thread's partials before thread 0's fence and count (release);
  // the last block's thread 0 fences after reading the count (acquire)
  // before the barrier that lets its threads read the partials.
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    sLast = atomicAdd(&counters[unit], 1) == nlive_hi - 1;
    if (sLast) {
      __threadfence();
      counters[unit] = 0;  // ready for the next launch
    }
  }
  __syncthreads();
  if (!sLast) return;

  // Merge every row with more than one live span: the row's max M over
  // its spans' maxima (exact, in any order), then its sum and P.V
  // rescaled to M and added in span order 0, 1, 2, ... A span's loads and
  // its factor exp(m_s - M) do not wait on the running sums, so all of an
  // item's loads are in flight together. Item: (row, 4 dimensions).
  for (int idx = tid; idx < rows * (D / 4); idx += nthreads) {
    const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
    int ts;
    const size_t qr = paged_qrow(r, nts, group, b, window, t0, heads, kvh0, &ts);
    const int nl = (min(len0 + t0 + ts, cap) + S - 1) / S;
    if (nl == 1) continue;
    const float* ml = ws_ml + qr * nspans * 2;
    const float* ac = ws_acc + qr * nspans * D + c;
    float mx = kNegInf, lsum = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    auto add = [&](float2 mls, float4 as) {
      const float f = expf(__fsub_rn(mls.x, mx));
      lsum = fmaf(mls.y, f, lsum);
      a.x = fmaf(as.x, f, a.x);
      a.y = fmaf(as.y, f, a.y);
      a.z = fmaf(as.z, f, a.z);
      a.w = fmaf(as.w, f, a.w);
    };
    constexpr int U = kPagedMergeUnroll;
    if (nl <= U) {  // (a row of up to U spans) every load at once
      float2 mls[U];
      float4 as[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (u < nl) {
          mls[u] = __ldcg(reinterpret_cast<const float2*>(ml + 2 * u));
          as[u] = __ldcg(reinterpret_cast<const float4*>(ac + (size_t)u * D));
        }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (u < nl) mx = fmaxf(mx, mls[u].x);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (u < nl) add(mls[u], as[u]);
    } else {  // the same arithmetic, the maxima first
#pragma unroll kPagedMergeUnroll
      for (int s2 = 0; s2 < nl; ++s2) mx = fmaxf(mx, __ldcg(ml + 2 * s2));
#pragma unroll kPagedMergeUnroll
      for (int s2 = 0; s2 < nl; ++s2)
        add(__ldcg(reinterpret_cast<const float2*>(ml + 2 * s2)),
            __ldcg(reinterpret_cast<const float4*>(ac + (size_t)s2 * D)));
    }
    T* out = o + qr * D + c;
    out[0] = from_f<T>(__fdiv_rn(a.x, lsum));
    out[1] = from_f<T>(__fdiv_rn(a.y, lsum));
    out[2] = from_f<T>(__fdiv_rn(a.z, lsum));
    out[3] = from_f<T>(__fdiv_rn(a.w, lsum));
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kPagedMaxThreads)
    paged_walk_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                      const T* __restrict__ v_pages, const int* __restrict__ block_tables,
                      const int* __restrict__ kv_lens, T* __restrict__ o, float* __restrict__ ws,
                      int* __restrict__ counters, int batch, int heads, int kv_heads, int page,
                      int maxp, int window, float scale, int kvh_blk, int slots_blk,
                      int slot_groups, int rows_blk) {
  paged_walk_block<T, D, false>(q, k_pages, v_pages, block_tables, kv_lens, o, ws, counters, batch,
                                heads, kv_heads, page, maxp, window, scale, kvh_blk, slots_blk,
                                slot_groups, rows_blk);
}

template <typename T, int D>
__global__ void __launch_bounds__(kPagedMaxThreads)
    paged_walk_mma_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                          const T* __restrict__ v_pages, const int* __restrict__ block_tables,
                          const int* __restrict__ kv_lens, T* __restrict__ o, float* __restrict__ ws,
                          int* __restrict__ counters, int batch, int heads, int kv_heads, int page,
                          int maxp, int window, float scale, int kvh_blk, int slots_blk,
                          int slot_groups, int rows_blk) {
  paged_walk_block<T, D, true>(q, k_pages, v_pages, block_tables, kv_lens, o, ws, counters, batch,
                               heads, kv_heads, page, maxp, window, scale, kvh_blk, slots_blk,
                               slot_groups, rows_blk);
}

// The kernel a plan launches, with the instance's dynamic shared memory
// limit raised (once per call; a constant of the instance).
template <typename T, int D>
static int paged_kernel(bool mma, void (**kernel)(const T*, const T*, const T*, const int*,
                                                  const int*, T*, float*, int*, int, int, int, int,
                                                  int, int, float, int, int, int, int)) {
  int smem = paged_smem_max<T, D>(false);
  *kernel = paged_walk_kernel<T, D>;
  if constexpr (sizeof(T) == 2) {
    if (mma) {
      smem = paged_smem_max<T, D>(true);
      *kernel = paged_walk_mma_kernel<T, D>;
    }
  }
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

template <typename T, int D>
static int paged_walk_launch_d(const void* q, const void* kp, const void* vp, const int* bt,
                               const int* lens, void* o, float* ws, int* counters, int batch,
                               int window, int heads, int kv_heads, int page, int maxp,
                               float scale, cudaStream_t stream) {
  const PagedPlan p = paged_plan<T, D>(heads / kv_heads, window);
  const int sets = (kv_heads + p.kv_heads - 1) / p.kv_heads;
  const long long units = (long long)batch * sets * p.slot_groups;
  const long long spans = ((long long)maxp * page + p.span - 1) / p.span;
  if (units > 0x7fffffffLL || spans > 65535) return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(const T*, const T*, const T*, const int*, const int*, T*, float*, int*, int, int,
                 int, int, int, int, float, int, int, int, int) = nullptr;
  const int rc = paged_kernel<T, D>(p.mma, &kernel);
  if (rc != 0) return rc;
  const dim3 grid(static_cast<unsigned>(units), static_cast<unsigned>(spans));
  kernel<<<grid, p.threads, p.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), bt, lens,
      static_cast<T*>(o), ws, counters, batch, heads, kv_heads, page, maxp, window, scale,
      p.kv_heads, p.slots, p.slot_groups, p.rows);
  return static_cast<int>(cudaGetLastError());
}

static inline bool paged_shape_ok(int heads, int kv_heads, int window, int page, int maxp) {
  return kv_heads >= 1 && heads % kv_heads == 0 && heads / kv_heads <= 8 && window >= 1 &&
         page >= 1 && maxp >= 1;
}

// Entry-point body shared by both libraries: dtype (bf16, fp16, fp32) and
// head_dim dispatch (64: the dense Qwen2 decoder; 128: the Qwen2-MoE
// decoder). ws holds one
// partial (acc[head_dim], then m and l) per query row ([B, W, H]) and
// span of the table; counters one int per (row, KV-head set, slot group),
// zero between launches.
static inline int paged_walk_dispatch(const void* q, const void* k_pages, const void* v_pages,
                                      const int* block_tables, const int* kv_lens, void* o,
                                      void* ws, void* counters, int batch, int window, int heads,
                                      int kv_heads, int page, int maxp, int head_dim, int dtype,
                                      float scale, void* stream) {
  if (!paged_shape_ok(heads, kv_heads, window, page, maxp))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  int* c = static_cast<int*>(counters);
#define LUMEN_PAGED_CASE(T, DD)                                                                  \
  return paged_walk_launch_d<T, DD>(q, k_pages, v_pages, block_tables, kv_lens, o, w, c, batch, \
                                    window, heads, kv_heads, page, maxp, scale, s)
  if (dtype == kBFloat16 && head_dim == 64) LUMEN_PAGED_CASE(__nv_bfloat16, 64);
  if (dtype == kBFloat16 && head_dim == 128) LUMEN_PAGED_CASE(__nv_bfloat16, 128);
  if (dtype == kFloat16 && head_dim == 64) LUMEN_PAGED_CASE(__half, 64);
  if (dtype == kFloat16 && head_dim == 128) LUMEN_PAGED_CASE(__half, 128);
  if (dtype == kFloat32 && head_dim == 64) LUMEN_PAGED_CASE(float, 64);
  if (dtype == kFloat32 && head_dim == 128) LUMEN_PAGED_CASE(float, 128);
#undef LUMEN_PAGED_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// One field of the plan of a call: 0 span, 1 KV heads a block, 2 window
// slots a block, 3 slot groups, 4 query rows a block, 5 threads, 6
// dynamic shared memory (bytes), 7 tensor cores (1) or FMA units (0), 8
// blocks resident an SM (the occupancy calculator, on the current
// device); -1 for a shape or field it has none of.
template <typename T, int D>
static int paged_plan_field_d(int group, int window, int field) {
  const PagedPlan p = paged_plan<T, D>(group, window);
  switch (field) {
    case 0: return p.span;
    case 1: return p.kv_heads;
    case 2: return p.slots;
    case 3: return p.slot_groups;
    case 4: return p.rows;
    case 5: return p.threads;
    case 6: return p.smem;
    case 7: return p.mma;
    case 8: {
      void (*kernel)(const T*, const T*, const T*, const int*, const int*, T*, float*, int*, int,
                     int, int, int, int, int, float, int, int, int, int) = nullptr;
      if (paged_kernel<T, D>(p.mma, &kernel) != 0) return -1;
      int blocks = 0;
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, p.threads, p.smem) !=
          cudaSuccess)
        return -1;
      return blocks;
    }
    default: return -1;
  }
}

static inline int paged_plan_query(int group, int head_dim, int window, int dtype, int field) {
  if (group < 1 || group > 8 || window < 1) return -1;
  if (dtype == kBFloat16 && head_dim == 64) return paged_plan_field_d<__nv_bfloat16, 64>(group, window, field);
  if (dtype == kBFloat16 && head_dim == 128) return paged_plan_field_d<__nv_bfloat16, 128>(group, window, field);
  if (dtype == kFloat16 && head_dim == 64) return paged_plan_field_d<__half, 64>(group, window, field);
  if (dtype == kFloat16 && head_dim == 128) return paged_plan_field_d<__half, 128>(group, window, field);
  if (dtype == kFloat32 && head_dim == 64) return paged_plan_field_d<float, 64>(group, window, field);
  if (dtype == kFloat32 && head_dim == 128) return paged_plan_field_d<float, 128>(group, window, field);
  return -1;
}

}  // namespace lumen
