// The paged KV walk shared by paged_attention.cu (one decode token per
// row) and paged_attention_varq.cu (a W-token speculative verify window
// per row): the attention of window slot t of row b over the row's first
// kv_lens[b] + t keys, read page by page through the row's block table.
//
// q is [B, W, H, D] (W = 1 is the single-token layout [B, H, D]), k/v
// pages [P, KVH, page, D], block_tables [B, MAXP] int32, kv_lens [B]
// int32: the t = 0 visibility (the just-written token included). Keys
// at or past a slot's live length are never read, so stale block-table
// entries (the dump page 0) cost nothing.
//
// Split over the row. A row's keys are cut into spans of kPagedSpan key
// positions aligned to absolute positions (span s holds keys [s * span,
// (s + 1) * span)), and each (row, KV head, window slot, span) is one
// block of 128 threads; blocks whose span starts at or past the slot's
// live length exit at once. A block:
//   1. reads its span's page ids and the row's length (independent
//      loads), then copies the span's live K and V rows into shared
//      memory with 16-byte cp.async, all of them in flight at once
//      (neighbouring threads on neighbouring 16 B of a row; dead rows
//      are zero-filled, not read);
//   2. scores the span's keys against the GQA group's query heads (up
//      to 8: the TPU version padded the group to 8 for its sublane
//      tiling; padding heads are idle rows) on the FMA units, in fp32;
//   3. takes each head's max and sum over the span and accumulates P.V
//      into an fp32 [group, D] partial (m, l, acc).
// The spans of a (row, KV head, slot) are combined in the same launch:
// a row with one live span writes its output directly; otherwise each
// block stores its partial in an fp32 workspace and counts itself in a
// per-slot counter, and the block that arrives last merges the partials
// in span order 0, 1, 2, ... (the online softmax's update, span by
// span: rescale by the running max), writes the output and resets the
// counter to 0 for the next launch. No float atomics, and no cap on the
// row length: the TPU kernels' maxp * page <= 8192 VMEM cap
// (lumen_tpu/ops/attention.py:967) has no counterpart.
//
// Determinism. A span's partial depends only on q, the span's live keys
// and the slot's length; the number of live spans and the merge order
// depend only on the length. So one query's output bits depend on its q,
// the live keys and its length alone -- not on maxp (the block-table
// bucket, which differs between a decode step and a verify turn), on W,
// or on the batch. Both entry points instantiate this one template, so a
// verify slot t computes exactly what a single-token step at length
// kv_lens + t does: W = 1 is the single-token kernel bit for bit, and the
// greedy identity of speculative decoding does not hang on rounding.
#pragma once

#include "common.cuh"

namespace lumen {

constexpr int kPagedThreads = 128;
constexpr int kPagedGroupMax = 8;  // query heads per KV head
constexpr int kPagedSpan = 64;     // key positions per block, aligned to absolute positions
constexpr int kPagedMergeUnroll = 8;  // spans whose partials the merge loads together

// Workspace floats per (row, KV head, slot, span): m and l of each head
// slot, then its [D] accumulator.
template <int D>
__host__ __device__ constexpr int paged_partial_floats() {
  return kPagedGroupMax * (D + 2);
}

template <typename T, int D>
__global__ void __launch_bounds__(kPagedThreads)
    paged_walk_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                      const T* __restrict__ v_pages, const int* __restrict__ block_tables,
                      const int* __restrict__ kv_lens, T* __restrict__ o, float* __restrict__ ws,
                      int* __restrict__ counters, int heads, int kv_heads, int page, int maxp,
                      int window, float scale) {
  constexpr int G = kPagedGroupMax;
  constexpr int S = kPagedSpan;
  constexpr int VEC = 16 / sizeof(T);         // elements per 16-byte copy
  constexpr int RV = D / VEC;                 // 16-byte copies per K or V row
  constexpr int ROW = D + VEC;                // row stride: +16 B keeps row reads conflict-free
  constexpr int HS = G * S / kPagedThreads;   // heads a thread scores (one key each)
  constexpr int HV = G * D / kPagedThreads;   // heads a thread accumulates (one dim each)
  constexpr int QV = G * D / kPagedThreads;   // query elements a thread stages
  static_assert(S % 32 == 0 && kPagedThreads % S == 0 && kPagedThreads % D == 0, "layout");
  static_assert(G % (kPagedThreads / 32) == 0, "max/sum: whole heads a warp");
  __shared__ __align__(16) T sK[S][ROW];
  __shared__ __align__(16) T sV[S][ROW];
  __shared__ __align__(16) float sQ[G][D];
  __shared__ float sP[G][S];
  __shared__ float sM[G], sL[G];
  __shared__ int sPid[S];
  __shared__ int sLast;

  const int tid = threadIdx.x;
  const int span = blockIdx.x;
  const int nspans = gridDim.x;
  const int slot = blockIdx.y;  // (b * kv_heads + kvh) * window + t
  const int t = slot % window;
  const int bk = slot / window;
  const int b = bk / kv_heads;
  const int kvh = bk % kv_heads;
  const int group = heads / kv_heads;
  const int start = span * S;
  const int* row_bt = block_tables + (size_t)b * maxp;
  const size_t q_row = ((size_t)b * window + t) * heads + (size_t)kvh * group;

  // The span's page ids, the row's length and the group's queries do not
  // depend on each other: all their loads are in flight together.
  int pid = 0;
  if (tid < S) {
    const int pidx = (start + tid) / page;
    pid = pidx < maxp ? row_bt[pidx] : 0;
  }
  float qv[QV];
#pragma unroll
  for (int i = 0; i < QV; ++i) {
    const int idx = tid + i * kPagedThreads, g = idx / D;
    qv[i] = g < group ? to_f(q[(q_row + g) * D + idx % D]) : 0.f;
  }
  // Slot t sees the t tokens written after the t = 0 one; never more than
  // the table addresses (the scheduler keeps windows inside it).
  const int len = min(kv_lens[b] + t, maxp * page);
  if (start >= len) return;  // the whole block: no live key in this span
  const int n = min(S, len - start);  // live keys of the span
  if (tid < S) sPid[tid] = tid < n ? pid : -1;
  __syncthreads();

  // 1. K and V rows of the span, all copies in flight at once.
  const size_t page_stride = (size_t)kv_heads * page * D;  // one page id, all KV heads
  const size_t head_off = (size_t)kvh * page * D;
  for (int idx = tid; idx < 2 * S * RV; idx += kPagedThreads) {
    const int which = idx / (S * RV);  // 0: K, 1: V
    const int r = (idx / RV) % S, c = (idx % RV) * VEC;
    const int p = sPid[r];
    const T* base = which ? v_pages : k_pages;
    const T* src = p >= 0 ? base + p * page_stride + head_off + (size_t)((start + r) % page) * D + c : base;
    cp_async_16(which ? &sV[r][c] : &sK[r][c], src, p >= 0);
  }
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < QV; ++i) {
    const int idx = tid + i * kPagedThreads;
    sQ[idx / D][idx % D] = qv[i];
  }
  cp_async_wait<0>();
  __syncthreads();

  // 2. Scores: thread (key j, heads h0..h0+HS-1), d in order, fp32.
  {
    const int j = tid % S, h0 = (tid / S) * HS;
    float s[HS];
#pragma unroll
    for (int i = 0; i < HS; ++i) s[i] = 0.f;
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 8) {
      float kf[8];
      load8(&sK[j][d0], kf);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
#pragma unroll
        for (int i = 0; i < HS; ++i) s[i] = fmaf(sQ[h0 + i][d0 + e], kf[e], s[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < HS; ++i) sP[h0 + i][j] = j < n ? s[i] * scale : kNegInf;
  }
  __syncthreads();

  // 3a. The span's max and sum: whole heads a warp, S / 32 keys a lane.
  {
    const int warp = tid / 32, lane = tid % 32;
    constexpr int HPW = G / (kPagedThreads / 32);
#pragma unroll
    for (int g = warp * HPW; g < warp * HPW + HPW; ++g) {
      float v[S / 32];
      float m = kNegInf;
#pragma unroll
      for (int i = 0; i < S / 32; ++i) {
        v[i] = sP[g][lane + 32 * i];
        m = fmaxf(m, v[i]);
      }
      m = warp_max(m);
      float l = 0.f;
#pragma unroll
      for (int i = 0; i < S / 32; ++i) {
        v[i] = expf(v[i] - m);
        l += v[i];
        sP[g][lane + 32 * i] = v[i];
      }
      l = warp_sum(l);
      if (lane == 0) {
        sM[g] = m;
        sL[g] = l;
      }
    }
  }
  __syncthreads();

  // 3b. P.V: thread (dim d, heads h0..h0+HV-1), keys in order.
  const int d = tid % D, h0 = (tid / D) * HV;
  float acc[HV];
#pragma unroll
  for (int i = 0; i < HV; ++i) acc[i] = 0.f;
  for (int j = 0; j < n; ++j) {
    const float vj = to_f(sV[j][d]);
#pragma unroll
    for (int i = 0; i < HV; ++i) acc[i] = fmaf(sP[h0 + i][j], vj, acc[i]);
  }

  const int nlive = (len + S - 1) / S;  // spans holding live keys: a function of len alone
  if (nlive == 1) {
#pragma unroll
    for (int i = 0; i < HV; ++i) {
      const int g = h0 + i;
      if (g < group) o[(q_row + g) * D + d] = from_f<T>(acc[i] / sL[g]);
    }
    return;
  }

  // Store the partial, count the block in, and let the last one merge.
  constexpr int PF = paged_partial_floats<D>();
  float* part = ws + ((size_t)slot * nspans + span) * PF;
#pragma unroll
  for (int i = 0; i < HV; ++i) part[2 * G + (h0 + i) * D + d] = acc[i];
  if (tid < G) {
    part[2 * tid] = sM[tid];
    part[2 * tid + 1] = sL[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) sLast = atomicAdd(&counters[slot], 1) == nlive - 1;
  __syncthreads();
  if (!sLast) return;
  __threadfence();
  if (tid == 0) counters[slot] = 0;  // ready for the next launch

  // Merge in span order 0, 1, 2, ...: the online softmax's update, span by
  // span (a span's loads do not wait on the running sums).
  const float* parts = ws + (size_t)slot * nspans * PF;
  float mx[HV], l[HV], a[HV];
#pragma unroll
  for (int i = 0; i < HV; ++i) {
    const int g = h0 + i;
    mx[i] = __ldcg(parts + 2 * g);
    l[i] = __ldcg(parts + 2 * g + 1);
    a[i] = __ldcg(parts + 2 * G + g * D + d);
  }
#pragma unroll kPagedMergeUnroll
  for (int s2 = 1; s2 < nlive; ++s2) {
    const float* ps = parts + (size_t)s2 * PF;
#pragma unroll
    for (int i = 0; i < HV; ++i) {
      const int g = h0 + i;
      const float ms = __ldcg(ps + 2 * g), ls = __ldcg(ps + 2 * g + 1);
      const float as = __ldcg(ps + 2 * G + g * D + d);
      const float mn = fmaxf(mx[i], ms);
      const float c_run = expf(mx[i] - mn), c_span = expf(ms - mn);
      l[i] = fmaf(ls, c_span, l[i] * c_run);
      a[i] = fmaf(as, c_span, a[i] * c_run);
      mx[i] = mn;
    }
  }
#pragma unroll
  for (int i = 0; i < HV; ++i) {
    const int g = h0 + i;
    if (g < group) o[(q_row + g) * D + d] = from_f<T>(a[i] / l[i]);
  }
}

template <typename T>
static int paged_walk_launch(const void* q, const void* kp, const void* vp, const int* bt,
                             const int* lens, void* o, float* ws, int* counters, int batch,
                             int window, int heads, int kv_heads, int page, int maxp, int d,
                             float scale, cudaStream_t stream) {
  if (heads % kv_heads != 0 || heads / kv_heads > kPagedGroupMax || window < 1 || page < 1 ||
      maxp < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // head_dim 64: the only one the repository's models use.
  if (d != 64) return static_cast<int>(cudaErrorInvalidValue);
  if (batch * kv_heads * window > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((maxp * page + kPagedSpan - 1) / kPagedSpan, batch * kv_heads * window);
  paged_walk_kernel<T, 64><<<grid, kPagedThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), bt, lens,
      static_cast<T*>(o), ws, counters, heads, kv_heads, page, maxp, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// Entry-point body shared by both libraries: dtype dispatch. ws holds
// paged_partial_floats<64>() floats per (row, KV head, slot, span) of the
// grid; counters one int per (row, KV head, slot), zero between launches.
static inline int paged_walk_dispatch(const void* q, const void* k_pages, const void* v_pages,
                                      const int* block_tables, const int* kv_lens, void* o,
                                      void* ws, void* counters, int batch, int window, int heads,
                                      int kv_heads, int page, int maxp, int head_dim, int dtype,
                                      float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  int* c = static_cast<int*>(counters);
  if (dtype == kBFloat16)
    return paged_walk_launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables, kv_lens, o, w, c,
                                            batch, window, heads, kv_heads, page, maxp, head_dim,
                                            scale, s);
  if (dtype == kFloat32)
    return paged_walk_launch<float>(q, k_pages, v_pages, block_tables, kv_lens, o, w, c, batch,
                                    window, heads, kv_heads, page, maxp, head_dim, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace lumen
