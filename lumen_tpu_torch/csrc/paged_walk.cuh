// The paged KV walk shared by paged_attention.cu (one decode token per
// row) and paged_attention_varq.cu (a W-token speculative verify window
// per row): one block of 128 threads per (row, KV head, window slot t)
// computes the slot's attention over the row's first kv_lens[b] + t keys,
// read page by page through the row's block table.
//
// q is [B, W, H, D] (W = 1 is the single-token layout [B, H, D]), k/v
// pages [P, KVH, page, D], block_tables [B, MAXP] int32, kv_lens [B]
// int32: the t = 0 visibility (the just-written token included). Slots
// at or past a slot's live length are masked; pages past it are never
// read, so stale block-table entries (the dump page 0) cost nothing.
//
// The block keeps the GQA group's query heads (up to 8 -- the TPU
// version padded the group to 8 for its sublane tiling; here padding
// rows are simply idle) in shared memory and walks the live tokens 128
// at a time:
//   A. each thread scores one token against every head of the group,
//      reading its K row straight from its page with 16-byte loads;
//   B. one warp per two heads folds the chunk into a running max/sum
//      (online softmax), so the row length is not capped by any scratch
//      -- the TPU kernels' maxp * page <= 8192 VMEM cap
//      (lumen_tpu/ops/attention.py:967) has no counterpart;
//   C. the chunk's V rows, staged in shared memory with coalesced loads,
//      are accumulated into the [group, D] output, 16 threads per head.
// Both entry points instantiate this one template, so a verify slot t
// computes exactly what a single-token step at length kv_lens + t does:
// W = 1 is the single-token kernel bit for bit, and the greedy identity
// of speculative decoding does not hang on rounding.
#pragma once

#include "common.cuh"

namespace lumen {

constexpr int kPagedThreads = 128;
constexpr int kPagedGroupMax = 8;  // query heads per KV head
constexpr int kPagedChunk = kPagedThreads;  // tokens per pass: one per thread

template <typename T, int D>
__global__ void __launch_bounds__(kPagedThreads)
    paged_walk_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                      const T* __restrict__ v_pages, const int* __restrict__ block_tables,
                      const int* __restrict__ kv_lens, T* __restrict__ o, int heads,
                      int kv_heads, int page, int maxp, int window, float scale) {
  constexpr int G = kPagedGroupMax;
  constexpr int TPH = kPagedThreads / G;  // output threads per head (16)
  constexpr int DPT = D / TPH;            // output dims per thread
  __shared__ float sQ[G][D];
  __shared__ float sS[G][kPagedChunk];
  __shared__ float sV[kPagedChunk][D];
  __shared__ float sM[G], sL[G], sAlpha[G];

  const int tid = threadIdx.x;
  const int t = blockIdx.x % window;  // window slot
  const int bk = blockIdx.x / window;
  const int b = bk / kv_heads;
  const int kvh = bk % kv_heads;
  const int group = heads / kv_heads;
  // Slot t sees the t tokens written after the t = 0 one; never more than
  // the table addresses (the scheduler keeps windows inside it).
  const int len = min(kv_lens[b] + t, maxp * page);
  const int* row_bt = block_tables + (size_t)b * maxp;
  const size_t page_stride = (size_t)kv_heads * page * D;  // one page id, all KV heads
  const size_t head_off = (size_t)kvh * page * D;
  const size_t q_row = ((size_t)b * window + t) * heads + (size_t)kvh * group;

  for (int idx = tid; idx < G * D; idx += kPagedThreads) {
    const int g = idx / D, d = idx % D;
    sQ[g][d] = g < group ? to_f(q[(q_row + g) * D + d]) : 0.f;
  }
  if (tid < G) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }
  const int og = tid / TPH, ot = tid % TPH;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int base = 0; base < len; base += kPagedChunk) {
    // A. scores of this thread's token for every head of the group.
    const int tok = base + tid;
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    if (tok < len) {
      const int pid = row_bt[tok / page];
      const T* krow = k_pages + pid * page_stride + head_off + (size_t)(tok % page) * D;
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += 8) {
        float kf[8];
        load8(krow + d0, kf);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
#pragma unroll
          for (int g = 0; g < G; ++g) s[g] = fmaf(sQ[g][d0 + e], kf[e], s[g]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) sS[g][tid] = tok < len ? s[g] * scale : kNegInf;
    // V rows of the chunk, coalesced: neighbouring threads, neighbouring
    // dims. Dead slots load zeros so p == 0 never meets a stale NaN.
    for (int idx = tid; idx < kPagedChunk * D; idx += kPagedThreads) {
      const int j = idx / D, d = idx % D;
      const int tj = base + j;
      float val = 0.f;
      if (tj < len) {
        const int pid = row_bt[tj / page];
        val = to_f(v_pages[pid * page_stride + head_off + (size_t)(tj % page) * D + d]);
      }
      sV[j][d] = val;
    }
    __syncthreads();

    // B. online softmax update, one warp per two heads.
    const int warp = tid / 32, lane = tid % 32;
    for (int g = warp * 2; g < warp * 2 + 2; ++g) {
      float cmax = kNegInf;
      for (int j = lane; j < kPagedChunk; j += 32) cmax = fmaxf(cmax, sS[g][j]);
      cmax = warp_max(cmax);
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, cmax);
      float psum = 0.f;
      for (int j = lane; j < kPagedChunk; j += 32) {
        const float p = expf(sS[g][j] - m_new);
        sS[g][j] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sAlpha[g] = alpha;
        sL[g] = alpha * sL[g] + psum;
        sM[g] = m_new;
      }
    }
    __syncthreads();

    // C. acc[og] = alpha * acc + P[og] @ V over the chunk's live slots.
    const float alpha = sAlpha[og];
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
    const int n = len - base < kPagedChunk ? len - base : kPagedChunk;
    for (int j = 0; j < n; ++j) {
      const float p = sS[og][j];
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p, sV[j][i * TPH + ot], acc[i]);
    }
    __syncthreads();  // sS / sV are rewritten by the next chunk
  }

  if (og < group) {
    const float denom = sL[og];
#pragma unroll
    for (int i = 0; i < DPT; ++i) o[(q_row + og) * D + i * TPH + ot] = from_f<T>(acc[i] / denom);
  }
}

template <typename T>
static int paged_walk_launch(const void* q, const void* kp, const void* vp, const int* bt,
                             const int* lens, void* o, int batch, int window, int heads,
                             int kv_heads, int page, int maxp, int d, float scale,
                             cudaStream_t stream) {
  if (heads % kv_heads != 0 || heads / kv_heads > kPagedGroupMax || window < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // head_dim 64: the only one the repository's models use (128 would
  // need 64 KB of fp32 V staging, i.e. dynamic shared memory).
  if (d != 64) return static_cast<int>(cudaErrorInvalidValue);
  paged_walk_kernel<T, 64><<<batch * kv_heads * window, kPagedThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), bt, lens,
      static_cast<T*>(o), heads, kv_heads, page, maxp, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// Entry-point body shared by both libraries: dtype dispatch.
static inline int paged_walk_dispatch(const void* q, const void* k_pages, const void* v_pages,
                                      const int* block_tables, const int* kv_lens, void* o,
                                      int batch, int window, int heads, int kv_heads, int page,
                                      int maxp, int head_dim, int dtype, float scale,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return paged_walk_launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables, kv_lens, o, batch,
                                            window, heads, kv_heads, page, maxp, head_dim, scale,
                                            s);
  if (dtype == kFloat32)
    return paged_walk_launch<float>(q, k_pages, v_pages, block_tables, kv_lens, o, batch, window,
                                    heads, kv_heads, page, maxp, head_dim, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace lumen
