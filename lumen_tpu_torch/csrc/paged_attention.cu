// paged_attention for the H100 (sm_90a): one decode token per row
// against KV pages picked through the row's block table (the continuous
// engine's every decode step, every decoder layer).
//
// Replaces the TPU kernel lumen_tpu/ops/attention.py:676
// paged_attention_kernel (body _paged_decode_kernel, :617). Inputs keep
// its layout: q [B, H, D], k/v pages [P, KVH, page, D], block_tables
// [B, MAXP] int32, kv_lens [B] int32 (the just-written token included).
// The kernel is the page walk of paged_walk.cuh with a window of one
// token: one block of 128 threads per (row, KV head), online softmax over
// 128-token chunks, live slots only.
//
// The TPU kernel used a single-pass softmax over the assembled row (to
// stay bitwise equal to its XLA reference); the online form here agrees
// with the plain PyTorch version within the tolerance chip_smoke.py
// states, not bitwise.
//
// What bounds it on the H100: bytes. Decode reads each live K/V slot
// once (8 rows x ~300 tokens x 2 KV heads x 64 x 2 B x 2 = ~1.2 MB a
// layer, ~0.4 us at 3.35 TB/s), so at the main path's sizes the launch
// and the 16-block grid's latency dominate, not bandwidth. Splitting a
// long row over several blocks (split-K with a second combine pass) is
// the step that fills the 132 SMs once rows grow.
#include "paged_walk.cuh"

extern "C" int lumen_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                     const int* block_tables, const int* kv_lens, void* o,
                                     int batch, int heads, int kv_heads, int page, int maxp,
                                     int head_dim, int dtype, float scale, void* stream) {
  return lumen::paged_walk_dispatch(q, k_pages, v_pages, block_tables, kv_lens, o, batch, 1,
                                    heads, kv_heads, page, maxp, head_dim, dtype, scale, stream);
}
