// paged_attention for the H100 (sm_90a): one decode token per row
// against KV pages picked through the row's block table (the continuous
// engine's every decode step, every decoder layer).
//
// Replaces the TPU kernel lumen_tpu/ops/attention.py:676
// paged_attention_kernel (body _paged_decode_kernel, :617). Inputs keep
// its layout: q [B, H, D], k/v pages [P, KVH, page, D], block_tables
// [B, MAXP] int32, kv_lens [B] int32 (the just-written token included).
// The kernel is the page walk of paged_walk.cuh with a window of one
// token, under a plan chosen from (group, head_dim, dtype): rows split
// over blocks of span absolute key positions, the spans merged in span
// order by the last block of the (row, KV-head set) in the same launch.
//
// The TPU kernel used a single-pass softmax over the assembled row (to
// stay bitwise equal to its XLA reference); the split form here agrees
// with the plain PyTorch version within the tolerance chip_smoke.py
// states, not bitwise.
//
// What bounds it on the H100: bytes, and at the main path's sizes the
// latency of reaching them. Decode reads each live K/V slot once (8 rows
// x ~170 tokens on average: ~0.7 MB a layer at 14/2 heads of 64, ~11 MB
// at 16/16 heads of 128; 0.2 / 3.3 us at 3.35 TB/s). The TPU kernel's
// query block was the GQA group padded to 8 sublanes; at the Qwen2-MoE
// decoder's group of one that left seven of eight rows idle, in the
// scores, the P.V and the partials. Here the plan packs several KV heads
// into a block at a group of one (a page's KV heads lie side by side, so
// the copy is one contiguous run a page and more bytes are in flight a
// block), gives each real query row one warp (lanes over keys for the
// scores, over head_dim for P.V, the query read as 16-byte broadcasts),
// and keeps one partial a live query row; the chain is one table read,
// one copy wait, the arithmetic and, for rows longer than a span, one
// store, counter and merge.
#include "paged_walk.cuh"

// ws: one fp32 partial (head_dim + 2 floats) per (query row, span of the
// table); counters: one int per (row, KV-head set), zero before the
// launch and left zero after it.
extern "C" int lumen_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                     const int* block_tables, const int* kv_lens, void* o,
                                     void* ws, void* counters, int batch, int heads, int kv_heads,
                                     int page, int maxp, int head_dim, int dtype, float scale,
                                     void* stream) {
  return lumen::paged_walk_dispatch(q, k_pages, v_pages, block_tables, kv_lens, o, ws, counters,
                                    batch, 1, heads, kv_heads, page, maxp, head_dim, dtype, scale,
                                    stream);
}

// The plan both paged libraries launch for a call of (group, head_dim,
// window, dtype): one field (lumen::paged_plan_query), or -1 for a shape
// or field it has none of.
extern "C" int lumen_paged_plan(int group, int head_dim, int window, int dtype, int field) {
  return lumen::paged_plan_query(group, head_dim, window, dtype, field);
}
