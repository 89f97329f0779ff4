// paged_attention for the H100 (sm_90a): one decode token per row
// against KV pages picked through the row's block table (the continuous
// engine's every decode step, every decoder layer).
//
// Replaces the TPU kernel lumen_tpu/ops/attention.py:676
// paged_attention_kernel (body _paged_decode_kernel, :617). Inputs keep
// its layout: q [B, H, D], k/v pages [P, KVH, page, D], block_tables
// [B, MAXP] int32, kv_lens [B] int32 (the just-written token included).
// The kernel is the page walk of paged_walk.cuh with a window of one
// token: each row split over blocks of 64 absolute key positions, the
// spans merged in span order by the last block of the row in the same
// launch.
//
// The TPU kernel used a single-pass softmax over the assembled row (to
// stay bitwise equal to its XLA reference); the split form here agrees
// with the plain PyTorch version within the tolerance chip_smoke.py
// states, not bitwise.
//
// What bounds it on the H100: bytes, and at the main path's sizes the
// latency of reaching them. Decode reads each live K/V slot once (8 rows
// x ~300 tokens x 2 KV heads x 64 x 2 B x 2 = ~1.2 MB a layer, ~0.4 us at
// 3.35 TB/s). One block per (row, KV head) walking its row 128 tokens at
// a time would be a serial chain of dependent loads on 16 blocks of 132
// SMs (0.09 ms a call). This design cuts the row into 64-key spans, a
// block each (~80-100 working blocks at 8 decode rows), copies a span's
// K and V rows with all their 16-byte cp.async copies in flight at once,
// and merges the spans in the same launch: the chain is one table read,
// one copy wait, the arithmetic and, for rows longer than a span, one
// store, counter and merge.
#include "paged_walk.cuh"

// ws: the span partials (lumen::paged_partial_floats<64>() floats per
// (row, KV head, span of the table)); counters: one int per (row, KV
// head), zero before the launch and left zero after it.
extern "C" int lumen_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                     const int* block_tables, const int* kv_lens, void* o,
                                     void* ws, void* counters, int batch, int heads, int kv_heads,
                                     int page, int maxp, int head_dim, int dtype, float scale,
                                     void* stream) {
  return lumen::paged_walk_dispatch(q, k_pages, v_pages, block_tables, kv_lens, o, ws, counters,
                                    batch, 1, heads, kv_heads, page, maxp, head_dim, dtype, scale,
                                    stream);
}
