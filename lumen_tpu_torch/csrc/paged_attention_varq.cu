// paged_attention_varq for the H100 (sm_90a): the speculative verify
// window. Every row carries W = K + 1 query tokens written at
// consecutive positions, and window slot t attends over the row's first
// kv_lens[b] + t keys (kv_lens is the t = 0 visibility, the pending
// token included), read through the row's block table.
//
// Replaces the TPU kernel lumen_tpu/ops/attention.py:849
// paged_attention_varq_kernel (body _paged_verify_kernel, :793). Inputs
// keep its layout: q [B, W, H, D], k/v pages [P, KVH, page, D],
// block_tables [B, MAXP] int32, kv_lens [B] int32; out [B, W, H, D].
//
// Design: the page walk of paged_walk.cuh with the window folded into
// the block's query rows, as the TPU kernel folded it into its [W * Gp,
// D] rows: one block per (row, KV-head set, slot group, span) holds every
// window slot's query rows (KV heads x slots x group; a window whose rows
// pass PagedShape::kRows, such as W = 16 at a group of 7, is split into
// equal slot groups), copies the span's K/V into shared memory once for
// all of them, masks each slot's keys at its own length kv_lens + t, and
// keeps a partial and a live-span count per slot; the last block of the
// (row, set, slot group) merges each slot's spans in span order. Each
// query row runs the same operations as in the single-token kernel, so
// W = 1 is paged_attention.cu bit for bit and a verify slot computes the
// same bits as the sequential decode step it stands in for. Slots past a
// row's q_len are computed too, as on the TPU: the accept scan ignores
// them, and their K/V writes sit above cur_len where the length mask
// hides them.
//
// What bounds it on the H100: bytes -- each live K/V slot of a row read
// once (the window's W - 1 extra keys included: ~0.7 MB a layer at 8
// rows, 14/2 heads of 64, ~11 MB at 16/16 heads of 128) -- and the
// latency of reaching them. Before the fold, each window slot's block
// copied the span again (W times the bytes, mostly from L2); now a span
// is copied once a slot group, and the extra work of W is arithmetic on
// rows already in shared memory.
#include "paged_walk.cuh"

// ws / counters: as for lumen_paged_attention; counters one int per
// (row, KV-head set, slot group).
extern "C" int lumen_paged_attention_varq(const void* q, const void* k_pages,
                                          const void* v_pages, const int* block_tables,
                                          const int* kv_lens, void* o, void* ws, void* counters,
                                          int batch, int window, int heads, int kv_heads, int page,
                                          int maxp, int head_dim, int dtype, float scale,
                                          void* stream) {
  return lumen::paged_walk_dispatch(q, k_pages, v_pages, block_tables, kv_lens, o, ws, counters,
                                    batch, window, heads, kv_heads, page, maxp, head_dim, dtype,
                                    scale, stream);
}

// The same plan query as lumen_paged_plan in paged_attention.cu, from
// this library's build of paged_walk.cuh.
extern "C" int lumen_paged_plan(int group, int head_dim, int window, int dtype, int field) {
  return lumen::paged_plan_query(group, head_dim, window, dtype, field);
}
