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
// Design: the page walk of paged_walk.cuh with blocks per (row, KV head,
// window slot, 64-key span) -- the TPU kernel folded the window into its query
// rows ([W * Gp, D] per (row, KV head)) and assembled the whole row in
// VMEM; here each slot is the single-token kernel at its own length, so
// W = 1 is paged_attention.cu bit for bit and a verify slot computes the
// same bits as the sequential decode step it stands in for. Slots past a
// row's q_len are computed too, as on the TPU: the accept scan ignores
// them, and their K/V writes sit above cur_len where the length mask
// hides them.
//
// What bounds it on the H100: bytes -- each live K/V slot of a row read
// once (8 rows x ~300 tokens x 2 KV heads x 64 x 2 B x 2 = ~1.2 MB a
// layer, ~0.4 us at 3.35 TB/s) -- and the latency of reaching them. It
// takes the split walk of paged_walk.cuh (64-key spans, a block each,
// merged in span order in the same launch), so its blocks fill the card;
// it still reads a row's K/V W times (mostly from the 50 MB L2, since
// the W slots of a row run together). Folding the window into one block
// that reads K/V once is the next redesign step.
#include "paged_walk.cuh"

// ws / counters: as for lumen_paged_attention, per (row, KV head, slot).
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
