// flash_attention_cache for the H100 (sm_90a): a prefill chunk of Sq
// queries against a contiguous per-request KV scratch of Sk slots, with
// a per-sample causal offset and live-slot count.
//
// Replaces the TPU kernel lumen_tpu/ops/attention.py:315
// flash_attention_cache (body _flash_cache_kernel, :249). Same mask:
// key j is visible to query i of sample b iff j <= q_offsets[b] + i and
// j < kv_valid[b]. The TPU version scalar-prefetched the two [B] arrays
// into SMEM ahead of the grid; here each block loads its own sample's
// pair, and the mask is computed in the kernel -- no [B, 1, Sq, Sk] mask
// tensor exists in device memory. Key tiles past kv_valid or above the
// block's causal diagonal are never loaded (the Pallas kernel's
// block_live skip). The JAX dispatch's min_flash_q / min-seq gates have
// no counterpart: every multi-token call on a CUDA tensor runs this.
//
// Bound and design: see flash_tile.cuh. On the main path a 256-token
// chunk of 14 heads launches 4 x 14 = 56 blocks per decoder layer.
#include "flash_tile.cuh"

namespace lumen {

template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads)
    flash_attention_cache_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                 const T* __restrict__ v, const int* __restrict__ q_offsets,
                                 const int* __restrict__ kv_valid, T* __restrict__ o, int heads,
                                 int sq, int sk, float scale) {
  const size_t bh = blockIdx.y;
  const int b = static_cast<int>(bh / heads);
  const int q0 = blockIdx.x * kFlashBQ;
  flash_tile<T, D>(q + bh * sq * D, k + bh * sk * D, v + bh * sk * D, o + bh * sq * D, sq, sk,
                   q0, q_offsets[b], kv_valid[b], true, scale);
}

template <typename T, int D>
static void launch(const void* q, const void* k, const void* v, const int* q_offsets,
                   const int* kv_valid, void* o, int batch, int heads, int sq, int sk,
                   float scale, cudaStream_t stream) {
  const dim3 grid((sq + kFlashBQ - 1) / kFlashBQ, batch * heads);
  flash_attention_cache_kernel<T, D><<<grid, kFlashThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), q_offsets,
      kv_valid, static_cast<T*>(o), heads, sq, sk, scale);
}

template <typename T>
static int dispatch_d(const void* q, const void* k, const void* v, const int* q_offsets,
                      const int* kv_valid, void* o, int batch, int heads, int sq, int sk, int d,
                      float scale, cudaStream_t stream) {
  // head_dim 64: the only one the repository's models use.
  if (d != 64) return static_cast<int>(cudaErrorInvalidValue);
  launch<T, 64>(q, k, v, q_offsets, kv_valid, o, batch, heads, sq, sk, scale, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lumen

extern "C" int lumen_flash_attention_cache(const void* q, const void* k, const void* v,
                                           const int* q_offsets, const int* kv_valid, void* o,
                                           int batch, int heads, int sq, int sk, int head_dim,
                                           int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lumen::kBFloat16)
    return lumen::dispatch_d<__nv_bfloat16>(q, k, v, q_offsets, kv_valid, o, batch, heads, sq, sk,
                                            head_dim, scale, s);
  if (dtype == lumen::kFloat32)
    return lumen::dispatch_d<float>(q, k, v, q_offsets, kv_valid, o, batch, heads, sq, sk,
                                    head_dim, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
