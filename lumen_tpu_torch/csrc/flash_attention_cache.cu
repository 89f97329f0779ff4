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
// bf16 and fp16 run the tensor-core tile (flash_tile_bf16.cuh: design,
// and what bounds it; one template over the 2-byte type), fp32 the FMA
// tile (flash_tile_fp32.cuh). On the serving
// path a caption prompt's two chunks are q [1, 14, 256, 64] (q_off 0,
// 256 live keys) and q [1, 14, 63, 64] (q_off 256, 265 live) against the
// 832-slot scratch; the bound of the first is 0.00055 ms of bytes (q, o
// and the live K/V slots once each at 3.35 TB/s). What limits the tile is
// latency: up to four dependent 64-key tiles a block (five for the
// second chunk) and the launch. The Qwen2-MoE decoder (Qwen1.5-MoE-A2.7B
// widths: 16 heads of head_dim 128) runs the <128> instance on its
// chunks, q [1, 16, 256, 128] and the prompt's rest, against the
// 832-slot scratch.
#include "flash_tile_bf16.cuh"
#include "flash_tile_fp32.cuh"

namespace lumen {

// One block a launch is all the tile needs of an SM (minimum 1): ptxas
// then has no reason to squeeze registers for a second block.
template <typename T, int D>
__global__ void __launch_bounds__(kFlashMmaThreads, 1)
    flash_attention_cache_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                     const T* __restrict__ v, const int* __restrict__ q_offsets,
                                     const int* __restrict__ kv_valid, T* __restrict__ o, int heads,
                                     int sq, int sk, float scale) {
  const size_t bh = blockIdx.y;
  const int b = static_cast<int>(bh / heads);
  const int q0 = blockIdx.x * kFlashMmaRows;
  flash_tile_mma<T, D>(q + bh * sq * D, k + bh * sk * D, v + bh * sk * D, o + bh * sq * D, sq, sk,
                       q0, q_offsets[b], kv_valid[b], true, scale);
}

template <int D>
__global__ void __launch_bounds__(kFlashThreads)
    flash_attention_cache_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                      const float* __restrict__ v,
                                      const int* __restrict__ q_offsets,
                                      const int* __restrict__ kv_valid, float* __restrict__ o,
                                      int heads, int sq, int sk, float scale) {
  const size_t bh = blockIdx.y;
  const int b = static_cast<int>(bh / heads);
  const int q0 = blockIdx.x * kFlashBQ;
  flash_tile_fp32<D>(q + bh * sq * D, k + bh * sk * D, v + bh * sk * D, o + bh * sq * D, sq, sk,
                     q0, q_offsets[b], kv_valid[b], true, scale);
}

}  // namespace lumen

namespace lumen {

// A 2-byte call (T = __nv_bfloat16 or __half): one block shape for both.
template <typename T, int D>
int launch_flash_cache_mma(const void* q, const void* k, const void* v, const int* q_offsets,
                           const int* kv_valid, void* o, int batch, int heads, int sq, int sk, float scale,
                           cudaStream_t s) {
  constexpr int smem = flash_mma_smem_bytes<D>();  // past the 48 KB default: opt in
  const cudaError_t rc = cudaFuncSetAttribute(flash_attention_cache_mma_kernel<T, D>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((sq + kFlashMmaRows - 1) / kFlashMmaRows, batch * heads);
  flash_attention_cache_mma_kernel<T, D><<<grid, kFlashMmaThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), q_offsets, kv_valid,
      static_cast<T*>(o), heads, sq, sk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_flash_cache(const void* q, const void* k, const void* v, const int* q_offsets,
                       const int* kv_valid, void* o, int batch, int heads, int sq, int sk, int dtype,
                       float scale, cudaStream_t s) {
  if (dtype == kBFloat16)
    return launch_flash_cache_mma<__nv_bfloat16, D>(q, k, v, q_offsets, kv_valid, o, batch, heads, sq, sk,
                                                    scale, s);
  if (dtype == kFloat16)
    return launch_flash_cache_mma<__half, D>(q, k, v, q_offsets, kv_valid, o, batch, heads, sq, sk, scale, s);
  if (dtype == kFloat32) {
    const dim3 grid((sq + kFlashBQ - 1) / kFlashBQ, batch * heads);
    flash_attention_cache_fp32_kernel<D><<<grid, kFlashThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        q_offsets, kv_valid, static_cast<float*>(o), heads, sq, sk, scale);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace lumen

// Plain C entry point (loaded through ctypes). Returns the launch's
// cudaGetLastError() code, 0 on success. head_dim 64 (the dense Qwen2
// decoder) or 128 (the Qwen2-MoE decoder); any other is refused.
extern "C" int lumen_flash_attention_cache(const void* q, const void* k, const void* v,
                                           const int* q_offsets, const int* kv_valid, void* o,
                                           int batch, int heads, int sq, int sk, int head_dim,
                                           int dtype, float scale, void* stream) {
  using namespace lumen;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return launch_flash_cache<64>(q, k, v, q_offsets, kv_valid, o, batch, heads, sq, sk, dtype, scale, s);
  if (head_dim == 128)
    return launch_flash_cache<128>(q, k, v, q_offsets, kv_valid, o, batch, heads, sq, sk, dtype, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
