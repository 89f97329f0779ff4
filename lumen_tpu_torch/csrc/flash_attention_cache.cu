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
// bf16 runs the tensor-core tile (flash_tile_bf16.cuh: design, and what
// bounds it), fp32 the FMA tile (flash_tile_fp32.cuh). On the serving
// path a caption prompt's two chunks are q [1, 14, 256, 64] (q_off 0,
// 256 live keys) and q [1, 14, 63, 64] (q_off 256, 265 live) against the
// 832-slot scratch; the bound of the first is 0.00055 ms of bytes (q, o
// and the live K/V slots once each at 3.35 TB/s). What limits the tile is
// latency: up to four dependent 64-key tiles a block (five for the
// second chunk) and the launch.
#include "flash_tile_bf16.cuh"
#include "flash_tile_fp32.cuh"

namespace lumen {

// One block a launch is all the tile needs of an SM (minimum 1): ptxas
// then has no reason to squeeze registers for a second block.
template <int D>
__global__ void __launch_bounds__(kFlashMmaThreads, 1)
    flash_attention_cache_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                      const __nv_bfloat16* __restrict__ k,
                                      const __nv_bfloat16* __restrict__ v,
                                      const int* __restrict__ q_offsets,
                                      const int* __restrict__ kv_valid,
                                      __nv_bfloat16* __restrict__ o, int heads, int sq, int sk,
                                      float scale) {
  const size_t bh = blockIdx.y;
  const int b = static_cast<int>(bh / heads);
  const int q0 = blockIdx.x * kFlashMmaRows;
  flash_tile_bf16<D>(q + bh * sq * D, k + bh * sk * D, v + bh * sk * D, o + bh * sq * D, sq, sk,
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

// Plain C entry point (loaded through ctypes). Returns the launch's
// cudaGetLastError() code, 0 on success. head_dim 64 only: the one the
// repository's models use.
extern "C" int lumen_flash_attention_cache(const void* q, const void* k, const void* v,
                                           const int* q_offsets, const int* kv_valid, void* o,
                                           int batch, int heads, int sq, int sk, int head_dim,
                                           int dtype, float scale, void* stream) {
  using namespace lumen;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim != 64) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBFloat16) {
    constexpr int smem = flash_bf16_smem_bytes<64>();  // past the 48 KB default: opt in
    const cudaError_t rc = cudaFuncSetAttribute(flash_attention_cache_bf16_kernel<64>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    const dim3 grid((sq + kFlashMmaRows - 1) / kFlashMmaRows, batch * heads);
    flash_attention_cache_bf16_kernel<64><<<grid, kFlashMmaThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), q_offsets, kv_valid,
        static_cast<__nv_bfloat16*>(o), heads, sq, sk, scale);
  } else if (dtype == kFloat32) {
    const dim3 grid((sq + kFlashBQ - 1) / kFlashBQ, batch * heads);
    flash_attention_cache_fp32_kernel<64><<<grid, kFlashThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        q_offsets, kv_valid, static_cast<float*>(o), heads, sq, sk, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
