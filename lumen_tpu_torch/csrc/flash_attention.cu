// flash_attention for the H100 (sm_90a): online-softmax attention over
// [B, H, S, D] tensors, bidirectional or causal, for the VLM vision
// tower (256 tokens, 12 heads, head_dim 64) and the decoder's cacheless
// causal forward.
//
// Replaces the TPU kernel lumen_tpu/ops/attention.py:173 flash_attention
// (body _flash_kernel, :97). Semantics kept: for causal with sq != sk,
// query i sees keys j <= i + (sk - sq); no key past sk is ever read (the
// Pallas version padded K to the block and masked the padding). The
// JAX min-seq gate (LUMEN_FLASH_MIN_SEQ) existed to keep a degenerate
// one-step TPU grid off short sequences; it has no counterpart here --
// every call on a CUDA tensor launches this kernel.
//
// bf16 runs the tensor-core tile (flash_tile_bf16.cuh: design, and what
// bounds it), fp32 the FMA tile (flash_tile_fp32.cuh). At the vision
// tower's [1, 12, 256, 64] the bound is 0.00047 ms of bytes (q, k, v, o
// once each at 3.35 TB/s; the 0.2 GFLOP take 0.0002 ms at 989 TFLOP/s):
// what limits the tile is latency, four dependent 64-key tiles a block
// and the launch. Grid: (query tiles of kFlashMmaRows, batch * heads).
#include "flash_tile_bf16.cuh"
#include "flash_tile_fp32.cuh"

namespace lumen {

// One block a launch is all the tile needs of an SM (minimum 1): ptxas
// then has no reason to squeeze registers for a second block.
template <int D>
__global__ void __launch_bounds__(kFlashMmaThreads, 1)
    flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                                int sq, int sk, int causal, float scale) {
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kFlashMmaRows;
  flash_tile_bf16<D>(q + bh * sq * D, k + bh * sk * D, v + bh * sk * D, o + bh * sq * D, sq, sk,
                     q0, sk - sq, sk, causal != 0, scale);
}

template <int D>
__global__ void __launch_bounds__(kFlashThreads)
    flash_attention_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, float* __restrict__ o, int sq, int sk,
                                int causal, float scale) {
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kFlashBQ;
  flash_tile_fp32<D>(q + bh * sq * D, k + bh * sk * D, v + bh * sk * D, o + bh * sq * D, sq, sk,
                     q0, sk - sq, sk, causal != 0, scale);
}

}  // namespace lumen

// Plain C entry point (loaded through ctypes). Returns the launch's
// cudaGetLastError() code, 0 on success. head_dim 64 only: the one the
// repository's models use.
extern "C" int lumen_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int batch_heads, int sq, int sk, int head_dim, int dtype,
                                     int causal, float scale, void* stream) {
  using namespace lumen;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim != 64) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBFloat16) {
    constexpr int smem = flash_bf16_smem_bytes<64>();  // past the 48 KB default: opt in
    const cudaError_t rc = cudaFuncSetAttribute(flash_attention_bf16_kernel<64>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    const dim3 grid((sq + kFlashMmaRows - 1) / kFlashMmaRows, batch_heads);
    flash_attention_bf16_kernel<64><<<grid, kFlashMmaThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), sq, sk, causal,
        scale);
  } else if (dtype == kFloat32) {
    const dim3 grid((sq + kFlashBQ - 1) / kFlashBQ, batch_heads);
    flash_attention_fp32_kernel<64><<<grid, kFlashThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), sq, sk, causal, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
