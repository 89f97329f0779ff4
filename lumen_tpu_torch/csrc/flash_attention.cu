// flash_attention for the H100 (sm_90a): online-softmax attention over
// [B, H, S, D] tensors, bidirectional or causal, for the VLM vision
// tower (256 tokens, 12 heads, head_dim 64), the decoder's cacheless
// causal forward (head_dim 64, or 128 for the Qwen2-MoE decoder), the
// CLIP towers (head_dim 64) and the native OCR recognizer's token mixing
// (4 heads of head_dim 16, 240-1920 tokens).
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
//
// At head_dim 16 the exponentials bound the tile, not the bytes or the
// products: every (query, key) pair costs one exp2f on the SFU (16 a
// clock an SM, ~4.2e12 a second over 132 SMs at 1.98 GHz) against 64
// tensor-core FLOPs. At the recognizer's widest call, [32, 4, 1920, 16],
// that is 472 M exponentials, ~0.113 ms, against 0.0094 ms of bytes and
// 0.031 ms of FLOPs. The tile is the D = 64 design with one k16 step of
// Q K^T and two n8 output tiles; it does nothing yet about the SFU.
//
// At head_dim 128 (the Qwen2-MoE decoder's cacheless forward, [1, 16,
// 265, 128] causal) the tile is the D = 64 design with eight k16 steps of
// Q K^T and sixteen n8 output tiles: twice the registers for Q and O a
// thread, and 148 KB of shared memory for the K/V ring, under the 227 KB
// a block may opt into.
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

namespace lumen {

template <int D>
int launch_flash(const void* q, const void* k, const void* v, void* o, int batch_heads, int sq, int sk,
                 int dtype, int causal, float scale, cudaStream_t s) {
  if (dtype == kBFloat16) {
    constexpr int smem = flash_bf16_smem_bytes<D>();  // past the 48 KB default at D = 64: opt in
    const cudaError_t rc = cudaFuncSetAttribute(flash_attention_bf16_kernel<D>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    const dim3 grid((sq + kFlashMmaRows - 1) / kFlashMmaRows, batch_heads);
    flash_attention_bf16_kernel<D><<<grid, kFlashMmaThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), sq, sk, causal,
        scale);
  } else if (dtype == kFloat32) {
    const dim3 grid((sq + kFlashBQ - 1) / kFlashBQ, batch_heads);
    flash_attention_fp32_kernel<D><<<grid, kFlashThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), sq, sk, causal, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lumen

// Plain C entry point (loaded through ctypes). Returns the launch's
// cudaGetLastError() code, 0 on success. head_dim 64 (the VLM and CLIP
// towers), 128 (the Qwen2-MoE decoder) or 16 (the native OCR
// recognizer); any other is refused.
extern "C" int lumen_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int batch_heads, int sq, int sk, int head_dim, int dtype,
                                     int causal, float scale, void* stream) {
  using namespace lumen;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch_flash<64>(q, k, v, o, batch_heads, sq, sk, dtype, causal, scale, s);
  if (head_dim == 128) return launch_flash<128>(q, k, v, o, batch_heads, sq, sk, dtype, causal, scale, s);
  if (head_dim == 16) return launch_flash<16>(q, k, v, o, batch_heads, sq, sk, dtype, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
