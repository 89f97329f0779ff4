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
// Bound and design: see flash_tile.cuh. Grid = (query tiles of 64,
// batch * heads): the vision tower's [1, 12, 256, 64] launches 48 blocks
// of 256 threads.
#include "flash_tile.cuh"

namespace lumen {

template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
                           int causal, float scale) {
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kFlashBQ;
  flash_tile<T, D>(q + bh * sq * D, k + bh * sk * D, v + bh * sk * D, o + bh * sq * D, sq, sk,
                   q0, sk - sq, sk, causal != 0, scale);
}

template <typename T, int D>
static void launch(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk,
                   int causal, float scale, cudaStream_t stream) {
  const dim3 grid((sq + kFlashBQ - 1) / kFlashBQ, bh);
  flash_attention_kernel<T, D><<<grid, kFlashThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, sk, causal, scale);
}

template <typename T>
static int dispatch_d(const void* q, const void* k, const void* v, void* o, int bh, int sq,
                      int sk, int d, int causal, float scale, cudaStream_t stream) {
  // head_dim 64: the only one the repository's models use.
  if (d != 64) return static_cast<int>(cudaErrorInvalidValue);
  launch<T, 64>(q, k, v, o, bh, sq, sk, causal, scale, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lumen

// Plain C entry point (loaded through ctypes). Returns the launch's
// cudaGetLastError() code, 0 on success.
extern "C" int lumen_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int batch_heads, int sq, int sk, int head_dim, int dtype,
                                     int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lumen::kBFloat16)
    return lumen::dispatch_d<__nv_bfloat16>(q, k, v, o, batch_heads, sq, sk, head_dim, causal,
                                            scale, s);
  if (dtype == lumen::kFloat32)
    return lumen::dispatch_d<float>(q, k, v, o, batch_heads, sq, sk, head_dim, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
