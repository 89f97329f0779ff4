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
// bf16 and fp16 run flash_plan_bf16.cuh (the design, and what bounds each
// regime; one template over the 2-byte type, the same plan for both),
// fp32 the FMA tile (flash_tile_fp32.cuh), used only by small fp32
// models. launch_flash picks a 2-byte call's plan from (sq, sk, head_dim,
// causal) alone -- the short path (sk <= 128: whole sequences a
// block, K/V once in shared memory) or the long path (a cp.async ring of
// key tiles, a block shape by head_dim) -- and lumen_flash_plan reports
// it. One call is one launch.
//
// What bounds each regime on the H100 (q, k, v, o once each at 3.35 TB/s;
// FLOPs at 989 TFLOP/s; at head_dim 16 one exp2 a (query, key) pair on
// the SFU, 16 a clock an SM, ~4.2e12 a second):
// - the CLIP towers' bulk batches, [64, 12, 50, 64] and [64, 8, 77, 64]
//   causal: bytes, ~0.006 ms; the short path keeps 4-5 blocks on every
//   SM, so the 768 / 512 (b, h) run in about one wave;
// - the VLM vision tower's [1, 12, 256, 64]: bytes, 0.00047 ms; the floor
//   is latency (two 64-key tiles a warp, and the launch: a one-head call
//   takes as long on this card, ours and SDPA's alike);
// - the Qwen2-MoE decoder's [1, 16, 265, 128] causal: bytes, 0.0013 ms;
//   latency again, with the heaviest row group's 265 keys split over
//   three warps and the heaviest row blocks first;
// - SVTR's [32, 4, 1920, 16]: the exponentials, 472 M of them, ~0.113 ms
//   on the SFU alone, though what holds the kernel at about twice that is
//   latency, not the SFU.
#include "flash_plan_bf16.cuh"
#include "flash_tile_fp32.cuh"

namespace lumen {

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

// A 2-byte call (T = __nv_bfloat16 or __half) under its plan.
template <typename T, int D>
int launch_flash_mma(const void* q, const void* k, const void* v, void* o, int batch_heads, int sq, int sk,
                     int causal, float scale, cudaStream_t s) {
  const FlashPlan p = flash_plan<D>(sq, sk, causal != 0);
  const dim3 grid(batch_heads, p.row_blocks);
  auto kernel = p.path == kFlashShort ? flash_short_mma_kernel<T, D> : flash_long_mma_kernel<T, D>;
  // past the 48 KB default on the long path at D = 64 and 128: opt in
  const cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<grid, p.threads, p.smem, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), static_cast<T*>(o), sq, sk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_flash(const void* q, const void* k, const void* v, void* o, int batch_heads, int sq, int sk,
                 int dtype, int causal, float scale, cudaStream_t s) {
  if (dtype == kBFloat16)
    return launch_flash_mma<__nv_bfloat16, D>(q, k, v, o, batch_heads, sq, sk, causal, scale, s);
  if (dtype == kFloat16)
    return launch_flash_mma<__half, D>(q, k, v, o, batch_heads, sq, sk, causal, scale, s);
  if (dtype == kFloat32) {
    const dim3 grid((sq + kFlashBQ - 1) / kFlashBQ, batch_heads);
    flash_attention_fp32_kernel<D><<<grid, kFlashThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), sq, sk, causal, scale);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// One field of a 2-byte call's plan (FLASH_PLAN_FIELDS in ops/attention.py):
// 0 path (0 short, 1 long), 1 rows a block, 2 key split, 3 ring slots, 4
// threads, 5 dynamic shared memory, 6 row blocks a (b, h), 7 heaviest
// first, 8 keys a warp's online-softmax step takes (a ring slot on the
// long path), 9 blocks resident on an SM of the current device (the
// occupancy calculator: registers, shared memory and threads together;
// the bf16 instance's -- the fp16 one runs the same plan).
template <int D>
int flash_plan_field(int sq, int sk, int causal, int field) {
  const FlashPlan p = flash_plan<D>(sq, sk, causal != 0);
  switch (field) {
    case 0: return p.path;
    case 1: return p.rows;
    case 2: return p.split;
    case 3: return p.stages;
    case 4: return p.threads;
    case 5: return p.smem;
    case 6: return p.row_blocks;
    case 7: return p.reverse;
    case 8: return p.path == kFlashShort ? kFlashShortChunk : FlashLong<D>::kKeys;
    case 9: {
      auto kernel = p.path == kFlashShort ? flash_short_mma_kernel<__nv_bfloat16, D>
                                          : flash_long_mma_kernel<__nv_bfloat16, D>;
      if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem) != cudaSuccess)
        return -1;
      int blocks = 0;
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, p.threads, p.smem) != cudaSuccess)
        return -1;
      return blocks;
    }
    default: return -1;
  }
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

// The plan lumen_flash_attention launches for a bf16 or fp16 call of this
// shape (one plan for both):
// one field (flash_plan_field), or -1 for a head_dim or field it has none
// of.
extern "C" int lumen_flash_plan(int sq, int sk, int head_dim, int causal, int field) {
  using namespace lumen;
  if (head_dim == 64) return flash_plan_field<64>(sq, sk, causal, field);
  if (head_dim == 128) return flash_plan_field<128>(sq, sk, causal, field);
  if (head_dim == 16) return flash_plan_field<16>(sq, sk, causal, field);
  return -1;
}
