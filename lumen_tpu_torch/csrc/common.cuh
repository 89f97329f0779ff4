// Shared pieces of the port's hand-written Hopper kernels: element
// conversion between the storage type (bf16, fp16 or fp32) and the fp32
// the kernels accumulate in, the finite "minus infinity" the JAX reference
// masks with, warp reductions, and the tensor-core building blocks
// (mma.sync m16n8k16 for either 2-byte type, ldmatrix, cp.async) of the
// flash tiles, the paged walk and w8a16_matmul.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lumen {

// Same finite mask value as lumen_tpu/ops/attention.py (NEG_INF = -1e30):
// a masked logit contributes exp(-1e30 - m) == 0 once any live key has
// set the running max, and an all-masked row degrades to a uniform
// average instead of NaN, exactly as in the reference.
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// Eight consecutive elements as fp32 through 16-byte loads (the caller
// guarantees 16-byte alignment: rows of head_dim >= 8 elements in
// tensors whose base the wrapper checked).
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const __half* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// dtype codes shared with the Python wrappers (ops/attention.py).
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kFloat16 = 2;

// -- tensor cores -------------------------------------------------------------
// Fragment coordinates of mma.sync m16n8k16 for lane l: gid = l / 4 (row
// of A/C, column of B), tig = l % 4 (pair of k of A/B, pair of columns of
// C). A: a0 (gid, 2tig..+1), a1 (gid+8, 2tig..), a2 (gid, 2tig+8..), a3
// (gid+8, 2tig+8..); B: b0 (k 2tig..+1, n gid), b1 (k 2tig+8..+9, n gid);
// C: c0/c1 (gid, 2tig..+1), c2/c3 (gid+8, 2tig..+1).

// Two fp32 values rounded (to nearest even) into a pair of the 2-byte
// type T, lo in the low half: an mma A/B register.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&h);
}

// A pair of 1.0 in the 2-byte type T (an mma B register of ones).
template <typename T>
__host__ __device__ constexpr uint32_t ones2();
template <>
__host__ __device__ constexpr uint32_t ones2<__nv_bfloat16>() { return 0x3F803F80u; }
template <>
__host__ __device__ constexpr uint32_t ones2<__half>() { return 0x3C003C00u; }

// c += a @ b, operands of the 2-byte type T (bf16 or fp16), fp32
// accumulator. The two forms share the fragment layout below.
template <typename T>
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, const uint32_t* b);
template <>
__device__ __forceinline__ void mma_16816<__nv_bfloat16>(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
template <>
__device__ __forceinline__ void mma_16816<__half>(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 matrices of a 2-byte type from shared memory: lanes 8i..8i+7 give the row
// addresses (16 bytes each) of matrix i, which lands in r[i] with the
// thread holding (row gid, columns 2tig..+1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// The same, transposed: the thread holds (rows 2tig..+1, column gid) --
// a B fragment from a row-major [k][n] tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// 16 bytes global -> shared without passing through registers (L2 only).
// With live == false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(live ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most n committed groups of this thread are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

}  // namespace lumen
