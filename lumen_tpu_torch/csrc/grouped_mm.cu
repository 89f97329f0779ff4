// grouped_mm for the H100 (sm_90a): the MoE expert bank's grouped
// product in fp16 and fp32. x [N, K] holds rows sorted by group, w [G, K,
// M] one matrix a group, ends [G] int32 the cumulative row ends (group g
// is rows ends[g - 1] .. ends[g] - 1); out [N, M] = each group's rows
// times its matrix, summed in fp32 and rounded to x's type once. Rows at
// or past ends[G - 1] are written as zero.
//
// Replaces no TPU kernel: the JAX package's grouped product is
// lax.ragged_dot (lumen_tpu/parallel/moe.py:105-107), an XLA op. It was
// added because no PyTorch call on this card computes a grouped product
// in fp16 or fp32 without reading the group ends on the host
// (torch._grouped_mm takes bf16 only here, and bf16 keeps it): a MoE
// layer in those types must stay at the bf16 layer's count of
// device-to-host syncs, so the ends are read on the device, here.
//
// Design: one block a (column tile of kGmmCols, group), plus one block a
// column tile that zeroes the rows past the last end. A block reads its
// group's two ends, exits at once when the group is empty (a decode step
// of 8 tokens x top-4 reaches some 27-29 of 60 experts), and walks the
// group's rows kGmmRows at a time; for each row tile it streams K in
// steps of kGmmDepth: the x tile and the w tile go to shared memory as
// fp32 through 16-byte loads (the next step's loads in
// flight in registers while this step computes), and each thread
// accumulates 2 rows x 4 columns with FMAs; a warp whose rows are all
// past the group's end skips the FMAs (at a decode step a group is a row
// or two). A value's sum runs over k in order in one thread: no atomics,
// no split, the same bits every run.
//
// What bounds it on the H100: at the decode step's shapes, bytes -- the
// chosen experts' matrices read once (gate bank, 32 rows over ~27 of 60
// experts at 2048 x 1408: ~156 MB in fp16, ~311 MB in fp32, 0.046-0.093
// ms at 3.35 TB/s); each block reads its column tile of w once a row
// tile, so a group's matrix is read once while its rows fit one tile
// (every decode step; a prefill chunk's groups of ~20 rows too). A long
// prefill's groups of many rows re-read w a row tile (from L2 mostly)
// and run on the FMA units (67 TFLOP/s in fp32), not the tensor cores:
// the simple kernel first, as the port's rule for a new kernel asks.
#include "common.cuh"

namespace lumen {

constexpr int kGmmRows = 32;   // rows of a tile
constexpr int kGmmCols = 64;   // columns of a tile (a block's)
// K a step. 64 in fp16 (8 KB of w a step, as fp32's 32) ran slower: 0.206
// against 0.140 ms at the gate bank's 32 rows (chip_smoke.py phase 2, NVIDIA
// H100 80GB HBM3, 700 W).
constexpr int kGmmDepth = 32;
constexpr int kGmmThreads = 256;

// A 16-byte vector as fp32 values: 4 of fp32, 8 of fp16 (load8 of
// common.cuh).
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}
__device__ __forceinline__ void load_vec(const __half* p, float* out) { load8(p, out); }

template <typename T>
__global__ void __launch_bounds__(kGmmThreads)
    grouped_mm_kernel(const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ ends,
                      T* __restrict__ out, int n, int k, int m, int groups) {
  constexpr int VEC = 16 / sizeof(T);  // elements a 16-byte load
  constexpr int TM = kGmmRows, TN = kGmmCols, TK = kGmmDepth;
  static_assert(TK % VEC == 0 && TN % VEC == 0, "tiles of whole vectors");
  constexpr int XV = TM * TK / VEC, WV = TK * TN / VEC;  // 16-byte vectors of a step's x and w tiles
  constexpr int XPT = (XV + kGmmThreads - 1) / kGmmThreads, WPT = (WV + kGmmThreads - 1) / kGmmThreads;
  __shared__ __align__(16) float sx[TK][TM + 4];  // x tile, transposed: sx[kk][row]
  __shared__ __align__(16) float sw[TK][TN];
  const int tid = threadIdx.x;
  const int g = blockIdx.y;
  const int n0 = blockIdx.x * TN;
  const int last = min(ends[groups - 1], n);
  if (g == groups) {  // the rows past the last group end
    for (int i = tid; i < (n - last) * TN; i += kGmmThreads) {
      const int r = last + i / TN, c = n0 + i % TN;
      if (c < m) out[(size_t)r * m + c] = from_f<T>(0.f);
    }
    return;
  }
  const int start = g == 0 ? 0 : min(ends[g - 1], n);
  const int end = min(ends[g], n);
  if (start >= end) return;
  const T* wg = w + (size_t)g * k * m;
  const int tr = tid / (TN / 4), tc = tid % (TN / 4);  // 2 rows x 4 columns a thread
  float fx[XPT][VEC], fw[WPT][VEC];  // the next step's vectors, in flight while this step computes
  for (int r0 = start; r0 < end; r0 += TM) {
    // x rows r0.., K k0.. (a vector of one row's K), zero past the
    // group's rows and past K (K is a multiple of VEC); w rows k0..,
    // columns n0.. (a vector of one row's columns).
    auto fetch = [&](int k0) {
#pragma unroll
      for (int j = 0; j < XPT; ++j) {
        const int i = tid + j * kGmmThreads, r = i / (TK / VEC), kk = (i % (TK / VEC)) * VEC;
        if (i < XV && r0 + r < end && k0 + kk < k) {
          load_vec(x + (size_t)(r0 + r) * k + k0 + kk, fx[j]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) fx[j][e] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < WPT; ++j) {
        const int i = tid + j * kGmmThreads, kk = i / (TN / VEC), c = (i % (TN / VEC)) * VEC;
        if (i < WV && k0 + kk < k && n0 + c < m) {
          load_vec(wg + (size_t)(k0 + kk) * m + n0 + c, fw[j]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) fw[j][e] = 0.f;
        }
      }
    };
    // Only the warps whose rows hold a live one compute (a decode step's
    // group is a row or two of the 32); every thread loads.
    const bool live = r0 + 2 * tr < end;
    float acc[2][4] = {};
    fetch(0);
    for (int k0 = 0; k0 < k; k0 += TK) {
      __syncthreads();  // every warp is done with the previous step's tiles
#pragma unroll
      for (int j = 0; j < XPT; ++j) {
        const int i = tid + j * kGmmThreads, r = i / (TK / VEC), kk = (i % (TK / VEC)) * VEC;
        if (i < XV) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) sx[kk + e][r] = fx[j][e];
        }
      }
#pragma unroll
      for (int j = 0; j < WPT; ++j) {
        const int i = tid + j * kGmmThreads, kk = i / (TN / VEC), c = (i % (TN / VEC)) * VEC;
        if (i < WV) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) sw[kk][c + e] = fw[j][e];
        }
      }
      __syncthreads();
      if (k0 + TK < k) fetch(k0 + TK);
      if (live) {
#pragma unroll 8
        for (int kk = 0; kk < TK; ++kk) {
          const float2 a = *reinterpret_cast<const float2*>(&sx[kk][2 * tr]);
          const float4 b = *reinterpret_cast<const float4*>(&sw[kk][4 * tc]);
          acc[0][0] = fmaf(a.x, b.x, acc[0][0]);
          acc[0][1] = fmaf(a.x, b.y, acc[0][1]);
          acc[0][2] = fmaf(a.x, b.z, acc[0][2]);
          acc[0][3] = fmaf(a.x, b.w, acc[0][3]);
          acc[1][0] = fmaf(a.y, b.x, acc[1][0]);
          acc[1][1] = fmaf(a.y, b.y, acc[1][1]);
          acc[1][2] = fmaf(a.y, b.z, acc[1][2]);
          acc[1][3] = fmaf(a.y, b.w, acc[1][3]);
        }
      }
    }
    __syncthreads();  // the next row tile's first stores wait for this one's last reads
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 2 * tr + i;
      if (r >= end) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + 4 * tc + j;
        if (c < m) out[(size_t)r * m + c] = from_f<T>(acc[i][j]);
      }
    }
  }
}

template <typename T>
int launch_grouped_mm(const void* x, const void* w, const int* ends, void* out, int n, int k, int m,
                      int groups, cudaStream_t s) {
  const dim3 grid((m + kGmmCols - 1) / kGmmCols, groups + 1);
  grouped_mm_kernel<T><<<grid, kGmmThreads, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(w), ends,
                                                    static_cast<T*>(out), n, k, m, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lumen

// Plain C entry point (loaded through ctypes). Returns the launch's
// cudaGetLastError() code, 0 on success. dtype fp16 or fp32 (bf16 runs
// torch._grouped_mm); K and M multiples of a 16-byte vector, at least
// one group, fewer than 65535.
extern "C" int lumen_grouped_mm(const void* x, const void* w, const int* ends, void* out, int n, int k, int m,
                                int groups, int dtype, void* stream) {
  using namespace lumen;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 0 || k < 1 || m < 1 || groups < 1 || groups >= 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  if (dtype == kFloat16 && k % 8 == 0 && m % 8 == 0)
    return launch_grouped_mm<__half>(x, w, ends, out, n, k, m, groups, s);
  if (dtype == kFloat32 && k % 4 == 0 && m % 4 == 0)
    return launch_grouped_mm<float>(x, w, ends, out, n, k, m, groups, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
