// lumen-tpu native host ops (the port's copy of lumen_tpu/native/_src/host_ops.cpp).
//
// The TPU compute path is JAX/XLA; this library covers the host side of the
// serving hot loops — the per-image CV work that runs between gRPC and the
// device call (letterbox/resize, NMS, CTC collapse). The reference delegates
// this to OpenCV/numpy from Python (SURVEY.md §2.2-2.6); here it is a
// self-contained C core invoked through ctypes, GIL-free so the ingest
// pipeline's worker threads scale across cores.
//
// Build: lumen_tpu_torch/native/__init__.py runs g++ -O2 -shared -fPIC at
// first use. No dependencies.
//
// All image buffers are uint8 HWC, C-contiguous.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Bilinear resize, uint8 HWC. Pixel-center alignment (matches
// cv2.INTER_LINEAR up to rounding):  src = (dst + 0.5) * scale - 0.5
// ---------------------------------------------------------------------------
void resize_bilinear_u8(const uint8_t* src, int sh, int sw, int channels,
                        uint8_t* dst, int dh, int dw) {
  if (sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0 || channels <= 0) return;
  const double scale_y = static_cast<double>(sh) / dh;
  const double scale_x = static_cast<double>(sw) / dw;
  std::vector<int> x0s(dw), x1s(dw);
  std::vector<float> fxs(dw);
  for (int x = 0; x < dw; ++x) {
    double fx = (x + 0.5) * scale_x - 0.5;
    int x0 = static_cast<int>(std::floor(fx));
    float t = static_cast<float>(fx - x0);
    if (x0 < 0) { x0 = 0; t = 0.f; }
    int x1 = x0 + 1;
    if (x1 >= sw) { x1 = sw - 1; t = (x0 >= sw - 1) ? 0.f : t; x0 = std::min(x0, sw - 1); }
    x0s[x] = x0; x1s[x] = x1; fxs[x] = t;
  }
  for (int y = 0; y < dh; ++y) {
    double fy = (y + 0.5) * scale_y - 0.5;
    int y0 = static_cast<int>(std::floor(fy));
    float ty = static_cast<float>(fy - y0);
    if (y0 < 0) { y0 = 0; ty = 0.f; }
    int y1 = y0 + 1;
    if (y1 >= sh) { y1 = sh - 1; ty = (y0 >= sh - 1) ? 0.f : ty; y0 = std::min(y0, sh - 1); }
    const uint8_t* row0 = src + static_cast<size_t>(y0) * sw * channels;
    const uint8_t* row1 = src + static_cast<size_t>(y1) * sw * channels;
    uint8_t* out = dst + static_cast<size_t>(y) * dw * channels;
    for (int x = 0; x < dw; ++x) {
      const int x0 = x0s[x] * channels, x1 = x1s[x] * channels;
      const float tx = fxs[x];
      for (int c = 0; c < channels; ++c) {
        const float top = row0[x0 + c] + tx * (row0[x1 + c] - row0[x0 + c]);
        const float bot = row1[x0 + c] + tx * (row1[x1 + c] - row1[x0 + c]);
        const float v = top + ty * (bot - top);
        out[x * channels + c] = static_cast<uint8_t>(std::lround(std::min(255.f, std::max(0.f, v))));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Fused letterbox: aspect-preserving resize into a target x target canvas
// with centered padding, one pass, no intermediate buffer. Geometry matches
// lumen_tpu_torch.ops.image.letterbox_params. Returns scale/pads via out-params.
// ---------------------------------------------------------------------------
void letterbox_u8(const uint8_t* src, int sh, int sw, int channels,
                  uint8_t* dst, int target, int fill,
                  double* out_scale, int* out_pad_top, int* out_pad_left) {
  const double scale = std::min(static_cast<double>(target) / sh,
                                static_cast<double>(target) / sw);
  // nearbyint (round-half-even under the default FP environment) matches
  // Python's round() in letterbox_params; lround's half-away-from-zero
  // would shift content by one row on exact .5 products.
  const int new_h = static_cast<int>(std::nearbyint(sh * scale));
  const int new_w = static_cast<int>(std::nearbyint(sw * scale));
  const int pad_top = (target - new_h) / 2;
  const int pad_left = (target - new_w) / 2;
  std::memset(dst, fill, static_cast<size_t>(target) * target * channels);
  std::vector<uint8_t> resized(static_cast<size_t>(new_h) * new_w * channels);
  resize_bilinear_u8(src, sh, sw, channels, resized.data(), new_h, new_w);
  for (int y = 0; y < new_h; ++y) {
    std::memcpy(dst + (static_cast<size_t>(pad_top + y) * target + pad_left) * channels,
                resized.data() + static_cast<size_t>(y) * new_w * channels,
                static_cast<size_t>(new_w) * channels);
  }
  if (out_scale) *out_scale = scale;
  if (out_pad_top) *out_pad_top = pad_top;
  if (out_pad_left) *out_pad_left = pad_left;
}

// ---------------------------------------------------------------------------
// Greedy IoU NMS. boxes: [n,4] float32 x1y1x2y2. Writes kept original
// indices (descending score) to out_keep; returns kept count. Semantics
// match lumen_tpu_torch.ops.nms.nms_numpy (IoU > threshold suppressed,
// denominator clamped at 1e-9).
// ---------------------------------------------------------------------------
int nms_f32(const float* boxes, const float* scores, int n,
            float iou_threshold, int64_t* out_keep) {
  if (n <= 0) return 0;
  std::vector<int> order(n);
  for (int i = 0; i < n; ++i) order[i] = i;
  // Tie-break on HIGHER index first: numpy's argsort()[::-1] (the fallback
  // in ops/nms.py) reverses a stable ascending sort, so equal scores come
  // out in descending index order — match it exactly.
  std::sort(order.begin(), order.end(), [&](int a, int b) {
    return scores[a] != scores[b] ? scores[a] > scores[b] : a > b;
  });
  std::vector<float> areas(n);
  for (int i = 0; i < n; ++i) {
    const float* b = boxes + 4 * i;
    areas[i] = std::max(b[2] - b[0], 0.f) * std::max(b[3] - b[1], 0.f);
  }
  std::vector<char> removed(n, 0);
  int kept = 0;
  for (int oi = 0; oi < n; ++oi) {
    const int i = order[oi];
    if (removed[i]) continue;
    out_keep[kept++] = i;
    const float* bi = boxes + 4 * i;
    for (int oj = oi + 1; oj < n; ++oj) {
      const int j = order[oj];
      if (removed[j]) continue;
      const float* bj = boxes + 4 * j;
      const float xx1 = std::max(bi[0], bj[0]);
      const float yy1 = std::max(bi[1], bj[1]);
      const float xx2 = std::min(bi[2], bj[2]);
      const float yy2 = std::min(bi[3], bj[3]);
      const float inter = std::max(xx2 - xx1, 0.f) * std::max(yy2 - yy1, 0.f);
      const float denom = std::max(areas[i] + areas[j] - inter, 1e-9f);
      if (inter / denom > iou_threshold) removed[j] = 1;
    }
  }
  return kept;
}

// ---------------------------------------------------------------------------
// CTC greedy collapse for a batch: drop repeats, drop blanks. For each
// sequence, writes emitted symbol ids and their confidences; returns counts.
// ids: [batch, t] int32; confs: [batch, t] float32.
// out_ids/out_confs: [batch, t]; out_counts: [batch].
// Semantics match lumen_tpu_torch.ops.ctc.ctc_collapse (emit when id != blank and
// id != previous id; confidence of the emitting timestep).
// ---------------------------------------------------------------------------
void ctc_collapse_batch(const int32_t* ids, const float* confs, int batch,
                        int t, int32_t blank, int32_t* out_ids,
                        float* out_confs, int32_t* out_counts) {
  for (int b = 0; b < batch; ++b) {
    const int32_t* seq = ids + static_cast<size_t>(b) * t;
    const float* conf = confs + static_cast<size_t>(b) * t;
    int32_t* oid = out_ids + static_cast<size_t>(b) * t;
    float* oconf = out_confs + static_cast<size_t>(b) * t;
    int count = 0;
    int32_t prev = -1;
    for (int step = 0; step < t; ++step) {
      const int32_t id = seq[step];
      if (id != blank && id != prev) {
        oid[count] = id;
        oconf[count] = conf[step];
        ++count;
      }
      prev = id;
    }
    out_counts[b] = count;
  }
}

// Version tag so the loader can detect stale builds.
int lumen_host_ops_abi_version() { return 1; }

}  // extern "C"
