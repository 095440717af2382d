// The PyTorch port's own copy of ai_font_renderer_tpu/fontgen/native/rasterizer.cpp, code unchanged.
// Native batched glyph rasterizer — the repo's first-party native component.
//
// Replaces the reference's only native dependency (node-canvas/Cairo doing TTF
// rasterization behind generate_font.ts:100-141) with a standalone C++
// implementation of the analytic signed-area accumulation rasterizer. The
// Python module `raster.py` implements the identical math and serves as the
// correctness oracle in tests; this file exists for throughput: baking
// thousands of subpixel phase variants (and later, full-Unicode SDF atlases)
// in milliseconds instead of minutes.
//
// Exposed C ABI (consumed via ctypes from `native.py`):
//   rasterize_batch(segments[M*4], item_offsets[N+1], N, width, height,
//                   out[N*height*width])
// Each item i owns segments [item_offsets[i], item_offsets[i+1]) given as
// (x0, y0, x1, y1) in device pixel coordinates (y-down). Output is analytic
// coverage in [0, 1], one (height, width) float32 image per item.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Deposit one segment's signed area deltas into acc (h rows, w+1 cols).
void accumulate(float* acc, int w, int h, float x0, float y0, float x1,
                float y1) {
  if (y0 == y1) return;
  float sign = 1.0f;
  if (y0 > y1) {
    sign = -1.0f;
    std::swap(x0, x1);
    std::swap(y0, y1);
  }
  const float dxdy = (x1 - x0) / (y1 - y0);
  const float y_top = std::max(0.0f, y0);
  const float y_bot = std::min(static_cast<float>(h), y1);
  if (y_top >= y_bot) return;
  const int iy0 = static_cast<int>(std::floor(y_top));
  const int iy1 = static_cast<int>(std::ceil(y_bot));
  for (int iy = iy0; iy < iy1; ++iy) {
    const float ya = std::max(y_top, static_cast<float>(iy));
    const float yb = std::min(y_bot, static_cast<float>(iy + 1));
    float dy = yb - ya;
    if (dy <= 0.0f) continue;
    float xa = x0 + (ya - y0) * dxdy;
    float xb = x0 + (yb - y0) * dxdy;
    if (xa > xb) std::swap(xa, xb);
    float* row = acc + static_cast<size_t>(iy) * (w + 1);
    if (xb <= 0.0f) {
      row[0] += sign * dy;
      continue;
    }
    if (xa >= static_cast<float>(w)) continue;
    if (xa < 0.0f) {
      const float frac = xb > xa ? (0.0f - xa) / (xb - xa) : 1.0f;
      row[0] += sign * dy * frac;
      dy *= 1.0f - frac;
      xa = 0.0f;
    }
    if (xb > static_cast<float>(w)) {
      const float frac = xb > xa ? (xb - static_cast<float>(w)) / (xb - xa) : 0.0f;
      dy *= 1.0f - frac;
      xb = static_cast<float>(w);
    }
    if (dy <= 0.0f) continue;
    const int ix0 = static_cast<int>(std::floor(xa));
    const int ix1 = static_cast<int>(std::floor(xb));
    if (ix0 == ix1) {
      const float xm = (xa + xb) * 0.5f - ix0;
      row[ix0] += sign * dy * (1.0f - xm);
      row[ix0 + 1] += sign * dy * xm;
    } else {
      const float inv_dx = 1.0f / (xb - xa);
      const float xe = static_cast<float>(ix0 + 1);
      const float dy_first = dy * (xe - xa) * inv_dx;
      float xm = (xa + xe) * 0.5f - ix0;
      row[ix0] += sign * dy_first * (1.0f - xm);
      row[ix0 + 1] += sign * dy_first * xm;
      const float dy_cell = dy * inv_dx;
      for (int ix = ix0 + 1; ix < ix1; ++ix) {
        row[ix] += sign * dy_cell * 0.5f;
        row[ix + 1] += sign * dy_cell * 0.5f;
      }
      const float dy_last = dy * (xb - static_cast<float>(ix1)) * inv_dx;
      if (dy_last > 0.0f) {
        xm = (static_cast<float>(ix1) + xb) * 0.5f - ix1;
        row[ix1] += sign * dy_last * (1.0f - xm);
        row[ix1 + 1] += sign * dy_last * xm;
      }
    }
  }
}

}  // namespace

extern "C" {

// Rasterize N independent items sharing one segment pool.
void rasterize_batch(const float* segments, const int64_t* item_offsets,
                     int64_t n_items, int32_t width, int32_t height,
                     float* out) {
  std::vector<float> acc(static_cast<size_t>(height) * (width + 1));
  for (int64_t i = 0; i < n_items; ++i) {
    std::memset(acc.data(), 0, acc.size() * sizeof(float));
    for (int64_t s = item_offsets[i]; s < item_offsets[i + 1]; ++s) {
      const float* seg = segments + 4 * s;
      accumulate(acc.data(), width, height, seg[0], seg[1], seg[2], seg[3]);
    }
    float* img = out + static_cast<size_t>(i) * height * width;
    for (int32_t y = 0; y < height; ++y) {
      const float* row = acc.data() + static_cast<size_t>(y) * (width + 1);
      float running = 0.0f;
      for (int32_t x = 0; x < width; ++x) {
        running += row[x];
        img[static_cast<size_t>(y) * width + x] =
            std::min(1.0f, std::fabs(running));
      }
    }
  }
}

}  // extern "C"
