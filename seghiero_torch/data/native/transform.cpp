// Native transform core for the port's host-side input pipeline: the
// port's own copy of seghiero_tpu/data/native/transform.cpp, the same
// loops in the same arithmetic order.
//
// Called through ctypes from seghiero_torch/data/native/__init__.py, which
// builds this file with `g++ -O3 -ffp-contract=off` (no -march=native): a
// host that has FMA would otherwise contract the bilinear blend, and its
// bytes would differ from the plain NumPy versions beside the bindings.
// Threading comes from the loader's thread pool: ctypes releases the GIL
// around these plain C calls.
//
// Conventions:
//   * bilinear: half-pixel centers, edge clamp, no antialias
//     (= torch F.interpolate(align_corners=False)), float32 throughout,
//     rounded by (int)(v + 0.5f)
//   * nearest (masks): src = floor(dst * in / out)
//   * lut_remap: 255-safe (out-of-range ids -> ignore)

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// uint8 HWC bilinear resize, half-pixel convention, C channels
void resize_bilinear_u8(const uint8_t* src, int sh, int sw, int ch,
                        uint8_t* dst, int dh, int dw) {
  const float scale_y = (float)sh / dh;
  const float scale_x = (float)sw / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * scale_y - 0.5f;
    int y0 = (int)fy - (fy < 0 ? 1 : 0);  // floor
    float ty = fy - y0;
    int y0c = std::min(std::max(y0, 0), sh - 1);
    int y1c = std::min(std::max(y0 + 1, 0), sh - 1);
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * scale_x - 0.5f;
      int x0 = (int)fx - (fx < 0 ? 1 : 0);
      float tx = fx - x0;
      int x0c = std::min(std::max(x0, 0), sw - 1);
      int x1c = std::min(std::max(x0 + 1, 0), sw - 1);
      const uint8_t* p00 = src + (y0c * sw + x0c) * ch;
      const uint8_t* p01 = src + (y0c * sw + x1c) * ch;
      const uint8_t* p10 = src + (y1c * sw + x0c) * ch;
      const uint8_t* p11 = src + (y1c * sw + x1c) * ch;
      uint8_t* out = dst + (y * dw + x) * ch;
      for (int c = 0; c < ch; ++c) {
        float v = (1 - ty) * ((1 - tx) * p00[c] + tx * p01[c]) +
                  ty * ((1 - tx) * p10[c] + tx * p11[c]);
        int iv = (int)(v + 0.5f);
        out[c] = (uint8_t)std::min(std::max(iv, 0), 255);
      }
    }
  }
}

// int32 nearest resize (label maps): src index = floor(dst * in / out)
void resize_nearest_i32(const int32_t* src, int sh, int sw,
                        int32_t* dst, int dh, int dw) {
  for (int y = 0; y < dh; ++y) {
    int sy = (int)((int64_t)y * sh / dh);
    const int32_t* row = src + (int64_t)sy * sw;
    int32_t* orow = dst + (int64_t)y * dw;
    for (int x = 0; x < dw; ++x) orow[x] = row[(int)((int64_t)x * sw / dw)];
  }
}

// horizontal flip, uint8 HWC
void hflip_u8(const uint8_t* src, int h, int w, int ch, uint8_t* dst) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = src + (int64_t)y * w * ch;
    uint8_t* orow = dst + (int64_t)y * w * ch;
    for (int x = 0; x < w; ++x)
      std::memcpy(orow + (int64_t)x * ch, row + (int64_t)(w - 1 - x) * ch, ch);
  }
}

void hflip_i32(const int32_t* src, int h, int w, int32_t* dst) {
  for (int y = 0; y < h; ++y) {
    const int32_t* row = src + (int64_t)y * w;
    int32_t* orow = dst + (int64_t)y * w;
    for (int x = 0; x < w; ++x) orow[x] = row[w - 1 - x];
  }
}

// 255-safe LUT remap: ids outside [0, n_lut) map to `ignore`
void lut_remap_i32(const int32_t* src, int64_t n, const int32_t* lut,
                   int n_lut, int32_t ignore, int32_t* dst) {
  for (int64_t i = 0; i < n; ++i) {
    int32_t v = src[i];
    dst[i] = (v >= 0 && v < n_lut) ? lut[v] : ignore;
  }
}

}  // extern "C"
