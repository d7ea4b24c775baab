// Native resize for the data loader: an aspect-kept resize of decoded RGB
// pixels into the top left of a square canvas padded with 114. Python
// binds it through ctypes (data/native_loader.py), whose threads decode
// each image with cv2 and call ryt_resize_pad (ctypes drops the GIL for
// the call, so the threads resize in parallel).
//
// The resize is the JAX package's native loader's (native/loader.cpp), byte
// for byte: box filter to shrink, bilinear to grow.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 loader.cpp -o libryloader.so

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr uint8_t kPad = 114;

// ---------------------------------------------------------------------------
// resize + pad
// ---------------------------------------------------------------------------

// Box-filter (area) downscale / bilinear upscale of the sh x sw x 3 pixels
// into the top left of the S x S canvas, which the caller has filled with
// kPad; hw gets (nh, nw).
void resize_pad(const uint8_t* src, int sh, int sw, int S, uint8_t* canvas,
                float* hw) {
  const double r = double(S) / std::max(sh, sw);
  const int nh = std::max(1, int(sh * r));
  const int nw = std::max(1, int(sw * r));
  hw[0] = float(nh);
  hw[1] = float(nw);

  for (int y = 0; y < nh; ++y) {
    uint8_t* dst_row = canvas + size_t(y) * S * 3;
    if (r < 1.0) {
      // area: average the source box [y0,y1) x [x0,x1)
      const double sy0 = y / r, sy1 = (y + 1) / r;
      const int iy0 = int(sy0), iy1 = std::min(int(sy1 + 0.9999), sh);
      for (int x = 0; x < nw; ++x) {
        const double sx0 = x / r, sx1 = (x + 1) / r;
        const int ix0 = int(sx0), ix1 = std::min(int(sx1 + 0.9999), sw);
        int acc[3] = {0, 0, 0};
        int cnt = 0;
        for (int yy = iy0; yy < iy1; ++yy) {
          const uint8_t* p = src + (size_t(yy) * sw + ix0) * 3;
          for (int xx = ix0; xx < ix1; ++xx, p += 3) {
            acc[0] += p[0];
            acc[1] += p[1];
            acc[2] += p[2];
            ++cnt;
          }
        }
        if (cnt == 0) cnt = 1;
        dst_row[x * 3 + 0] = uint8_t(acc[0] / cnt);
        dst_row[x * 3 + 1] = uint8_t(acc[1] / cnt);
        dst_row[x * 3 + 2] = uint8_t(acc[2] / cnt);
      }
    } else {
      // bilinear
      const double sy = std::min((y + 0.5) / r - 0.5, double(sh - 1));
      const int y0 = std::max(0, int(sy));
      const int y1 = std::min(y0 + 1, sh - 1);
      const double fy = std::max(0.0, sy - y0);
      for (int x = 0; x < nw; ++x) {
        const double sx = std::min((x + 0.5) / r - 0.5, double(sw - 1));
        const int x0 = std::max(0, int(sx));
        const int x1 = std::min(x0 + 1, sw - 1);
        const double fx = std::max(0.0, sx - x0);
        for (int c = 0; c < 3; ++c) {
          const double v00 = src[(size_t(y0) * sw + x0) * 3 + c];
          const double v01 = src[(size_t(y0) * sw + x1) * 3 + c];
          const double v10 = src[(size_t(y1) * sw + x0) * 3 + c];
          const double v11 = src[(size_t(y1) * sw + x1) * 3 + c];
          dst_row[x * 3 + c] = uint8_t(
              (v00 * (1 - fx) + v01 * fx) * (1 - fy) +
              (v10 * (1 - fx) + v11 * fx) * fy + 0.5);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// pixels the caller decoded (h x w x 3 RGB, rows packed) resized and padded
// into the S x S x 3 canvas; hw gets (nh, nw)
void ryt_resize_pad(const uint8_t* rgb, int h, int w, int img_size,
                    uint8_t* canvas, float* hw) {
  memset(canvas, kPad, size_t(img_size) * img_size * 3);
  resize_pad(rgb, h, w, img_size, canvas, hw);
}

}  // extern "C"
