// cv — native image preprocessing for inference serving.
//
// A copy of paddle_lite_tpu/native/cv.cc (the same functions and the same
// arithmetic, so the port's binding gives the reference binding's bytes),
// itself a re-design of Paddle-Lite's NEON CV library (``lite/utils/cv/``:
// image_convert.cc, image_resize.cc, image_rotate.cc, image_flip.cc,
// image2tensor.cc, shipped as ``paddle_lite_cv``).  Preprocessing runs on
// the serving host's CPU ahead of the card's feed: plain tight loops
// compiled -O3 (auto-vectorized); the card never sees uint8 camera
// formats.
//
// All functions use a C ABI over caller-allocated uint8/float buffers
// (HWC layout), bound via ctypes in paddle_lite_tpu_torch/cv/preprocess.py
// and built by paddle_lite_tpu_torch/native/build.py.

#include <algorithm>
#include <cstdint>
#include <cstring>

namespace {

inline uint8_t clamp_u8(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

}  // namespace

extern "C" {

// ---- color conversion -----------------------------------------------------
// NV12/NV21: full-res Y plane then interleaved half-res UV (NV12: U first).
// BT.601 integer math, matching the reference's nv-to-bgr kernels.
void cv_nv_to_rgb(const uint8_t* y_plane, const uint8_t* uv_plane,
                  int height, int width, int is_nv21, uint8_t* rgb_out) {
  for (int r = 0; r < height; ++r) {
    const uint8_t* yrow = y_plane + r * width;
    const uint8_t* uvrow = uv_plane + (r / 2) * width;
    uint8_t* out = rgb_out + r * width * 3;
    for (int c = 0; c < width; ++c) {
      int yv = yrow[c];
      int u = uvrow[(c / 2) * 2 + (is_nv21 ? 1 : 0)] - 128;
      int v = uvrow[(c / 2) * 2 + (is_nv21 ? 0 : 1)] - 128;
      int rr = yv + ((v * 359) >> 8);
      int gg = yv - ((u * 88 + v * 183) >> 8);
      int bb = yv + ((u * 454) >> 8);
      out[c * 3 + 0] = clamp_u8(rr);
      out[c * 3 + 1] = clamp_u8(gg);
      out[c * 3 + 2] = clamp_u8(bb);
    }
  }
}

void cv_bgr_rgb_swap(const uint8_t* in, int height, int width, uint8_t* out) {
  const int64_t n = static_cast<int64_t>(height) * width;
  for (int64_t i = 0; i < n; ++i) {
    out[i * 3 + 0] = in[i * 3 + 2];
    out[i * 3 + 1] = in[i * 3 + 1];
    out[i * 3 + 2] = in[i * 3 + 0];
  }
}

// ---- resize ---------------------------------------------------------------
// Bilinear, HWC uint8, arbitrary channel count (1/3/4).
void cv_resize_bilinear(const uint8_t* in, int ih, int iw, int channels,
                        int oh, int ow, uint8_t* out) {
  const float sh = static_cast<float>(ih) / oh;
  const float sw = static_cast<float>(iw) / ow;
  for (int r = 0; r < oh; ++r) {
    float fy = (r + 0.5f) * sh - 0.5f;
    int y0 = static_cast<int>(fy < 0 ? 0 : fy);
    y0 = std::min(y0, ih - 1);
    int y1 = std::min(y0 + 1, ih - 1);
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    for (int c = 0; c < ow; ++c) {
      float fx = (c + 0.5f) * sw - 0.5f;
      int x0 = static_cast<int>(fx < 0 ? 0 : fx);
      x0 = std::min(x0, iw - 1);
      int x1 = std::min(x0 + 1, iw - 1);
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      for (int ch = 0; ch < channels; ++ch) {
        float v00 = in[(y0 * iw + x0) * channels + ch];
        float v01 = in[(y0 * iw + x1) * channels + ch];
        float v10 = in[(y1 * iw + x0) * channels + ch];
        float v11 = in[(y1 * iw + x1) * channels + ch];
        float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                  v10 * wy * (1 - wx) + v11 * wy * wx;
        out[(r * ow + c) * channels + ch] = clamp_u8(static_cast<int>(v + 0.5f));
      }
    }
  }
}

// ---- rotate / flip --------------------------------------------------------
// degree in {90, 180, 270}; out must be sized for the rotated dims.
void cv_rotate(const uint8_t* in, int h, int w, int channels, int degree,
               uint8_t* out) {
  for (int r = 0; r < h; ++r) {
    for (int c = 0; c < w; ++c) {
      int orr, occ, ow_;
      if (degree == 90) {
        orr = c; occ = h - 1 - r; ow_ = h;
      } else if (degree == 180) {
        orr = h - 1 - r; occ = w - 1 - c; ow_ = w;
      } else {  // 270
        orr = w - 1 - c; occ = r; ow_ = h;
      }
      std::memcpy(out + (orr * ow_ + occ) * channels,
                  in + (r * w + c) * channels, channels);
    }
  }
}

// axis: 0 = vertical (up-down), 1 = horizontal (left-right), -1 = both
void cv_flip(const uint8_t* in, int h, int w, int channels, int axis,
             uint8_t* out) {
  for (int r = 0; r < h; ++r) {
    for (int c = 0; c < w; ++c) {
      int rr = (axis == 0 || axis == -1) ? h - 1 - r : r;
      int cc = (axis == 1 || axis == -1) ? w - 1 - c : c;
      std::memcpy(out + (rr * w + cc) * channels,
                  in + (r * w + c) * channels, channels);
    }
  }
}

// ---- image -> tensor ------------------------------------------------------
// uint8 HWC -> float32 HWC with per-channel (x/255 - mean) / std
// (image2tensor.cc analog; output feeds the NHWC device tensor directly).
void cv_image_to_tensor(const uint8_t* in, int h, int w, int channels,
                        const float* mean, const float* stddev,
                        float* out) {
  const int64_t n = static_cast<int64_t>(h) * w;
  for (int64_t i = 0; i < n; ++i) {
    for (int ch = 0; ch < channels; ++ch) {
      float v = in[i * channels + ch] * (1.0f / 255.0f);
      out[i * channels + ch] = (v - mean[ch]) / stddev[ch];
    }
  }
}

}  // extern "C"
