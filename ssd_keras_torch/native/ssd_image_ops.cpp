// Host image arithmetic of ssd_keras_torch's augmentation chains: resize,
// affine warp and colour conversion, one HWC image per call.
//
// Each entry is a C++ copy of the NumPy function named beside it in
// ssd_keras_torch/data/geometric.py and photometric.py (the plain versions,
// which compute what OpenCV 5 computes). The results are equal bit for bit:
// every sum runs in the NumPy function's order and accumulator type, each
// product and sum is rounded to that type on its own (built with
// -ffp-contract=off, so no multiply-add is fused), np.rint is
// std::nearbyint under the default rounding mode (half to even), and the
// per-tap indices and weights come in from Python, computed there as the
// NumPy functions compute them, so no sine or rounding is redone here.
//
// dtype codes: 0 uint8, 1 float32, 2 float64. uint8 images accumulate in
// float32 (or in integers where NumPy does); float images in their own type.
//
// Built at first use by native/image_ops.py with g++ -O3 -shared -fPIC
// -ffp-contract=off -fno-tree-vectorize (see IMAGE_OPS_FLAGS there for why),
// into ssd_keras_torch/_build/. One thread: no OpenMP.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <type_traits>
#include <vector>

namespace {

// np.clip(np.rint(v), 0, 255).astype(np.uint8). Inside (0, 255), adding and
// subtracting 2**23 rounds half to even as np.rint does (the float spacing
// there is 1), without a call to nearbyint.
inline uint8_t round_u8(float v) {
  if (!(v > 0.0f)) return 0;
  if (v >= 255.0f) return 255;
  return static_cast<uint8_t>((v + 8388608.0f) - 8388608.0f);
}

// np.floor(x).astype(np.int64): truncation, one down for a negative
// fraction; std::floor only outside the range an int64 holds exactly.
template <typename W>
inline int64_t floor_i64(W x) {
  if (x > W(-4.0e18) && x < W(4.0e18)) {
    const int64_t t = static_cast<int64_t>(x);
    return t - (W(t) > x ? 1 : 0);
  }
  return static_cast<int64_t>(std::floor(x));
}

// Runs f with the channel count as a compile-time constant for 1 and 3
// channels (0: any count, read at run time).
template <typename F>
inline void by_channels(int64_t c, F f) {
  if (c == 3)
    f(std::integral_constant<int, 3>());
  else if (c == 1)
    f(std::integral_constant<int, 1>());
  else
    f(std::integral_constant<int, 0>());
}

// The rows of the source that a vertical pass reads.
inline std::vector<char> rows_read(const int64_t* yi, int64_t n, int64_t h) {
  std::vector<char> need(static_cast<size_t>(h), 0);
  for (int64_t i = 0; i < n; ++i) need[yi[i]] = 1;
  return need;
}

template <typename T, typename A>
inline T store(A v) {
  return static_cast<T>(v);
}

template <>
inline uint8_t store<uint8_t, float>(float v) {
  return round_u8(v);
}

// ------------------------------------------------------------------------- //
// Resize
// ------------------------------------------------------------------------- //

// geometric.py:_nearest. A gather of whole pixels of `pixel_bytes` bytes.
void nearest(const uint8_t* src, int64_t w, int64_t pixel_bytes, const int64_t* ys,
             int64_t out_h, const int64_t* xs, int64_t out_w, uint8_t* dst) {
  for (int64_t oy = 0; oy < out_h; ++oy) {
    const uint8_t* row = src + ys[oy] * w * pixel_bytes;
    uint8_t* out = dst + oy * out_w * pixel_bytes;
    for (int64_t ox = 0; ox < out_w; ++ox)
      std::memcpy(out + ox * pixel_bytes, row + xs[ox] * pixel_bytes, pixel_bytes);
  }
}

// geometric.py:_linear on uint8: 11-bit weights, an int32 horizontal pass,
// the vertical pass ((b0 * (S0 >> 4)) >> 16 + (b1 * (S1 >> 4)) >> 16 + 2) >> 2.
template <int C>
void linear_u8(const uint8_t* src, int64_t h, int64_t w, int64_t c_any, const int64_t* x0,
               const int64_t* x1, const int32_t* a0, const int32_t* a1, int64_t out_w,
               const int64_t* y0, const int64_t* y1, const int32_t* b0, const int32_t* b1,
               int64_t out_h, uint8_t* dst) {
  const int64_t c = C > 0 ? C : c_any;
  const int64_t row_len = out_w * c;
  std::vector<int32_t> rows(static_cast<size_t>(h * row_len));
  std::vector<char> need = rows_read(y0, out_h, h), need1 = rows_read(y1, out_h, h);
  for (int64_t y = 0; y < h; ++y) {
    if (!need[y] && !need1[y]) continue;
    const uint8_t* s = src + y * w * c;
    int32_t* r = rows.data() + y * row_len;
    for (int64_t ox = 0; ox < out_w; ++ox) {
      const uint8_t* p0 = s + x0[ox] * c;
      const uint8_t* p1 = s + x1[ox] * c;
      for (int64_t ch = 0; ch < c; ++ch)
        r[ox * c + ch] = int32_t(p0[ch]) * a0[ox] + int32_t(p1[ch]) * a1[ox];
    }
  }
  for (int64_t oy = 0; oy < out_h; ++oy) {
    const int32_t* r0 = rows.data() + y0[oy] * row_len;
    const int32_t* r1 = rows.data() + y1[oy] * row_len;
    uint8_t* out = dst + oy * row_len;
    for (int64_t k = 0; k < row_len; ++k) {
      const int32_t top = (b0[oy] * (r0[k] >> 4)) >> 16;
      const int32_t bottom = (b1[oy] * (r1[k] >> 4)) >> 16;
      int32_t v = (top + bottom + 2) >> 2;
      out[k] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

// geometric.py:_separable (cubic, Lanczos on floats), _linear on floats (two
// taps, weights 1 - f and f) and the table path of _area_shrink
// (x_from_zero: the horizontal sum starts from 0 and adds every tap). Taps
// are (out, k) tables of clamped source indices and weights in A. The
// horizontal pass covers every source row, the vertical pass reads them.
template <typename T, typename A, int C>
void separable(const T* src, int64_t h, int64_t w, int64_t c_any, const int64_t* xi,
               const A* xw, int64_t kx, int64_t out_w, const int64_t* yi, const A* yw,
               int64_t ky, int64_t out_h, bool x_from_zero, T* dst) {
  const int64_t c = C > 0 ? C : c_any;
  constexpr int n = C > 0 ? C : 1;  // channels summed side by side
  const int64_t row_len = out_w * c;
  std::vector<A> rows(static_cast<size_t>(h * row_len));
  const std::vector<char> need = rows_read(yi, out_h * ky, h);
  for (int64_t y = 0; y < h; ++y) {
    if (!need[y]) continue;
    const T* s = src + y * w * c;
    A* r = rows.data() + y * row_len;
    for (int64_t ox = 0; ox < out_w; ++ox) {
      const int64_t* ix = xi + ox * kx;
      const A* wx = xw + ox * kx;
      for (int64_t ch = 0; ch < c; ch += n) {
        A acc[n];
        int64_t j = 0;
        if (x_from_zero) {
          for (int k = 0; k < n; ++k) acc[k] = A(0);
        } else {
          const T* p = s + ix[0] * c + ch;
          for (int k = 0; k < n; ++k) acc[k] = A(p[k]) * wx[0];
          j = 1;
        }
        for (; j < kx; ++j) {
          const T* p = s + ix[j] * c + ch;
          const A wj = wx[j];
          for (int k = 0; k < n; ++k) acc[k] = acc[k] + A(p[k]) * wj;
        }
        for (int k = 0; k < n; ++k) r[ox * c + ch + k] = acc[k];
      }
    }
  }
  std::vector<A> line(static_cast<size_t>(row_len));
  for (int64_t oy = 0; oy < out_h; ++oy) {
    const int64_t* iy = yi + oy * ky;
    const A* wy = yw + oy * ky;
    const A* r0 = rows.data() + iy[0] * row_len;
    for (int64_t k = 0; k < row_len; ++k) line[k] = r0[k] * wy[0];
    for (int64_t j = 1; j < ky; ++j) {
      const A* rj = rows.data() + iy[j] * row_len;
      const A wj = wy[j];
      for (int64_t k = 0; k < row_len; ++k) line[k] = line[k] + rj[k] * wj;
    }
    T* out = dst + oy * row_len;
    for (int64_t k = 0; k < row_len; ++k) out[k] = store<T, A>(line[k]);
  }
}

// geometric.py:_separable on uint8 with Lanczos4: OpenCV's 11-bit integer
// weights, sums exact in int64, then (total + (1 << 21)) >> 22.
template <int C>
void lanczos_u8(const uint8_t* src, int64_t h, int64_t w, int64_t c_any, const int64_t* xi,
                const int32_t* xw, int64_t kx, int64_t out_w, const int64_t* yi,
                const int32_t* yw, int64_t ky, int64_t out_h, uint8_t* dst) {
  const int64_t c = C > 0 ? C : c_any;
  constexpr int n = C > 0 ? C : 1;
  const int64_t row_len = out_w * c;
  std::vector<int64_t> rows(static_cast<size_t>(h * row_len));
  const std::vector<char> need = rows_read(yi, out_h * ky, h);
  for (int64_t y = 0; y < h; ++y) {
    if (!need[y]) continue;
    const uint8_t* s = src + y * w * c;
    int64_t* r = rows.data() + y * row_len;
    for (int64_t ox = 0; ox < out_w; ++ox) {
      const int64_t* ix = xi + ox * kx;
      const int32_t* wx = xw + ox * kx;
      for (int64_t ch = 0; ch < c; ch += n) {
        int64_t acc[n] = {};
        for (int64_t j = 0; j < kx; ++j) {
          const uint8_t* p = s + ix[j] * c + ch;
          const int64_t wj = wx[j];
          for (int k = 0; k < n; ++k) acc[k] += int64_t(p[k]) * wj;
        }
        for (int k = 0; k < n; ++k) r[ox * c + ch + k] = acc[k];
      }
    }
  }
  std::vector<int64_t> line(static_cast<size_t>(row_len));
  for (int64_t oy = 0; oy < out_h; ++oy) {
    const int64_t* iy = yi + oy * ky;
    const int32_t* wy = yw + oy * ky;
    std::fill(line.begin(), line.end(), 0);
    for (int64_t j = 0; j < ky; ++j) {
      const int64_t* rj = rows.data() + iy[j] * row_len;
      const int64_t wj = wy[j];
      for (int64_t k = 0; k < row_len; ++k) line[k] += rj[k] * wj;
    }
    uint8_t* out = dst + oy * row_len;
    for (int64_t k = 0; k < row_len; ++k) {
      const int64_t v = (line[k] + (int64_t(1) << 21)) >> 22;
      out[k] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

// geometric.py:_halve (halve) and the integer-factor path of _area_shrink:
// the mean of each iy x ix block. uint8: (sum + 2) >> 2 for the halving, else
// the int64 sum times float32(1 / (ix * iy)), rounded. Floats add the block
// row by row (from 0 on the area path, from the first pixel when halving)
// and multiply by T(1 / (ix * iy)).
template <typename T>
void block_mean(const T* src, int64_t w, int64_t c, int64_t iy, int64_t ix, int64_t out_h,
                int64_t out_w, bool halve, T* dst) {
  const T inv = T(1.0 / double(ix * iy));
  for (int64_t oy = 0; oy < out_h; ++oy)
    for (int64_t ox = 0; ox < out_w; ++ox)
      for (int64_t ch = 0; ch < c; ++ch) {
        const T* p = src + (oy * iy * w + ox * ix) * c + ch;
        T acc = halve ? p[0] : T(0) + p[0];
        for (int64_t a = 0; a < iy; ++a)
          for (int64_t b = (a == 0 ? 1 : 0); b < ix; ++b) acc = acc + p[(a * w + b) * c];
        dst[(oy * out_w + ox) * c + ch] = acc * inv;
      }
}

template <>
void block_mean<uint8_t>(const uint8_t* src, int64_t w, int64_t c, int64_t iy, int64_t ix,
                         int64_t out_h, int64_t out_w, bool halve, uint8_t* dst) {
  const float inv = float(1.0 / double(ix * iy));
  for (int64_t oy = 0; oy < out_h; ++oy)
    for (int64_t ox = 0; ox < out_w; ++ox)
      for (int64_t ch = 0; ch < c; ++ch) {
        const uint8_t* p = src + (oy * iy * w + ox * ix) * c + ch;
        int64_t total = 0;
        for (int64_t a = 0; a < iy; ++a)
          for (int64_t b = 0; b < ix; ++b) total += p[(a * w + b) * c];
        dst[(oy * out_w + ox) * c + ch] =
            halve ? static_cast<uint8_t>((total + 2) >> 2) : round_u8(float(total) * inv);
      }
}

// ------------------------------------------------------------------------- //
// Affine warp (geometric.py:warp_affine): INTER_LINEAR, constant border.
// ------------------------------------------------------------------------- //

// geometric.py:_fma: the product and the sum in double, one rounding to W
// at the end (for float32 the product is exact). Not std::fma.
template <typename W>
inline W fma_(W a, W b, W c) {
  return static_cast<W>(double(a) * double(b) + double(c));
}

template <typename T, typename W, int C>
void warp(const T* src, int64_t h, int64_t w, int64_t c_any, const W* inv, const W* border,
          int64_t out_h, int64_t out_w, T* dst) {
  const int64_t c = C > 0 ? C : c_any;
  std::vector<W> p(static_cast<size_t>(4 * c));
  for (int64_t oy = 0; oy < out_h; ++oy) {
    const W yv = W(oy);
    const W bx = inv[1] * yv + inv[2];
    const W by = inv[4] * yv + inv[5];
    for (int64_t ox = 0; ox < out_w; ++ox) {
      const W xv = W(ox);
      const W x = fma_(inv[0], xv, bx);
      const W y = fma_(inv[3], xv, by);
      const int64_t sx = floor_i64(x);
      const int64_t sy = floor_i64(y);
      const W ax = static_cast<W>(double(x) - double(sx));
      const W ay = static_cast<W>(double(y) - double(sy));
      // p00, p01, p10, p11: a neighbour outside the image takes the border.
      for (int n = 0; n < 4; ++n) {
        const int64_t yy = sy + (n >> 1), xx = sx + (n & 1);
        const bool inside = yy >= 0 && yy < h && xx >= 0 && xx < w;
        for (int64_t ch = 0; ch < c; ++ch)
          p[n * c + ch] = inside ? W(src[(yy * w + xx) * c + ch]) : border[ch];
      }
      T* out = dst + (oy * out_w + ox) * c;
      for (int64_t ch = 0; ch < c; ++ch) {
        const W p00 = p[ch], p01 = p[c + ch], p10 = p[2 * c + ch], p11 = p[3 * c + ch];
        const W top = fma_<W>(ax, p01 - p00, p00);
        const W bottom = fma_<W>(ax, p11 - p10, p10);
        out[ch] = store<T, W>(fma_<W>(ay, bottom - top, top));
      }
    }
  }
}

// ------------------------------------------------------------------------- //
// Colour conversion (photometric.py). RGB in, channels last, 3 channels.
// ------------------------------------------------------------------------- //

const int kHsvShift = 12;
const int kHsvBlock = 32;  // pixels per step of OpenCV's vector HSV2RGB loop
// Which of (v, p, q, t) is (b, g, r) in each 60-degree sector.
const int kSector[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1}, {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};

// np.maximum / np.minimum: a NaN in either operand is the result.
inline float nmax(float a, float b) { return (a >= b || a != a) ? a : b; }
inline float nmin(float a, float b) { return (a <= b || a != a) ? a : b; }

// photometric.py:_rgb_to_hsv_u8
void rgb_to_hsv_u8(const uint8_t* src, int64_t n, const int64_t* sdiv, const int64_t* hdiv,
                   uint8_t* dst) {
  // NumPy sums in int64; every term here fits int32 (|h * hdiv| < 2**28).
  const int32_t half = int32_t(1) << (kHsvShift - 1);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t r = src[3 * i], g = src[3 * i + 1], b = src[3 * i + 2];
    int32_t v = r > g ? r : g;
    v = v > b ? v : b;
    int32_t lo = r < g ? r : g;
    lo = lo < b ? lo : b;
    const int32_t diff = v - lo;
    const int32_t s = (diff * int32_t(sdiv[v]) + half) >> kHsvShift;
    int32_t h = v == r ? g - b : (v == g ? b - r + 2 * diff : r - g + 4 * diff);
    h = (h * int32_t(hdiv[diff]) + half) >> kHsvShift;
    if (h < 0) h += 180;
    dst[3 * i] = static_cast<uint8_t>(h);
    dst[3 * i + 1] = static_cast<uint8_t>(s);
    dst[3 * i + 2] = static_cast<uint8_t>(v);
  }
}

// photometric.py:_rgb_to_hsv_f32
void rgb_to_hsv_f32(const float* src, int64_t n, float* dst) {
  const float eps = 1.1920928955078125e-07f;  // np.finfo(np.float32).eps
  for (int64_t i = 0; i < n; ++i) {
    const float r = src[3 * i], g = src[3 * i + 1], b = src[3 * i + 2];
    const float v = nmax(nmax(r, g), b);
    const float diff = v - nmin(nmin(r, g), b);
    const float s = diff / (std::fabs(v) + eps);
    const float d = 60.0f / (diff + eps);
    float h = v == r ? (g - b) * d : (v == g ? (b - r) * d + 120.0f : (r - g) * d + 240.0f);
    if (h < 0) h = h + 360.0f;
    dst[3 * i] = h;
    dst[3 * i + 1] = s;
    dst[3 * i + 2] = v;
  }
}

// np.trunc of a float that is >= 0 and < 2**31 (the uint8 path's H).
inline float trunc_small(float x) { return static_cast<float>(static_cast<int32_t>(x)); }

// photometric.py:_hsv_sectors: (r, g, b) from H in sextants, S and V.
// fused: the q and t terms as _fma, and H in [0, 255] (the uint8 path);
// else plain products and any H.
template <bool fused>
inline void hsv_sectors(float h, float s, float v, float hscale, float* rgb) {
  const float hh = h * hscale;
  const float pre = fused ? trunc_small(hh) : std::trunc(hh);
  const float frac = hh - pre;
  const float sixth = pre * float(1.0 / 6.0);
  int64_t k = static_cast<int64_t>(pre - (fused ? trunc_small(sixth) : std::trunc(sixth)) * 6.0f) % 6;
  if (k < 0) k += 6;
  const float one = 1.0f;
  float tab[4];
  tab[0] = v;
  tab[1] = v * (one - s);
  if (fused) {
    tab[2] = v * fma_<float>(-s, frac, 1.0f);
    tab[3] = v * fma_<float>(-s, one - frac, 1.0f);
  } else {
    tab[2] = v * (one - s * frac);
    tab[3] = v * (one - s * (one - frac));
  }
  rgb[0] = tab[kSector[k][2]];
  rgb[1] = tab[kSector[k][1]];
  rgb[2] = tab[kSector[k][0]];
}

// photometric.py:_hsv_to_rgb_u8: truncated in OpenCV's 32-pixel vector
// blocks, rounded in the last width % 32 pixels of each row.
void hsv_to_rgb_u8(const uint8_t* src, int64_t h, int64_t w, uint8_t* dst) {
  const float scale = float(1.0 / 255.0);
  const float hscale = float(6.0 / 180.0);
  const int64_t tail = w - w % kHsvBlock;
  for (int64_t y = 0; y < h; ++y)
    for (int64_t x = 0; x < w; ++x) {
      const int64_t i = y * w + x;
      float rgb[3];
      hsv_sectors<true>(float(src[3 * i]), float(src[3 * i + 1]) * scale,
                        float(src[3 * i + 2]) * scale, hscale, rgb);
      // Each value is in [0, 255]: truncation is the floor.
      for (int ch = 0; ch < 3; ++ch) {
        const float value = rgb[ch] * 255.0f;
        dst[3 * i + ch] = x < tail ? static_cast<uint8_t>(value) : round_u8(value);
      }
    }
}

// photometric.py:_hsv_to_rgb_f32
void hsv_to_rgb_f32(const float* src, int64_t n, float* dst) {
  const float hscale = float(6.0 / 360.0);
  for (int64_t i = 0; i < n; ++i)
    hsv_sectors<false>(src[3 * i], src[3 * i + 1], src[3 * i + 2], hscale, dst + 3 * i);
}

// photometric.py:_rgb_to_gray
void rgb_to_gray_u8(const uint8_t* src, int64_t n, uint8_t* dst) {
  for (int64_t i = 0; i < n; ++i)
    dst[i] = static_cast<uint8_t>((int64_t(src[3 * i]) * 9798 + int64_t(src[3 * i + 1]) * 19235 +
                                   int64_t(src[3 * i + 2]) * 3735 + (1 << 14)) >> 15);
}

void rgb_to_gray_f32(const float* src, int64_t n, float* dst) {
  for (int64_t i = 0; i < n; ++i)
    dst[i] = src[3 * i] * float(0.299) + src[3 * i + 1] * float(0.587) + src[3 * i + 2] * float(0.114);
}

}  // namespace

extern "C" {

void ssd_resize_nearest(const void* src, int64_t w, int64_t pixel_bytes, const int64_t* ys,
                        int64_t out_h, const int64_t* xs, int64_t out_w, void* dst) {
  nearest(static_cast<const uint8_t*>(src), w, pixel_bytes, ys, out_h, xs, out_w,
          static_cast<uint8_t*>(dst));
}

void ssd_resize_linear_u8(const uint8_t* src, int64_t h, int64_t w, int64_t c, const int64_t* x0,
                          const int64_t* x1, const int32_t* a0, const int32_t* a1, int64_t out_w,
                          const int64_t* y0, const int64_t* y1, const int32_t* b0,
                          const int32_t* b1, int64_t out_h, uint8_t* dst) {
  by_channels(c, [&](auto k) {
    linear_u8<decltype(k)::value>(src, h, w, c, x0, x1, a0, a1, out_w, y0, y1, b0, b1, out_h,
                                  dst);
  });
}

// Weights are float32 for uint8 and float32 images, float64 for float64.
void ssd_resize_separable(int dtype, const void* src, int64_t h, int64_t w, int64_t c,
                          const int64_t* xi, const void* xw, int64_t kx, int64_t out_w,
                          const int64_t* yi, const void* yw, int64_t ky, int64_t out_h,
                          int x_from_zero, void* dst) {
  by_channels(c, [&](auto k) {
    constexpr int C = decltype(k)::value;
    if (dtype == 0)
      separable<uint8_t, float, C>(static_cast<const uint8_t*>(src), h, w, c, xi,
                                   static_cast<const float*>(xw), kx, out_w, yi,
                                   static_cast<const float*>(yw), ky, out_h, x_from_zero != 0,
                                   static_cast<uint8_t*>(dst));
    else if (dtype == 1)
      separable<float, float, C>(static_cast<const float*>(src), h, w, c, xi,
                                 static_cast<const float*>(xw), kx, out_w, yi,
                                 static_cast<const float*>(yw), ky, out_h, x_from_zero != 0,
                                 static_cast<float*>(dst));
    else
      separable<double, double, C>(static_cast<const double*>(src), h, w, c, xi,
                                   static_cast<const double*>(xw), kx, out_w, yi,
                                   static_cast<const double*>(yw), ky, out_h, x_from_zero != 0,
                                   static_cast<double*>(dst));
  });
}

void ssd_resize_lanczos_u8(const uint8_t* src, int64_t h, int64_t w, int64_t c, const int64_t* xi,
                           const int32_t* xw, int64_t kx, int64_t out_w, const int64_t* yi,
                           const int32_t* yw, int64_t ky, int64_t out_h, uint8_t* dst) {
  by_channels(c, [&](auto k) {
    lanczos_u8<decltype(k)::value>(src, h, w, c, xi, xw, kx, out_w, yi, yw, ky, out_h, dst);
  });
}

void ssd_resize_block_mean(int dtype, const void* src, int64_t w, int64_t c, int64_t iy,
                           int64_t ix, int64_t out_h, int64_t out_w, int halve, void* dst) {
  if (dtype == 0)
    block_mean<uint8_t>(static_cast<const uint8_t*>(src), w, c, iy, ix, out_h, out_w, halve != 0,
                        static_cast<uint8_t*>(dst));
  else if (dtype == 1)
    block_mean<float>(static_cast<const float*>(src), w, c, iy, ix, out_h, out_w, halve != 0,
                      static_cast<float*>(dst));
  else
    block_mean<double>(static_cast<const double*>(src), w, c, iy, ix, out_h, out_w, halve != 0,
                       static_cast<double*>(dst));
}

// inv: the inverted map's six values and border: c values, both in the work
// type (float32 for uint8 and float32 images, float64 for float64).
void ssd_warp_affine(int dtype, const void* src, int64_t h, int64_t w, int64_t c, const void* inv,
                     const void* border, int64_t out_h, int64_t out_w, void* dst) {
  by_channels(c, [&](auto k) {
    constexpr int C = decltype(k)::value;
    if (dtype == 0)
      warp<uint8_t, float, C>(static_cast<const uint8_t*>(src), h, w, c,
                              static_cast<const float*>(inv), static_cast<const float*>(border),
                              out_h, out_w, static_cast<uint8_t*>(dst));
    else if (dtype == 1)
      warp<float, float, C>(static_cast<const float*>(src), h, w, c,
                            static_cast<const float*>(inv), static_cast<const float*>(border),
                            out_h, out_w, static_cast<float*>(dst));
    else
      warp<double, double, C>(static_cast<const double*>(src), h, w, c,
                              static_cast<const double*>(inv), static_cast<const double*>(border),
                              out_h, out_w, static_cast<double*>(dst));
  });
}

// code: 0 RGB->HSV, 1 HSV->RGB, 2 RGB->GRAY; dtype 0 uint8 or 1 float32.
// sdiv, hdiv: the 256-entry division tables of the uint8 RGB->HSV.
void ssd_cvt_color(int code, int dtype, const void* src, int64_t h, int64_t w,
                   const int64_t* sdiv, const int64_t* hdiv, void* dst) {
  const int64_t n = h * w;
  if (dtype == 0) {
    const uint8_t* s = static_cast<const uint8_t*>(src);
    uint8_t* d = static_cast<uint8_t*>(dst);
    if (code == 0) rgb_to_hsv_u8(s, n, sdiv, hdiv, d);
    else if (code == 1) hsv_to_rgb_u8(s, h, w, d);
    else rgb_to_gray_u8(s, n, d);
  } else {
    const float* s = static_cast<const float*>(src);
    float* d = static_cast<float*>(dst);
    if (code == 0) rgb_to_hsv_f32(s, n, d);
    else if (code == 1) hsv_to_rgb_f32(s, n, d);
    else rgb_to_gray_f32(s, n, d);
  }
}

}  // extern "C"
