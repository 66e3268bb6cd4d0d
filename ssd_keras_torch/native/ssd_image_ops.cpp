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
// dtype codes: 0 uint8, 1 float32, 2 float64, 3 uint16, 4 int16. Integer
// images accumulate in float32 (or in integers where NumPy does) and are
// rounded half to even and saturated to their type, as OpenCV's
// saturate_cast; float images accumulate in their own type.
//
// Built at first use by native/image_ops.py with g++ -O3 -shared -fPIC
// -ffp-contract=off -fno-tree-vectorize (see IMAGE_OPS_FLAGS there for why),
// into ssd_keras_torch/_build/. One thread: no OpenMP.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
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

// np.clip(np.rint(v), min, max).astype(T) for the 16-bit types.
template <typename T>
inline T round_saturate(float v) {
  const float r = std::nearbyint(v);
  if (!(r > float(std::numeric_limits<T>::min()))) return std::numeric_limits<T>::min();
  if (r >= float(std::numeric_limits<T>::max())) return std::numeric_limits<T>::max();
  return static_cast<T>(r);
}

template <typename T, typename A>
inline T store(A v) {
  if constexpr (std::is_same<T, uint8_t>::value)
    return round_u8(v);
  else if constexpr (std::is_integral<T>::value)
    return round_saturate<T>(v);
  else
    return static_cast<T>(v);
}

// Runs f(T(), A()) for the image type of a dtype code and its accumulator.
template <typename F>
inline void by_dtype(int dtype, F f) {
  switch (dtype) {
    case 0: f(uint8_t(), float()); break;
    case 1: f(float(), float()); break;
    case 2: f(double(), double()); break;
    case 3: f(uint16_t(), float()); break;
    default: f(int16_t(), float()); break;
  }
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
               int64_t ky, int64_t out_h, bool x_from_zero, int64_t lanes, T* dst) {
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
  // OpenCV's vertical vector pass: the first `vec` elements sum in reverse.
  const int64_t vec = lanes > 0 ? row_len - row_len % lanes : 0;
  std::vector<A> line(static_cast<size_t>(row_len));
  for (int64_t oy = 0; oy < out_h; ++oy) {
    const int64_t* iy = yi + oy * ky;
    const A* wy = yw + oy * ky;
    const A* r0 = rows.data() + iy[0] * row_len;
    for (int64_t k = vec; k < row_len; ++k) line[k] = r0[k] * wy[0];
    for (int64_t j = 1; j < ky; ++j) {
      const A* rj = rows.data() + iy[j] * row_len;
      const A wj = wy[j];
      for (int64_t k = vec; k < row_len; ++k) line[k] = line[k] + rj[k] * wj;
    }
    if (vec > 0) {
      const A* rl = rows.data() + iy[ky - 1] * row_len;
      for (int64_t k = 0; k < vec; ++k) line[k] = rl[k] * wy[ky - 1];
      for (int64_t j = ky - 2; j >= 0; --j) {
        const A* rj = rows.data() + iy[j] * row_len;
        const A wj = wy[j];
        for (int64_t k = 0; k < vec; ++k) line[k] = rj[k] * wj + line[k];
      }
    }
    T* out = dst + oy * row_len;
    for (int64_t k = 0; k < row_len; ++k) out[k] = store<T, A>(line[k]);
  }
}

// geometric.py:_separable on uint8, Lanczos4 and cubic: OpenCV's 11-bit
// integer weights, sums exact in int64, then (total + (1 << 21)) >> 22. With
// `lanes`, the first row_len - row_len % lanes elements of each output row
// take OpenCV's vertical vector pass instead: float32, the taps in reverse,
// on the weights times 2**-22, rounded half to even and saturated.
template <int C>
void fixed_u8(const uint8_t* src, int64_t h, int64_t w, int64_t c_any, const int64_t* xi,
              const int32_t* xw, int64_t kx, int64_t out_w, const int64_t* yi,
              const int32_t* yw, int64_t ky, int64_t out_h, int64_t lanes, uint8_t* dst) {
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
  const int64_t vec = lanes > 0 ? row_len - row_len % lanes : 0;
  const float scale = 1.0f / 4194304.0f;  // 2**-22
  std::vector<int64_t> line(static_cast<size_t>(row_len));
  std::vector<float> fline(static_cast<size_t>(vec));
  for (int64_t oy = 0; oy < out_h; ++oy) {
    const int64_t* iy = yi + oy * ky;
    const int32_t* wy = yw + oy * ky;
    std::fill(line.begin(), line.end(), 0);
    for (int64_t j = 0; j < ky; ++j) {
      const int64_t* rj = rows.data() + iy[j] * row_len;
      const int64_t wj = wy[j];
      for (int64_t k = vec; k < row_len; ++k) line[k] += rj[k] * wj;
    }
    if (vec > 0) {
      const int64_t* rl = rows.data() + iy[ky - 1] * row_len;
      const float bl = float(wy[ky - 1]) * scale;
      for (int64_t k = 0; k < vec; ++k) fline[k] = float(rl[k]) * bl;
      for (int64_t j = ky - 2; j >= 0; --j) {
        const int64_t* rj = rows.data() + iy[j] * row_len;
        const float bj = float(wy[j]) * scale;
        for (int64_t k = 0; k < vec; ++k) fline[k] = float(rj[k]) * bj + fline[k];
      }
    }
    uint8_t* out = dst + oy * row_len;
    for (int64_t k = 0; k < vec; ++k) out[k] = round_u8(fline[k]);
    for (int64_t k = vec; k < row_len; ++k) {
      const int64_t v = (line[k] + (int64_t(1) << 21)) >> 22;
      out[k] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

// geometric.py:_halve (halve) and _block_mean: the mean of each iy x ix
// block. Integer images: (sum + 2) >> 2 for the halving (OpenCV's vector
// path), else uint8 the int64 sum, 16-bit the float32 sum, times float32(1 /
// (ix * iy)), rounded. Floats: when halving, ((a + b) + c) +
// d, or with `lanes` (a + b) + (c + d) on the first row_len - row_len % lanes
// elements of each output row; on the area path the block's pixels in row
// order, four at a time added among themselves, then to the total from 0
// (OpenCV's unrolled loop); times float32(1 / (ix * iy)).
template <typename T, typename A>
void block_mean(const T* src, int64_t w, int64_t c, int64_t iy, int64_t ix, int64_t out_h,
                int64_t out_w, bool halve, int64_t lanes, T* dst) {
  const A inv = A(1.0f / float(ix * iy));  // OpenCV's float scale, for float64 too
  const int64_t row_len = out_w * c;
  const int64_t vec = lanes > 0 ? row_len - row_len % lanes : 0;
  const int64_t area = ix * iy;
  for (int64_t oy = 0; oy < out_h; ++oy)
    for (int64_t ox = 0; ox < out_w; ++ox)
      for (int64_t ch = 0; ch < c; ++ch) {
        const T* p = src + (oy * iy * w + ox * ix) * c + ch;
        T& out = dst[(oy * out_w + ox) * c + ch];
        if (std::is_integral<T>::value && (halve || std::is_same<T, uint8_t>::value)) {
          int64_t total = 0;
          for (int64_t a = 0; a < iy; ++a)
            for (int64_t b = 0; b < ix; ++b) total += p[(a * w + b) * c];
          out = halve ? static_cast<T>((total + 2) >> 2) : store<T, A>(A(total) * inv);
          continue;
        }
        auto tap = [&](int64_t k) { return A(p[((k / ix) * w + k % ix) * c]); };
        A acc;
        if (halve && ox * c + ch < vec)
          acc = (tap(0) + tap(1)) + (tap(2) + tap(3));
        else if (halve)
          acc = ((tap(0) + tap(1)) + tap(2)) + tap(3);
        else {
          acc = A(0);
          int64_t k = 0;
          for (; k + 3 < area; k += 4) acc = acc + (((tap(k) + tap(k + 1)) + tap(k + 2)) + tap(k + 3));
          for (; k < area; ++k) acc = acc + tap(k);
        }
        out = store<T, A>(acc * inv);
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

// geometric.py:_warp_remap: OpenCV's remap-path bilinear, which its
// warpAffine takes for float64 and int16 images and for any image of other
// than 1, 3 or 4 channels. Each source position is in 1/32 pixel: X = (x0[oy]
// + dx[ox]) >> 5 (int32 sums, as OpenCV's), its pixel X >> 5 saturated to
// int16 and its fraction X & 31. The four weights come from `tab`, OpenCV's
// 32 x 32 bilinear table (int32 15-bit weights for uint8, else float32), and
// are summed as v00 * w0 + v01 * w1 + v10 * w2 + v11 * w3 in W: int32 for
// uint8 (then (s + (1 << 14)) >> 15), float32 for uint16, int16 and float32,
// float64 for float64. A neighbour outside the image takes cval; a pixel
// whose four neighbours all lie outside is cval itself.
inline int64_t sat_i16(int32_t v) { return v < -32768 ? -32768 : (v > 32767 ? 32767 : v); }

template <typename T, typename W, typename Tab, int C>
void warp_remap(const T* src, int64_t h, int64_t w, int64_t c_any, const int32_t* x0,
                const int32_t* y0, const int32_t* dx, const int32_t* dy, const Tab* tab,
                const T* cval, int64_t out_h, int64_t out_w, T* dst) {
  const int64_t c = C > 0 ? C : c_any;
  for (int64_t oy = 0; oy < out_h; ++oy)
    for (int64_t ox = 0; ox < out_w; ++ox) {
      const int32_t X = int32_t(uint32_t(x0[oy]) + uint32_t(dx[ox])) >> 5;
      const int32_t Y = int32_t(uint32_t(y0[oy]) + uint32_t(dy[ox])) >> 5;
      const int64_t sx = sat_i16(X >> 5), sy = sat_i16(Y >> 5);
      const Tab* wt = tab + ((Y & 31) * 32 + (X & 31)) * 4;
      T* out = dst + (oy * out_w + ox) * c;
      if (sx >= w || sx + 1 < 0 || sy >= h || sy + 1 < 0) {
        for (int64_t ch = 0; ch < c; ++ch) out[ch] = cval[ch];
        continue;
      }
      const T* nb[4];
      for (int n = 0; n < 4; ++n) {
        const int64_t yy = sy + (n >> 1), xx = sx + (n & 1);
        nb[n] = yy >= 0 && yy < h && xx >= 0 && xx < w ? src + (yy * w + xx) * c : nullptr;
      }
      for (int64_t ch = 0; ch < c; ++ch) {
        W sum = W(0);
        for (int n = 0; n < 4; ++n) {
          const W term = W(nb[n] ? nb[n][ch] : cval[ch]) * W(wt[n]);
          sum = n == 0 ? term : sum + term;
        }
        if constexpr (std::is_same<T, uint8_t>::value) {
          const int32_t v = (sum + (1 << 14)) >> 15;
          out[ch] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
        } else {
          out[ch] = store<T, W>(sum);
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

// photometric.py:_rgb_to_gray, uint8 and uint16
template <typename T>
void rgb_to_gray_int(const T* src, int64_t n, T* dst) {
  for (int64_t i = 0; i < n; ++i)
    dst[i] = static_cast<T>((int64_t(src[3 * i]) * 9798 + int64_t(src[3 * i + 1]) * 19235 +
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

// Weights are float64 for float64 images, float32 for the others. lanes: 0,
// or the step of OpenCV's vertical vector pass (separable()).
void ssd_resize_separable(int dtype, const void* src, int64_t h, int64_t w, int64_t c,
                          const int64_t* xi, const void* xw, int64_t kx, int64_t out_w,
                          const int64_t* yi, const void* yw, int64_t ky, int64_t out_h,
                          int x_from_zero, int64_t lanes, void* dst) {
  by_dtype(dtype, [&](auto t, auto a) {
    using T = decltype(t);
    using A = decltype(a);
    by_channels(c, [&](auto k) {
      separable<T, A, decltype(k)::value>(
          static_cast<const T*>(src), h, w, c, xi, static_cast<const A*>(xw), kx, out_w, yi,
          static_cast<const A*>(yw), ky, out_h, x_from_zero != 0, lanes,
          static_cast<T*>(dst));
    });
  });
}

void ssd_resize_fixed_u8(const uint8_t* src, int64_t h, int64_t w, int64_t c, const int64_t* xi,
                         const int32_t* xw, int64_t kx, int64_t out_w, const int64_t* yi,
                         const int32_t* yw, int64_t ky, int64_t out_h, int64_t lanes,
                         uint8_t* dst) {
  by_channels(c, [&](auto k) {
    fixed_u8<decltype(k)::value>(src, h, w, c, xi, xw, kx, out_w, yi, yw, ky, out_h, lanes,
                                 dst);
  });
}

void ssd_resize_block_mean(int dtype, const void* src, int64_t w, int64_t c, int64_t iy,
                           int64_t ix, int64_t out_h, int64_t out_w, int halve, int64_t lanes,
                           void* dst) {
  by_dtype(dtype, [&](auto t, auto a) {
    using T = decltype(t);
    block_mean<T, decltype(a)>(static_cast<const T*>(src), w, c, iy, ix, out_h, out_w,
                               halve != 0, lanes, static_cast<T*>(dst));
  });
}

// inv: the inverted map's six values and border: c values, both in the work
// type (float64 for float64 images, float32 for the others).
void ssd_warp_affine(int dtype, const void* src, int64_t h, int64_t w, int64_t c, const void* inv,
                     const void* border, int64_t out_h, int64_t out_w, void* dst) {
  by_dtype(dtype, [&](auto t, auto a) {
    using T = decltype(t);
    using W = decltype(a);
    by_channels(c, [&](auto k) {
      warp<T, W, decltype(k)::value>(static_cast<const T*>(src), h, w, c,
                                     static_cast<const W*>(inv), static_cast<const W*>(border),
                                     out_h, out_w, static_cast<T*>(dst));
    });
  });
}

// x0, y0: each output row's start in 1/1024 pixel plus the round delta;
// dx, dy: each output column's step (int32). tab: 32 * 32 * 4 weights, int32
// for uint8 images, float32 for the others. cval: c values of the image type.
void ssd_warp_remap(int dtype, const void* src, int64_t h, int64_t w, int64_t c,
                    const int32_t* x0, const int32_t* y0, const int32_t* dx, const int32_t* dy,
                    const void* tab, const void* cval, int64_t out_h, int64_t out_w, void* dst) {
  by_dtype(dtype, [&](auto t, auto a) {
    using T = decltype(t);
    using A = decltype(a);
    by_channels(c, [&](auto k) {
      constexpr int C = decltype(k)::value;
      const T* s = static_cast<const T*>(src);
      const T* v = static_cast<const T*>(cval);
      T* d = static_cast<T*>(dst);
      if constexpr (std::is_same<T, uint8_t>::value)
        warp_remap<T, int32_t, int32_t, C>(s, h, w, c, x0, y0, dx, dy,
                                          static_cast<const int32_t*>(tab), v, out_h, out_w, d);
      else
        warp_remap<T, A, float, C>(s, h, w, c, x0, y0, dx, dy, static_cast<const float*>(tab),
                                   v, out_h, out_w, d);
    });
  });
}

// code: 0 RGB->HSV, 1 HSV->RGB, 2 RGB->GRAY; dtype 0 uint8 or 1 float32, or
// 3 uint16 for RGB->GRAY.
// sdiv, hdiv: the 256-entry division tables of the uint8 RGB->HSV.
void ssd_cvt_color(int code, int dtype, const void* src, int64_t h, int64_t w,
                   const int64_t* sdiv, const int64_t* hdiv, void* dst) {
  const int64_t n = h * w;
  if (dtype == 3) {
    rgb_to_gray_int(static_cast<const uint16_t*>(src), n, static_cast<uint16_t*>(dst));
  } else if (dtype == 0) {
    const uint8_t* s = static_cast<const uint8_t*>(src);
    uint8_t* d = static_cast<uint8_t*>(dst);
    if (code == 0) rgb_to_hsv_u8(s, n, sdiv, hdiv, d);
    else if (code == 1) hsv_to_rgb_u8(s, h, w, d);
    else rgb_to_gray_int(s, n, d);
  } else {
    const float* s = static_cast<const float*>(src);
    float* d = static_cast<float*>(dst);
    if (code == 0) rgb_to_hsv_f32(s, n, d);
    else if (code == 1) hsv_to_rgb_f32(s, n, d);
    else rgb_to_gray_f32(s, n, d);
  }
}

}  // extern "C"
