// libjpeg's chroma upsampling and YCbCr -> RGB conversion over a batch of
// decoded JPEG planes, for Hopper (sm_90a).
//
// Not the port of a TPU kernel: it is the colour stage of the JAX package's
// host decoder (ssd_keras_tpu/native/ssd_jpeg.cpp:decode_one, libjpeg's
// jdsample.c and jdcolor.c), moved onto the card. nvJPEG decodes the batch
// to planar Y, Cb, Cr at their own resolutions (NVJPEG_OUTPUT_UNCHANGED);
// its planes differ from libjpeg's integer IDCT by at most one level, but
// its own RGB output upsamples chroma by another rule and converts in
// floating point, tens of levels from PIL at strong chroma edges. This
// kernel computes what libjpeg computes from the planes, in the same
// integer arithmetic:
//
//   - "fancy" upsampling (libjpeg's default, which PIL keeps): for 4:2:2
//     (h2v1) each output sample is (3 nearer + 1 farther + bias) / 4, the
//     bias 1 then 2; for 4:2:0 (h2v2) the column sums 3 nearer row + 1
//     farther row are weighted 3:1 the same way, (.. + 8) >> 4 then
//     (.. + 7) >> 4. Edge samples take their own value as the missing
//     neighbour (libjpeg's replicated context rows and special-cased end
//     columns). A chroma plane two samples wide or less is replicated, as
//     libjpeg does there;
//   - the conversion with libjpeg's 16-bit fixed-point tables
//     (FIX(1.40200), FIX(1.77200), -FIX(0.71414), -FIX(0.34414), rounding
//     by ONE_HALF), clamped to 0..255.
//
// Gray images (one plane) are copied as they are. Other subsamplings
// (4:4:0, 4:1:1, 4:1:0) are not taken: the binding reads those files
// through PIL.
//
// What bounds it on this card: bytes. A pixel reads its Y byte and four
// chroma bytes (shared with its neighbours, served by L1) and writes three,
// with ~30 integer operations: 32 VOC images (500 x 375, 4:2:0) move 27.0
// MB, 8 us at 3.35 TB/s, against ~0.2 G operations. One thread a pixel,
// neighbouring threads on neighbouring pixels of a row, so the reads and
// writes of a warp are contiguous; one grid row (blockIdx.y) an image.
//
// Layout: one row of kLayoutFields int64 an image (ssd_keras_torch/ops/
// jpeg_color.py:LAYOUT_FIELDS): offsets of the Y, Cb and Cr planes in
// `planes` (pitch: the plane's width), the chroma plane's width and
// height, the image's height and width, its kind (0 gray, 1 4:4:4, 2 4:2:2,
// 3 4:2:0) and the offset of its pixels in `out` (H x W gray, or H x W x 3
// interleaved RGB). The wrapper checks every offset against the buffers.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLayoutFields = 9;
constexpr int kThreads = 256;
constexpr int kMaxBlocksX = 2048;

enum Kind { kGray = 0, k444 = 1, k422 = 2, k420 = 3 };

// libjpeg's build_ycc_rgb_table entries for sample value v.
__device__ __forceinline__ int cr_r(int v) { return (91881 * (v - 128) + 32768) >> 16; }
__device__ __forceinline__ int cb_b(int v) { return (116130 * (v - 128) + 32768) >> 16; }
__device__ __forceinline__ int cr_g(int v) { return -46802 * (v - 128); }
__device__ __forceinline__ int cb_g(int v) { return -22554 * (v - 128) + 32768; }

__device__ __forceinline__ uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// Chroma sample of output pixel (r, c) from plane p (cw x ch, pitch cw).
__device__ __forceinline__ int chroma(const uint8_t* p, int kind, int cw, int ch, int r,
                                      int c) {
  if (kind == k444) return p[static_cast<int64_t>(r) * cw + c];
  const int j = c >> 1;
  const bool odd = c & 1;
  const int jn = odd ? min(j + 1, cw - 1) : max(j - 1, 0);
  if (kind == k422) {
    const uint8_t* row = p + static_cast<int64_t>(r) * cw;
    if (cw <= 2) return row[j];
    return (3 * row[j] + row[jn] + (odd ? 2 : 1)) >> 2;
  }
  // 4:2:0: the nearer chroma row and the farther one (above for an even
  // output row, below for an odd one).
  const int i = r >> 1;
  const int i2 = (r & 1) ? min(i + 1, ch - 1) : max(i - 1, 0);
  const uint8_t* row0 = p + static_cast<int64_t>(i) * cw;
  if (cw <= 2) return row0[j];
  const uint8_t* row1 = p + static_cast<int64_t>(i2) * cw;
  const int s = 3 * row0[j] + row1[j];
  const int sn = 3 * row0[jn] + row1[jn];
  return (3 * s + sn + (odd ? 7 : 8)) >> 4;
}

__global__ void __launch_bounds__(kThreads)
    ycc_to_rgb(const uint8_t* __restrict__ planes, const int64_t* __restrict__ layout,
               uint8_t* __restrict__ out) {
  const int64_t* d = layout + static_cast<int64_t>(blockIdx.y) * kLayoutFields;
  const uint8_t* y_plane = planes + d[0];
  const uint8_t* cb_plane = planes + d[1];
  const uint8_t* cr_plane = planes + d[2];
  const int cw = static_cast<int>(d[3]);
  const int ch = static_cast<int>(d[4]);
  const int h = static_cast<int>(d[5]);
  const int w = static_cast<int>(d[6]);
  const int kind = static_cast<int>(d[7]);
  uint8_t* dst = out + d[8];
  const int64_t pixels = static_cast<int64_t>(h) * w;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; p < pixels;
       p += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int r = static_cast<int>(p / w);
    const int c = static_cast<int>(p - static_cast<int64_t>(r) * w);
    const int y = y_plane[p];
    if (kind == kGray) {
      dst[p] = static_cast<uint8_t>(y);
      continue;
    }
    const int cb = chroma(cb_plane, kind, cw, ch, r, c);
    const int cr = chroma(cr_plane, kind, cw, ch, r, c);
    uint8_t* px = dst + 3 * p;
    px[0] = clamp255(y + cr_r(cr));
    px[1] = clamp255(y + ((cb_g(cb) + cr_g(cr)) >> 16));
    px[2] = clamp255(y + cb_b(cb));
  }
}

}  // namespace

// n images, the largest max_pixels pixels; layout on the card. Returns the
// launch's cudaError_t.
extern "C" int ssd_jpeg_ycc_to_rgb(const void* planes, const void* layout, void* out, int n,
                                   long long max_pixels, void* stream) {
  if (n <= 0 || max_pixels <= 0) return 0;
  const long long blocks = (max_pixels + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(blocks < kMaxBlocksX ? blocks : kMaxBlocksX), n);
  ycc_to_rgb<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(planes), static_cast<const int64_t*>(layout),
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
