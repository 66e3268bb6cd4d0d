// OpenCV's uint8 INTER_LINEAR resize over a batch of decoded JPEG pixels,
// for Hopper (sm_90a).
//
// Not the port of a TPU kernel: the JAX package resizes on its host with
// cv2.resize. It was added so that the evaluator's 'resize' input mode keeps
// a JPEG batch on the card: nvJPEG decodes it, the colour kernel
// (csrc/jpeg_color.cu) writes its pixels packed one image after another,
// and this kernel resizes each image from there into one (B, out_h, out_w,
// 3) uint8 batch that goes to the model as it is. Without it the pixels
// would cross to the host for its resize and back.
//
// The arithmetic is OpenCV's fixed-point path for uint8, as the host C++
// computes it (ssd_keras_torch/native/ssd_image_ops.cpp:linear_u8), bit for
// bit what its plain version (ssd_keras_torch/ops/resize.py:
// resize_linear_u8) computes: per output pixel two source columns x0, x1
// with 11-bit weights a0, a1 and two source rows y0, y1 with weights b0,
// b1 (the wrapper builds the tables from data/geometric.py:linear_taps_u8);
// each source row's horizontal sum S = p[x0] a0 + p[x1] a1 in int32, then
// ((b0 (S0 >> 4)) >> 16 + (b1 (S1 >> 4)) >> 16 + 2) >> 2, clamped to
// 0..255. A gray image (one channel) is read once a pixel and written to
// all three channels, as ConvertTo3Channels then Resize give.
//
// What bounds it on this card: bytes. Each source pixel is read once from
// memory (the four taps of neighbouring outputs hit the same lines, which
// stay in L1/L2) and each output pixel written once: a 500 x 375 image to
// 512 x 512 moves 0.56 MB in and 0.79 MB out, 1.35 MB; a batch of 8, 10.8
// MB, 3.2 us at 3.35 TB/s. Speed is not this kernel's point (it replaces a
// host resize of milliseconds an image); it has to be exact and cheap.
//
// One launch a batch: blockIdx.y is the image, and each thread makes
// kGroup neighbouring output pixels of one output row (48 bytes for RGB),
// so that a warp writes whole rows; the bytes go out as three 16-byte
// stores where the address allows, else as 4-byte or byte stores.
//
// `images`: one row of kImageFields int64 an image: the offset of its
// pixels in `pixels`, its height, width and channels (1 or 3), and the
// device address of its taps table (int32: x0, x1, a0, a1 of out_w each,
// then y0, y1, b0, b1 of out_h each). The wrapper (kernels/resize.py)
// checks every offset against the buffers.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kImageFields = 5;
constexpr int kThreads = 256;
constexpr int kGroup = 16;               // output pixels a thread
constexpr int kWords = kGroup * 3 / 4;   // their RGB bytes as 32-bit words

template <int C>
__device__ __forceinline__ void resize_group(const uint8_t* __restrict__ src, int64_t w,
                                             const int* __restrict__ taps, int out_h, int out_w,
                                             int oy, int ox0, uint8_t* __restrict__ dst) {
  const int* xt = taps;
  const int* yt = taps + 4 * out_w;
  const int y0 = __ldg(yt + oy), y1 = __ldg(yt + out_h + oy);
  const int b0 = __ldg(yt + 2 * out_h + oy), b1 = __ldg(yt + 3 * out_h + oy);
  const uint8_t* r0 = src + static_cast<int64_t>(y0) * w * C;
  const uint8_t* r1 = src + static_cast<int64_t>(y1) * w * C;
  const int n = min(kGroup, out_w - ox0);
  uint32_t words[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) words[k] = 0;
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    if (k < n) {
      const int ox = ox0 + k;
      const int x0 = __ldg(xt + ox) * C, x1 = __ldg(xt + out_w + ox) * C;
      const int a0 = __ldg(xt + 2 * out_w + ox), a1 = __ldg(xt + 3 * out_w + ox);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const int c = C == 1 ? 0 : ch;
        const int s0 = int(__ldg(r0 + x0 + c)) * a0 + int(__ldg(r0 + x1 + c)) * a1;
        const int s1 = int(__ldg(r1 + x0 + c)) * a0 + int(__ldg(r1 + x1 + c)) * a1;
        int v = (((b0 * (s0 >> 4)) >> 16) + ((b1 * (s1 >> 4)) >> 16) + 2) >> 2;
        v = min(max(v, 0), 255);
        const int byte = 3 * k + ch;  // a constant once unrolled
        words[byte >> 2] |= static_cast<uint32_t>(v) << (8 * (byte & 3));
      }
    }
  }
  const uintptr_t address = reinterpret_cast<uintptr_t>(dst);
  if (n == kGroup && (address & 15) == 0) {
    uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
    for (int k = 0; k < kWords / 4; ++k)
      d[k] = make_uint4(words[4 * k], words[4 * k + 1], words[4 * k + 2], words[4 * k + 3]);
  } else if (n == kGroup && (address & 3) == 0) {
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
#pragma unroll
    for (int k = 0; k < kWords; ++k) d[k] = words[k];
  } else {
#pragma unroll
    for (int byte = 0; byte < 3 * kGroup; ++byte)
      if (byte < 3 * n) dst[byte] = static_cast<uint8_t>(words[byte >> 2] >> (8 * (byte & 3)));
  }
}

__global__ void __launch_bounds__(kThreads)
    resize_linear_u8(const uint8_t* __restrict__ pixels, const int64_t* __restrict__ images,
                     int out_h, int out_w, uint8_t* __restrict__ out) {
  const int groups = (out_w + kGroup - 1) / kGroup;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<int64_t>(groups) * out_h) return;
  const int oy = static_cast<int>(t / groups);
  const int ox0 = static_cast<int>(t % groups) * kGroup;
  const int64_t* image = images + static_cast<int64_t>(blockIdx.y) * kImageFields;
  const uint8_t* src = pixels + image[0];
  const int64_t w = image[2];
  const int* taps = reinterpret_cast<const int*>(image[4]);
  uint8_t* dst = out + ((static_cast<int64_t>(blockIdx.y) * out_h + oy) * out_w + ox0) * 3;
  if (image[3] == 1)
    resize_group<1>(src, w, taps, out_h, out_w, oy, ox0, dst);
  else
    resize_group<3>(src, w, taps, out_h, out_w, oy, ox0, dst);
}

}  // namespace

// `images` (n_images rows, on the card), `pixels` and `out` (n_images x
// out_h x out_w x 3 bytes) on the card. Returns the launch's cudaError_t.
extern "C" int ssd_resize_linear_u8(const void* pixels, const void* images, int n_images,
                                    int out_h, int out_w, void* out, void* stream) {
  if (n_images <= 0 || out_h <= 0 || out_w <= 0) return 0;
  const int64_t groups = (out_w + kGroup - 1) / kGroup;
  const dim3 grid(static_cast<unsigned>((groups * out_h + kThreads - 1) / kThreads),
                  static_cast<unsigned>(n_images));
  resize_linear_u8<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pixels), static_cast<const int64_t*>(images), out_h, out_w,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
