// Batch JPEG decode on the card through nvJPEG, the CUDA toolkit's decoder.
//
// The card-side counterpart of ssd_jpeg.cpp (the threaded libjpeg decoder
// of the host). It is not a port of a TPU kernel (the JAX package decodes
// with libjpeg on its host), so it holds no kernel: nvJPEG's Huffman decode
// and IDCT do the work, and write each file's planes as they are encoded
// (NVJPEG_OUTPUT_UNCHANGED: Y, Cb, Cr at their own resolutions, or Y alone
// for gray). The colour stage is the port's own kernel,
// ssd_keras_torch/csrc/jpeg_color.cu (libjpeg's upsampling and conversion),
// since nvJPEG's own RGB output is not libjpeg's. The Python binding
// (ssd_keras_torch/native/jpeg.py) routes the files, stages the bitstreams
// in pinned memory, allocates the planes on the card and copies the pixels
// back in one transfer.
//
// One decoder per card for the life of the process: the nvJPEG handle and
// its state cost milliseconds to create, so they are made at a card's
// first call and kept (NVJPEG_BACKEND_DEFAULT; on the H100 tried, the
// hardware backend's handle is refused with NVJPEG_STATUS_ARCH_MISMATCH).
// The batched state is re-initialised only when the batch size or the
// output format changes.
// The binding serialises calls (one lock); the mutex here guards only the
// creation.
//
// Entries return 0, an nvjpegStatus_t (1-10), or 1000 + a cudaError_t.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared -Xcompiler -fPIC
//        -I$CUDA_HOME/include nvjpeg_decode.cu -L$CUDA_HOME/lib64 -lnvjpeg

#include <cstddef>
#include <cstdint>
#include <mutex>
#include <vector>

#include <cuda_runtime.h>
#include <nvjpeg.h>

namespace {

constexpr int kMaxDevices = 64;
constexpr int kCudaError = 1000;

struct Decoder {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t batched = nullptr;  // nvjpegDecodeBatched's state
  int batch_size = 0;                   // what `batched` was initialised for,
  int format = -1;                      // and to which output format
};

Decoder g_decoders[kMaxDevices];
std::mutex g_create;

#define NVJPEG_TRY(call)                                 \
  do {                                                   \
    const nvjpegStatus_t status_ = (call);               \
    if (status_ != NVJPEG_STATUS_SUCCESS) return status_; \
  } while (0)

int set_device(int device) {
  if (device < 0 || device >= kMaxDevices) return NVJPEG_STATUS_INVALID_PARAMETER;
  const cudaError_t err = cudaSetDevice(device);
  return err == cudaSuccess ? 0 : kCudaError + static_cast<int>(err);
}

// The decoder of `device`, made at its first use.
int decoder(int device, Decoder** out) {
  const int status = set_device(device);
  if (status != 0) return status;
  std::lock_guard<std::mutex> lock(g_create);
  Decoder& d = g_decoders[device];
  if (d.handle == nullptr) {
    nvjpegHandle_t handle = nullptr;
    NVJPEG_TRY(nvjpegCreateSimple(&handle));
    NVJPEG_TRY(nvjpegJpegStateCreate(handle, &d.batched));
    d.handle = handle;
  }
  *out = &d;
  return 0;
}

int last_cuda_error() {
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? 0 : kCudaError + static_cast<int>(err);
}

}  // namespace

extern "C" {

// The header of one file (nvjpegGetImageInfo): component count, chroma
// subsampling (an nvjpegChromaSubsampling_t), and each component's width
// and height (NVJPEG_MAX_COMPONENT entries each; 0 where not encoded).
int ssd_nvjpeg_info(int device, const unsigned char* data, size_t length,
                    int* components, int* subsampling, int* widths, int* heights) {
  Decoder* d = nullptr;
  const int status = decoder(device, &d);
  if (status != 0) return status;
  nvjpegChromaSubsampling_t css = NVJPEG_CSS_UNKNOWN;
  NVJPEG_TRY(nvjpegGetImageInfo(d->handle, data, length, components, &css, widths, heights));
  *subsampling = static_cast<int>(css);
  return 0;
}

// Decode n files (host pointers, pinned by the caller) with one
// nvjpegDecodeBatched call on `stream`, to their planes: file i's component
// c goes to planes[3 i + c] (device memory, pitch pitches[3 i + c] bytes a
// row; null past the file's components). With `rgbi` set, to nvJPEG's own
// interleaved RGB at planes[3 i] instead (for comparisons). Does not
// synchronise.
int ssd_nvjpeg_decode_batched(int device, const unsigned char* const* data,
                              const size_t* lengths, int n, unsigned char* const* planes,
                              const size_t* pitches, int rgbi, void* stream) {
  if (n <= 0) return 0;
  Decoder* d = nullptr;
  const int status = decoder(device, &d);
  if (status != 0) return status;
  const nvjpegOutputFormat_t format = rgbi ? NVJPEG_OUTPUT_RGBI : NVJPEG_OUTPUT_UNCHANGED;
  if (d->batch_size != n || d->format != format) {
    NVJPEG_TRY(nvjpegDecodeBatchedInitialize(d->handle, d->batched, n, 1, format));
    d->batch_size = n;
    d->format = format;
  }
  std::vector<nvjpegImage_t> images(n, nvjpegImage_t{});
  for (int i = 0; i < n; ++i) {
    for (int c = 0; c < 3; ++c) {
      images[i].channel[c] = planes[3 * i + c];
      images[i].pitch[c] = pitches[3 * i + c];
    }
  }
  NVJPEG_TRY(nvjpegDecodeBatched(d->handle, d->batched, data, lengths, images.data(),
                                 static_cast<cudaStream_t>(stream)));
  return last_cuda_error();
}

}  // extern "C"
