// Threaded JPEG batch decoder of the host (libjpeg), ssd_keras_torch's copy
// of ssd_keras_tpu/native/ssd_jpeg.cpp. The code below the header is that
// file's, unchanged, so the two decode bit for bit alike.
//
// It decodes a whole batch of JPEG buffers in parallel with std::thread +
// libjpeg, writing straight into caller-allocated RGB (or gray) buffers.
// On the card the same contract is kept by nvjpeg_decode.cu (nvJPEG).
//
// Kept in its own shared object so the host ops in ssd_host_ops.cpp never
// depend on libjpeg being present: ssd_keras_torch/native/jpeg.py builds it
// at its first use, only where g++ finds jpeglib.h.
//
// Build: g++ -O3 -shared -fPIC -o libssd_jpeg.so ssd_jpeg.cpp -ljpeg -lpthread

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void on_error(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

void silence(j_common_ptr, int) {}
void silence_msg(j_common_ptr) {}

// Decode one JPEG buffer to uint8, `channels` 1 (grayscale) or 3 (RGB) —
// matching what PIL's np.array(Image.open(...)) yields for the same file,
// so the batch path and the per-image fallback agree on shapes. Returns 0
// on success.
int decode_one(const uint8_t* data, int len, uint8_t* out, int out_h,
               int out_w, int channels) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = on_error;
  jerr.pub.emit_message = silence;
  jerr.pub.output_message = silence_msg;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = channels == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != out_h ||
      static_cast<int>(cinfo.output_width) != out_w ||
      cinfo.output_components != channels) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  const int stride = out_w * channels;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // namespace

extern "C" {

// Read width/height/components from a JPEG header. Returns 0 on success.
int ssd_jpeg_dims(const uint8_t* data, int len, int* width, int* height,
                  int* components) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = on_error;
  jerr.pub.emit_message = silence;
  jerr.pub.output_message = silence_msg;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  *width = static_cast<int>(cinfo.image_width);
  *height = static_cast<int>(cinfo.image_height);
  *components = cinfo.num_components;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode n JPEG buffers into caller-allocated buffers (channels[i] 1 or 3),
// n_threads-wide. Returns the number of failed images (0 = all good);
// failures are recorded in `status` (0 ok, nonzero error code per image).
int ssd_decode_jpeg_batch(const uint8_t** datas, const int* lens, int n,
                          uint8_t** outs, const int* heights,
                          const int* widths, const int* channels,
                          int n_threads, int* status) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) {
    workers.emplace_back([&, t]() {
      for (int i = t; i < n; i += n_threads) {
        status[i] = decode_one(datas[i], lens[i], outs[i], heights[i],
                               widths[i], channels[i]);
      }
    });
  }
  for (auto& w : workers) w.join();
  int failures = 0;
  for (int i = 0; i < n; ++i) failures += status[i] != 0;
  return failures;
}

}  // extern "C"
