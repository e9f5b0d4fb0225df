// Native host data loader: multi-threaded JPEG decode + bilinear resize.
//
// An own copy of reid_tpu/native/loader.cpp for the PyTorch port, unchanged
// but for these header lines. The reference consumes its
// native decode/resize through OpenCV/PIL + prefetch_generator
// (ref reid/train_utils.py:21-23 DataLoaderX, reid/data_prepare.py PIL loads);
// here the hot host path is a libjpeg + pthread-pool batch decoder exposed to
// Python via ctypes (see reid_tpu_torch/native/__init__.py).
//
// API (C):
//   int rtl_decode_batch(const char** paths, int n, int out_h, int out_w,
//                        unsigned char* out, int n_threads);
//     Decodes n JPEG files, bilinear-resizes each to (out_h, out_w, 3) RGB,
//     writes into out[n, out_h, out_w, 3]. Returns number of failures
//     (failed slots are zero-filled).
//
// Build: g++ -O3 -shared -fPIC loader.cpp -o libreidloader.so -ljpeg -lpthread

#include <atomic>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode one JPEG file to an RGB buffer. Returns true on success.
bool decode_jpeg(const char* path, std::vector<unsigned char>& rgb,
                 int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;

  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);

  *w = cinfo.output_width;
  *h = cinfo.output_height;
  const int stride = *w * 3;
  rgb.resize(static_cast<size_t>(stride) * *h);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = rgb.data() +
        static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

// Bilinear resize (H, W, 3) -> (out_h, out_w, 3), PIL-style alignment.
void resize_bilinear(const unsigned char* src, int sh, int sw,
                     unsigned char* dst, int dh, int dw) {
  const float sy = static_cast<float>(sh) / dh;
  const float sx = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = static_cast<int>(fy);
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    float wy = fy - y0;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      int x0 = static_cast<int>(fx);
      int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      float wx = fx - x0;
      for (int c = 0; c < 3; ++c) {
        const float v00 = src[(y0 * sw + x0) * 3 + c];
        const float v01 = src[(y0 * sw + x1) * 3 + c];
        const float v10 = src[(y1 * sw + x0) * 3 + c];
        const float v11 = src[(y1 * sw + x1) * 3 + c];
        const float top = v00 + (v01 - v00) * wx;
        const float bot = v10 + (v11 - v10) * wx;
        dst[(y * dw + x) * 3 + c] =
            static_cast<unsigned char>(top + (bot - top) * wy + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" int rtl_decode_batch(const char** paths, int n, int out_h,
                                int out_w, unsigned char* out,
                                int n_threads) {
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  if (n_threads > n) n_threads = n > 0 ? n : 1;
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  const size_t item = static_cast<size_t>(out_h) * out_w * 3;

  auto worker = [&]() {
    std::vector<unsigned char> rgb;
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      unsigned char* dst = out + item * i;
      int w = 0, h = 0;
      if (decode_jpeg(paths[i], rgb, &w, &h) && w > 0 && h > 0) {
        resize_bilinear(rgb.data(), h, w, dst, out_h, out_w);
      } else {
        memset(dst, 0, item);
        failures.fetch_add(1);
      }
    }
  };

  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failures.load();
}
