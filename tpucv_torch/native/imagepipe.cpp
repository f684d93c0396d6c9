// Native host image pipeline: threaded JPEG decode + nearest letterbox.
//
// The reference's host input path is cv2 (JPEG decode via libjpeg-turbo +
// cv2.resize INTER_NEAREST letterbox, core/utils/image_process.py:7-66).
// The port keeps resize/pad/normalize on the device (ops/preprocess.py);
// what remains on the host per eval/predict batch is JPEG decode + a paste
// into the raw uint8 canvas.  This file does that natively: libjpeg decode
// straight to RGB (cv2 decodes BGR then converts — one extra pass), a
// nearest-neighbour pre-shrink for images larger than the canvas (same
// int-truncation geometry as cv2.resize INTER_NEAREST), and a std::thread
// pool across images so a production host's cores all feed the device.
//
// Exposed via ctypes (tpucv_torch/native/imagepipe.py); everything degrades
// gracefully to the cv2 path when the library is unavailable.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void err_exit(j_common_ptr cinfo) {
  ErrMgr* e = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(e->jb, 1);
}
void err_silent(j_common_ptr, int) {}
void err_silent_msg(j_common_ptr) {}

// cv2.resize INTER_NEAREST geometry: src index = int(dst * (src/dst)),
// clamped (modules/imgproc/src/resize.cpp resizeNN — scale in double,
// truncation toward zero, no half-pixel center offset).
void nearest_resize_rgb(const uint8_t* src, int sh, int sw, uint8_t* dst,
                        int dh, int dw) {
  const double sx = static_cast<double>(sw) / dw;
  const double sy = static_cast<double>(sh) / dh;
  std::vector<int> xmap(dw);
  for (int x = 0; x < dw; ++x) {
    int v = static_cast<int>(x * sx);
    xmap[x] = (v < sw ? v : sw - 1) * 3;
  }
  for (int y = 0; y < dh; ++y) {
    int yv = static_cast<int>(y * sy);
    if (yv >= sh) yv = sh - 1;
    const uint8_t* srow = src + static_cast<size_t>(yv) * sw * 3;
    uint8_t* drow = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      std::memcpy(drow + x * 3, srow + xmap[x], 3);
    }
  }
}

// Guard against absurd header-declared dimensions (cv2 caps at 2^30 pixels
// via CV_IO_MAX_IMAGE_PIXELS; a SOF can declare up to 65500x65500 = 12.9 GB
// RGB).  64 MP is far beyond any detection input and bounds a per-thread
// decode buffer at 192 MB.
constexpr size_t kMaxPixels = 64u * 1024 * 1024;

// Decode one JPEG buffer to RGB uint8.  Returns 1 on success and fills
// (pixels, h, w); 0 on failure (malformed, CMYK, oversized — caller falls
// back to cv2); -2 when `capacity` >= 0 and the image needs more than
// `capacity` bytes (h/w are still filled; nothing is decoded, so the caller
// can retry with an exact-size buffer after only a header parse).
// Grayscale JPEGs are expanded to RGB by libjpeg.
int decode_jpeg_rgb(const uint8_t* data, size_t size,
                    std::vector<uint8_t>* pixels, int* h, int* w,
                    int64_t capacity = -1) {
  jpeg_decompress_struct cinfo;
  ErrMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = err_exit;
  err.pub.emit_message = err_silent;
  err.pub.output_message = err_silent_msg;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(size));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  const size_t W0 = cinfo.image_width, H0 = cinfo.image_height;
  if (W0 == 0 || H0 == 0 || H0 * W0 > kMaxPixels) {
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  *h = static_cast<int>(H0);
  *w = static_cast<int>(W0);
  if (capacity >= 0 &&
      static_cast<int64_t>(H0 * W0 * 3) > capacity) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  cinfo.out_color_space = JCS_RGB;  // gray -> RGB handled by libjpeg
  jpeg_start_decompress(&cinfo);
  if (cinfo.output_components != 3 ||
      cinfo.output_width != W0 || cinfo.output_height != H0) {
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  try {
    pixels->resize(H0 * W0 * 3);
  } catch (const std::bad_alloc&) {
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row =
        pixels->data() + static_cast<size_t>(cinfo.output_scanline) * W0 * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 1;
}

bool read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  if (n <= 0) {
    std::fclose(f);
    return false;
  }
  std::fseek(f, 0, SEEK_SET);
  buf->resize(static_cast<size_t>(n));
  size_t got = std::fread(buf->data(), 1, buf->size(), f);
  std::fclose(f);
  return got == buf->size();
}

template <typename Fn>
void run_pool(int n, int n_threads, Fn fn) {
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  if (n_threads == 1 || n <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
  };
  std::vector<std::thread> pool;
  const int k = n_threads < n ? n_threads : n;
  pool.reserve(k);
  for (int t = 0; t < k; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Decode n JPEG files into the TOP-LEFT of per-image (canvas, canvas, 3)
// uint8 canvases (the device-side letterbox input layout of
// algorithms/base.py::_batched_detections).  Images larger than the canvas
// are nearest pre-shrunk by canvas/max(h, w) with int-truncated target dims
// — the exact geometry of the python fallback.  out must be pre-zeroed
// n*canvas*canvas*3 bytes.  hw[2i],hw[2i+1] = placed h,w; orig likewise the
// pre-resize dims; ok[i]=1 on success (failed images left zero for the
// caller to fill via cv2).  Returns the number decoded successfully.
int tpucv_decode_to_canvas(const char** paths, int n, int canvas,
                           uint8_t* out, int32_t* hw, int32_t* orig,
                           uint8_t* ok, int n_threads) {
  std::atomic<int> n_ok(0);
  run_pool(n, n_threads, [&](int i) {
   try {
    ok[i] = 0;
    std::vector<uint8_t> buf, pix;
    int h = 0, w = 0;
    if (!read_file(paths[i], &buf) ||
        decode_jpeg_rgb(buf.data(), buf.size(), &pix, &h, &w) != 1)
      return;
    orig[2 * i] = h;
    orig[2 * i + 1] = w;
    const uint8_t* src = pix.data();
    std::vector<uint8_t> shrunk;
    if (h > canvas || w > canvas) {
      const double pre = static_cast<double>(canvas) / (h > w ? h : w);
      const int nh = static_cast<int>(h * pre), nw = static_cast<int>(w * pre);
      shrunk.resize(static_cast<size_t>(nh) * nw * 3);
      nearest_resize_rgb(src, h, w, shrunk.data(), nh, nw);
      src = shrunk.data();
      h = nh;
      w = nw;
    }
    uint8_t* dst = out + static_cast<size_t>(i) * canvas * canvas * 3;
    for (int y = 0; y < h; ++y)
      std::memcpy(dst + static_cast<size_t>(y) * canvas * 3,
                  src + static_cast<size_t>(y) * w * 3,
                  static_cast<size_t>(w) * 3);
    hw[2 * i] = h;
    hw[2 * i + 1] = w;
    ok[i] = 1;
    n_ok.fetch_add(1);
   } catch (...) {  // e.g. bad_alloc on a huge file: fail just this image
    ok[i] = 0;
   }
  });
  return n_ok.load();
}

// Decode one JPEG file to RGB into caller memory (capacity bytes).  Returns
// 0 on success and writes h/w, -1 on decode failure, -2 if capacity is too
// small (h/w still written — only the header was parsed, so the caller can
// retry with an exact-size buffer without paying a wasted full decode).
int tpucv_decode_jpeg(const char* path, uint8_t* out, int64_t capacity,
                      int32_t* h, int32_t* w) try {
  std::vector<uint8_t> buf, pix;
  int hh = 0, ww = 0;
  if (!read_file(path, &buf)) return -1;
  const int rc =
      decode_jpeg_rgb(buf.data(), buf.size(), &pix, &hh, &ww, capacity);
  if (rc == 0) return -1;
  *h = hh;
  *w = ww;
  if (rc == -2) return -2;
  std::memcpy(out, pix.data(), pix.size());
  return 0;
} catch (...) {
  return -1;
}

// Raw nearest resize (uint8 RGB HWC), cv2.resize INTER_NEAREST geometry —
// exposed for exact-parity unit tests of the resampler.
void tpucv_nearest_resize(const uint8_t* src, int sh, int sw, uint8_t* dst,
                          int dh, int dw) {
  nearest_resize_rgb(src, sh, sw, dst, dh, dw);
}

}  // extern "C"
