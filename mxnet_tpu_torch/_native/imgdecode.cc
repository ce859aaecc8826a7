// Native batched image decode + crop + resize — the C++ half of the
// image pipeline.
//
// Reference counterpart: ImageRecordIOParser2's OMP decode loop
// (src/io/iter_image_recordio_2.cc:121-319) + the default augmenter's
// crop/resize (src/io/image_aug_default.cc), which run per record on
// worker threads with OpenCV. Here: libjpeg/libpng decode, bilinear
// crop-resize, optional mirror, a std::thread pool — fully off the
// Python GIL, one FFI call per batch.
//
// LINK: -ljpeg -lpng

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct JErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jerr_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JErr*>(cinfo->err)->jb, 1);
}

bool is_jpeg(const uint8_t* p, int64_t n) {
  return n >= 2 && p[0] == 0xFF && p[1] == 0xD8;
}

bool is_png(const uint8_t* p, int64_t n) {
  static const uint8_t sig[4] = {0x89, 'P', 'N', 'G'};
  return n >= 4 && std::memcmp(p, sig, 4) == 0;
}

bool decode_jpeg(const uint8_t* buf, int64_t len, std::vector<uint8_t>* rgb,
                 int* h, int* w) {
  jpeg_decompress_struct cinfo;
  JErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jerr_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;  // grayscale sources expand to RGB
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  rgb->resize(static_cast<size_t>(*h) * *w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = rgb->data() +
        static_cast<size_t>(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_png(const uint8_t* buf, int64_t len, std::vector<uint8_t>* rgb,
                int* h, int* w) {
  png_image img;
  std::memset(&img, 0, sizeof(img));
  img.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&img, buf, len)) return false;
  img.format = PNG_FORMAT_RGB;
  *w = img.width;
  *h = img.height;
  rgb->resize(PNG_IMAGE_SIZE(img));
  if (!png_image_finish_read(&img, nullptr, rgb->data(), 0, nullptr)) {
    png_image_free(&img);
    return false;
  }
  return true;
}

bool decode_any(const uint8_t* buf, int64_t len, std::vector<uint8_t>* rgb,
                int* h, int* w) {
  if (is_jpeg(buf, len)) return decode_jpeg(buf, len, rgb, h, w);
  if (is_png(buf, len)) return decode_png(buf, len, rgb, h, w);
  return false;
}

// bilinear sample of the rect (x0,y0,cw,ch) of src into (oh,ow) at dst
void crop_resize(const uint8_t* src, int sh, int sw, float x0, float y0,
                 float cw, float ch, uint8_t* dst, int oh, int ow,
                 bool flip) {
  const float sx = cw / ow;
  const float sy = ch / oh;
  for (int y = 0; y < oh; ++y) {
    float fy = y0 + (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    if (fy > sh - 1) fy = sh - 1;
    const int iy = static_cast<int>(fy);
    const int iy1 = iy + 1 < sh ? iy + 1 : iy;
    const float wy = fy - iy;
    for (int x = 0; x < ow; ++x) {
      float fx = x0 + (x + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      if (fx > sw - 1) fx = sw - 1;
      const int ix = static_cast<int>(fx);
      const int ix1 = ix + 1 < sw ? ix + 1 : ix;
      const float wx = fx - ix;
      const uint8_t* p00 = src + (static_cast<size_t>(iy) * sw + ix) * 3;
      const uint8_t* p01 = src + (static_cast<size_t>(iy) * sw + ix1) * 3;
      const uint8_t* p10 = src + (static_cast<size_t>(iy1) * sw + ix) * 3;
      const uint8_t* p11 = src + (static_cast<size_t>(iy1) * sw + ix1) * 3;
      const int ox = flip ? ow - 1 - x : x;
      uint8_t* q = dst + (static_cast<size_t>(y) * ow + ox) * 3;
      for (int c = 0; c < 3; ++c) {
        const float top = p00[c] + (p01[c] - p00[c]) * wx;
        const float bot = p10[c] + (p11[c] - p10[c]) * wx;
        q[c] = static_cast<uint8_t>(top + (bot - top) * wy + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" {

// dimensions without full decode (header parse): hw <- {h, w}; 0 on ok
int imgd_probe(const uint8_t* buf, int64_t len, int32_t* hw) {
  if (is_jpeg(buf, len)) {
    jpeg_decompress_struct cinfo;
    JErr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jerr_exit;
    if (setjmp(jerr.jb)) {
      jpeg_destroy_decompress(&cinfo);
      return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, buf, len);
    jpeg_read_header(&cinfo, TRUE);
    hw[0] = cinfo.image_height;
    hw[1] = cinfo.image_width;
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  if (is_png(buf, len)) {
    png_image img;
    std::memset(&img, 0, sizeof(img));
    img.version = PNG_IMAGE_VERSION;
    if (!png_image_begin_read_from_memory(&img, buf, len)) return 1;
    hw[0] = img.height;
    hw[1] = img.width;
    png_image_free(&img);
    return 0;
  }
  return 1;
}

// Decode n images, crop rects[i] = {x0,y0,cw,ch} (scaled by 1/16 fixed
// point via float array), bilinear-resize each to (oh, ow), optional
// mirror, into out (n * oh * ow * 3, HWC uint8). Returns 0 on success,
// else 1-based index of the first failed image.
int imgd_batch(const uint8_t** bufs, const int64_t* lens, int n,
               const float* rects, const uint8_t* flips, int oh, int ow,
               uint8_t* out, int n_threads) {
  std::atomic<int> next(0), failed(0);
  auto worker = [&]() {
    std::vector<uint8_t> rgb;
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n || failed.load()) return;  // batch is doomed: stop early
      int h = 0, w = 0;
      bool ok = false;
      try {
        ok = decode_any(bufs[i], lens[i], &rgb, &h, &w) &&
            static_cast<int64_t>(h) * w <= (1ll << 26);  // 64MPix cap
      } catch (...) {
        ok = false;  // bad_alloc from absurd claimed dims etc.
      }
      if (!ok) {
        int expect = 0;
        failed.compare_exchange_strong(expect, i + 1);
        continue;
      }
      const float* r = rects + static_cast<size_t>(i) * 4;
      float x0 = r[0], y0 = r[1], cw = r[2], ch = r[3];
      if (cw <= 0 || ch <= 0) {  // sentinel: whole image
        x0 = 0; y0 = 0; cw = w; ch = h;
      }
      crop_resize(rgb.data(), h, w, x0, y0, cw, ch,
                  out + static_cast<size_t>(i) * oh * ow * 3, oh, ow,
                  flips[i] != 0);
    }
  };
  int nt = n_threads > 0 ? n_threads : 1;
  if (nt > n) nt = n;
  std::vector<std::thread> pool;
  for (int t = 1; t < nt; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return failed.load();
}

}  // extern "C"
