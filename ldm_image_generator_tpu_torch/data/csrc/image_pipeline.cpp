// Native image preprocessing pipeline for the data loader.
//
// Replaces the Python/PIL hot path of the dataset cache build
// (reference dataset.py:47-71 semantics): decode JPEG/PNG, aspect-
// preserving nearest resize (+ separable gaussian blur sigma=1 when
// downscaling), centered black square pad, normalize to float32
// NHWC in [-1, 1].
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).
// Thread-safe: no globals; callers may invoke from multiple threads
// (the Python side releases the GIL through ctypes).
//
// Build: data/native_loader.py compiles it at first use (g++ -O3 -shared,
// links libjpeg + libpng).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

struct Image {
  int w = 0, h = 0;
  std::vector<uint8_t> rgb;  // packed RGB, h*w*3
};

// ---------------------------------------------------------------- JPEG

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

bool decode_jpeg(const uint8_t* data, size_t len, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->rgb.assign(size_t(out->w) * out->h * 3, 0);
  const size_t stride = size_t(out->w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->rgb.data() + stride * cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ----------------------------------------------------------------- PNG

struct PngReadCtx {
  const uint8_t* data;
  size_t len;
  size_t pos;
};

void png_read_fn(png_structp png, png_bytep dst, png_size_t n) {
  PngReadCtx* ctx = static_cast<PngReadCtx*>(png_get_io_ptr(png));
  if (ctx->pos + n > ctx->len) {
    png_error(png, "png: truncated");
  }
  memcpy(dst, ctx->data + ctx->pos, n);
  ctx->pos += n;
}

bool decode_png(const uint8_t* data, size_t len, Image* out) {
  if (len < 8 || png_sig_cmp(data, 0, 8)) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  PngReadCtx ctx{data, len, 0};
  png_set_read_fn(png, &ctx, png_read_fn);
  png_read_info(png, info);
  png_set_expand(png);          // palette/gray/low-bit -> 8-bit
  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  out->w = png_get_image_width(png, info);
  out->h = png_get_image_height(png, info);
  out->rgb.assign(size_t(out->w) * out->h * 3, 0);
  std::vector<png_bytep> rows(out->h);
  for (int y = 0; y < out->h; ++y)
    rows[y] = out->rgb.data() + size_t(y) * out->w * 3;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

// ------------------------------------------------------------ pipeline

// PIL-compatible nearest resize: src = floor((dst + 0.5) * scale)
void resize_nearest(const Image& src, int nw, int nh,
                    std::vector<uint8_t>* dst) {
  dst->assign(size_t(nw) * nh * 3, 0);
  const double sx = double(src.w) / nw;
  const double sy = double(src.h) / nh;
  for (int y = 0; y < nh; ++y) {
    int syi = int((y + 0.5) * sy);
    if (syi >= src.h) syi = src.h - 1;
    const uint8_t* srow = src.rgb.data() + size_t(syi) * src.w * 3;
    uint8_t* drow = dst->data() + size_t(y) * nw * 3;
    for (int x = 0; x < nw; ++x) {
      int sxi = int((x + 0.5) * sx);
      if (sxi >= src.w) sxi = src.w - 1;
      memcpy(drow + size_t(x) * 3, srow + size_t(sxi) * 3, 3);
    }
  }
}

// separable gaussian, sigma=1, radius 2 (approximates PIL GaussianBlur(1))
void gaussian_blur_sigma1(std::vector<uint8_t>* img, int w, int h) {
  static const float k[5] = {0.06136f, 0.24477f, 0.38774f, 0.24477f,
                             0.06136f};
  std::vector<float> tmp(size_t(w) * h * 3);
  // horizontal
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      for (int c = 0; c < 3; ++c) {
        float acc = 0.f;
        for (int t = -2; t <= 2; ++t) {
          int xi = x + t;
          if (xi < 0) xi = 0;
          if (xi >= w) xi = w - 1;
          acc += k[t + 2] * (*img)[(size_t(y) * w + xi) * 3 + c];
        }
        tmp[(size_t(y) * w + x) * 3 + c] = acc;
      }
    }
  }
  // vertical
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      for (int c = 0; c < 3; ++c) {
        float acc = 0.f;
        for (int t = -2; t <= 2; ++t) {
          int yi = y + t;
          if (yi < 0) yi = 0;
          if (yi >= h) yi = h - 1;
          acc += k[t + 2] * tmp[(size_t(yi) * w + x) * 3 + c];
        }
        (*img)[(size_t(y) * w + x) * 3 + c] =
            uint8_t(acc + 0.5f > 255.f ? 255 : acc + 0.5f);
      }
    }
  }
}

bool decode_any(const uint8_t* data, size_t len, Image* img) {
  if (len >= 2 && data[0] == 0xFF && data[1] == 0xD8)
    return decode_jpeg(data, len, img);
  if (!png_sig_cmp(data, 0, len < 8 ? len : 8))
    return decode_png(data, len, img);
  // fall through: try both
  return decode_jpeg(data, len, img) || decode_png(data, len, img);
}

}  // namespace

extern "C" {

// Decode + preprocess one image file buffer.
//   data/len : encoded bytes (JPEG or PNG)
//   size     : target square size
//   out      : float32 buffer [size, size, 3], filled with the
//              normalized (-1..1) padded image (-1 = black padding)
// Returns 0 on success, nonzero on decode failure.
int ldm_preprocess(const uint8_t* data, size_t len, int size, float* out) {
  Image img;
  if (!decode_any(data, len, &img) || img.w <= 0 || img.h <= 0) return 1;

  int nw, nh;  // aspect-preserving fit into size x size
  if (img.w > img.h) {
    nw = size;
    nh = img.h * size / img.w;
    if (nh < 1) nh = 1;
  } else {
    nh = size;
    nw = img.w * size / img.h;
    if (nw < 1) nw = 1;
  }
  std::vector<uint8_t> resized;
  resize_nearest(img, nw, nh, &resized);
  if (img.w > nw || img.h > nh) {  // blur when downscaling
    gaussian_blur_sigma1(&resized, nw, nh);
  }

  // centered pad into the float output, black (-1) background
  const size_t total = size_t(size) * size * 3;
  for (size_t i = 0; i < total; ++i) out[i] = -1.0f;
  const int x0 = (size - nw) / 2;
  const int y0 = (size - nh) / 2;
  for (int y = 0; y < nh; ++y) {
    const uint8_t* srow = resized.data() + size_t(y) * nw * 3;
    float* drow = out + (size_t(y0 + y) * size + x0) * 3;
    for (int i = 0; i < nw * 3; ++i) {
      drow[i] = srow[i] / 127.5f - 1.0f;
    }
  }
  return 0;
}

// Decode only: returns width/height via pointers; writes RGB bytes into
// out (caller allocates w*h*3 after a first call with out == null).
int ldm_decode_size(const uint8_t* data, size_t len, int* w, int* h) {
  Image img;
  if (!decode_any(data, len, &img)) return 1;
  *w = img.w;
  *h = img.h;
  return 0;
}

// Thread-pooled batch preprocessing with file IO done natively:
//   paths    : n NUL-terminated file paths
//   size     : target square size
//   out      : float32 buffer [n, size, size, 3] (caller-allocated; may
//              be a pinned host buffer for direct device transfer)
//   status   : int[n], 0 = ok, nonzero = read/decode failure (that
//              image's slot is left all -1 black)
//   threads  : pool width; <= 0 uses hardware_concurrency
// One C call per batch: the GIL is released for the whole batch and
// decode/resize/pad runs across cores without Python dispatch per image.
int ldm_preprocess_batch(const char** paths, int n, int size, float* out,
                         int* status, int threads) {
  if (n <= 0) return 0;
  int pool = threads > 0 ? threads
                         : int(std::thread::hardware_concurrency());
  if (pool < 1) pool = 1;
  if (pool > n) pool = n;
  const size_t per = size_t(size) * size * 3;
  std::atomic<int> next(0);
  std::atomic<int> failures(0);

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      float* dst = out + size_t(i) * per;
      status[i] = 1;
      FILE* f = fopen(paths[i], "rb");
      if (f) {
        fseek(f, 0, SEEK_END);
        long len = ftell(f);
        fseek(f, 0, SEEK_SET);
        if (len > 0) {
          std::vector<uint8_t> buf(static_cast<size_t>(len), 0);
          if (fread(buf.data(), 1, size_t(len), f) == size_t(len)) {
            status[i] =
                ldm_preprocess(buf.data(), buf.size(), size, dst);
          }
        }
        fclose(f);
      }
      if (status[i] != 0) {
        for (size_t j = 0; j < per; ++j) dst[j] = -1.0f;
        failures.fetch_add(1);
      }
    }
  };

  std::vector<std::thread> ts;
  ts.reserve(pool);
  for (int t = 0; t < pool; ++t) ts.emplace_back(worker);
  for (auto& t : ts) t.join();
  return failures.load();
}

}  // extern "C"
