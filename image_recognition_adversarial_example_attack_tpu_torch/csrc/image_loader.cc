// Native batch image loader: threaded JPEG/PNG/BMP decode -> antialiased
// bilinear resize (shorter side -> 256, PIL-equivalent triangle filter) ->
// center crop 224 -> float32 NHWC in [0,1].
//
// Role: the framework's data-plane runtime. The reference decodes with
// PIL per image on the Python thread (defense_experiments.py:649-653);
// at TPU attack throughput (hundreds-thousands img/s) single-threaded
// Python decode becomes the pipeline bottleneck. This loader saturates
// host cores and feeds batches directly into pinned numpy buffers.
//
// C ABI only (consumed via ctypes — no pybind11 in the image).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

// libpng is optional: without it the loader still builds and serves the
// JPEG/BMP fast paths; PNG rows fall back to the caller's PIL decoder.
#if defined(__has_include)
#if __has_include(<png.h>)
#define ADV_HAVE_PNG 1
#include <png.h>
#endif
#endif

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG file into interleaved RGB u8. Returns false on failure.
bool decode_jpeg(const char* path, std::vector<uint8_t>* out, int* w, int* h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;

  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);

  *w = static_cast<int>(cinfo.output_width);
  *h = static_cast<int>(cinfo.output_height);
  out->resize(static_cast<size_t>(*w) * (*h) * 3);
  const int stride = (*w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() + static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return true;
}

bool decode_image(const char* path, std::vector<uint8_t>* out, int* w, int* h);

// PIL-style separable resample with a triangle (bilinear) filter whose
// support scales with the downscale ratio (antialiasing) — the same
// algorithm Pillow uses for Image.resize(..., BILINEAR).
struct FilterTap {
  int first;
  std::vector<double> weights;  // normalized
};

void build_taps(int in_size, int out_size, std::vector<FilterTap>* taps) {
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 1.0 * filterscale;  // bilinear support = 1
  taps->resize(out_size);
  for (int i = 0; i < out_size; ++i) {
    const double center = (i + 0.5) * scale;
    int xmin = static_cast<int>(std::max(0.0, std::floor(center - support)));
    int xmax = static_cast<int>(std::min(static_cast<double>(in_size),
                                         std::ceil(center + support)));
    auto& tap = (*taps)[i];
    tap.first = xmin;
    tap.weights.resize(xmax - xmin);
    double total = 0.0;
    for (int x = xmin; x < xmax; ++x) {
      const double t = std::abs((x + 0.5 - center) / filterscale);
      const double wgt = t < 1.0 ? 1.0 - t : 0.0;
      tap.weights[x - xmin] = wgt;
      total += wgt;
    }
    if (total > 0) {
      for (auto& wv : tap.weights) wv /= total;
    }
  }
}

// Resize interleaved RGB u8 [h,w] -> float32 [out_h,out_w] (separable).
void resize_rgb(const uint8_t* src, int w, int h, int out_w, int out_h,
                std::vector<float>* dst) {
  std::vector<FilterTap> htaps, vtaps;
  build_taps(w, out_w, &htaps);
  build_taps(h, out_h, &vtaps);

  // horizontal pass: [h, out_w, 3]
  std::vector<float> tmp(static_cast<size_t>(h) * out_w * 3);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * w * 3;
    float* trow = tmp.data() + static_cast<size_t>(y) * out_w * 3;
    for (int x = 0; x < out_w; ++x) {
      const auto& tap = htaps[x];
      double acc[3] = {0, 0, 0};
      for (size_t k = 0; k < tap.weights.size(); ++k) {
        const uint8_t* px = row + (tap.first + k) * 3;
        const double wgt = tap.weights[k];
        acc[0] += wgt * px[0];
        acc[1] += wgt * px[1];
        acc[2] += wgt * px[2];
      }
      trow[x * 3 + 0] = static_cast<float>(acc[0]);
      trow[x * 3 + 1] = static_cast<float>(acc[1]);
      trow[x * 3 + 2] = static_cast<float>(acc[2]);
    }
  }

  // vertical pass: [out_h, out_w, 3]
  dst->resize(static_cast<size_t>(out_h) * out_w * 3);
  for (int y = 0; y < out_h; ++y) {
    const auto& tap = vtaps[y];
    float* drow = dst->data() + static_cast<size_t>(y) * out_w * 3;
    for (int x = 0; x < out_w * 3; ++x) {
      double acc = 0;
      for (size_t k = 0; k < tap.weights.size(); ++k) {
        acc += tap.weights[k] *
               tmp[static_cast<size_t>(tap.first + k) * out_w * 3 + x];
      }
      drow[x] = static_cast<float>(acc);
    }
  }
}

// Round half to even, matching Python's round() used by the PIL pipeline
// (core/images.py); plain lround rounds half away and shifts odd crops by 1.
int round_half_even(double v) {
  const double fl = std::floor(v);
  const double diff = v - fl;
  if (diff > 0.5) return static_cast<int>(fl) + 1;
  if (diff < 0.5) return static_cast<int>(fl);
  const int lo = static_cast<int>(fl);
  return (lo % 2 == 0) ? lo : lo + 1;
}

// One image: decode -> shorter-side resize -> center crop -> [0,1] floats.
bool process_one(const char* path, int resize_to, int crop, float* out) {
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  if (!decode_image(path, &rgb, &w, &h)) return false;

  // long side TRUNCATES like torchvision's _compute_resized_output_size
  int new_w, new_h;
  if (w <= h) {
    new_w = resize_to;
    new_h = std::max(1, static_cast<int>(static_cast<double>(h) * resize_to / w));
  } else {
    new_h = resize_to;
    new_w = std::max(1, static_cast<int>(static_cast<double>(w) * resize_to / h));
  }
  std::vector<float> resized;
  resize_rgb(rgb.data(), w, h, new_w, new_h, &resized);

  const int left = round_half_even((new_w - crop) / 2.0);
  const int top = round_half_even((new_h - crop) / 2.0);
  for (int y = 0; y < crop; ++y) {
    const int sy = std::min(std::max(top + y, 0), new_h - 1);
    for (int x = 0; x < crop; ++x) {
      const int sx = std::min(std::max(left + x, 0), new_w - 1);
      const float* px = resized.data() + (static_cast<size_t>(sy) * new_w + sx) * 3;
      float* dst = out + (static_cast<size_t>(y) * crop + x) * 3;
      // PIL stores the resized image as u8 before ToTensor's /255; match
      // that quantization (round-half-even like Pillow's +0.5 floor ≈ round)
      dst[0] = std::min(255.0f, std::max(0.0f, std::round(px[0]))) / 255.0f;
      dst[1] = std::min(255.0f, std::max(0.0f, std::round(px[1]))) / 255.0f;
      dst[2] = std::min(255.0f, std::max(0.0f, std::round(px[2]))) / 255.0f;
    }
  }
  return true;
}

// Headers can claim absurd dimensions before any pixel data is validated;
// cap total pixels so a crafted file can't trigger a multi-GB allocation
// (PIL's decompression-bomb limit has the same role; its default is ~89M).
constexpr uint64_t kMaxPixels = 100000000;  // 100 MP ~ 300 MB RGB

// Decode a PNG file into interleaved RGB u8 (palette/gray/16-bit expanded,
// alpha dropped — PIL's Image.convert("RGB") semantics). False on failure.
#if !defined(ADV_HAVE_PNG)
bool decode_png(const char*, std::vector<uint8_t>*, int*, int*) { return false; }
#else
bool decode_png(const char* path, std::vector<uint8_t>* out, int* w, int* h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(f);
    return false;
  }
  png_infop info = png_create_info_struct(png);
  // Constructed BEFORE setjmp: a libpng longjmp lands back here and we
  // return through normal scope exit, so destructors still run (jumping
  // over a live non-trivially-destructible object would be UB + a leak).
  std::vector<png_bytep> rows;
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, info ? &info : nullptr, nullptr);
    std::fclose(f);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);

  const png_byte color = png_get_color_type(png, info);
  const png_byte depth = png_get_bit_depth(png, info);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);  // PIL convert("RGB") drops alpha
  png_set_interlace_handling(png);
  png_read_update_info(png, info);

  const uint64_t pw = png_get_image_width(png, info);
  const uint64_t ph = png_get_image_height(png, info);
  if (pw == 0 || ph == 0 || pw * ph > kMaxPixels ||
      png_get_rowbytes(png, info) != static_cast<size_t>(pw) * 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(f);
    return false;
  }
  *w = static_cast<int>(pw);
  *h = static_cast<int>(ph);
  out->resize(static_cast<size_t>(*w) * (*h) * 3);
  rows.resize(*h);
  for (int y = 0; y < *h; ++y)
    rows[y] = out->data() + static_cast<size_t>(y) * (*w) * 3;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(f);
  return true;
}
#endif  // ADV_HAVE_PNG

uint32_t read_u32le(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) | (static_cast<uint32_t>(p[3]) << 24);
}

// Decode an uncompressed (BI_RGB) 24/32-bit BMP into interleaved RGB u8.
// Handles bottom-up (positive height) and top-down rows. False otherwise.
bool decode_bmp(const char* path, std::vector<uint8_t>* out, int* w, int* h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  const long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (fsize < 54) {
    std::fclose(f);
    return false;
  }
  std::vector<uint8_t> buf(static_cast<size_t>(fsize));
  const bool read_ok = std::fread(buf.data(), 1, buf.size(), f) == buf.size();
  std::fclose(f);
  if (!read_ok || buf[0] != 'B' || buf[1] != 'M') return false;

  const uint32_t data_off = read_u32le(&buf[10]);
  const uint32_t hdr_size = read_u32le(&buf[14]);
  if (hdr_size < 40) return false;  // BITMAPINFOHEADER or later only
  const int32_t bw = static_cast<int32_t>(read_u32le(&buf[18]));
  const int32_t bh = static_cast<int32_t>(read_u32le(&buf[22]));
  const uint16_t bpp = static_cast<uint16_t>(buf[28] | (buf[29] << 8));
  const uint32_t compression = read_u32le(&buf[30]);
  if (bw <= 0 || bh == 0 || compression != 0 || (bpp != 24 && bpp != 32))
    return false;

  const bool top_down = bh < 0;
  if (bh == INT32_MIN) return false;  // -bh below would be signed overflow UB
  const int height = top_down ? -bh : bh;
  if (static_cast<uint64_t>(bw) * height > kMaxPixels) return false;
  const size_t row_bytes = (static_cast<size_t>(bw) * (bpp / 8) + 3) & ~size_t{3};
  if (data_off + row_bytes * height > buf.size()) return false;

  *w = bw;
  *h = height;
  out->resize(static_cast<size_t>(bw) * height * 3);
  for (int y = 0; y < height; ++y) {
    const int sy = top_down ? y : (height - 1 - y);
    const uint8_t* row = buf.data() + data_off + row_bytes * sy;
    uint8_t* drow = out->data() + static_cast<size_t>(y) * bw * 3;
    for (int x = 0; x < bw; ++x) {
      const uint8_t* px = row + static_cast<size_t>(x) * (bpp / 8);
      drow[x * 3 + 0] = px[2];  // BMP stores BGR(A)
      drow[x * 3 + 1] = px[1];
      drow[x * 3 + 2] = px[0];
    }
  }
  return true;
}

// Dispatch on magic bytes so misleading extensions still decode.
bool decode_image(const char* path, std::vector<uint8_t>* out, int* w, int* h) {
  uint8_t magic[8] = {0};
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  const size_t got = std::fread(magic, 1, sizeof(magic), f);
  std::fclose(f);
  if (got >= 2 && magic[0] == 0xFF && magic[1] == 0xD8)
    return decode_jpeg(path, out, w, h);
  if (got >= 8 && !std::memcmp(magic, "\x89PNG\r\n\x1a\n", 8))
    return decode_png(path, out, w, h);
  if (got >= 2 && magic[0] == 'B' && magic[1] == 'M')
    return decode_bmp(path, out, w, h);
  return false;
}

}  // namespace

extern "C" {

// Batch API. paths: n null-terminated strings. out: [n, crop, crop, 3]
// float32. ok: [n] int32 (1 = decoded, 0 = failure — caller falls back to
// its Python decoder for those). Returns number of successes.
int load_batch(const char** paths, int n, int resize_to, int crop,
               int n_threads, float* out, int32_t* ok) {
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 4;
  }
  n_threads = std::min(n_threads, n);
  std::atomic<int> next{0};
  std::atomic<int> n_ok{0};
  const size_t img_elems = static_cast<size_t>(crop) * crop * 3;

  auto worker = [&]() {
    while (true) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      bool good = false;
      try {
        good = process_one(paths[i], resize_to, crop, out + i * img_elems);
      } catch (...) {
        // per-image isolation: an exception (e.g. bad_alloc on a crafted
        // header) must mark THIS row failed, not escape the thread and
        // std::terminate the host process
        good = false;
      }
      ok[i] = good ? 1 : 0;
      if (good) n_ok.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return n_ok.load();
}

int loader_abi_version() { return 2; }  // v2: PNG + BMP decode

}  // extern "C"
