// s4_native: the host data path's native runtime for s4former_tpu_torch.
//
// The port's copy of s4former_tpu/native/src/s4_native.cpp with a plain C
// interface in place of the Python C API, loaded with ctypes
// (s4former_tpu_torch/native/__init__.py). ctypes releases the interpreter
// lock for the length of every foreign call, so the loader's threads
// (data/loader.py) decode and augment in parallel.
//
// What it computes, each bit-exact to a plain version in
// s4former_tpu_torch/data/pipelines/transforms.py (tests/test_torch_native.py
// and chip_smoke.py's phase `native` hold them to it):
//   - s4_decode: JPEG/PNG -> RGB uint8, or a label PNG -> uint8 indices
//     (PIL's Image.open(...).convert('RGB') / np.asarray(Image.open(...)));
//     compiled in only where jpeglib.h and png.h are found (s4_has_decode);
//   - s4_resize: PIL Image.resize, BILINEAR (the antialiased triangle
//     filter in PIL's fixed point) and NEAREST;
//   - s4_convert_u8, s4_saturation_u8, s4_hue_u8: PhotoMetricDistortion's
//     brightness/contrast and its cv2-convention HSV jitters;
//   - s4_normalize_f32: (u8 RGB - mean) / std.
//
// Buffers: the caller owns every input and output, except the decoder's
// output, whose size is known only once the header is read: s4_decode
// hands back a buffer of its own, which the caller copies and releases
// with s4_free. Nothing here throws across the C interface: failures
// return nonzero with a message.

#include <cmath>
#include <csetjmp>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <vector>

#if __has_include(<jpeglib.h>) && __has_include(<png.h>)
#define S4_HAS_DECODE 1
#include <jpeglib.h>
#include <png.h>
#else
#define S4_HAS_DECODE 0
#endif

namespace {

#if S4_HAS_DECODE
// ---------------------------------------------------------------------
// JPEG decode (libjpeg, JCS_RGB, default ISLOW DCT like PIL)
// ---------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

bool decode_jpeg_rgb(const uint8_t* data, size_t len,
                     std::vector<uint8_t>& out, int& h, int& w,
                     std::string& err) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    err = "libjpeg: decode failed";
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  w = static_cast<int>(cinfo.output_width);
  h = static_cast<int>(cinfo.output_height);
  out.resize(static_cast<size_t>(h) * w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out.data() +
        static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ---------------------------------------------------------------------
// PNG decode (libpng, from-memory read)
// ---------------------------------------------------------------------

struct PngSrc {
  const uint8_t* data;
  size_t len;
  size_t off;
};

void png_read_cb(png_structp p, png_bytep dst, png_size_t n) {
  PngSrc* s = static_cast<PngSrc*>(png_get_io_ptr(p));
  if (s->off + n > s->len) png_error(p, "unexpected EOF");
  memcpy(dst, s->data + s->off, n);
  s->off += n;
}

// rgb=true  -> 3-channel RGB (PIL convert('RGB'): palette expanded, gray
//              replicated, alpha dropped, 16-bit stripped).
// rgb=false -> label mode: palette stays as raw indices, gray stays gray,
//              RGB(A) reduced to channel 0 (the loader's `seg[..., 0]`).
//              Output is 1 channel.
bool decode_png(const uint8_t* data, size_t len, bool rgb,
                std::vector<uint8_t>& out, int& h, int& w, int& c,
                std::string& err) {
  png_structp p =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr,
                             nullptr);
  if (!p) { err = "libpng: alloc failed"; return false; }
  png_infop info = png_create_info_struct(p);
  if (!info) {
    png_destroy_read_struct(&p, nullptr, nullptr);
    err = "libpng: alloc failed";
    return false;
  }
  // declared before setjmp, so a longjmp skips no constructor
  std::vector<uint8_t> raw;
  std::vector<png_bytep> rows;
  if (setjmp(png_jmpbuf(p))) {
    png_destroy_read_struct(&p, &info, nullptr);
    err = "libpng: decode failed";
    return false;
  }
  PngSrc src{data, len, 0};
  png_set_read_fn(p, &src, png_read_cb);
  png_read_info(p, info);

  png_byte color_type = png_get_color_type(p, info);
  png_byte bit_depth = png_get_bit_depth(p, info);

  if (bit_depth == 16) png_set_strip_16(p);
  if (rgb) {
    if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(p);
    if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
      png_set_expand_gray_1_2_4_to_8(p);
    if (color_type == PNG_COLOR_TYPE_GRAY ||
        color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
      png_set_gray_to_rgb(p);
    png_set_strip_alpha(p);
  } else {
    // sub-byte packed pixels (palette or gray) unpack to one byte each
    // without scaling
    if (color_type == PNG_COLOR_TYPE_PALETTE && bit_depth < 8)
      png_set_packing(p);
    if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
      png_set_expand_gray_1_2_4_to_8(p);
    png_set_strip_alpha(p);
  }
  png_read_update_info(p, info);

  w = static_cast<int>(png_get_image_width(p, info));
  h = static_cast<int>(png_get_image_height(p, info));
  int channels = static_cast<int>(png_get_channels(p, info));
  size_t rowbytes = png_get_rowbytes(p, info);

  raw.resize(static_cast<size_t>(h) * rowbytes);
  rows.resize(h);
  for (int y = 0; y < h; y++) rows[y] = raw.data() + (size_t)y * rowbytes;
  png_read_image(p, rows.data());
  png_destroy_read_struct(&p, &info, nullptr);

  if (rgb) {
    if (channels != 3) { err = "png: expected 3 channels"; return false; }
    c = 3;
    out = std::move(raw);
  } else {
    c = 1;
    if (channels == 1 && rowbytes == static_cast<size_t>(w)) {
      out = std::move(raw);
    } else {
      out.resize(static_cast<size_t>(h) * w);
      for (int y = 0; y < h; y++) {
        const uint8_t* r = raw.data() + (size_t)y * rowbytes;
        uint8_t* o = out.data() + (size_t)y * w;
        for (int x = 0; x < w; x++) o[x] = r[(size_t)x * channels];
      }
    }
  }
  return true;
}
#endif  // S4_HAS_DECODE

bool is_png(const uint8_t* d, size_t n) {
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', 0x0d, 0x0a,
                                 0x1a, 0x0a};
  return n >= 8 && memcmp(d, sig, 8) == 0;
}

bool is_jpeg(const uint8_t* d, size_t n) {
  return n >= 3 && d[0] == 0xff && d[1] == 0xd8 && d[2] == 0xff;
}

// ---------------------------------------------------------------------
// PIL-semantics resampling, 8 bits/channel fixed-point path.
//
// Triangle (bilinear) filter with antialias support scaling on
// downsample, coefficients quantized to 1<<PRECISION_BITS with
// round-half-away, accumulators seeded with the rounding constant, and
// a horizontal-then-vertical pass order on uint8 intermediates: PIL's
// documented resampling algorithm.
// ---------------------------------------------------------------------

constexpr int PRECISION_BITS = 32 - 8 - 2;

inline uint8_t clip8(int in) {
  if (in >= (255 << PRECISION_BITS)) return 255;
  if (in <= 0) return 0;
  return static_cast<uint8_t>(in >> PRECISION_BITS);
}

inline double triangle_filter(double x) {
  if (x < 0.0) x = -x;
  return x < 1.0 ? 1.0 - x : 0.0;
}

// Per-output-pixel integer coefficient table for one axis.
void precompute_coeffs(int in_size, int out_size,
                       std::vector<int>& bounds, std::vector<int>& kk,
                       int& ksize) {
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = filterscale;  // triangle filter support = 1.0
  ksize = static_cast<int>(ceil(support)) * 2 + 1;
  double ss = 1.0 / filterscale;

  bounds.resize(static_cast<size_t>(out_size) * 2);
  std::vector<double> kd(static_cast<size_t>(out_size) * ksize, 0.0);
  for (int xx = 0; xx < out_size; xx++) {
    double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = kd.data() + static_cast<size_t>(xx) * ksize;
    double wsum = 0.0;
    for (int x = 0; x < xmax; x++) {
      double wv = triangle_filter((x + xmin - center + 0.5) * ss);
      k[x] = wv;
      wsum += wv;
    }
    if (wsum != 0.0)
      for (int x = 0; x < xmax; x++) k[x] /= wsum;
    bounds[xx * 2] = xmin;
    bounds[xx * 2 + 1] = xmax;
  }
  kk.resize(kd.size());
  for (size_t i = 0; i < kd.size(); i++) {
    double v = kd[i] * (1 << PRECISION_BITS);
    kk[i] = static_cast<int>(v < 0 ? v - 0.5 : v + 0.5);
  }
}

// Horizontal pass: [h, in_w, c] u8 -> [h, out_w, c] u8.
void resample_horizontal(const uint8_t* in, uint8_t* out, int h,
                         int in_w, int out_w, int c,
                         const std::vector<int>& bounds,
                         const std::vector<int>& kk, int ksize) {
  for (int yy = 0; yy < h; yy++) {
    const uint8_t* irow = in + static_cast<size_t>(yy) * in_w * c;
    uint8_t* orow = out + static_cast<size_t>(yy) * out_w * c;
    for (int xx = 0; xx < out_w; xx++) {
      int xmin = bounds[xx * 2], xmax = bounds[xx * 2 + 1];
      const int* k = kk.data() + static_cast<size_t>(xx) * ksize;
      for (int ch = 0; ch < c; ch++) {
        int ss = 1 << (PRECISION_BITS - 1);
        const uint8_t* ip = irow + static_cast<size_t>(xmin) * c + ch;
        for (int x = 0; x < xmax; x++) ss += ip[(size_t)x * c] * k[x];
        orow[static_cast<size_t>(xx) * c + ch] = clip8(ss);
      }
    }
  }
}

// Vertical pass: [in_h, w, c] u8 -> [out_h, w, c] u8.
void resample_vertical(const uint8_t* in, uint8_t* out, int out_h, int w,
                       int c, const std::vector<int>& bounds,
                       const std::vector<int>& kk, int ksize) {
  size_t row = static_cast<size_t>(w) * c;
  for (int yy = 0; yy < out_h; yy++) {
    int ymin = bounds[yy * 2], ymax = bounds[yy * 2 + 1];
    const int* k = kk.data() + static_cast<size_t>(yy) * ksize;
    uint8_t* orow = out + static_cast<size_t>(yy) * row;
    for (size_t i = 0; i < row; i++) {
      int ss = 1 << (PRECISION_BITS - 1);
      const uint8_t* ip = in + static_cast<size_t>(ymin) * row + i;
      for (int y = 0; y < ymax; y++) ss += ip[(size_t)y * row] * k[y];
      orow[i] = clip8(ss);
    }
  }
}

void resize_bilinear_u8(const uint8_t* in, int in_h, int in_w, int c,
                        int out_h, int out_w, uint8_t* out) {
  std::vector<int> xb, xk, yb, yk;
  int xks, yks;
  precompute_coeffs(in_w, out_w, xb, xk, xks);
  precompute_coeffs(in_h, out_h, yb, yk, yks);
  // horizontal first on the full-height image, then vertical: PIL's pass
  // order (the uint8 rounding between the passes depends on it)
  std::vector<uint8_t> tmp(static_cast<size_t>(in_h) * out_w * c);
  resample_horizontal(in, tmp.data(), in_h, in_w, out_w, c, xb, xk, xks);
  resample_vertical(tmp.data(), out, out_h, out_w, c, yb, yk, yks);
}

// PIL NEAREST: samples at pixel centres with the coordinate accumulated
// incrementally (xo starts at scale/2 and steps by scale, truncated); on
// downscales PIL's accumulation order decides the pixel, so it is
// repeated rather than computed as (x + 0.5) * scale per pixel.
void resize_nearest_u8(const uint8_t* in, int in_h, int in_w, int c,
                       int out_h, int out_w, uint8_t* out) {
  double sx = static_cast<double>(in_w) / out_w;
  double sy = static_cast<double>(in_h) / out_h;
  std::vector<int> xmap(out_w);
  double xo = sx * 0.5;
  for (int x = 0; x < out_w; x++) {
    int xi = static_cast<int>(xo);
    xmap[x] = xi < in_w ? xi : in_w - 1;
    xo += sx;
  }
  double yo = sy * 0.5;
  for (int y = 0; y < out_h; y++) {
    int yi = static_cast<int>(yo);
    yo += sy;
    if (yi >= in_h) yi = in_h - 1;
    const uint8_t* irow = in + static_cast<size_t>(yi) * in_w * c;
    uint8_t* orow = out + static_cast<size_t>(y) * out_w * c;
    if (c == 1) {
      for (int x = 0; x < out_w; x++) orow[x] = irow[xmap[x]];
    } else if (c == 3) {
      for (int x = 0; x < out_w; x++) {
        const uint8_t* s = irow + static_cast<size_t>(xmap[x]) * 3;
        uint8_t* d = orow + static_cast<size_t>(x) * 3;
        d[0] = s[0]; d[1] = s[1]; d[2] = s[2];
      }
    } else {
      for (int x = 0; x < out_w; x++)
        memcpy(orow + static_cast<size_t>(x) * c,
               irow + static_cast<size_t>(xmap[x]) * c, c);
    }
  }
}

// ---------------------------------------------------------------------
// PhotoMetricDistortion primitives (cv2-convention HSV), one pass per
// pixel, no intermediate arrays. Bit-exact to the numpy plain versions
// (the same f32 arithmetic in the same order; np.round is round-half-even,
// nearbyintf here; the uint8 casts in _convert truncate). The library is
// built with -ffp-contract=off, so no product and sum fuse into an FMA
// that numpy does not do.
// ---------------------------------------------------------------------

inline uint8_t trunc_clip_u8(float v) {
  if (v < 0.0f) return 0;
  if (v > 255.0f) return 255;
  return static_cast<uint8_t>(v);  // truncation, as astype(np.uint8)
}

// uint8 RGB -> cv2-style quantized HSV ints (H in [0,180), S/V in
// [0,255]): transforms.py _rgb_to_hsv_cv.
inline void px_rgb_to_hsv(uint8_t r8, uint8_t g8, uint8_t b8, int& hh,
                          int& ss, int& vv) {
  float r = r8 / 255.0f, g = g8 / 255.0f, b = b8 / 255.0f;
  float mx = r > g ? (r > b ? r : b) : (g > b ? g : b);
  float mn = r < g ? (r < b ? r : b) : (g < b ? g : b);
  float diff = mx - mn;
  float h = 0.0f;
  if (diff > 0.0f) {
    if (mx == r) {
      // 60*(g-b)/diff is in (-60, 60): the mod-360 is one branch
      h = 60.0f * (g - b) / diff;
      if (h < 0.0f) h += 360.0f;
    } else if (mx == g) {
      h = 60.0f * (b - r) / diff + 120.0f;
    } else {
      h = 60.0f * (r - g) / diff + 240.0f;
    }
  }
  float s = mx > 0.0f ? diff / mx : 0.0f;
  hh = static_cast<int>(nearbyintf(h / 2.0f)) % 180;  // round-half-even
  float ssf = nearbyintf(s * 255.0f);
  ss = ssf < 0 ? 0 : (ssf > 255 ? 255 : static_cast<int>(ssf));
  float vvf = nearbyintf(mx * 255.0f);
  vv = vvf < 0 ? 0 : (vvf > 255 ? 255 : static_cast<int>(vvf));
}

// quantized HSV ints -> uint8 RGB: transforms.py _hsv_to_rgb_cv.
inline void px_hsv_to_rgb(int hh, int ss, int vv, uint8_t& r8,
                          uint8_t& g8, uint8_t& b8) {
  float h = hh * 2.0f;
  float s = ss / 255.0f;
  float v = vv / 255.0f;
  float c = v * s;
  float hp = h / 60.0f;  // in [0, 6)
  int ip = static_cast<int>(hp);
  // fmodf(hp, 2) == hp - 2*trunc(hp/2), exact in f32 for hp in [0, 6)
  float x = c * (1.0f - fabsf(hp - 2.0f * (ip / 2) - 1.0f));
  int idx = ip % 6;
  float rf = 0, gf = 0, bf = 0;
  switch (idx) {
    case 0: rf = c; gf = x; break;
    case 1: rf = x; gf = c; break;
    case 2: gf = c; bf = x; break;
    case 3: gf = x; bf = c; break;
    case 4: rf = x; bf = c; break;
    default: rf = c; bf = x; break;
  }
  float m = v - c;
  auto q = [](float f) {
    float r = nearbyintf(f * 255.0f);
    return static_cast<uint8_t>(r < 0 ? 0 : (r > 255 ? 255 : r));
  };
  r8 = q(rf + m);
  g8 = q(gf + m);
  b8 = q(bf + m);
}

}  // namespace

// ---------------------------------------------------------------------
// The C interface (ctypes)
// ---------------------------------------------------------------------

extern "C" {

// 1 when the decoders are compiled in (jpeglib.h and png.h were found)
int s4_has_decode(void) { return S4_HAS_DECODE; }

// Frees a buffer that s4_decode handed back.
void s4_free(void* handle) {
  delete static_cast<std::vector<uint8_t>*>(handle);
}

// JPEG/PNG bytes -> uint8 [h, w, c] (label=0: RGB, c = 3; label=1: a
// label PNG's raw indices, c = 1). On success returns 0 and sets *handle
// (for s4_free) and *pixels; else returns 1 with a message in err.
int s4_decode(const uint8_t* data, size_t len, int label, void** handle,
              const uint8_t** pixels, int* h, int* w, int* c, char* err,
              int errlen) {
  std::string msg;
  *handle = nullptr;
  try {
#if S4_HAS_DECODE
    std::vector<uint8_t> out;
    bool ok = false;
    if (is_jpeg(data, len)) {
      if (!label) {
        ok = decode_jpeg_rgb(data, len, out, *h, *w, msg);
        *c = 3;
      } else {
        msg = "labels must be PNG";
      }
    } else if (is_png(data, len)) {
      ok = decode_png(data, len, !label, out, *h, *w, *c, msg);
    } else {
      msg = "unsupported image format (not JPEG/PNG)";
    }
    if (ok) {
      auto* v = new std::vector<uint8_t>(std::move(out));
      *handle = v;
      *pixels = v->data();
      return 0;
    }
#else
    (void)data; (void)len; (void)label; (void)pixels; (void)h; (void)w;
    (void)c;
    msg = "built without jpeglib.h/png.h: no decoder";
#endif
  } catch (const std::bad_alloc&) {
    msg = "out of memory";
  }
  snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
  return 1;
}

// PIL Image.resize of uint8 [in_h, in_w, c] into out [out_h, out_w, c]:
// BILINEAR, or NEAREST when nearest != 0. Returns 0, or 1 on bad sizes or
// no memory.
int s4_resize(const uint8_t* in, int in_h, int in_w, int c, int out_h,
              int out_w, int nearest, uint8_t* out) {
  if (in_h <= 0 || in_w <= 0 || out_h <= 0 || out_w <= 0 || c <= 0 ||
      c > 16)
    return 1;
  try {
    if (nearest)
      resize_nearest_u8(in, in_h, in_w, c, out_h, out_w, out);
    else
      resize_bilinear_u8(in, in_h, in_w, c, out_h, out_w, out);
  } catch (const std::bad_alloc&) {
    return 1;
  }
  return 0;
}

// out = clip(in * alpha + beta, 0, 255) truncated to uint8
// (PhotoMetricDistortion._convert), over n values.
void s4_convert_u8(const uint8_t* in, size_t n, float alpha, float beta,
                   uint8_t* out) {
  for (size_t i = 0; i < n; i++)
    out[i] = trunc_clip_u8(in[i] * alpha + beta);
}

// Saturation jitter on npx RGB pixels: RGB -> HSV, S *= alpha
// (truncate-clip), -> RGB.
void s4_saturation_u8(const uint8_t* in, size_t npx, float alpha,
                      uint8_t* out) {
  for (size_t i = 0; i < npx; i++) {
    int hh, ss, vv;
    px_rgb_to_hsv(in[i * 3], in[i * 3 + 1], in[i * 3 + 2], hh, ss, vv);
    ss = trunc_clip_u8(ss * alpha);
    px_hsv_to_rgb(hh, ss, vv, out[i * 3], out[i * 3 + 1], out[i * 3 + 2]);
  }
}

// Hue jitter on npx RGB pixels: RGB -> HSV, H = (H + dh) mod 180, -> RGB.
void s4_hue_u8(const uint8_t* in, size_t npx, int dh, uint8_t* out) {
  for (size_t i = 0; i < npx; i++) {
    int hh, ss, vv;
    px_rgb_to_hsv(in[i * 3], in[i * 3 + 1], in[i * 3 + 2], hh, ss, vv);
    hh = ((hh + dh) % 180 + 180) % 180;
    px_hsv_to_rgb(hh, ss, vv, out[i * 3], out[i * 3 + 1], out[i * 3 + 2]);
  }
}

// (in - mean) / std on npx u8 RGB pixels -> f32 (Normalize). A true
// division, not a reciprocal product, as numpy divides.
void s4_normalize_f32(const uint8_t* in, size_t npx, const float* mean,
                      const float* std3, float* out) {
  for (size_t i = 0; i < npx; i++)
    for (int c = 0; c < 3; c++)
      out[i * 3 + c] = (in[i * 3 + c] - mean[c]) / std3[c];
}

}  // extern "C"
