// Host data-loader core of the port: file read, JPEG/PNG decode, bilinear
// resize to the drawn short edge, horizontal flip, RGB -> BGR swap and
// paste onto the zeroed canvas, in one call that the caller makes without
// the interpreter lock (ctypes releases it), so the loader's threads
// decode in parallel.
//
// Port of the JAX package's native extension (its C++ core, with a plain C
// interface in place of the Python C API). The float32 arithmetic, its
// order, the + 0.5f truncation and the clamps are the same, so the outputs
// are bitwise equal. Build without -ffast-math, -march=native or FMA
// contraction (aldi_tpu_torch/ops/_build.py): each would round otherwise.
//
// With ALDI_CODECS defined (libjpeg and libpng, linked with -ljpeg -lpng)
// the library reads and decodes files itself (aldi_load_resize_pad). Without
// it only aldi_resize_pad is built, on RGB pixels the caller decoded.
//
//   int aldi_load_resize_pad(path, short_edge, max_size, canvas_h, canvas_w,
//                            bgr, flip, canvas, out_hw, scale)
//       0, or nonzero when the file cannot be read or decoded.
//   int aldi_resize_pad(rgb, h, w, short_edge, max_size, canvas_h,
//                       canvas_w, bgr, flip, canvas, out_hw, scale)
//       rgb: h x w x 3 uint8. 0, or nonzero when memory runs out.
// canvas: canvas_h x canvas_w x 3 uint8, zeroed by the caller; out_hw: the
// resized (clamped) height and width; scale: the resize factor.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#ifdef ALDI_CODECS
#include <csetjmp>

#include <jpeglib.h>
#include <png.h>
#endif

namespace {

struct Image {
  int h = 0, w = 0;
  const unsigned char* rgb = nullptr;  // H*W*3
  std::vector<unsigned char> owned;
};

#ifdef ALDI_CODECS
bool read_file(const char* path, std::vector<unsigned char>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n < 0) {
    std::fclose(f);
    return false;
  }
  out->resize(n);
  size_t got = std::fread(out->data(), 1, n, f);
  std::fclose(f);
  return got == static_cast<size_t>(n);
}

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

bool decode_jpeg(const std::vector<unsigned char>& buf, Image* img) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf.data(), buf.size());
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  img->h = cinfo.output_height;
  img->w = cinfo.output_width;
  img->owned.resize(static_cast<size_t>(img->h) * img->w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = img->owned.data() +
        static_cast<size_t>(cinfo.output_scanline) * img->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  img->rgb = img->owned.data();
  return true;
}

bool decode_png(const std::vector<unsigned char>& buf, Image* img) {
  png_image pi;
  std::memset(&pi, 0, sizeof(pi));
  pi.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&pi, buf.data(), buf.size()))
    return false;
  pi.format = PNG_FORMAT_RGB;
  img->h = pi.height;
  img->w = pi.width;
  img->owned.resize(PNG_IMAGE_SIZE(pi));
  if (!png_image_finish_read(&pi, nullptr, img->owned.data(), 0, nullptr)) {
    png_image_free(&pi);
    return false;
  }
  img->rgb = img->owned.data();
  return true;
}

bool decode(const std::vector<unsigned char>& buf, Image* img) {
  if (buf.size() >= 8 && buf[0] == 0x89 && buf[1] == 'P') {
    return decode_png(buf, img);
  }
  if (buf.size() >= 2 && buf[0] == 0xFF && buf[1] == 0xD8) {
    return decode_jpeg(buf, img);
  }
  return false;
}
#endif  // ALDI_CODECS

// Bilinear resize (PIL-compatible half-pixel sampling) fused with optional
// horizontal flip, optional RGB->BGR swap, and paste into the canvas.
void resize_flip_swap_paste(const Image& src, int out_h, int out_w,
                            bool flip, bool bgr, unsigned char* canvas,
                            int canvas_w_stride) {
  const float sy = static_cast<float>(src.h) / out_h;
  const float sx = static_cast<float>(src.w) / out_w;
  const int c0 = bgr ? 2 : 0;
  const int c2 = bgr ? 0 : 2;
  std::vector<int> x0s(out_w), x1s(out_w);
  std::vector<float> lxs(out_w);
  for (int ox = 0; ox < out_w; ++ox) {
    const int ix = flip ? (out_w - 1 - ox) : ox;
    float fx = (ix + 0.5f) * sx - 0.5f;
    fx = std::max(0.0f, std::min(fx, static_cast<float>(src.w - 1)));
    x0s[ox] = static_cast<int>(fx);
    x1s[ox] = std::min(x0s[ox] + 1, src.w - 1);
    lxs[ox] = fx - x0s[ox];
  }
  for (int oy = 0; oy < out_h; ++oy) {
    float fy = (oy + 0.5f) * sy - 0.5f;
    fy = std::max(0.0f, std::min(fy, static_cast<float>(src.h - 1)));
    const int y0 = static_cast<int>(fy);
    const int y1 = std::min(y0 + 1, src.h - 1);
    const float ly = fy - y0;
    const unsigned char* r0 = src.rgb + static_cast<size_t>(y0) * src.w * 3;
    const unsigned char* r1 = src.rgb + static_cast<size_t>(y1) * src.w * 3;
    unsigned char* dst = canvas + static_cast<size_t>(oy) * canvas_w_stride * 3;
    for (int ox = 0; ox < out_w; ++ox) {
      const int x0 = x0s[ox] * 3, x1 = x1s[ox] * 3;
      const float lx = lxs[ox];
      for (int ch = 0; ch < 3; ++ch) {
        const float top = r0[x0 + ch] * (1 - lx) + r0[x1 + ch] * lx;
        const float bot = r1[x0 + ch] * (1 - lx) + r1[x1 + ch] * lx;
        const float v = top * (1 - ly) + bot * ly;
        const int oc = (ch == 0) ? c0 : (ch == 2 ? c2 : 1);
        dst[ox * 3 + oc] = static_cast<unsigned char>(v + 0.5f);
      }
    }
  }
}

// The short edge to short_edge, the long one capped at max_size; the
// resized size clamped to the canvas before the resize (the image is then
// squeezed into the canvas, not cropped).
void scale_and_paste(const Image& img, int short_edge, int max_size,
                     int canvas_h, int canvas_w, bool bgr, bool flip,
                     unsigned char* canvas, int* out_hw, double* scale) {
  double s = static_cast<double>(short_edge) / std::min(img.h, img.w);
  if (std::max(img.h, img.w) * s > max_size)
    s = static_cast<double>(max_size) / std::max(img.h, img.w);
  const int out_h = std::min(static_cast<int>(img.h * s + 0.5), canvas_h);
  const int out_w = std::min(static_cast<int>(img.w * s + 0.5), canvas_w);
  resize_flip_swap_paste(img, out_h, out_w, flip, bgr, canvas, canvas_w);
  out_hw[0] = out_h;
  out_hw[1] = out_w;
  *scale = s;
}

}  // namespace

extern "C" {

#ifdef ALDI_CODECS
int aldi_load_resize_pad(const char* path, int short_edge, int max_size,
                         int canvas_h, int canvas_w, int bgr, int flip,
                         uint8_t* canvas, int* out_hw, double* scale) {
  try {
    std::vector<unsigned char> buf;
    Image img;
    if (!read_file(path, &buf) || !decode(buf, &img)) return 1;
    scale_and_paste(img, short_edge, max_size, canvas_h, canvas_w, bgr, flip,
                    canvas, out_hw, scale);
  } catch (...) {  // no C++ exception may cross the C interface
    return 2;
  }
  return 0;
}
#endif

int aldi_resize_pad(const uint8_t* rgb, int h, int w, int short_edge,
                    int max_size, int canvas_h, int canvas_w, int bgr,
                    int flip, uint8_t* canvas, int* out_hw, double* scale) {
  try {
    Image img;
    img.h = h;
    img.w = w;
    img.rgb = rgb;
    scale_and_paste(img, short_edge, max_size, canvas_h, canvas_w, bgr, flip,
                    canvas, out_hw, scale);
  } catch (...) {
    return 2;
  }
  return 0;
}

}  // extern "C"
