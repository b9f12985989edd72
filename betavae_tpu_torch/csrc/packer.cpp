// Packed-dataset decoder: multithreaded image decode into the packed uint8
// (N, H, W, C) array that the training pipeline uploads to the device.
//
// The port's own copy of the JAX package's decoder
// (betavae_tpu/native/packer.cpp), with the same C interface and the same
// libpng, libjpeg and resize code, so that both packages decode one file to
// the same bytes: libpng's simplified gray conversion for an RGB PNG, and a
// bilinear resize with half-pixel centres and no antialiasing where the
// source size differs from the target.  Built with the host compiler (not
// nvcc) by betavae_tpu_torch/_build.py into build/kernels/ and loaded with
// ctypes by betavae_tpu_torch/data/native.py; data/dataset.py::load_split
// takes it where the JAX load_split does, and PIL where it cannot build or
// an image fails to decode.
//
// C interface:
//   int bv_pack_images(const char** paths, int n, int size, int channels,
//                      unsigned char* out, int n_threads, int* err_index);
// Decodes paths[i] -> out[i*size*size*channels ...], grayscale (channels=1,
// BT.601 luma like PIL convert("L")) or RGB (channels=3), resizing to
// size x size (bilinear) when the source dimensions differ.  Returns the
// number of failed images (first failure index in *err_index, else -1).

#include <png.h>

#include <atomic>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {
#include <jpeglib.h>
}

namespace {

struct Image {
  std::vector<unsigned char> data;  // H * W * C
  int w = 0, h = 0, c = 0;
};

bool read_png(const char* path, Image* im, int want_channels) {
  png_image png;
  std::memset(&png, 0, sizeof(png));
  png.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_file(&png, path)) return false;
  png.format = (want_channels == 1) ? PNG_FORMAT_GRAY : PNG_FORMAT_RGB;
  im->w = png.width;
  im->h = png.height;
  im->c = want_channels;
  im->data.resize(static_cast<size_t>(im->w) * im->h * im->c);
  if (!png_image_finish_read(&png, nullptr, im->data.data(), 0, nullptr)) {
    png_image_free(&png);
    return false;
  }
  return true;
}

bool read_jpeg(const char* path, Image* im, int want_channels) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  cinfo.out_color_space = (want_channels == 1) ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  im->w = cinfo.output_width;
  im->h = cinfo.output_height;
  im->c = cinfo.output_components;
  im->data.resize(static_cast<size_t>(im->w) * im->h * im->c);
  std::vector<unsigned char*> rows(im->h);
  for (int y = 0; y < im->h; ++y)
    rows[y] = im->data.data() + static_cast<size_t>(y) * im->w * im->c;
  while (cinfo.output_scanline < cinfo.output_height) {
    jpeg_read_scanlines(&cinfo, rows.data() + cinfo.output_scanline,
                        cinfo.output_height - cinfo.output_scanline);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return im->c == want_channels;
}

bool decode(const char* path, Image* im, int want_channels) {
  unsigned char magic[4] = {0};
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  size_t got = std::fread(magic, 1, 4, f);
  std::fclose(f);
  if (got < 4) return false;
  if (magic[0] == 0x89 && magic[1] == 'P') return read_png(path, im, want_channels);
  if (magic[0] == 0xFF && magic[1] == 0xD8) return read_jpeg(path, im, want_channels);
  return false;
}

// Bilinear resize (half-pixel centers).  Rarely hit: the preprocessing step
// stores images at the target size already, in which case this is skipped
// and output bytes match the decode exactly.
void resize_bilinear(const Image& src, int size, unsigned char* dst) {
  const float sx = static_cast<float>(src.w) / size;
  const float sy = static_cast<float>(src.h) / size;
  for (int y = 0; y < size; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(std::floor(fy));
    float wy = fy - y0;
    int y1 = y0 + 1;
    if (y0 < 0) y0 = 0;
    if (y1 >= src.h) y1 = src.h - 1;
    if (y0 >= src.h) y0 = src.h - 1;
    for (int x = 0; x < size; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = static_cast<int>(std::floor(fx));
      float wx = fx - x0;
      int x1 = x0 + 1;
      if (x0 < 0) x0 = 0;
      if (x1 >= src.w) x1 = src.w - 1;
      if (x0 >= src.w) x0 = src.w - 1;
      for (int ch = 0; ch < src.c; ++ch) {
        auto at = [&](int yy, int xx) {
          return static_cast<float>(
              src.data[(static_cast<size_t>(yy) * src.w + xx) * src.c + ch]);
        };
        float v = (1 - wy) * ((1 - wx) * at(y0, x0) + wx * at(y0, x1)) +
                  wy * ((1 - wx) * at(y1, x0) + wx * at(y1, x1));
        dst[(static_cast<size_t>(y) * size + x) * src.c + ch] =
            static_cast<unsigned char>(v + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" int bv_pack_images(const char** paths, int n, int size,
                              int channels, unsigned char* out,
                              int n_threads, int* err_index) {
  if (n_threads < 1) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads < 1) n_threads = 1;
  }
  std::atomic<int> next(0);
  std::atomic<int> errors(0);
  std::atomic<int> first_err(-1);
  const size_t stride = static_cast<size_t>(size) * size * channels;

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      Image im;
      if (!decode(paths[i], &im, channels)) {
        errors.fetch_add(1);
        int expected = -1;
        first_err.compare_exchange_strong(expected, i);
        std::memset(out + stride * i, 0, stride);
        continue;
      }
      if (im.w == size && im.h == size) {
        std::memcpy(out + stride * i, im.data.data(), stride);
      } else {
        resize_bilinear(im, size, out + stride * i);
      }
    }
  };

  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  if (err_index) *err_index = first_err.load();
  return errors.load();
}
