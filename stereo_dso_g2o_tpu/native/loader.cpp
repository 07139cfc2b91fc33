// Native stereo frame loader: threaded PNG/JPEG decode + geometric remap +
// photometric correction + bounded in-order prefetch.
//
// Native runtime equivalent of the reference's C++ data path:
//   - util/DatasetReader.h (ImageFolderReader::getImage :200-226)
//   - IOWrapper/OpenCV/ImageRW_OpenCV.cpp (8/16-bit PNG read)
//   - util/Undistort.cpp remap application (Undistort::undistortGeneric)
//   - util/IndexThreadReduce.h (persistent worker pool)
// The decode+undistort work runs on host worker threads so the device
// pipeline (one XLA program per frame) never waits on image I/O.
//
// C API (ctypes-friendly); all images float32 row-major.
//   sdso_decode_gray(path, out, out_cap, &w, &h)      one-shot decode
//   sdso_loader_open(...)                              start prefetch pool
//   sdso_loader_next(h, out_left, out_right)           blocking, in order
//   sdso_loader_close(h)
//
// Build: g++ -O3 -shared -fPIC loader.cpp -lpng -ljpeg -lz -lpthread

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {
#include <jpeglib.h>
}

namespace {

// ---------------------------------------------------------------------------
// decoding
// ---------------------------------------------------------------------------

// Grayscale conversion weights matching the Python reader (io/dataset.py).
constexpr float kR = 0.299f, kG = 0.587f, kB = 0.114f;

bool decode_png_gray(const char* path, std::vector<float>& out, int* w,
                     int* h) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    return false;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    if (png) png_destroy_read_struct(&png, info ? &info : nullptr, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  const int width = png_get_image_width(png, info);
  const int height = png_get_image_height(png, info);
  const int bit_depth = png_get_bit_depth(png, info);
  const int color = png_get_color_type(png, info);

  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);
  if (bit_depth == 16) png_set_swap(png);  // little-endian u16
  png_read_update_info(png, info);

  const int channels = png_get_channels(png, info);
  const size_t rowbytes = png_get_rowbytes(png, info);
  std::vector<png_byte> data(rowbytes * height);
  std::vector<png_bytep> rows(height);
  for (int y = 0; y < height; y++) rows[y] = data.data() + y * rowbytes;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);

  out.resize(size_t(width) * height);
  const float scale16 = 255.0f / 65535.0f;  // match io/dataset.py 16-bit path
  for (int y = 0; y < height; y++) {
    float* dst = out.data() + size_t(y) * width;
    if (bit_depth == 16) {
      const uint16_t* src = reinterpret_cast<const uint16_t*>(rows[y]);
      if (channels == 1)
        for (int x = 0; x < width; x++) dst[x] = src[x] * scale16;
      else
        for (int x = 0; x < width; x++)
          dst[x] = (kR * src[x * channels] + kG * src[x * channels + 1] +
                    kB * src[x * channels + 2]) *
                   scale16;
    } else {
      const uint8_t* src = rows[y];
      if (channels == 1)
        for (int x = 0; x < width; x++) dst[x] = float(src[x]);
      else
        for (int x = 0; x < width; x++)
          dst[x] = kR * src[x * channels] + kG * src[x * channels + 1] +
                   kB * src[x * channels + 2];
    }
  }
  *w = width;
  *h = height;
  return true;
}

struct JpegErr {
  jpeg_error_mgr mgr;
  std::jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  std::longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jb, 1);
}

bool decode_jpeg_gray(const char* path, std::vector<float>& out, int* w,
                      int* h) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_GRAYSCALE;  // libjpeg uses ITU-R 601 weights
  jpeg_start_decompress(&cinfo);
  const int width = cinfo.output_width, height = cinfo.output_height;
  out.resize(size_t(width) * height);
  std::vector<uint8_t> row(width);
  uint8_t* rp = row.data();
  for (int y = 0; y < height; y++) {
    jpeg_read_scanlines(&cinfo, &rp, 1);
    float* dst = out.data() + size_t(y) * width;
    for (int x = 0; x < width; x++) dst[x] = float(row[x]);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(fp);
  *w = width;
  *h = height;
  return true;
}

bool has_suffix(const char* s, const char* suf) {
  const size_t n = std::strlen(s), m = std::strlen(suf);
  return n >= m && !std::strcmp(s + n - m, suf);
}

bool decode_gray(const char* path, std::vector<float>& out, int* w, int* h) {
  if (has_suffix(path, ".jpg") || has_suffix(path, ".jpeg"))
    return decode_jpeg_gray(path, out, w, h);
  return decode_png_gray(path, out, w, h);
}

// ---------------------------------------------------------------------------
// remap + photometric (the per-frame tail of ImageFolderReader::getImage)
// ---------------------------------------------------------------------------

struct Calibration {
  int out_w = 0, out_h = 0;      // final (cropped) size
  std::vector<float> remap_x;    // out_h*out_w source coords; <0 -> invalid
  std::vector<float> remap_y;
  std::vector<float> gamma;      // 256-entry inverse response (or empty)
  std::vector<float> vignette_inv;  // out_h*out_w 1/V (or empty)
};

// src (sw x sh) -> dst (out_w x out_h): bilinear remap (or plain crop when no
// remap table), then gamma LUT + vignette division — single pass per pixel.
void postprocess(const std::vector<float>& src, int sw, int sh, float* dst,
                 const Calibration& c) {
  const bool remap = !c.remap_x.empty();
  const bool gamma = !c.gamma.empty();
  const bool vig = !c.vignette_inv.empty();
  for (int y = 0; y < c.out_h; y++) {
    for (int x = 0; x < c.out_w; x++) {
      const size_t o = size_t(y) * c.out_w + x;
      float v;
      if (remap) {
        const float fx = c.remap_x[o], fy = c.remap_y[o];
        if (fx < 0.f || fy < 0.f || fx >= sw - 1 || fy >= sh - 1) {
          v = 0.f;
        } else {
          const int ix = int(fx), iy = int(fy);
          const float ax = fx - ix, ay = fy - iy;
          const float* p = src.data() + size_t(iy) * sw + ix;
          v = (1 - ay) * ((1 - ax) * p[0] + ax * p[1]) +
              ay * ((1 - ax) * p[sw] + ax * p[sw + 1]);
        }
      } else {
        v = (y < sh && x < sw) ? src[size_t(y) * sw + x] : 0.f;
      }
      if (gamma) {
        int i = int(v);
        if (i < 0) i = 0;
        if (i > 255) i = 255;
        v = c.gamma[i];
      }
      if (vig) v *= c.vignette_inv[o];
      dst[o] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// prefetch pool
// ---------------------------------------------------------------------------

struct Slot {
  std::vector<float> left, right;
  bool ready = false;
  bool failed = false;
};

struct Loader {
  std::vector<std::string> lpaths, rpaths;
  Calibration calib;
  int capacity = 8;

  std::vector<Slot> ring;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready;   // consumer waits on slot ready
  std::condition_variable cv_space;   // workers wait for ring space
  std::atomic<int> next_claim{0};
  int cursor = 0;  // next frame index the consumer will take
  bool stop = false;

  int n() const { return int(lpaths.size()); }

  void worker() {
    std::vector<float> buf;
    for (;;) {
      const int idx = next_claim.fetch_add(1);
      if (idx >= n()) return;
      // bound the readahead: wait until idx is within [cursor, cursor+cap)
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] { return stop || idx < cursor + capacity; });
        if (stop) return;
      }
      Slot& s = ring[idx % capacity];
      s.failed = false;
      int w = 0, h = 0;
      const size_t px = size_t(calib.out_w) * calib.out_h;
      s.left.resize(px);
      s.right.resize(px);
      if (decode_gray(lpaths[idx].c_str(), buf, &w, &h))
        postprocess(buf, w, h, s.left.data(), calib);
      else
        s.failed = true;
      if (decode_gray(rpaths[idx].c_str(), buf, &w, &h))
        postprocess(buf, w, h, s.right.data(), calib);
      else
        s.failed = true;
      {
        std::lock_guard<std::mutex> lk(mu);
        s.ready = true;
      }
      cv_ready.notify_all();
    }
  }

  int take(float* out_l, float* out_r) {
    if (cursor >= n()) return -1;
    Slot& s = ring[cursor % capacity];
    {
      std::unique_lock<std::mutex> lk(mu);
      cv_ready.wait(lk, [&] { return s.ready; });
    }
    const int idx = cursor;
    const int rc = s.failed ? -2 : idx;
    const size_t bytes = sizeof(float) * size_t(calib.out_w) * calib.out_h;
    std::memcpy(out_l, s.left.data(), bytes);
    std::memcpy(out_r, s.right.data(), bytes);
    {
      std::lock_guard<std::mutex> lk(mu);
      s.ready = false;
      cursor = idx + 1;
    }
    cv_space.notify_all();
    return rc;
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_space.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
  }
};

}  // namespace

extern "C" {

// One-shot decode into caller buffer (cap floats); returns 0 on success.
int sdso_decode_gray(const char* path, float* out, long cap, int* w, int* h) {
  std::vector<float> buf;
  if (!decode_gray(path, buf, w, h)) return -1;
  if (long(buf.size()) > cap) return -2;
  std::memcpy(out, buf.data(), buf.size() * sizeof(float));
  return 0;
}

void* sdso_loader_open(const char** left_paths, const char** right_paths,
                       int n_frames, int n_workers, int capacity, int out_w,
                       int out_h, const float* remap_x, const float* remap_y,
                       const float* gamma_lut, const float* vignette_inv) {
  auto* L = new Loader();
  L->lpaths.assign(left_paths, left_paths + n_frames);
  L->rpaths.assign(right_paths, right_paths + n_frames);
  L->calib.out_w = out_w;
  L->calib.out_h = out_h;
  const size_t px = size_t(out_w) * out_h;
  if (remap_x && remap_y) {
    L->calib.remap_x.assign(remap_x, remap_x + px);
    L->calib.remap_y.assign(remap_y, remap_y + px);
  }
  if (gamma_lut) L->calib.gamma.assign(gamma_lut, gamma_lut + 256);
  if (vignette_inv)
    L->calib.vignette_inv.assign(vignette_inv, vignette_inv + px);
  if (capacity < 2) capacity = 2;
  L->capacity = capacity;
  L->ring.resize(capacity);
  if (n_workers < 1) n_workers = 1;
  for (int i = 0; i < n_workers; i++)
    L->workers.emplace_back([L] { L->worker(); });
  return L;
}

// Blocking in-order fetch. Returns the frame index, -1 at end of sequence,
// -2 if decoding that frame failed (buffers zero-filled).
int sdso_loader_next(void* handle, float* out_left, float* out_right) {
  return static_cast<Loader*>(handle)->take(out_left, out_right);
}

void sdso_loader_close(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"
