// PIL's bicubic resample of 8-bit RGB frames, bit for bit, for
// media/preprocess.py (Pillow's src/libImaging/Resample.c: precompute_coeffs,
// normalize_coeffs_8bpc, ImagingResampleHorizontal_8bpc and
// ImagingResampleVertical_8bpc, with its a = -0.5 cubic). The taps cover the
// antialiased support (2 * max(scale, 1) input pixels each side), are
// normalized to sum to 1 and rounded to 22 fractional bits; a horizontal
// pass clipped to uint8 comes first, then a vertical one. Frames are split
// among threads.
//
// Build: media/_native.py (g++ -O3 -shared at first use, with
// -ffp-contract=off so that the taps round as PIL's do), no dependency.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;

double bicubic(double x) {
  const double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

struct Taps {
  int ksize;
  std::vector<int> bounds;   // first input pixel and tap count an output
  std::vector<int32_t> k;    // ksize fixed-point taps an output
};

Taps precompute(int in_size, int out_size) {
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 2.0 * filterscale;
  const double ss = 1.0 / filterscale;
  Taps t;
  t.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  t.bounds.assign(2 * out_size, 0);
  t.k.assign(static_cast<size_t>(out_size) * t.ksize, 0);
  std::vector<double> w(t.ksize);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      w[x] = bicubic((x + xmin - center + 0.5) * ss);
      ww += w[x];
    }
    int32_t* k = &t.k[static_cast<size_t>(xx) * t.ksize];
    for (int x = 0; x < xmax; ++x) {
      const double v = ww != 0.0 ? w[x] / ww : w[x];
      k[x] = static_cast<int32_t>(v < 0 ? -0.5 + v * (1 << kPrecisionBits)
                                        : 0.5 + v * (1 << kPrecisionBits));
    }
    t.bounds[2 * xx] = xmin;
    t.bounds[2 * xx + 1] = xmax;
  }
  return t;
}

inline uint8_t clip8(int in) {
  if (in >= (1 << kPrecisionBits << 8)) return 255;
  if (in <= 0) return 0;
  return static_cast<uint8_t>(in >> kPrecisionBits);
}

// in: h x w x 3 -> out: h x out_w x 3
void horizontal(const uint8_t* in, int h, int w, const Taps& t, int out_w,
                uint8_t* out) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = in + static_cast<size_t>(y) * w * 3;
    uint8_t* dst = out + static_cast<size_t>(y) * out_w * 3;
    for (int xx = 0; xx < out_w; ++xx) {
      const int xmin = t.bounds[2 * xx], xmax = t.bounds[2 * xx + 1];
      const int32_t* k = &t.k[static_cast<size_t>(xx) * t.ksize];
      int ss0 = 1 << (kPrecisionBits - 1), ss1 = ss0, ss2 = ss0;
      for (int x = 0; x < xmax; ++x) {
        const uint8_t* px = row + (x + xmin) * 3;
        ss0 += px[0] * k[x];
        ss1 += px[1] * k[x];
        ss2 += px[2] * k[x];
      }
      dst[xx * 3] = clip8(ss0);
      dst[xx * 3 + 1] = clip8(ss1);
      dst[xx * 3 + 2] = clip8(ss2);
    }
  }
}

// in: h x w x 3 -> out: out_h x w x 3
void vertical(const uint8_t* in, int w, const Taps& t, int out_h,
              uint8_t* out) {
  const size_t stride = static_cast<size_t>(w) * 3;
  std::vector<int32_t> acc(stride);
  for (int yy = 0; yy < out_h; ++yy) {
    const int ymin = t.bounds[2 * yy], ymax = t.bounds[2 * yy + 1];
    const int32_t* k = &t.k[static_cast<size_t>(yy) * t.ksize];
    // the same sums as PIL's, row by row so that the inner loop vectorizes
    std::fill(acc.begin(), acc.end(), 1 << (kPrecisionBits - 1));
    for (int y = 0; y < ymax; ++y) {
      const uint8_t* row = in + (y + ymin) * stride;
      const int32_t ky = k[y];
      for (size_t i = 0; i < stride; ++i) acc[i] += row[i] * ky;
    }
    uint8_t* dst = out + yy * stride;
    for (size_t i = 0; i < stride; ++i) dst[i] = clip8(acc[i]);
  }
}

}  // namespace

// frames: n x h x w x 3 uint8 -> out: n x out_h x out_w x 3, each frame what
// PIL's Image.resize((out_w, out_h), Image.BICUBIC) gives. Returns 0, or 1
// on a size below 1.
extern "C" int resample_bicubic(const uint8_t* frames, long n, int h, int w,
                                uint8_t* out, int out_h, int out_w,
                                int threads) {
  if (n < 0 || h < 1 || w < 1 || out_h < 1 || out_w < 1) return 1;
  const Taps th = precompute(w, out_w);
  const Taps tv = precompute(h, out_h);
  const size_t in_size = static_cast<size_t>(h) * w * 3;
  const size_t out_size = static_cast<size_t>(out_h) * out_w * 3;
  auto run = [&](long first, long step) {
    std::vector<uint8_t> tmp(static_cast<size_t>(h) * out_w * 3);
    for (long i = first; i < n; i += step) {
      const uint8_t* src = frames + i * in_size;
      uint8_t* dst = out + i * out_size;
      if (w != out_w && h != out_h) {
        horizontal(src, h, w, th, out_w, tmp.data());
        vertical(tmp.data(), out_w, tv, out_h, dst);
      } else if (w != out_w) {
        horizontal(src, h, w, th, out_w, dst);
      } else if (h != out_h) {
        vertical(src, w, tv, out_h, dst);
      } else {
        std::memcpy(dst, src, in_size);
      }
    }
  };
  const long workers = std::max(1L, std::min<long>(threads, n));
  std::vector<std::thread> pool;
  for (long t = 1; t < workers; ++t) pool.emplace_back(run, t, workers);
  run(0, workers);
  for (auto& t : pool) t.join();
  return 0;
}
