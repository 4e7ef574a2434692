// WebP bitstreams -> pixels, for media/webp.py (which walks the RIFF
// container). The output is the one libwebp gives with its default
// WebPDecoderConfig (fancy upsampling on, no dithering), as PIL decodes
// through WebPAnimDecoder into RGBA, bit for bit:
//   - VP8L (lossless; the 2023 WebP Lossless Bitstream specification):
//     prefix codes in groups selected by the meta prefix image, the color
//     cache, LZ77 backward references with the 120-entry distance map, and
//     the predictor (14 modes; 14 and 15 predict black, as libwebp's
//     table pads them), cross-color, subtract-green and color-indexing
//     (with pixel bundling) transforms, undone in reverse order. The same
//     decoder reads an ALPH chunk of compression 1: a VP8L stream without
//     its header whose green channel is the alpha.
//   - ALPH: compression 0 (raw) and 1, then the none / horizontal /
//     vertical / gradient unfilter of libwebp's filters.c.
//   - VP8 (lossy; RFC 6386) key frames: the boolean decoder, the frame
//     header (segments, quantizer and loop-filter deltas, token
//     partitions), coefficient-probability updates, token decoding with
//     skip, the dequantizers, the inverse WHT and DCT, 16x16 / 4x4 /
//     chroma intra prediction with libwebp's edge samples (127 above the
//     frame, 129 left of it), and the normal and simple loop filters with
//     their sharpness and per-macroblock interior limits. Prediction reads
//     unfiltered samples, so the frame is reconstructed first and filtered
//     after, in macroblock order, as libwebp's delayed filtering gives.
//   - libwebp's output stage for VP8: the "fancy" upsampler (the 9-3-3-1
//     chroma filter over pairs of rows, the first and last rows on their
//     own) and its 14-bit fixed-point YUV -> RGB (yuv.h VP8YUVToR/G/B).
// The constant tables (coefficient and update probabilities, 4x4 mode
// probabilities, quantizer steps, the distance map) are RFC 6386's and the
// lossless specification's, in libwebp's mode order.
//
// Build: media/_native.py (g++ -O3 -shared at first use), no dependency.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Error{msg}; }

int report(const Error& e, char* msg, int msglen) {
  if (msg && msglen > 0) std::snprintf(msg, msglen, "%s", e.msg.c_str());
  return 1;
}

// ---------------------------------------------------------------------------
// VP8L

// LSB-first bits. Past the end the stream reads as zeros; it has ended
// (libwebp's VP8LIsEndOfStream) once more bits were consumed than it holds,
// counted as libwebp counts them: a stream under 8 bytes holds 64.
class LBits {
 public:
  LBits(const uint8_t* data, size_t n)
      : data_(data), len_(n), limit_(std::max<uint64_t>(64, 8ull * n)) {}

  uint32_t peek(int n) const {
    const uint64_t byte = pos_ >> 3;
    uint64_t w = 0;
    if (byte + 8 <= len_) {
      std::memcpy(&w, data_ + byte, 8);
    } else {
      for (uint64_t i = 0; i < 8 && byte + i < len_; ++i)
        w |= static_cast<uint64_t>(data_[byte + i]) << (8 * i);
    }
    return static_cast<uint32_t>((w >> (pos_ & 7)) & ((1ull << n) - 1));
  }
  void skip(int n) { pos_ += n; }
  uint32_t read(int n) {
    const uint32_t v = peek(n);
    pos_ += n;
    return v;
  }
  bool ended() const { return pos_ > limit_; }
  void check(const char* where) const {
    if (ended()) fail(std::string("VP8L: the stream ends inside ") + where);
  }

 private:
  const uint8_t* data_;
  uint64_t len_, limit_, pos_ = 0;
};

// A canonical prefix code read LSB-first: an 8-bit root table and second
// level tables for longer codes. A code with a single used symbol has no
// bits. Incomplete and over-subscribed codes are refused, as libwebp's
// VP8LBuildHuffmanTable refuses them.
class PrefixCode {
 public:
  bool build(const uint8_t* lengths, int n) {
    int count[16] = {0};
    int used = 0, last = 0;
    for (int i = 0; i < n; ++i) {
      if (lengths[i] > 15) return false;
      ++count[lengths[i]];
      if (lengths[i]) ++used, last = i;
    }
    if (used == 0) return false;
    if (used == 1) {
      single_ = true;
      symbol_ = static_cast<uint16_t>(last);
      return true;
    }
    single_ = false;
    int open = 1;
    for (int len = 1; len <= 15; ++len) {
      open = 2 * open - count[len];
      if (open < 0) return false;
    }
    if (open != 0) return false;
    int next[16];
    int code = 0;
    count[0] = 0;
    for (int len = 1; len <= 15; ++len) {
      code = (code + count[len - 1]) << 1;
      next[len] = code;
    }
    std::vector<uint16_t> rev(n);
    int sub_bits[256] = {0};
    for (int s = 0; s < n; ++s) {
      const int len = lengths[s];
      if (!len) continue;
      const int c = next[len]++;
      int r = 0;
      for (int b = 0; b < len; ++b) r |= ((c >> b) & 1) << (len - 1 - b);
      rev[s] = static_cast<uint16_t>(r);
      if (len > 8)
        sub_bits[r & 255] = std::max(sub_bits[r & 255], len - 8);
    }
    table_.assign(256, Entry{0, 0, 0});
    size_t total = 256;
    for (int r = 0; r < 256; ++r) {
      if (!sub_bits[r]) continue;
      table_[r] = Entry{static_cast<uint16_t>(total),
                        static_cast<uint8_t>(sub_bits[r]), 1};
      total += size_t{1} << sub_bits[r];
    }
    table_.resize(total, Entry{0, 0, 0});
    for (int s = 0; s < n; ++s) {
      const int len = lengths[s];
      if (!len) continue;
      const int r = rev[s];
      if (len <= 8) {
        for (int k = r; k < 256; k += 1 << len)
          table_[k] = Entry{static_cast<uint16_t>(s),
                            static_cast<uint8_t>(len), 0};
      } else {
        const Entry& root = table_[r & 255];
        for (int k = r >> 8; k < (1 << root.bits); k += 1 << (len - 8))
          table_[root.value + k] = Entry{static_cast<uint16_t>(s),
                                         static_cast<uint8_t>(len - 8), 0};
      }
    }
    return true;
  }

  int read(LBits& br) const {
    if (single_) return symbol_;
    const uint32_t w = br.peek(15);
    const Entry& root = table_[w & 255];
    if (!root.sub) {
      br.skip(root.bits);
      return root.value;
    }
    const Entry& e = table_[root.value + ((w >> 8) & ((1u << root.bits) - 1))];
    br.skip(8 + e.bits);
    return e.value;
  }

 private:
  struct Entry {
    uint16_t value;
    uint8_t bits;
    uint8_t sub;
  };
  std::vector<Entry> table_;
  bool single_ = false;
  uint16_t symbol_ = 0;
};

struct PrefixGroup {
  PrefixCode code[5];  // green + length + cache, red, blue, alpha, distance
};

struct Transform {
  int type;   // 0 predictor, 1 cross-color, 2 subtract-green, 3 indexing
  int bits;   // tile bits (0, 1) or bundling bits (3)
  int xsize;  // the width it applies to
  std::vector<uint32_t> data;
};

inline int subsample(int size, int bits) {
  return (size + (1 << bits) - 1) >> bits;
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline uint32_t clip255(int v) {
  return v < 0 ? 0 : v > 255 ? 255 : static_cast<uint32_t>(v);
}

inline int sub3(int a, int b, int c) {
  const int pb = b - c, pa = a - c;
  return std::abs(pb) - std::abs(pa);
}

// libwebp's Select: `a` top, `b` left, `c` top-left
inline uint32_t select(uint32_t a, uint32_t b, uint32_t c) {
  int d = 0;
  for (int s = 0; s < 32; s += 8)
    d += sub3((a >> s) & 0xff, (b >> s) & 0xff, (c >> s) & 0xff);
  return d <= 0 ? a : b;
}

inline uint32_t clamped_add_sub_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= clip255(static_cast<int>((c0 >> s) & 0xff) +
                   static_cast<int>((c1 >> s) & 0xff) -
                   static_cast<int>((c2 >> s) & 0xff)) << s;
  return out;
}

inline uint32_t clamped_add_sub_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (ave >> s) & 0xff, b = (c2 >> s) & 0xff;
    out |= clip255(a + (a - b) / 2) << s;  // C division: toward zero
  }
  return out;
}

inline uint32_t predict(int mode, uint32_t L, uint32_t T, uint32_t TL,
                        uint32_t TR) {
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: return select(T, L, TL);
    case 12: return clamped_add_sub_full(L, T, TL);
    case 13: return clamped_add_sub_half(L, T, TL);
    default: return 0xff000000u;  // 0, and 14 and 15 as libwebp pads them
  }
}

// the lossless distance map: (dy << 4) | (8 - dx) for the 120 short
// distance codes
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57,
    21, 27, 54, 58, 37, 43, 72, 4, 71, 73, 20, 28, 53, 59, 70, 74,
    36, 44, 88, 69, 75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30, 102, 106, 34, 46,
    84, 92, 67, 77, 101, 107, 50, 62, 120, 1, 119, 121, 83, 93, 17, 31,
    100, 108, 66, 78, 118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125, 81, 95, 64, 114,
    126, 97, 111, 80, 113, 127, 96, 112,
};

class VP8LDecoder {
 public:
  VP8LDecoder(const uint8_t* data, size_t n) : br_(data, n) {}

  // A headed stream (a VP8L chunk): the 5-byte header, then the image.
  std::vector<uint32_t> decode_headed(int* width, int* height) {
    if (br_.read(8) != 0x2f) fail("VP8L: bad signature");
    *width = static_cast<int>(br_.read(14)) + 1;
    *height = static_cast<int>(br_.read(14)) + 1;
    br_.read(1);  // alpha_is_used: a hint only
    if (br_.read(3) != 0) fail("VP8L: unknown version");
    return stream(*width, *height, true);
  }

  // A headerless stream of a known size (an ALPH chunk's).
  std::vector<uint32_t> decode_plain(int width, int height) {
    return stream(width, height, true);
  }

 private:
  LBits br_;
  unsigned seen_ = 0;

  // One entropy-coded image; the level-0 one may carry transforms and a
  // meta prefix image, and comes back with its transforms undone.
  std::vector<uint32_t> stream(int xsize, int ysize, bool level0) {
    std::vector<Transform> transforms;
    int coded_xsize = xsize;
    if (level0) {
      while (br_.read(1)) {
        read_transform(&coded_xsize, ysize, &transforms);
        br_.check("a transform");
      }
    }
    int cache_bits = 0;
    if (br_.read(1)) {
      cache_bits = static_cast<int>(br_.read(4));
      if (cache_bits < 1 || cache_bits > 11)
        fail("VP8L: color cache of " + std::to_string(cache_bits) +
             " bits");
    }
    int meta_bits = 0, meta_xsize = 0;
    std::vector<uint32_t> meta;
    size_t num_groups = 1;
    if (level0 && br_.read(1)) {
      meta_bits = static_cast<int>(br_.read(3)) + 2;
      meta_xsize = subsample(coded_xsize, meta_bits);
      meta = stream(meta_xsize, subsample(ysize, meta_bits), false);
      for (uint32_t& m : meta) {
        m = (m >> 8) & 0xffff;
        num_groups = std::max<size_t>(num_groups, m + 1);
      }
    }
    br_.check("the prefix codes");
    std::vector<PrefixGroup> groups(num_groups);
    const int cache_size = cache_bits ? 1 << cache_bits : 0;
    static const int kAlphabet[5] = {256 + 24, 256, 256, 256, 40};
    for (PrefixGroup& g : groups)
      for (int j = 0; j < 5; ++j)
        read_code(kAlphabet[j] + (j == 0 ? cache_size : 0), &g.code[j]);
    br_.check("the prefix codes");
    std::vector<uint32_t> px(static_cast<size_t>(coded_xsize) * ysize);
    decode_pixels(px.data(), coded_xsize, ysize, groups, meta, meta_xsize,
                  meta_bits, cache_bits);
    for (auto t = transforms.rbegin(); t != transforms.rend(); ++t)
      inverse(*t, ysize, &px);
    return px;
  }

  void read_transform(int* xsize, int ysize, std::vector<Transform>* out) {
    const int type = static_cast<int>(br_.read(2));
    if (seen_ & (1u << type)) fail("VP8L: a transform is repeated");
    seen_ |= 1u << type;
    Transform t{type, 0, *xsize, {}};
    if (type == 0 || type == 1) {
      t.bits = static_cast<int>(br_.read(3)) + 2;
      t.data = stream(subsample(*xsize, t.bits), subsample(ysize, t.bits),
                      false);
    } else if (type == 3) {
      const int colors = static_cast<int>(br_.read(8)) + 1;
      t.bits = colors > 16 ? 0 : colors > 4 ? 1 : colors > 2 ? 2 : 3;
      *xsize = subsample(t.xsize, t.bits);
      std::vector<uint32_t> pal = stream(colors, 1, false);
      // delta-coded palette, zeros (transparent black) past its end
      t.data.assign(size_t{1} << (8 >> t.bits), 0);
      t.data[0] = pal[0];
      for (int i = 1; i < colors; ++i)
        t.data[i] = add_pixels(pal[i], t.data[i - 1]);
    }
    out->push_back(std::move(t));
  }

  void read_code(int alphabet, PrefixCode* code) {
    std::vector<uint8_t> lengths(std::max(alphabet, 256), 0);
    if (br_.read(1)) {  // simple code: one or two symbols of length 1
      const int num = static_cast<int>(br_.read(1)) + 1;
      const int first_bits = br_.read(1) ? 8 : 1;
      lengths[br_.read(first_bits)] = 1;
      if (num == 2) lengths[br_.read(8)] = 1;
    } else {
      static const int kOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                     7, 8, 9, 10, 11, 12, 13, 14, 15};
      uint8_t cl_lengths[19] = {0};
      const int num = static_cast<int>(br_.read(4)) + 4;
      for (int i = 0; i < num; ++i)
        cl_lengths[kOrder[i]] = static_cast<uint8_t>(br_.read(3));
      PrefixCode cl;
      if (!cl.build(cl_lengths, 19))
        fail("VP8L: bad code-length code");
      int max_symbol = alphabet;
      if (br_.read(1)) {
        const int nbits = 2 + 2 * static_cast<int>(br_.read(3));
        max_symbol = 2 + static_cast<int>(br_.read(nbits));
        if (max_symbol > alphabet)
          fail("VP8L: more code lengths than symbols");
      }
      int symbol = 0, prev = 8;
      while (symbol < alphabet) {
        if (max_symbol-- == 0) break;
        const int len = cl.read(br_);
        if (len < 16) {
          lengths[symbol++] = static_cast<uint8_t>(len);
          if (len) prev = len;
        } else {
          static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
          const int repeat = static_cast<int>(br_.read(kExtra[len - 16])) +
                             kOffset[len - 16];
          if (symbol + repeat > alphabet)
            fail("VP8L: code lengths repeat past the alphabet");
          const uint8_t v = static_cast<uint8_t>(len == 16 ? prev : 0);
          for (int i = 0; i < repeat; ++i) lengths[symbol++] = v;
        }
      }
    }
    br_.check("a prefix code");
    if (!code->build(lengths.data(), alphabet))
      fail("VP8L: bad prefix code");
  }

  uint32_t copy_value(int symbol) {
    if (symbol < 4) return symbol + 1;
    const int extra = (symbol - 2) >> 1;
    const uint32_t offset = static_cast<uint32_t>(2 + (symbol & 1)) << extra;
    return offset + br_.read(extra) + 1;
  }

  static uint64_t plane_distance(int xsize, uint32_t code) {
    if (code > 120) return code - 120;
    const int c = kCodeToPlane[code - 1];
    const int64_t d = static_cast<int64_t>(c >> 4) * xsize + 8 - (c & 0xf);
    return d >= 1 ? static_cast<uint64_t>(d) : 1;
  }

  void decode_pixels(uint32_t* px, int xsize, int ysize,
                     const std::vector<PrefixGroup>& groups,
                     const std::vector<uint32_t>& meta, int meta_xsize,
                     int meta_bits, int cache_bits) {
    std::vector<uint32_t> cache(cache_bits ? size_t{1} << cache_bits : 0);
    const int shift = 32 - cache_bits;
    const uint64_t total = static_cast<uint64_t>(xsize) * ysize;
    uint64_t pos = 0;
    int x = 0, y = 0;
    auto insert = [&](uint32_t argb) {
      if (cache_bits) cache[(0x1e35a7bdu * argb) >> shift] = argb;
    };
    while (pos < total) {
      const PrefixGroup& g =
          meta_bits ? groups[meta[static_cast<size_t>(y >> meta_bits) *
                                      meta_xsize + (x >> meta_bits)]]
                    : groups[0];
      const int code = g.code[0].read(br_);
      if (code < 256) {
        const uint32_t red = g.code[1].read(br_);
        const uint32_t blue = g.code[2].read(br_);
        const uint32_t alpha = g.code[3].read(br_);
        br_.check("the pixels");
        px[pos] = (alpha << 24) | (red << 16) |
                  (static_cast<uint32_t>(code) << 8) | blue;
        insert(px[pos++]);
        if (++x >= xsize) x = 0, ++y;
      } else if (code < 256 + 24) {
        const uint64_t length = copy_value(code - 256);
        const int dist_symbol = g.code[4].read(br_);
        const uint64_t dist = plane_distance(xsize, copy_value(dist_symbol));
        br_.check("the pixels");
        if (dist > pos || length > total - pos)
          fail("VP8L: a backward reference outside the image");
        for (uint64_t i = 0; i < length; ++i, ++pos) {
          px[pos] = px[pos - dist];
          insert(px[pos]);
        }
        x += static_cast<int>(length % xsize);
        y += static_cast<int>(length / xsize);
        if (x >= xsize) x -= xsize, ++y;
      } else {
        br_.check("the pixels");
        px[pos] = cache[code - 256 - 24];
        insert(px[pos++]);
        if (++x >= xsize) x = 0, ++y;
      }
    }
    br_.check("the pixels");
  }

  void inverse(const Transform& t, int ysize, std::vector<uint32_t>* pixels) {
    const int w = t.xsize;
    uint32_t* d = pixels->data();
    if (t.type == 2) {  // add green to red and blue
      for (uint32_t& p : *pixels) {
        const uint32_t g = (p >> 8) & 0xff;
        p = (p & 0xff00ff00u) | ((((p >> 16) + g) & 0xff) << 16) |
            ((p + g) & 0xff);
      }
    } else if (t.type == 0) {  // predictor, in place in raster order
      const int tiles = subsample(w, t.bits);
      d[0] = add_pixels(d[0], 0xff000000u);
      for (int x = 1; x < w; ++x) d[x] = add_pixels(d[x], d[x - 1]);
      for (int y = 1; y < ysize; ++y) {
        uint32_t* row = d + static_cast<size_t>(y) * w;
        const uint32_t* top = row - w;  // top[w] is this row's first pixel
        const uint32_t* modes =
            t.data.data() + static_cast<size_t>(y >> t.bits) * tiles;
        row[0] = add_pixels(row[0], top[0]);
        for (int x = 1; x < w; ++x) {
          const int mode = (modes[x >> t.bits] >> 8) & 0xf;
          row[x] = add_pixels(row[x], predict(mode, row[x - 1], top[x],
                                              top[x - 1], top[x + 1]));
        }
      }
    } else if (t.type == 1) {  // cross-color
      const int tiles = subsample(w, t.bits);
      for (int y = 0; y < ysize; ++y) {
        uint32_t* row = d + static_cast<size_t>(y) * w;
        const uint32_t* m =
            t.data.data() + static_cast<size_t>(y >> t.bits) * tiles;
        for (int x = 0; x < w; ++x) {
          const uint32_t code = m[x >> t.bits];
          const int g2r = static_cast<int8_t>(code & 0xff);
          const int g2b = static_cast<int8_t>((code >> 8) & 0xff);
          const int r2b = static_cast<int8_t>((code >> 16) & 0xff);
          const uint32_t argb = row[x];
          const int green = static_cast<int8_t>((argb >> 8) & 0xff);
          int red = (argb >> 16) & 0xff, blue = argb & 0xff;
          red = (red + ((g2r * green) >> 5)) & 0xff;
          blue += (g2b * green) >> 5;
          blue += (r2b * static_cast<int8_t>(red)) >> 5;
          row[x] = (argb & 0xff00ff00u) | (static_cast<uint32_t>(red) << 16) |
                   (static_cast<uint32_t>(blue) & 0xff);
        }
      }
    } else {  // color indexing, unbundling bits_per_pixel indices a byte
      const int packed = subsample(w, t.bits);
      std::vector<uint32_t> out(static_cast<size_t>(w) * ysize);
      const int bits_per_pixel = 8 >> t.bits;
      const int count_mask = (1 << t.bits) - 1;
      const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
      for (int y = 0; y < ysize; ++y) {
        const uint32_t* src = d + static_cast<size_t>(y) * packed;
        uint32_t* dst = out.data() + static_cast<size_t>(y) * w;
        uint32_t code = 0;
        for (int x = 0; x < w; ++x) {
          if ((x & count_mask) == 0) code = (*src++ >> 8) & 0xff;
          dst[x] = t.data[code & bit_mask];
          code >>= bits_per_pixel;
        }
      }
      pixels->swap(out);
    }
  }
};

// ALPH (WebP container specification): a header byte, then raw or
// VP8L-coded alpha, then libwebp's unfilter (filters.c).
void decode_alpha(const uint8_t* data, size_t n, int w, int h, uint8_t* out) {
  if (n <= 1) fail("ALPH chunk without data");
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3;
  const int pre = (data[0] >> 4) & 3, reserved = data[0] >> 6;
  if (method > 1 || pre > 1 || reserved)
    fail("ALPH header: compression " + std::to_string(method) +
         ", preprocessing " + std::to_string(pre) + ", reserved " +
         std::to_string(reserved));
  const size_t npix = static_cast<size_t>(w) * h;
  if (method == 0) {
    if (n - 1 < npix) fail("ALPH: raw alpha shorter than the image");
    std::memcpy(out, data + 1, npix);
  } else {
    VP8LDecoder dec(data + 1, n - 1);
    const std::vector<uint32_t> argb = dec.decode_plain(w, h);
    for (size_t i = 0; i < npix; ++i) out[i] = (argb[i] >> 8) & 0xff;
  }
  for (int y = 0; y < h && filter; ++y) {
    uint8_t* row = out + static_cast<size_t>(y) * w;
    const uint8_t* prev = y ? row - w : nullptr;
    if (filter == 1 || !prev) {  // horizontal; every filter's first row
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < w; ++x) pred = row[x] = static_cast<uint8_t>(
                                          row[x] + pred);
    } else if (filter == 2) {  // vertical
      for (int x = 0; x < w; ++x)
        row[x] = static_cast<uint8_t>(row[x] + prev[x]);
    } else {  // gradient
      uint8_t top_left = prev[0], left = prev[0];
      for (int x = 0; x < w; ++x) {
        const uint8_t top = prev[x];
        const int g = left + top - top_left;
        left = static_cast<uint8_t>(row[x] + (g < 0 ? 0 : g > 255 ? 255 : g));
        top_left = top;
        row[x] = left;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// VP8

// RFC 6386's tables: quantizer steps (dc_qlookup, ac_qlookup), default
// coefficient probabilities and their update probabilities
// [type][band][context][node], and the key-frame 4x4 mode probabilities
// [above][left][node] in libwebp's mode order
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

const uint8_t kCoeffsProba0[4][8][3][11] = {
  {
    {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
     {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
     {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
     {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
     {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
    {{1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
     {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
     {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
    {{1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
     {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
     {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
    {{1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
     {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
     {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
    {{1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
     {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
     {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
    {{1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
     {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
     {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
    {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
  },
  {
    {{198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62},
     {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1},
     {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
    {{1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
     {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
     {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
    {{1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
     {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
     {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
    {{1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
     {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
     {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
    {{1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
     {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
     {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
    {{1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
     {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
     {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
    {{1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
     {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
     {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
    {{1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
     {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
     {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}},
  },
  {
    {{253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
     {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
     {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
    {{1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
     {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
     {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
    {{1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
     {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
     {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
    {{1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
     {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
     {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
    {{1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
     {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
     {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
     {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
     {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
     {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
     {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
  },
  {
    {{202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
     {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
     {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
    {{1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
     {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
     {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
    {{1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
     {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
     {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
    {{1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
     {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
     {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
    {{1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
     {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
     {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
    {{1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
     {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
     {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
    {{1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
     {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
     {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
    {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
     {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
  },
};

const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
  {
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
     {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
     {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
     {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
  {
    {{217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
     {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
    {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
  {
    {{186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
     {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
     {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
    {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
  {
    {{248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
     {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
     {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
     {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
     {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
};

const uint8_t kBModesProba[10][10][9] = {
  {
    {231, 120, 48, 89, 115, 113, 120, 152, 112},
    {152, 179, 64, 126, 170, 118, 46, 70, 95},
    {175, 69, 143, 80, 85, 82, 72, 155, 103},
    {56, 58, 10, 171, 218, 189, 17, 13, 152},
    {114, 26, 17, 163, 44, 195, 21, 10, 173},
    {121, 24, 80, 195, 26, 62, 44, 64, 85},
    {144, 71, 10, 38, 171, 213, 144, 34, 26},
    {170, 46, 55, 19, 136, 160, 33, 206, 71},
    {63, 20, 8, 114, 114, 208, 12, 9, 226},
    {81, 40, 11, 96, 182, 84, 29, 16, 36},
  },
  {
    {134, 183, 89, 137, 98, 101, 106, 165, 148},
    {72, 187, 100, 130, 157, 111, 32, 75, 80},
    {66, 102, 167, 99, 74, 62, 40, 234, 128},
    {41, 53, 9, 178, 241, 141, 26, 8, 107},
    {74, 43, 26, 146, 73, 166, 49, 23, 157},
    {65, 38, 105, 160, 51, 52, 31, 115, 128},
    {104, 79, 12, 27, 217, 255, 87, 17, 7},
    {87, 68, 71, 44, 114, 51, 15, 186, 23},
    {47, 41, 14, 110, 182, 183, 21, 17, 194},
    {66, 45, 25, 102, 197, 189, 23, 18, 22},
  },
  {
    {88, 88, 147, 150, 42, 46, 45, 196, 205},
    {43, 97, 183, 117, 85, 38, 35, 179, 61},
    {39, 53, 200, 87, 26, 21, 43, 232, 171},
    {56, 34, 51, 104, 114, 102, 29, 93, 77},
    {39, 28, 85, 171, 58, 165, 90, 98, 64},
    {34, 22, 116, 206, 23, 34, 43, 166, 73},
    {107, 54, 32, 26, 51, 1, 81, 43, 31},
    {68, 25, 106, 22, 64, 171, 36, 225, 114},
    {34, 19, 21, 102, 132, 188, 16, 76, 124},
    {62, 18, 78, 95, 85, 57, 50, 48, 51},
  },
  {
    {193, 101, 35, 159, 215, 111, 89, 46, 111},
    {60, 148, 31, 172, 219, 228, 21, 18, 111},
    {112, 113, 77, 85, 179, 255, 38, 120, 114},
    {40, 42, 1, 196, 245, 209, 10, 25, 109},
    {88, 43, 29, 140, 166, 213, 37, 43, 154},
    {61, 63, 30, 155, 67, 45, 68, 1, 209},
    {100, 80, 8, 43, 154, 1, 51, 26, 71},
    {142, 78, 78, 16, 255, 128, 34, 197, 171},
    {41, 40, 5, 102, 211, 183, 4, 1, 221},
    {51, 50, 17, 168, 209, 192, 23, 25, 82},
  },
  {
    {138, 31, 36, 171, 27, 166, 38, 44, 229},
    {67, 87, 58, 169, 82, 115, 26, 59, 179},
    {63, 59, 90, 180, 59, 166, 93, 73, 154},
    {40, 40, 21, 116, 143, 209, 34, 39, 175},
    {47, 15, 16, 183, 34, 223, 49, 45, 183},
    {46, 17, 33, 183, 6, 98, 15, 32, 183},
    {57, 46, 22, 24, 128, 1, 54, 17, 37},
    {65, 32, 73, 115, 28, 128, 23, 128, 205},
    {40, 3, 9, 115, 51, 192, 18, 6, 223},
    {87, 37, 9, 115, 59, 77, 64, 21, 47},
  },
  {
    {104, 55, 44, 218, 9, 54, 53, 130, 226},
    {64, 90, 70, 205, 40, 41, 23, 26, 57},
    {54, 57, 112, 184, 5, 41, 38, 166, 213},
    {30, 34, 26, 133, 152, 116, 10, 32, 134},
    {39, 19, 53, 221, 26, 114, 32, 73, 255},
    {31, 9, 65, 234, 2, 15, 1, 118, 73},
    {75, 32, 12, 51, 192, 255, 160, 43, 51},
    {88, 31, 35, 67, 102, 85, 55, 186, 85},
    {56, 21, 23, 111, 59, 205, 45, 37, 192},
    {55, 38, 70, 124, 73, 102, 1, 34, 98},
  },
  {
    {125, 98, 42, 88, 104, 85, 117, 175, 82},
    {95, 84, 53, 89, 128, 100, 113, 101, 45},
    {75, 79, 123, 47, 51, 128, 81, 171, 1},
    {57, 17, 5, 71, 102, 57, 53, 41, 49},
    {38, 33, 13, 121, 57, 73, 26, 1, 85},
    {41, 10, 67, 138, 77, 110, 90, 47, 114},
    {115, 21, 2, 10, 102, 255, 166, 23, 6},
    {101, 29, 16, 10, 85, 128, 101, 196, 26},
    {57, 18, 10, 102, 102, 213, 34, 20, 43},
    {117, 20, 15, 36, 163, 128, 68, 1, 26},
  },
  {
    {102, 61, 71, 37, 34, 53, 31, 243, 192},
    {69, 60, 71, 38, 73, 119, 28, 222, 37},
    {68, 45, 128, 34, 1, 47, 11, 245, 171},
    {62, 17, 19, 70, 146, 85, 55, 62, 70},
    {37, 43, 37, 154, 100, 163, 85, 160, 1},
    {63, 9, 92, 136, 28, 64, 32, 201, 85},
    {75, 15, 9, 9, 64, 255, 184, 119, 16},
    {86, 6, 28, 5, 64, 255, 25, 248, 1},
    {56, 8, 17, 132, 137, 255, 55, 116, 128},
    {58, 15, 20, 82, 135, 57, 26, 121, 40},
  },
  {
    {164, 50, 31, 137, 154, 133, 25, 35, 218},
    {51, 103, 44, 131, 131, 123, 31, 6, 158},
    {86, 40, 64, 135, 148, 224, 45, 183, 128},
    {22, 26, 17, 131, 240, 154, 14, 1, 209},
    {45, 16, 21, 91, 64, 222, 7, 1, 197},
    {56, 21, 39, 155, 60, 138, 23, 102, 213},
    {83, 12, 13, 54, 192, 255, 68, 47, 28},
    {85, 26, 85, 85, 128, 128, 32, 146, 171},
    {18, 11, 7, 63, 144, 171, 4, 4, 246},
    {35, 27, 10, 146, 174, 171, 12, 26, 128},
  },
  {
    {190, 80, 35, 99, 180, 80, 126, 54, 45},
    {85, 126, 47, 87, 176, 51, 41, 20, 32},
    {101, 75, 128, 139, 118, 146, 116, 128, 85},
    {56, 41, 15, 176, 236, 85, 37, 9, 62},
    {71, 30, 17, 119, 118, 255, 17, 18, 138},
    {101, 38, 60, 138, 55, 70, 43, 26, 142},
    {146, 36, 19, 30, 171, 255, 97, 27, 20},
    {138, 45, 61, 62, 219, 1, 81, 188, 64},
    {32, 41, 20, 117, 151, 142, 20, 21, 163},
    {112, 19, 12, 61, 195, 128, 48, 4, 24},
  },
};


// The boolean decoder of RFC 6386 section 7, kept as libwebp keeps it
// (range - 1, bits left past an 8-bit window) so that its end-of-data flag
// rises where libwebp's does: when a bit is needed past the last byte.
class BoolDecoder {
 public:
  void init(const uint8_t* data, size_t n) {
    buf_ = data;
    end_ = data + n;
    value_ = 0;
    range_ = 254;
    bits_ = -8;
    eof_ = false;
    load();
  }
  int bit(int prob) {
    uint32_t range = range_;
    if (bits_ < 0) load();
    const int pos = bits_;
    const uint32_t split = (range * static_cast<uint32_t>(prob)) >> 8;
    const uint32_t value = static_cast<uint32_t>(value_ >> pos);
    const int b = value > split;
    if (b) {
      range -= split;
      value_ -= static_cast<uint64_t>(split + 1) << pos;
    } else {
      range = split + 1;
    }
    const int shift = 7 ^ (31 - __builtin_clz(range));
    range <<= shift;
    bits_ -= shift;
    range_ = range - 1;
    return b;
  }
  int literal(int nbits) {
    int v = 0;
    while (nbits-- > 0) v |= bit(0x80) << nbits;
    return v;
  }
  int signed_literal(int nbits) {
    const int v = literal(nbits);
    return bit(0x80) ? -v : v;
  }
  bool eof() const { return eof_; }

 private:
  void load() {
    if (buf_ < end_) {
      bits_ += 8;
      value_ = (value_ << 8) | *buf_++;
    } else if (!eof_) {
      value_ <<= 8;
      bits_ += 8;
      eof_ = true;
    } else {
      bits_ = 0;
    }
  }
  const uint8_t* buf_ = nullptr;
  const uint8_t* end_ = nullptr;
  uint64_t value_ = 0;
  uint32_t range_ = 254;
  int bits_ = -8;
  bool eof_ = false;
};


const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11,
                             14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130,
                         129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// libwebp's mode numbers: DC, TM, VE, HE (also the 16x16 and chroma
// modes), then the 4x4 diagonals; 16x16 / chroma DC variants at the edges
enum { DC_PRED = 0, TM_PRED, V_PRED, H_PRED, RD_PRED, VR_PRED, LD_PRED,
       VL_PRED, HD_PRED, HU_PRED };
constexpr int DC_NOTOP = 4, DC_NOLEFT = 5, DC_NOTOPLEFT = 6;

// the reconstruction work area of libwebp's frame_dec.c: a row of
// context above, four columns of it to the left, 32-byte rows
constexpr int BPS = 32;
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;

inline uint8_t clip8(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
}
inline uint8_t avg3(int a, int b, int c) {
  return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2);
}
inline uint8_t avg2(int a, int b) {
  return static_cast<uint8_t>((a + b + 1) >> 1);
}

#define DST(x, y) dst[(x) + (y) * BPS]

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y, dst += BPS)
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + dst[-1] - tl);
}

void predict4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  const int X = dst[-1 - BPS], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS];
  const int L = dst[-1 + 3 * BPS];
  switch (mode) {
    case DC_PRED: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
      for (int i = 0; i < 4; ++i) std::memset(dst + i * BPS, dc >> 3, 4);
      break;
    }
    case TM_PRED:
      true_motion(dst, 4);
      break;
    case V_PRED: {
      const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D),
                            avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, v, 4);
      break;
    }
    case H_PRED:
      std::memset(dst, avg3(X, I, J), 4);
      std::memset(dst + BPS, avg3(I, J, K), 4);
      std::memset(dst + 2 * BPS, avg3(J, K, L), 4);
      std::memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case RD_PRED:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case VR_PRED:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case LD_PRED:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case VL_PRED:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case HD_PRED:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    default:  // HU_PRED
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) =
          DST(3, 3) = static_cast<uint8_t>(L);
      break;
  }
}

#undef DST

// 16x16 luma (size 16) or 8x8 chroma (size 8) prediction
void predict_block(int mode, uint8_t* dst, int size) {
  const int log2 = size == 16 ? 4 : 3;
  int dc = -1;
  switch (mode) {
    case TM_PRED:
      true_motion(dst, size);
      return;
    case V_PRED:
      for (int j = 0; j < size; ++j)
        std::memcpy(dst + j * BPS, dst - BPS, size);
      return;
    case H_PRED:
      for (int j = 0; j < size; ++j)
        std::memset(dst + j * BPS, dst[j * BPS - 1], size);
      return;
    case DC_PRED: {
      int s = size;
      for (int j = 0; j < size; ++j) s += dst[j * BPS - 1] + dst[j - BPS];
      dc = s >> (log2 + 1);
      break;
    }
    case DC_NOTOP: {
      int s = size >> 1;
      for (int j = 0; j < size; ++j) s += dst[j * BPS - 1];
      dc = s >> log2;
      break;
    }
    case DC_NOLEFT: {
      int s = size >> 1;
      for (int j = 0; j < size; ++j) s += dst[j - BPS];
      dc = s >> log2;
      break;
    }
    default:
      dc = 0x80;
      break;
  }
  for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, dc, size);
}

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// the inverse DCT of RFC 6386 section 14.3, added onto the prediction
void idct_add(const int16_t* in, uint8_t* dst) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[i] + in[8 + i];
    const int b = in[i] - in[8 + i];
    const int c = mul2(in[4 + i]) - mul1(in[12 + i]);
    const int d = mul1(in[4 + i]) + mul2(in[12 + i]);
    tmp[4 * i + 0] = a + d;
    tmp[4 * i + 1] = b + c;
    tmp[4 * i + 2] = b - c;
    tmp[4 * i + 3] = a - d;
  }
  for (int i = 0; i < 4; ++i, dst += BPS) {  // horizontal pass
    const int dc = tmp[i] + 4;
    const int a = dc + tmp[8 + i];
    const int b = dc - tmp[8 + i];
    const int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]);
    const int d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
  }
}

// the inverse Walsh-Hadamard transform: the Y2 block's outputs become the
// DC coefficients of the 16 luma blocks
void iwht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[i] - in[12 + i];
    tmp[i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i, out += 64) {
    const int dc = tmp[4 * i] + 3;
    const int a0 = dc + tmp[4 * i + 3], a1 = tmp[4 * i + 1] + tmp[4 * i + 2];
    const int a2 = tmp[4 * i + 1] - tmp[4 * i + 2], a3 = dc - tmp[4 * i + 3];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
  }
}

// -- the loop filters of RFC 6386 section 15, as libwebp's dsp/dec.c
// writes them (thresholds doubled plus one, so no halving is needed)

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
         std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
         std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// hstride across the edge, vstride along it
void simple_edge(uint8_t* p, int hstride, int vstride, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, t2)) filter2(p, hstride);
}

void complex_edge(uint8_t* p, int hstride, int vstride, int size, int thresh,
                  int ithresh, int hev_thresh, bool inner) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_thresh))
      filter2(p, hstride);
    else if (inner)
      filter4(p, hstride);
    else
      filter6(p, hstride);
  }
}

struct FilterInfo {
  int limit = 0, ilevel = 0, hev = 0;
  bool inner = false;
};

struct MacroBlock {  // one macroblock's modes and dequantized coefficients
  int segment = 0;
  bool skip = false, i4x4 = false;
  uint8_t imodes[16];
  int uvmode = 0;
  int16_t coeffs[384];
};

class VP8Decoder {
 public:
  // `data`: the VP8 payload up to the end of its chunk (its pad byte
  // included, as libwebp reads it); `chunk_size`: the unpadded size.
  VP8Decoder(const uint8_t* data, size_t n, size_t chunk_size) {
    if (n < 10) fail("VP8: frame header truncated");
    const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
    if (bits & 1) fail("VP8: not a key frame");
    if (((bits >> 1) & 7) > 3) fail("VP8: unknown profile");
    if (!((bits >> 4) & 1)) fail("VP8: frame not displayable");
    const uint32_t part_len = bits >> 5;
    if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a)
      fail("VP8: bad start code");
    width = ((data[7] << 8) | data[6]) & 0x3fff;
    height = ((data[9] << 8) | data[8]) & 0x3fff;
    if (!width || !height) fail("VP8: zero width or height");
    if (part_len >= chunk_size) fail("VP8: partition larger than the chunk");
    const uint8_t* buf = data + 10;
    const size_t size = n - 10;
    if (part_len > size) fail("VP8: bad partition length");
    br_.init(buf, part_len);
    br_.bit(0x80);  // color space
    br_.bit(0x80);  // clamping type (libwebp always clamps)
    parse_segment_header();
    if (br_.eof()) fail("VP8: cannot parse the segment header");
    parse_filter_header();
    if (br_.eof()) fail("VP8: cannot parse the filter header");
    parse_partitions(buf + part_len, size - part_len);
    parse_quant();
    br_.bit(0x80);  // refresh_entropy_probs: a key frame's only
    parse_proba();
  }

  int width = 0, height = 0;

  // The frame to RGB (height x width x 3).
  void decode(uint8_t* rgb) {
    mb_w_ = (width + 15) >> 4;
    mb_h_ = (height + 15) >> 4;
    ystride_ = mb_w_ * 16;
    uvstride_ = mb_w_ * 8;
    y_.assign(static_cast<size_t>(ystride_) * mb_h_ * 16, 0);
    u_.assign(static_cast<size_t>(uvstride_) * mb_h_ * 8, 0);
    v_.assign(u_.size(), 0);
    finfo_.assign(static_cast<size_t>(mb_w_) * mb_h_, FilterInfo{});
    intra_t_.assign(4 * mb_w_, DC_PRED);
    nz_.assign(mb_w_, 0);
    nz_dc_.assign(mb_w_, 0);
    top_y_.assign(16 * mb_w_, 0);
    top_u_.assign(8 * mb_w_, 0);
    top_v_.assign(8 * mb_w_, 0);
    precompute_filter_strengths();
    std::vector<MacroBlock> row(mb_w_);
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
      BoolDecoder& tokens = parts_[mb_y & (num_parts_ - 1)];
      std::memset(intra_l_, DC_PRED, sizeof(intra_l_));
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x)
        parse_intra_mode(mb_x, &row[mb_x]);
      if (br_.eof()) fail("VP8: premature end of partition 0");
      left_nz_ = left_nz_dc_ = 0;
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        decode_mb(mb_x, mb_y, &row[mb_x], tokens);
        if (tokens.eof()) fail("VP8: premature end of a token partition");
      }
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x)
        reconstruct(mb_x, mb_y, row[mb_x]);
    }
    if (filter_type_)
      for (int mb_y = 0; mb_y < mb_h_; ++mb_y)
        for (int mb_x = 0; mb_x < mb_w_; ++mb_x) loop_filter(mb_x, mb_y);
    upsample_to_rgb(rgb);
  }

 private:
  BoolDecoder br_;
  BoolDecoder parts_[8];
  int num_parts_ = 1;
  // segment header
  bool use_segment_ = false, update_map_ = false, absolute_delta_ = true;
  int quantizer_[4] = {0}, filter_strength_[4] = {0};
  uint8_t segment_proba_[3] = {255, 255, 255};
  // filter header
  bool simple_ = false, use_lf_delta_ = false;
  int level_ = 0, sharpness_ = 0, filter_type_ = 0;
  int ref_lf_delta_[4] = {0}, mode_lf_delta_[4] = {0};
  // quantizers a segment: y1, y2, uv as {dc, ac}
  int dq_[4][3][2];
  uint8_t proba_[4][8][3][11];
  bool use_skip_ = false;
  int skip_p_ = 0;
  FilterInfo fstrength_[4][2];

  int mb_w_ = 0, mb_h_ = 0, ystride_ = 0, uvstride_ = 0;
  std::vector<uint8_t> y_, u_, v_;
  std::vector<FilterInfo> finfo_;
  std::vector<uint8_t> intra_t_;
  uint8_t intra_l_[4];
  std::vector<uint8_t> nz_, nz_dc_;
  uint8_t left_nz_ = 0, left_nz_dc_ = 0;
  std::vector<uint8_t> top_y_, top_u_, top_v_;
  uint8_t work_[YUV_SIZE] = {0};

  void parse_segment_header() {
    use_segment_ = br_.bit(0x80);
    if (use_segment_) {
      update_map_ = br_.bit(0x80);
      if (br_.bit(0x80)) {
        absolute_delta_ = br_.bit(0x80);
        for (int& q : quantizer_) q = br_.bit(0x80) ? br_.signed_literal(7) : 0;
        for (int& f : filter_strength_)
          f = br_.bit(0x80) ? br_.signed_literal(6) : 0;
      }
      if (update_map_)
        for (uint8_t& p : segment_proba_)
          p = static_cast<uint8_t>(br_.bit(0x80) ? br_.literal(8) : 255);
    } else {
      update_map_ = false;
    }
  }

  void parse_filter_header() {
    simple_ = br_.bit(0x80);
    level_ = br_.literal(6);
    sharpness_ = br_.literal(3);
    use_lf_delta_ = br_.bit(0x80);
    if (use_lf_delta_ && br_.bit(0x80)) {
      for (int& d : ref_lf_delta_)
        if (br_.bit(0x80)) d = br_.signed_literal(6);
      for (int& d : mode_lf_delta_)
        if (br_.bit(0x80)) d = br_.signed_literal(6);
    }
    filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
  }

  void parse_partitions(const uint8_t* buf, size_t size) {
    num_parts_ = 1 << br_.literal(2);
    const size_t last = num_parts_ - 1;
    if (size < 3 * last) fail("VP8: cannot read the partition sizes");
    const uint8_t* sz = buf;
    const uint8_t* start = buf + 3 * last;
    size_t left = size - 3 * last;
    for (size_t p = 0; p < last; ++p, sz += 3) {
      size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (psize > left) psize = left;
      parts_[p].init(start, psize);
      start += psize;
      left -= psize;
    }
    parts_[last].init(start, left);
    if (!left) fail("VP8: the token partitions are truncated");
  }

  void parse_quant() {
    const int base_q0 = br_.literal(7);
    int d[5];
    for (int& v : d) v = br_.bit(0x80) ? br_.signed_literal(4) : 0;
    const int dqy1_dc = d[0], dqy2_dc = d[1], dqy2_ac = d[2];
    const int dquv_dc = d[3], dquv_ac = d[4];
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int s = 0; s < 4; ++s) {
      int q = base_q0;
      if (use_segment_) {
        q = quantizer_[s] + (absolute_delta_ ? 0 : base_q0);
      } else if (s > 0) {
        std::memcpy(dq_[s], dq_[0], sizeof(dq_[0]));
        continue;
      }
      dq_[s][0][0] = kDcTable[clip(q + dqy1_dc, 127)];
      dq_[s][0][1] = kAcTable[clip(q, 127)];
      dq_[s][1][0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      // x * 155 / 100 for x in [0, 284]
      dq_[s][1][1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (dq_[s][1][1] < 8) dq_[s][1][1] = 8;
      dq_[s][2][0] = kDcTable[clip(q + dquv_dc, 117)];
      dq_[s][2][1] = kAcTable[clip(q + dquv_ac, 127)];
    }
  }

  void parse_proba() {
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p)
            proba_[t][b][c][p] = static_cast<uint8_t>(
                br_.bit(kCoeffsUpdateProba[t][b][c][p])
                    ? br_.literal(8) : kCoeffsProba0[t][b][c][p]);
    use_skip_ = br_.bit(0x80);
    if (use_skip_) skip_p_ = br_.literal(8);
  }

  void precompute_filter_strengths() {
    if (!filter_type_) return;
    for (int s = 0; s < 4; ++s) {
      int base = level_;
      if (use_segment_)
        base = filter_strength_[s] + (absolute_delta_ ? 0 : level_);
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FilterInfo& info = fstrength_[s][i4x4];
        int level = base;
        if (use_lf_delta_) {
          level += ref_lf_delta_[0];
          if (i4x4) level += mode_lf_delta_[0];
        }
        level = level < 0 ? 0 : level > 63 ? 63 : level;
        if (level > 0) {
          int ilevel = level;
          if (sharpness_ > 0) {
            ilevel >>= sharpness_ > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = ilevel;
          info.limit = 2 * level + ilevel;
          info.hev = level >= 40 ? 2 : level >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = i4x4;
      }
    }
  }

  void parse_intra_mode(int mb_x, MacroBlock* mb) {
    uint8_t* top = intra_t_.data() + 4 * mb_x;
    mb->segment = update_map_
        ? (!br_.bit(segment_proba_[0]) ? br_.bit(segment_proba_[1])
                                       : br_.bit(segment_proba_[2]) + 2)
        : 0;
    mb->skip = use_skip_ ? br_.bit(skip_p_) : false;
    mb->i4x4 = !br_.bit(145);
    if (!mb->i4x4) {
      const int ymode = br_.bit(156) ? (br_.bit(128) ? TM_PRED : H_PRED)
                                     : (br_.bit(163) ? V_PRED : DC_PRED);
      mb->imodes[0] = static_cast<uint8_t>(ymode);
      std::memset(top, ymode, 4);
      std::memset(intra_l_, ymode, 4);
    } else {
      uint8_t* modes = mb->imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = intra_l_[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* p = kBModesProba[top[x]][ymode];
          ymode = !br_.bit(p[0]) ? DC_PRED
                : !br_.bit(p[1]) ? TM_PRED
                : !br_.bit(p[2]) ? V_PRED
                : !br_.bit(p[3])
                    ? (!br_.bit(p[4]) ? H_PRED
                                      : (!br_.bit(p[5]) ? RD_PRED : VR_PRED))
                    : (!br_.bit(p[6]) ? LD_PRED
                       : !br_.bit(p[7]) ? VL_PRED
                       : !br_.bit(p[8]) ? HD_PRED : HU_PRED);
          top[x] = static_cast<uint8_t>(ymode);
        }
        std::memcpy(modes, top, 4);
        modes += 4;
        intra_l_[y] = static_cast<uint8_t>(ymode);
      }
    }
    mb->uvmode = !br_.bit(142) ? DC_PRED
               : !br_.bit(114) ? V_PRED
               : br_.bit(183) ? TM_PRED : H_PRED;
  }

  static int large_value(BoolDecoder& br, const uint8_t* p) {
    if (!br.bit(p[3])) {
      if (!br.bit(p[4])) return 2;
      return 3 + br.bit(p[5]);
    }
    if (!br.bit(p[6])) {
      if (!br.bit(p[7])) return 5 + br.bit(159);
      int v = 7 + 2 * br.bit(165);
      return v + br.bit(145);
    }
    const int bit1 = br.bit(p[8]);
    const int bit0 = br.bit(p[9 + bit1]);
    const int cat = 2 * bit1 + bit0;
    int v = 0;
    for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab)
      v += v + br.bit(*tab);
    return v + 3 + (8 << cat);
  }

  // One block's tokens from position n; returns the position after the
  // last one decoded (0 to 16), as libwebp's GetCoeffs.
  int coeffs(BoolDecoder& br, int type, int ctx, const int* dq, int n,
             int16_t* out) {
    const uint8_t* p = proba_[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!br.bit(p[0])) return n;
      while (!br.bit(p[1])) {
        p = proba_[type][kBands[++n]][0];
        if (n == 16) return 16;
      }
      int v;
      if (!br.bit(p[2])) {
        v = 1;
        p = proba_[type][kBands[n + 1]][1];
      } else {
        v = large_value(br, p);
        p = proba_[type][kBands[n + 1]][2];
      }
      const int s = br.bit(0x80) ? -v : v;
      out[kZigzag[n]] = static_cast<int16_t>(s * dq[n > 0]);
    }
    return 16;
  }

  static uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
    nz_coeffs <<= 2;
    nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
    return nz_coeffs;
  }

  // libwebp's ParseResiduals; returns whether no coefficient is non-zero
  bool residuals(int mb_x, MacroBlock* mb, BoolDecoder& br) {
    const int(*q)[2] = dq_[mb->segment];
    int16_t* dst = mb->coeffs;
    std::memset(dst, 0, sizeof(mb->coeffs));
    int first, ac_type;
    if (!mb->i4x4) {
      int16_t dc[16] = {0};
      const int ctx = nz_dc_[mb_x] + left_nz_dc_;
      const int nz = coeffs(br, 1, ctx, q[1], 0, dc);
      nz_dc_[mb_x] = left_nz_dc_ = nz > 0;
      if (nz > 1) {
        iwht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 256; i += 16) dst[i] = static_cast<int16_t>(dc0);
      }
      first = 1;
      ac_type = 0;
    } else {
      first = 0;
      ac_type = 3;
    }
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    uint32_t tnz = nz_[mb_x] & 0x0f, lnz = left_nz_ & 0x0f;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      uint32_t nzc = 0;
      for (int x = 0; x < 4; ++x, dst += 16) {
        const int ctx = l + (tnz & 1);
        const int nz = coeffs(br, ac_type, ctx, q[0], first, dst);
        l = nz > first;
        tnz = (tnz >> 1) | (l << 7);
        nzc = nz_code_bits(nzc, nz, dst[0] != 0);
      }
      tnz >>= 4;
      lnz = (lnz >> 1) | (l << 7);
      non_zero_y = (non_zero_y << 8) | nzc;
    }
    uint32_t out_t = tnz, out_l = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t nzc = 0;
      tnz = nz_[mb_x] >> (4 + ch);
      lnz = left_nz_ >> (4 + ch);
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x, dst += 16) {
          const int ctx = l + (tnz & 1);
          const int nz = coeffs(br, 2, ctx, q[2], 0, dst);
          l = nz > 0;
          tnz = (tnz >> 1) | (l << 3);
          nzc = nz_code_bits(nzc, nz, dst[0] != 0);
        }
        tnz >>= 2;
        lnz = (lnz >> 1) | (l << 5);
      }
      non_zero_uv |= nzc << (4 * ch);
      out_t |= (tnz << 4) << ch;
      out_l |= (lnz & 0xf0) << ch;
    }
    nz_[mb_x] = static_cast<uint8_t>(out_t);
    left_nz_ = static_cast<uint8_t>(out_l);
    return !(non_zero_y | non_zero_uv);
  }

  void decode_mb(int mb_x, int mb_y, MacroBlock* mb, BoolDecoder& tokens) {
    bool skip = use_skip_ ? mb->skip : false;
    if (!skip) {
      skip = residuals(mb_x, mb, tokens);
    } else {
      nz_[mb_x] = left_nz_ = 0;
      if (!mb->i4x4) nz_dc_[mb_x] = left_nz_dc_ = 0;
      std::memset(mb->coeffs, 0, sizeof(mb->coeffs));
    }
    if (filter_type_) {
      FilterInfo f = fstrength_[mb->segment][mb->i4x4];
      f.inner = f.inner || !skip;
      finfo_[static_cast<size_t>(mb_y) * mb_w_ + mb_x] = f;
    }
  }

  static int check_mode(int mb_x, int mb_y, int mode) {
    if (mode != DC_PRED) return mode;
    if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
    return mb_y == 0 ? DC_NOTOP : DC_PRED;
  }

  // libwebp's ReconstructRow for one macroblock: prediction from the work
  // area's context, the residuals added, the result copied out and its
  // edges kept as context
  void reconstruct(int mb_x, int mb_y, const MacroBlock& mb) {
    uint8_t* const y_dst = work_ + Y_OFF;
    uint8_t* const u_dst = work_ + U_OFF;
    uint8_t* const v_dst = work_ + V_OFF;
    if (mb_x == 0) {
      for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
      for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
      if (mb_y > 0) {
        y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
      } else {
        std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
        std::memset(u_dst - BPS - 1, 127, 8 + 1);
        std::memset(v_dst - BPS - 1, 127, 8 + 1);
      }
    } else {
      for (int j = -1; j < 16; ++j)
        std::memcpy(y_dst + j * BPS - 4, y_dst + j * BPS + 12, 4);
      for (int j = -1; j < 8; ++j) {
        std::memcpy(u_dst + j * BPS - 4, u_dst + j * BPS + 4, 4);
        std::memcpy(v_dst + j * BPS - 4, v_dst + j * BPS + 4, 4);
      }
    }
    if (mb_y > 0) {
      std::memcpy(y_dst - BPS, &top_y_[16 * mb_x], 16);
      std::memcpy(u_dst - BPS, &top_u_[8 * mb_x], 8);
      std::memcpy(v_dst - BPS, &top_v_[8 * mb_x], 8);
    }
    const int16_t* coeffs = mb.coeffs;
    if (mb.i4x4) {
      uint8_t* top_right = y_dst - BPS + 16;
      if (mb_y > 0) {
        if (mb_x >= mb_w_ - 1)
          std::memset(top_right, top_y_[16 * mb_x + 15], 4);
        else
          std::memcpy(top_right, &top_y_[16 * (mb_x + 1)], 4);
      }
      // the macroblock's top-right samples serve the right column's
      // lower blocks too
      for (int r = 1; r < 4; ++r)
        std::memcpy(top_right + 4 * r * BPS, top_right, 4);
      for (int n = 0; n < 16; ++n) {
        uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
        predict4(mb.imodes[n], dst);
        idct_add(coeffs + n * 16, dst);
      }
    } else {
      predict_block(check_mode(mb_x, mb_y, mb.imodes[0]), y_dst, 16);
      for (int n = 0; n < 16; ++n)
        idct_add(coeffs + n * 16, y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
    }
    const int uvmode = check_mode(mb_x, mb_y, mb.uvmode);
    predict_block(uvmode, u_dst, 8);
    predict_block(uvmode, v_dst, 8);
    for (int n = 0; n < 4; ++n) {
      idct_add(coeffs + 256 + n * 16, u_dst + (n & 1) * 4 + (n >> 1) * 4 * BPS);
      idct_add(coeffs + 320 + n * 16, v_dst + (n & 1) * 4 + (n >> 1) * 4 * BPS);
    }
    if (mb_y < mb_h_ - 1) {
      std::memcpy(&top_y_[16 * mb_x], y_dst + 15 * BPS, 16);
      std::memcpy(&top_u_[8 * mb_x], u_dst + 7 * BPS, 8);
      std::memcpy(&top_v_[8 * mb_x], v_dst + 7 * BPS, 8);
    }
    for (int j = 0; j < 16; ++j)
      std::memcpy(&y_[(static_cast<size_t>(mb_y) * 16 + j) * ystride_ +
                      16 * mb_x], y_dst + j * BPS, 16);
    for (int j = 0; j < 8; ++j) {
      const size_t o = (static_cast<size_t>(mb_y) * 8 + j) * uvstride_ +
                       8 * mb_x;
      std::memcpy(&u_[o], u_dst + j * BPS, 8);
      std::memcpy(&v_[o], v_dst + j * BPS, 8);
    }
  }

  // libwebp's DoFilter: the left edge, the inner vertical edges, the top
  // edge, the inner horizontal edges
  void loop_filter(int mb_x, int mb_y) {
    const FilterInfo& f = finfo_[static_cast<size_t>(mb_y) * mb_w_ + mb_x];
    const int limit = f.limit;
    if (limit == 0) return;
    const int ys = ystride_, uvs = uvstride_;
    uint8_t* yd = &y_[static_cast<size_t>(mb_y) * 16 * ys + mb_x * 16];
    if (filter_type_ == 1) {
      if (mb_x > 0) simple_edge(yd, 1, ys, limit + 4);
      if (f.inner)
        for (int k = 1; k < 4; ++k) simple_edge(yd + 4 * k, 1, ys, limit);
      if (mb_y > 0) simple_edge(yd, ys, 1, limit + 4);
      if (f.inner)
        for (int k = 1; k < 4; ++k) simple_edge(yd + 4 * k * ys, ys, 1, limit);
      return;
    }
    uint8_t* ud = &u_[static_cast<size_t>(mb_y) * 8 * uvs + mb_x * 8];
    uint8_t* vd = &v_[static_cast<size_t>(mb_y) * 8 * uvs + mb_x * 8];
    const int il = f.ilevel, hv = f.hev;
    if (mb_x > 0) {
      complex_edge(yd, 1, ys, 16, limit + 4, il, hv, false);
      complex_edge(ud, 1, uvs, 8, limit + 4, il, hv, false);
      complex_edge(vd, 1, uvs, 8, limit + 4, il, hv, false);
    }
    if (f.inner) {
      for (int k = 1; k < 4; ++k)
        complex_edge(yd + 4 * k, 1, ys, 16, limit, il, hv, true);
      complex_edge(ud + 4, 1, uvs, 8, limit, il, hv, true);
      complex_edge(vd + 4, 1, uvs, 8, limit, il, hv, true);
    }
    if (mb_y > 0) {
      complex_edge(yd, ys, 1, 16, limit + 4, il, hv, false);
      complex_edge(ud, uvs, 1, 8, limit + 4, il, hv, false);
      complex_edge(vd, uvs, 1, 8, limit + 4, il, hv, false);
    }
    if (f.inner) {
      for (int k = 1; k < 4; ++k)
        complex_edge(yd + 4 * k * ys, ys, 1, 16, limit, il, hv, true);
      complex_edge(ud + 4 * uvs, uvs, 1, 8, limit, il, hv, true);
      complex_edge(vd + 4 * uvs, uvs, 1, 8, limit, il, hv, true);
    }
  }

  // -- libwebp's output stage: fancy upsampling and yuv.h's conversion

  static inline int mult_hi(int v, int c) { return (v * c) >> 8; }
  static inline uint8_t yuv_clip(int v) {
    return static_cast<uint8_t>((v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255);
  }
  static inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
    const int yy = mult_hi(y, 19077);
    rgb[0] = yuv_clip(yy + mult_hi(v, 26149) - 14234);
    rgb[1] = yuv_clip(yy - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
    rgb[2] = yuv_clip(yy + mult_hi(u, 33050) - 17685);
  }

  // UpsampleRgbaLinePair: one or two output rows between two chroma rows
  // (the same row twice at the image's first and last rows)
  void line_pair(const uint8_t* top_y, const uint8_t* bot_y,
                 const uint8_t* tu, const uint8_t* tv, const uint8_t* cu,
                 const uint8_t* cv, uint8_t* top_dst, uint8_t* bot_dst,
                 int len) const {
    const int last_pair = (len - 1) >> 1;
    int tl_u = tu[0], tl_v = tv[0], l_u = cu[0], l_v = cv[0];
    yuv_to_rgb(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
               top_dst);
    if (bot_y)
      yuv_to_rgb(bot_y[0], (3 * l_u + tl_u + 2) >> 2,
                 (3 * l_v + tl_v + 2) >> 2, bot_dst);
    for (int x = 1; x <= last_pair; ++x) {
      const int t_u = tu[x], t_v = tv[x], c_u = cu[x], c_v = cv[x];
      const int avg_u = tl_u + t_u + l_u + c_u + 8;
      const int avg_v = tl_v + t_v + l_v + c_v + 8;
      const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3;
      const int d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
      const int d03_u = (avg_u + 2 * (tl_u + c_u)) >> 3;
      const int d03_v = (avg_v + 2 * (tl_v + c_v)) >> 3;
      yuv_to_rgb(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1,
                 top_dst + 3 * (2 * x - 1));
      yuv_to_rgb(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1,
                 top_dst + 3 * (2 * x));
      if (bot_y) {
        yuv_to_rgb(bot_y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1,
                   bot_dst + 3 * (2 * x - 1));
        yuv_to_rgb(bot_y[2 * x], (d12_u + c_u) >> 1, (d12_v + c_v) >> 1,
                   bot_dst + 3 * (2 * x));
      }
      tl_u = t_u, tl_v = t_v, l_u = c_u, l_v = c_v;
    }
    if (!(len & 1)) {
      yuv_to_rgb(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2,
                 (3 * tl_v + l_v + 2) >> 2, top_dst + 3 * (len - 1));
      if (bot_y)
        yuv_to_rgb(bot_y[len - 1], (3 * l_u + tl_u + 2) >> 2,
                   (3 * l_v + tl_v + 2) >> 2, bot_dst + 3 * (len - 1));
    }
  }

  void upsample_to_rgb(uint8_t* rgb) const {
    const int w = width, h = height;
    const size_t row = static_cast<size_t>(w) * 3;
    auto Y = [&](int y) { return &y_[static_cast<size_t>(y) * ystride_]; };
    auto U = [&](int y) { return &u_[static_cast<size_t>(y) * uvstride_]; };
    auto V = [&](int y) { return &v_[static_cast<size_t>(y) * uvstride_]; };
    line_pair(Y(0), nullptr, U(0), V(0), U(0), V(0), rgb, nullptr, w);
    int k = 1;
    for (; 2 * k < h; ++k)
      line_pair(Y(2 * k - 1), Y(2 * k), U(k - 1), V(k - 1), U(k), V(k),
                rgb + (2 * k - 1) * row, rgb + 2 * k * row, w);
    if (!(h & 1) && h > 1)
      line_pair(Y(h - 1), nullptr, U(k - 1), V(k - 1), U(k - 1), V(k - 1),
                rgb + (h - 1) * row, nullptr, w);
  }
};

}  // namespace

// The entry points return 0, or 1 with the reason in msg for a stream
// libwebp refuses too.

// A VP8L chunk's payload (its pad byte included) of the size its header
// gives, which the caller has read: RGB into out (height x width x 3).
extern "C" int webp_vp8l(const uint8_t* data, long n, int width, int height,
                         uint8_t* out, char* msg, int msglen) {
  try {
    VP8LDecoder dec(data, static_cast<size_t>(n));
    int w = 0, h = 0;
    const std::vector<uint32_t> argb = dec.decode_headed(&w, &h);
    if (w != width || h != height) fail("VP8L: the header changed size");
    const size_t npix = static_cast<size_t>(w) * h;
    for (size_t i = 0; i < npix; ++i) {
      out[3 * i] = static_cast<uint8_t>(argb[i] >> 16);
      out[3 * i + 1] = static_cast<uint8_t>(argb[i] >> 8);
      out[3 * i + 2] = static_cast<uint8_t>(argb[i]);
    }
    return 0;
  } catch (const Error& e) {
    return report(e, msg, msglen);
  } catch (const std::exception& e) {
    return report(Error{std::string("VP8L decode failed: ") + e.what()}, msg,
                  msglen);
  }
}

// A VP8 chunk's payload (its pad byte included; chunk_size without it):
// the key frame through libwebp's fancy upsampling to RGB.
extern "C" int webp_vp8(const uint8_t* data, long n, long chunk_size,
                        int width, int height, uint8_t* out, char* msg,
                        int msglen) {
  try {
    VP8Decoder dec(data, static_cast<size_t>(n),
                   static_cast<size_t>(chunk_size));
    if (dec.width != width || dec.height != height)
      fail("VP8: the frame header changed size");
    dec.decode(out);
    return 0;
  } catch (const Error& e) {
    return report(e, msg, msglen);
  } catch (const std::exception& e) {
    return report(Error{std::string("VP8 decode failed: ") + e.what()}, msg,
                  msglen);
  }
}

// An ALPH chunk's payload: the alpha plane (height x width) into out.
extern "C" int webp_alpha(const uint8_t* data, long n, int width, int height,
                          uint8_t* out, char* msg, int msglen) {
  try {
    decode_alpha(data, static_cast<size_t>(n), width, height, out);
    return 0;
  } catch (const Error& e) {
    return report(e, msg, msglen);
  } catch (const std::exception& e) {
    return report(Error{std::string("ALPH decode failed: ") + e.what()}, msg,
                  msglen);
  }
}
