// Huffman JPEG (8-bit samples), baseline, extended sequential and
// progressive, -> RGB, for media/image_io.py. The output is the one
// libjpeg-turbo gives with its defaults, as PIL decodes
// (`Image.open(f).convert("RGB")`), bit for bit:
//   - every scan's coefficients into a buffer a component (jdhuff.c's
//     sequential decoding; jdphuff.c's four progressive scan kinds: DC
//     first and refinement, AC first with EOB runs, AC refinement with
//     correction bits), dequantized with the table in force at the
//     component's first scan (jdinput.c latch_quant_tables);
//   - the JDCT_ISLOW integer IDCT of jidctint.c (13-bit constants, two
//     passes, 2 extra bits between them);
//   - jdsample.c's upsampling: "fancy" triangle filters for h2v1 and h2v2
//     (when the downsampled width is above 2, else replication) and h1v2,
//     replication (int_upsample) for any other integral factor; edges
//     replicate the last sample row or column;
//   - jdcolor.c: gray repeated to three channels, the fixed-point YCbCr ->
//     RGB tables (16 fraction bits), RGB without conversion, CMYK as is and
//     YCCK -> CMYK, the color space chosen as jdapimin.c does (JFIF and
//     Adobe segments, then component ids); CMYK then goes through PIL's
//     inverted "CMYK;I" raw mode and its cmyk2rgb.
// Interleaved and non-interleaved scans, restart intervals, 8- and 16-bit
// quantization tables and any width and height are decoded. Refused with
// status 2 and a message naming the variant: arithmetic, lossless,
// hierarchical and 12-bit files, 2 components, fractional chroma ratios,
// and a progressive file whose coefficients 1-9 are not refined to Al 0
// (libjpeg-turbo smooths its blocks, jdcoefct.c decompress_smooth_data).
// The progression checks libjpeg makes fatal (JERR_BAD_PROGRESSION) fail
// with status 1; scans out of order decode, as libjpeg only warns there.
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

// jutils.c's jpeg_natural_order: zigzag index -> natural position, with
// 16 extra entries of 63 so that a run past the last coefficient lands
// there, as libjpeg's decoders let it
const int kZigzag[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kMaxDimension = 65500;
constexpr long kMaxPixels = 178956970;

struct Error {
  int status;  // 1 malformed, 2 not supported
  std::string msg;
};

[[noreturn]] void fail(int status, const std::string& msg) {
  throw Error{status, msg};
}

struct Huffman {
  bool defined = false;
  int maxcode[18];
  int valoffset[18];
  uint8_t vals[256];
  // 9-bit lookahead: (length << 8) | value, 0 when the code is longer
  uint16_t look[512];

  // A table whose codes overrun their length (jdhuff.c's check: the
  // all-ones code of a length is never assigned) or a DC table with a
  // value above 15 is refused before anything is written.
  void build(const uint8_t* counts, const uint8_t* values, int nvals,
             bool is_dc) {
    for (int i = 0; i < nvals; ++i)
      if (is_dc && values[i] > 15)
        fail(1, "bad JPEG Huffman table: a DC value above 15");
    std::memcpy(vals, values, nvals);
    std::memset(look, 0, sizeof(look));
    int code = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
      valoffset[len] = k - code;
      if (counts[len - 1]) {
        for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
          if (code >= (1 << len) - 1)
            fail(1, "bad JPEG Huffman table: codes overrun their lengths");
          if (len <= 9) {
            int shift = 9 - len;
            for (int j = 0; j < (1 << shift); ++j)
              look[(code << shift) | j] =
                  static_cast<uint16_t>((len << 8) | vals[k]);
          }
        }
        maxcode[len] = code - 1;
      } else {
        maxcode[len] = -1;
      }
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
  }
};

struct Component {
  int id, h, v, tq;
  int bw, bh;                 // blocks a row and block rows stored
  int dw, dh;                 // downsampled width and height
  std::vector<int16_t> coef;  // bw x bh blocks of 64, natural order
  std::vector<uint8_t> plane; // bw * 8 x bh * 8 samples
  int dc_table = 0, ac_table = 0;
  long pred = 0;
  bool latched = false;       // q holds the table of its first scan
  uint16_t q[64];
  int coef_bits[64];          // progressive: the last Al sent, -1 none

  int16_t* block(int bx, int by) {
    return coef.data() + (static_cast<size_t>(by) * bw + bx) * 64;
  }
};

class BitReader {
 public:
  BitReader(const uint8_t* data, long n, long pos)
      : data_(data), n_(n), pos_(pos) {}

  int bits(int count) {
    if (count == 0) return 0;
    fill(count);
    int v = static_cast<int>((acc_ >> (nbits_ - count)) & ((1u << count) - 1));
    nbits_ -= count;
    return v;
  }

  int peek9() {
    fill(9);
    return static_cast<int>((acc_ >> (nbits_ - 9)) & 511);
  }

  void skip(int count) { nbits_ -= count; }

  int decode(const Huffman& h) {
    int look = h.look[peek9()];
    if (look) {
      skip(look >> 8);
      return look & 255;
    }
    int code = bits(9), len = 9;
    while (code > h.maxcode[len]) {
      code = (code << 1) | bits(1);
      if (++len > 16) fail(1, "corrupt JPEG data: bad Huffman code");
    }
    return h.vals[code + h.valoffset[len]];
  }

  // Skip to the restart marker RSTn and past it; drops the buffered bits.
  void restart(int expected) {
    acc_ = 0;
    nbits_ = 0;
    at_marker_ = false;
    while (pos_ + 1 < n_ && !(data_[pos_] == 0xFF && data_[pos_ + 1] != 0 &&
                               data_[pos_ + 1] != 0xFF))
      ++pos_;
    if (pos_ + 1 >= n_) fail(1, "JPEG restart marker missing");
    if (data_[pos_ + 1] != 0xD0 + expected)
      fail(1, "corrupt JPEG data: unexpected restart marker");
    pos_ += 2;
  }

  // The position of the next marker after the entropy-coded data.
  long end() {
    long p = pos_;
    while (p + 1 < n_ && !(data_[p] == 0xFF && data_[p + 1] != 0 &&
                           !(data_[p + 1] >= 0xD0 && data_[p + 1] <= 0xD7)))
      ++p;
    return p;
  }

 private:
  void fill(int count) {
    while (nbits_ < count) {
      uint32_t byte = 0;
      if (!at_marker_ && pos_ < n_) {
        byte = data_[pos_];
        if (byte == 0xFF) {
          uint8_t next = pos_ + 1 < n_ ? data_[pos_ + 1] : 0xD9;
          if (next == 0) {
            pos_ += 2;
          } else {
            at_marker_ = true;  // a marker: pad with zeros, as libjpeg does
            byte = 0;
          }
        } else {
          ++pos_;
        }
      }
      acc_ = (acc_ << 8) | byte;
      nbits_ += 8;
    }
  }

  const uint8_t* data_;
  long n_, pos_;
  uint64_t acc_ = 0;
  int nbits_ = 0;
  bool at_marker_ = false;
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// jidctint.c's jpeg_idct_islow on one dequantized block.
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr long F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
               F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
               F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

inline long descale(long x, int n) { return (x + (1L << (n - 1))) >> n; }

inline uint8_t clamp_sample(long v) {
  v += 128;
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

void idct_islow(const int* in, uint8_t* out, int stride) {
  long ws[64];
  for (int c = 0; c < 8; ++c) {
    const int* col = in + c;
    if (!col[8] && !col[16] && !col[24] && !col[32] && !col[40] &&
        !col[48] && !col[56]) {
      long dc = col[0] * (1L << kPass1Bits);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
      continue;
    }
    long z2 = col[16], z3 = col[48];
    long z1 = (z2 + z3) * F0541;
    long tmp2 = z1 + z3 * (-F1847);
    long tmp3 = z1 + z2 * F0765;
    z2 = col[0];
    z3 = col[32];
    long tmp0 = (z2 + z3) * (1L << kConstBits);
    long tmp1 = (z2 - z3) * (1L << kConstBits);
    long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = col[56];
    tmp1 = col[40];
    tmp2 = col[24];
    tmp3 = col[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    long z4 = tmp1 + tmp3;
    long z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    ws[0 * 8 + c] = descale(tmp10 + tmp3, n);
    ws[7 * 8 + c] = descale(tmp10 - tmp3, n);
    ws[1 * 8 + c] = descale(tmp11 + tmp2, n);
    ws[6 * 8 + c] = descale(tmp11 - tmp2, n);
    ws[2 * 8 + c] = descale(tmp12 + tmp1, n);
    ws[5 * 8 + c] = descale(tmp12 - tmp1, n);
    ws[3 * 8 + c] = descale(tmp13 + tmp0, n);
    ws[4 * 8 + c] = descale(tmp13 - tmp0, n);
  }
  for (int r = 0; r < 8; ++r) {
    const long* row = ws + r * 8;
    uint8_t* o = out + r * stride;
    long z2 = row[2], z3 = row[6];
    long z1 = (z2 + z3) * F0541;
    long tmp2 = z1 + z3 * (-F1847);
    long tmp3 = z1 + z2 * F0765;
    long tmp0 = (row[0] + row[4]) * (1L << kConstBits);
    long tmp1 = (row[0] - row[4]) * (1L << kConstBits);
    long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = row[7];
    tmp1 = row[5];
    tmp2 = row[3];
    tmp3 = row[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    long z4 = tmp1 + tmp3;
    long z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits + kPass1Bits + 3;
    o[0] = clamp_sample(descale(tmp10 + tmp3, n));
    o[7] = clamp_sample(descale(tmp10 - tmp3, n));
    o[1] = clamp_sample(descale(tmp11 + tmp2, n));
    o[6] = clamp_sample(descale(tmp11 - tmp2, n));
    o[2] = clamp_sample(descale(tmp12 + tmp1, n));
    o[5] = clamp_sample(descale(tmp12 - tmp1, n));
    o[3] = clamp_sample(descale(tmp13 + tmp0, n));
    o[4] = clamp_sample(descale(tmp13 - tmp0, n));
  }
}

// Component c's samples into c.plane, as jdcoefct.c's decompress_data
// makes them: each block the upsampler reads, dequantized with the
// component's latched table (zeros where it had no scan), through
// idct_islow.
void idct_plane(Component& c) {
  const int stride = c.bw * 8;
  const int nbx = (c.dw + 7) / 8, nby = (c.dh + 7) / 8;
  int deq[64];
  for (int by = 0; by < nby; ++by)
    for (int bx = 0; bx < nbx; ++bx) {
      const int16_t* blk = c.block(bx, by);
      for (int i = 0; i < 64; ++i) deq[i] = blk[i] * (c.latched ? c.q[i] : 0);
      idct_islow(deq,
                 c.plane.data() + static_cast<size_t>(by) * 8 * stride +
                     bx * 8,
                 stride);
    }
}

enum ColorSpace { kGray, kYCbCr, kRGB, kCMYK, kYCCK };

struct Decoder {
  const uint8_t* data;
  long n;
  long pos = 2;
  int width = 0, height = 0, hmax = 1, vmax = 1;
  bool frame = false, progressive = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  ColorSpace space = kGray;
  int restart_interval = 0, scans = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  std::vector<Component> comps;
  int mcux = 0, mcuy = 0;

  int u8() {
    if (pos >= n) fail(1, "truncated JPEG");
    return data[pos++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  // Up to the frame header (headers only) or through EOI (decode).
  void run(bool decode) {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) fail(1, "not a JPEG");
    for (;;) {
      int b = u8();
      if (b != 0xFF) continue;  // garbage between markers, as libjpeg skips
      int m = u8();
      while (m == 0xFF) m = u8();
      if (m == 0xD9) {  // EOI
        if (!frame) fail(1, "JPEG without a frame");
        if (!scans) fail(1, "JPEG without a scan");
        return;
      }
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      int len = u16();
      if (len < 2 || pos + len - 2 > n) fail(1, "truncated JPEG segment");
      long seg = pos, next = pos + len - 2;
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
          read_frame(m == 0xC2);
          if (!decode) return;
          break;
        case 0xC6:
          fail(2, "progressive JPEG (hierarchical, differential)");
        case 0xC3:
        case 0xC7:
          fail(2, "lossless JPEG");
        case 0xC5:
          fail(2, "hierarchical JPEG (differential sequential)");
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          fail(2, "arithmetic-coded JPEG");
        case 0xCC:
          fail(2, "arithmetic-coded JPEG (DAC marker)");
        case 0xC4:
          read_dht(next);
          break;
        case 0xDB:
          read_dqt(next);
          break;
        case 0xDD:
          restart_interval = u16();
          break;
        case 0xDC:
          fail(2, "JPEG with a DNL marker");
        case 0xE0:  // jdmarker.c examine_app0: 14 bytes of JFIF header
          if (len >= 16 && std::memcmp(data + seg, "JFIF\0", 5) == 0)
            jfif = true;
          break;
        case 0xEE:  // examine_app14: 12 bytes of Adobe header
          if (len >= 14 && std::memcmp(data + seg, "Adobe", 5) == 0) {
            adobe = true;
            adobe_transform = data[seg + 11];
          }
          break;
        case 0xDA:
          if (!frame) fail(1, "JPEG scan before its frame header");
          if (!scans) choose_color_space();
          read_scan();
          ++scans;
          continue;  // the scan reader leaves pos at the next marker
        default:
          break;  // APPn, COM and the rest carry nothing decoded here
      }
      pos = next;
    }
  }

  // jdapimin.c default_decompress_parms, from the markers before the first
  // scan.
  void choose_color_space() {
    if (comps.size() == 1) {
      space = kGray;
    } else if (comps.size() == 3) {
      int c0 = comps[0].id, c1 = comps[1].id, c2 = comps[2].id;
      if (jfif)
        space = kYCbCr;
      else if (adobe)
        space = adobe_transform == 0 ? kRGB : kYCbCr;
      else
        space = (c0 == 82 && c1 == 71 && c2 == 66) ? kRGB : kYCbCr;
    } else {
      space = adobe && adobe_transform != 0 ? kYCCK : kCMYK;
    }
  }

  void read_frame(bool prog) {
    if (frame) fail(1, "JPEG with two frame headers");
    progressive = prog;
    int precision = u8();
    if (precision != 8)
      fail(2, std::to_string(precision) + "-bit JPEG");
    height = u16();
    width = u16();
    int nc = u8();
    if (height == 0) fail(2, "JPEG with a DNL marker (height 0)");
    if (width == 0) fail(1, "JPEG of width 0");
    // libjpeg's JPEG_MAX_DIMENSION, and PIL's decompression-bomb limit
    // (2 x Image.MAX_IMAGE_PIXELS) on the pixel count
    if (width > kMaxDimension || height > kMaxDimension)
      fail(1, "JPEG of " + std::to_string(width) + "x" +
                  std::to_string(height) + ": a side above " +
                  std::to_string(kMaxDimension) + " pixels");
    if (static_cast<long>(width) * height > kMaxPixels)
      fail(1, "JPEG of " + std::to_string(width) + "x" +
                  std::to_string(height) + ": more than " +
                  std::to_string(kMaxPixels) + " pixels");
    if (nc != 1 && nc != 3 && nc != 4)  // PIL opens no other count
      fail(2, "JPEG with " + std::to_string(nc) + " components");
    comps.resize(nc);
    for (auto& c : comps) {
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail(1, "bad JPEG component header");
    }
    if (nc == 1) comps[0].h = comps[0].v = 1;  // one component: no MCU
    hmax = vmax = 1;
    for (auto& c : comps) {
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    // jdsample.c upsamples by integral factors only
    for (auto& c : comps) {
      if (hmax % c.h || vmax % c.v) {
        std::string s;
        for (auto& d : comps)
          s += (s.empty() ? "" : ",") + std::to_string(d.h) + "x" +
               std::to_string(d.v);
        fail(2, "JPEG chroma sampling " + s + " (a fractional ratio)");
      }
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      c.dw = (width * c.h + hmax - 1) / hmax;
      c.dh = (height * c.v + vmax - 1) / vmax;
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
    }
    frame = true;
  }

  void read_dht(long end) {
    while (pos < end) {
      int tc = u8();
      int cls = tc >> 4, id = tc & 15;
      if (cls > 1 || id > 3) fail(1, "bad JPEG Huffman table");
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i] = u8();
      if (total > 256 || pos + total > end) fail(1, "bad JPEG Huffman table");
      (cls ? ac : dc)[id].build(counts, data + pos, total, cls == 0);
      pos += total;
    }
  }

  void read_dqt(long end) {
    while (pos < end) {
      int pq = u8();
      int prec = pq >> 4, id = pq & 15;
      if (id > 3 || prec > 1) fail(1, "bad JPEG quantization table");
      for (int i = 0; i < 64; ++i)
        qt[id][kZigzag[i]] = static_cast<uint16_t>(prec ? u16() : u8());
      qt_defined[id] = true;
    }
  }

  void need_table(const Huffman* tables, int id) {
    if (id > 3 || !tables[id].defined)
      fail(1, "JPEG scan uses an undefined Huffman table");
  }

  void read_scan() {
    int ns = u8();
    if (ns < 1 || ns > 4) fail(1, "bad JPEG scan header");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      int id = u8(), t = u8();
      Component* c = nullptr;
      for (auto& d : comps)
        if (!c && d.id == id) c = &d;
      if (!c) fail(1, "JPEG scan names an unknown component");
      for (auto* d : sc)
        if (d == c) fail(1, "JPEG scan names a component twice");
      c->dc_table = t >> 4;
      c->ac_table = t & 15;
      sc.push_back(c);
    }
    const int ss = u8(), se = u8(), a = u8(), ah = a >> 4, al = a & 15;
    if (!progressive) {
      if (ss != 0 || se != 63 || a != 0)
        fail(2, "progressive JPEG (spectral selection in a sequential "
                "frame)");
      for (auto* c : sc) {
        need_table(dc, c->dc_table);
        need_table(ac, c->ac_table);
      }
    } else {
      // jdphuff.c start_pass_phuff_decoder: the fatal checks
      // (JERR_BAD_PROGRESSION); a scan out of order only warns there
      bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
      if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
      if (bad)
        fail(1, "invalid progressive parameters Ss=" + std::to_string(ss) +
                    " Se=" + std::to_string(se) + " Ah=" +
                    std::to_string(ah) + " Al=" + std::to_string(al));
      for (auto* c : sc) {
        if (ss == 0 && ah == 0) need_table(dc, c->dc_table);
        if (ss != 0) need_table(ac, c->ac_table);
        for (int k = ss; k <= se; ++k) c->coef_bits[k] = al;
      }
    }
    int blocks = 0;
    for (auto* c : sc) {  // jdinput.c latch_quant_tables
      if (!c->latched) {
        if (!qt_defined[c->tq])
          fail(1, "JPEG component uses an undefined quantization table");
        std::memcpy(c->q, qt[c->tq], sizeof(c->q));
        c->latched = true;
      }
      if (c->coef.empty())
        c->coef.assign(static_cast<size_t>(c->bw) * c->bh * 64, 0);
      blocks += c->h * c->v;
    }
    if (ns > 1 && blocks > 10)  // D_MAX_BLOCKS_IN_MCU
      fail(1, "JPEG scan of more than 10 blocks an MCU");
    for (auto* c : sc) c->pred = 0;

    BitReader br(data, n, pos);
    int eobrun = 0;
    auto dc_value = [&](Component* c) -> long {
      const int s = br.decode(dc[c->dc_table]);
      const long diff = s ? extend(br.bits(s), s) : 0;
      c->pred += diff;
      if (c->pred > INT32_MAX || c->pred < INT32_MIN)
        fail(1, "corrupt JPEG data: DC coefficient out of range");
      return c->pred;
    };
    // jdhuff.c decode_mcu: a sequential block
    auto sequential = [&](Component* c, int16_t* blk) {
      blk[0] = static_cast<int16_t>(dc_value(c));
      const Huffman& h = ac[c->ac_table];
      for (int k = 1; k < 64; ++k) {
        const int rs = br.decode(h), r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          blk[kZigzag[k]] = static_cast<int16_t>(extend(br.bits(s), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    };
    // jdphuff.c decode_mcu_DC_first / _DC_refine
    auto dc_first = [&](Component* c, int16_t* blk) {
      blk[0] = static_cast<int16_t>(
          static_cast<uint32_t>(dc_value(c)) << al);
    };
    auto dc_refine = [&](Component*, int16_t* blk) {
      if (br.bits(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
    };
    // decode_mcu_AC_first: the band Ss..Se at point transform Al
    auto ac_first = [&](Component* c, int16_t* blk) {
      if (eobrun > 0) {
        --eobrun;
        return;
      }
      const Huffman& h = ac[c->ac_table];
      for (int k = ss; k <= se; ++k) {
        const int rs = br.decode(h);
        int r = rs >> 4;
        const int s = rs & 15;
        if (s) {
          k += r;
          blk[kZigzag[k]] = static_cast<int16_t>(
              static_cast<uint32_t>(extend(br.bits(s), s)) << al);
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun = (1 << r) + br.bits(r) - 1;
          break;
        }
      }
    };
    // decode_mcu_AC_refine: one more bit of every coefficient in the band
    auto ac_refine = [&](Component* c, int16_t* blk) {
      const int p1 = 1 << al, m1 = -p1;
      auto correct = [&](int16_t* coef) {
        if (br.bits(1) && (*coef & p1) == 0)
          *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
      };
      int k = ss;
      if (eobrun == 0) {
        const Huffman& h = ac[c->ac_table];
        for (; k <= se; ++k) {
          const int rs = br.decode(h);
          int r = rs >> 4, s = rs & 15;
          if (s) {  // a newly nonzero coefficient, size 1
            s = br.bits(1) ? p1 : m1;
          } else if (r != 15) {
            eobrun = (1 << r) + br.bits(r);
            break;
          }
          // past already-nonzero coefficients (a correction bit each) and
          // r zero ones
          do {
            int16_t* coef = blk + kZigzag[k];
            if (*coef) {
              correct(coef);
            } else if (--r < 0) {
              break;
            }
            ++k;
          } while (k <= se);
          if (s) blk[kZigzag[k]] = static_cast<int16_t>(s);
        }
      }
      if (eobrun > 0) {
        for (; k <= se; ++k) {
          int16_t* coef = blk + kZigzag[k];
          if (*coef) correct(coef);
        }
        --eobrun;
      }
    };
    auto run_blocks = [&](auto&& decode_block) {
      int ux, uy;
      if (ns == 1) {
        ux = (sc[0]->dw + 7) / 8;
        uy = (sc[0]->dh + 7) / 8;
      } else {
        ux = mcux;
        uy = mcuy;
      }
      const long units = static_cast<long>(ux) * uy;
      int rst = 0;
      for (long u = 0; u < units; ++u) {
        if (restart_interval && u && u % restart_interval == 0) {
          br.restart(rst);
          rst = (rst + 1) & 7;
          for (auto* c : sc) c->pred = 0;
          eobrun = 0;
        }
        const int mx = static_cast<int>(u % ux), my = static_cast<int>(u / ux);
        if (ns == 1) {
          decode_block(sc[0], sc[0]->block(mx, my));
        } else {
          for (auto* c : sc)
            for (int y = 0; y < c->v; ++y)
              for (int x = 0; x < c->h; ++x)
                decode_block(c, c->block(mx * c->h + x, my * c->v + y));
        }
      }
    };
    if (!progressive)
      run_blocks(sequential);
    else if (ss == 0)
      ah == 0 ? run_blocks(dc_first) : run_blocks(dc_refine);
    else
      ah == 0 ? run_blocks(ac_first) : run_blocks(ac_refine);
    pos = br.end();
  }

  // jdcoefct.c smoothing_ok: libjpeg-turbo smooths the blocks of a
  // progressive file (decompress_smooth_data) when a component's DC is
  // known and one of its coefficients 1-9 (SAVED_COEFS) was never refined
  // to Al 0, provided every component has a latched table whose entries
  // at those positions are nonzero.
  bool needs_smoothing() const {
    if (!progressive) return false;
    static const int kSaved[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (const auto& c : comps) {
      if (!c.latched) return false;
      for (int pos : kSaved)
        if (c.q[pos] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }
};

// One component upsampled to width x height (jdsample.c's methods).
void upsample(const Component& c, int hmax, int vmax, int width, int height,
              std::vector<uint8_t>& out) {
  out.resize(static_cast<size_t>(width) * height);
  const int stride = c.bw * 8, dw = c.dw, dh = c.dh;
  const int rh = hmax / c.h, rv = vmax / c.v;
  auto at = [&](int y, int x) -> int {
    y = std::min(std::max(y, 0), dh - 1);
    x = std::min(std::max(x, 0), dw - 1);
    return c.plane[static_cast<size_t>(y) * stride + x];
  };
  const bool fancy_h = dw > 2;
  for (int y = 0; y < height; ++y) {
    uint8_t* o = out.data() + static_cast<size_t>(y) * width;
    if (rh == 1 && rv == 1) {
      for (int x = 0; x < width; ++x) o[x] = at(y, x);
    } else if (rh == 2 && rv == 1 && fancy_h) {  // h2v1_fancy_upsample
      for (int x = 0; x < width; ++x) {
        int i = x >> 1;
        if (x & 1)
          o[x] = static_cast<uint8_t>((at(y, i) * 3 + at(y, i + 1) + 2) >> 2);
        else
          o[x] = static_cast<uint8_t>((at(y, i) * 3 + at(y, i - 1) + 1) >> 2);
      }
    } else if (rh == 1 && rv == 2) {  // h1v2_fancy_upsample
      const int r = y >> 1, other = (y & 1) ? r + 1 : r - 1;
      const int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < width; ++x)
        o[x] = static_cast<uint8_t>((at(r, x) * 3 + at(other, x) + bias) >> 2);
    } else if (rh == 2 && rv == 2 && fancy_h) {  // h2v2_fancy_upsample
      const int r = y >> 1, other = (y & 1) ? r + 1 : r - 1;
      auto colsum = [&](int i) { return at(r, i) * 3 + at(other, i); };
      for (int x = 0; x < width; ++x) {
        int i = x >> 1;
        if (x & 1)
          o[x] = static_cast<uint8_t>((colsum(i) * 3 + colsum(i + 1) + 7) >> 4);
        else
          o[x] = static_cast<uint8_t>((colsum(i) * 3 + colsum(i - 1) + 8) >> 4);
      }
    } else {  // h2v1_upsample, h2v2_upsample, int_upsample: replication
      const int r = y / rv;
      for (int x = 0; x < width; ++x) o[x] = at(r, x / rh);
    }
  }
}

struct ColorTables {
  int cr_r[256], cb_b[256];
  long cr_g[256], cb_g[256];
  ColorTables() {  // jdcolor.c build_ycc_rgb_table
    const long one_half = 1L << 15;
    auto fix = [](double x) { return static_cast<long>(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      long x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
  }
};

inline uint8_t limit(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// PIL's Convert.c cmyk2rgb on the inverted samples of its "CMYK;I" raw
// mode (255 - what libjpeg gives); MULDIV255(a, b) rounds a * b / 255.
inline uint8_t cmyk_channel(int c, int k) {
  const int ic = 255 - c, nk = k;  // nk = 255 - (255 - k)
  const int t = ic * nk + 128;
  return limit(nk - (((t >> 8) + t) >> 8));
}

int report(const Error& e, char* msg, int msglen) {
  if (msg && msglen > 0) std::snprintf(msg, msglen, "%s", e.msg.c_str());
  return e.status;
}

}  // namespace

// Headers only: the image's width and height. Returns 0, 1 (malformed) or
// 2 (not supported), with the reason in msg.
extern "C" int jpeg_info(const uint8_t* data, long n, int* width, int* height,
                         char* msg, int msglen) {
  try {
    Decoder d{data, n};
    d.run(false);
    if (!d.frame) fail(1, "JPEG without a frame header");
    *width = d.width;
    *height = d.height;
    return 0;
  } catch (const Error& e) {
    return report(e, msg, msglen);
  } catch (const std::exception& e) {
    return report(Error{1, std::string("JPEG decode failed: ") + e.what()},
                  msg, msglen);
  }
}

// The whole image into out (height x width x 3 RGB). Same returns.
extern "C" int jpeg_decode(const uint8_t* data, long n, uint8_t* out,
                           long out_size, char* msg, int msglen) {
  try {
    Decoder d{data, n};
    d.run(true);
    const long w = d.width, h = d.height;
    if (out_size < w * h * 3) fail(1, "output buffer too small");
    if (d.needs_smoothing())
      fail(2, "progressive JPEG with incomplete refinement (block "
              "smoothing)");
    std::vector<std::vector<uint8_t>> planes(d.comps.size());
    for (size_t i = 0; i < d.comps.size(); ++i) {
      Component& c = d.comps[i];
      if (c.coef.empty())  // no scan: zero coefficients, as libjpeg's
        c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
      c.plane.assign(static_cast<size_t>(c.bw) * 8 * c.bh * 8, 0);
      idct_plane(c);
      std::vector<int16_t>().swap(c.coef);
      upsample(c, d.hmax, d.vmax, d.width, d.height, planes[i]);
      std::vector<uint8_t>().swap(c.plane);
    }
    const uint8_t* p0 = planes[0].data();
    if (d.space == kGray) {
      for (long i = 0; i < w * h; ++i)
        out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = p0[i];
      return 0;
    }
    const uint8_t *p1 = planes[1].data(), *p2 = planes[2].data();
    if (d.space == kRGB) {  // jdcolor.c rgb_rgb_convert
      for (long i = 0; i < w * h; ++i) {
        out[3 * i] = p0[i];
        out[3 * i + 1] = p1[i];
        out[3 * i + 2] = p2[i];
      }
      return 0;
    }
    static const ColorTables t;
    if (d.space == kYCbCr) {  // ycc_rgb_convert
      for (long i = 0; i < w * h; ++i) {
        int y = p0[i], cb = p1[i], cr = p2[i];
        out[3 * i] = limit(y + t.cr_r[cr]);
        out[3 * i + 1] =
            limit(y + static_cast<int>((t.cb_g[cb] + t.cr_g[cr]) >> 16));
        out[3 * i + 2] = limit(y + t.cb_b[cb]);
      }
      return 0;
    }
    const uint8_t* p3 = planes[3].data();
    for (long i = 0; i < w * h; ++i) {
      int c = p0[i], m = p1[i], yy = p2[i];
      if (d.space == kYCCK) {  // ycck_cmyk_convert
        int y = p0[i], cb = p1[i], cr = p2[i];
        c = limit(255 - (y + t.cr_r[cr]));
        m = limit(255 - (y + static_cast<int>((t.cb_g[cb] + t.cr_g[cr]) >>
                                              16)));
        yy = limit(255 - (y + t.cb_b[cb]));
      }
      const int k = p3[i];
      out[3 * i] = cmyk_channel(c, k);
      out[3 * i + 1] = cmyk_channel(m, k);
      out[3 * i + 2] = cmyk_channel(yy, k);
    }
    return 0;
  } catch (const Error& e) {
    return report(e, msg, msglen);
  } catch (const std::exception& e) {
    return report(Error{1, std::string("JPEG decode failed: ") + e.what()},
                  msg, msglen);
  }
}
