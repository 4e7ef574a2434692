// TIFF's LZW (TIFF 6.0 section 13, as libtiff's tif_lzw.c decodes it) for
// media/tiff.py: one strip or tile into at most `need` bytes. Codes are
// read MSB-first from 9 to 12 bits; 256 clears the table, 257 ends the
// data, and the code width grows one code early (when the next free entry
// reaches 511, 1023 or 2047), unlike GIF's LSB-first variant in
// gif_lzw.cc. A stream that ends without 257 stops there.
//
// Build: media/_native.py (g++ -O3 -shared at first use), no dependency.

#include <cstdint>

// Returns the bytes written (fewer than need when the data ends first),
// or -1 for a corrupt code: a first code after a clear above 255, or a
// code past the next free entry.
extern "C" long tiff_lzw(const uint8_t* data, long n, uint8_t* out,
                         long need) {
  static thread_local uint16_t prefix[4096 + 1024];
  static thread_local uint8_t suffix[4096 + 1024];
  static thread_local uint8_t first[4096 + 1024];
  static thread_local uint8_t stack[4096 + 1024];
  const int kClear = 256, kEoi = 257, kMaxEntries = 4096 + 1024;
  for (int i = 0; i < 256; ++i) {
    prefix[i] = 0xFFFF;
    suffix[i] = first[i] = static_cast<uint8_t>(i);
  }
  int nbits = 9, next = 258, prev = -1;
  uint64_t acc = 0;
  int have = 0;
  long pos = 0, written = 0;
  while (written < need) {
    while (have < nbits && pos < n) {
      acc = (acc << 8) | data[pos++];
      have += 8;
    }
    if (have < nbits) break;  // the data ends without EOI
    int code = static_cast<int>((acc >> (have - nbits)) & ((1u << nbits) - 1));
    have -= nbits;
    if (code == kEoi) break;
    if (code == kClear) {
      nbits = 9;
      next = 258;
      prev = -1;
      continue;
    }
    if (prev < 0) {  // the first code after a clear
      if (code > kClear) return -1;
      out[written++] = static_cast<uint8_t>(code);
      prev = code;
      continue;
    }
    if (code > next || next >= kMaxEntries) return -1;
    // the new entry: the previous string and the first byte of this one
    // (of the previous one when the code is the entry being made)
    prefix[next] = static_cast<uint16_t>(prev);
    first[next] = first[prev];
    suffix[next] = code < next ? first[code] : first[prev];
    if (++next > (1 << nbits) - 2 && nbits < 12) ++nbits;
    int sp = 0;
    for (int c = code; c != 0xFFFF; c = prefix[c]) stack[sp++] = suffix[c];
    while (sp && written < need) out[written++] = stack[--sp];
    prev = code;
  }
  return written;
}
