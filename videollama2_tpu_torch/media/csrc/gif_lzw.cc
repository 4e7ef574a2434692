// GIF's variable-width LZW (GIF89a, appendix F) for media/video_reader.py:
// one image's code stream, its sub-blocks already joined, into palette
// indices in stream order (the caller undoes interlacing). Each decoded
// string walks back through the prefix table, so a frame is a tight loop
// here rather than per-pixel Python.
//
// Build: media/_native.py (g++ -O3 -shared at first use), no dependency.

#include <cstdint>

// data: the joined sub-blocks; min_code_size: the byte before them (2-12).
// Writes at most npix indices into out. Returns the count written (fewer
// than npix when the end code comes early), or -1 for a code that is
// neither in the table nor the next one to be added.
extern "C" long gif_lzw(const uint8_t* data, long n, int min_code_size,
                        uint8_t* out, long npix) {
  if (min_code_size < 1 || min_code_size > 11) return -1;
  static thread_local uint16_t prefix[4096];
  static thread_local uint8_t suffix[4096];
  static thread_local uint8_t first[4096];
  static thread_local uint8_t stack[4097];
  const int clear = 1 << min_code_size, eoi = clear + 1;
  for (int i = 0; i < clear; ++i) {
    prefix[i] = 0xFFFF;
    suffix[i] = static_cast<uint8_t>(i);
    first[i] = static_cast<uint8_t>(i);
  }
  int size = min_code_size + 1, next = clear + 2, prev = -1;
  uint32_t acc = 0;
  int nbits = 0;
  long pos = 0, written = 0;
  while (written < npix) {
    while (nbits < size && pos < n) {
      acc |= static_cast<uint32_t>(data[pos++]) << nbits;
      nbits += 8;
    }
    if (nbits < size) break;  // the data ran out
    int code = static_cast<int>(acc & ((1u << size) - 1));
    acc >>= size;
    nbits -= size;
    if (code == clear) {
      size = min_code_size + 1;
      next = clear + 2;
      prev = -1;
      continue;
    }
    if (code == eoi) break;
    int sp = 0, c;
    if (prev < 0) {
      if (code >= clear) return -1;
      c = code;
    } else if (code < next) {
      c = code;
    } else if (code == next) {
      stack[sp++] = first[prev];
      c = prev;
    } else {
      return -1;
    }
    const uint8_t head = first[c];
    while (c != 0xFFFF && sp < 4097) {
      stack[sp++] = suffix[c];
      c = prefix[c];
    }
    while (sp && written < npix) out[written++] = stack[--sp];
    if (prev >= 0 && next < 4096) {
      prefix[next] = static_cast<uint16_t>(prev);
      suffix[next] = head;
      first[next] = first[prev];
      ++next;
      if (next == (1 << size) && size < 12) ++size;
    }
    prev = code;
  }
  return written;
}
