// PNG row unfiltering (the PNG specification, section 9: filter types 0-4)
// for media/image_io.py. Paeth and Average depend on the pixel just
// decoded to their left, so a row cannot be undone by whole-array numpy
// operations; this loop undoes one image's rows in a single pass.
//
// Build: media/_native.py (g++ -O3 -shared at first use), no dependency.

#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a);
  const int pb = std::abs(p - b);
  const int pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

// data: `height` rows of 1 filter-type byte + `row_bytes` filtered bytes.
// out: height x row_bytes unfiltered bytes. bpp: bytes a complete pixel
// (at least 1). Returns 0, or 1 + the index of the first row whose filter
// type is not 0-4.
extern "C" long png_unfilter(const uint8_t* data, long height, long row_bytes,
                             int bpp, uint8_t* out) {
  for (long y = 0; y < height; ++y) {
    const uint8_t* src = data + y * (row_bytes + 1);
    const uint8_t type = src[0];
    ++src;
    uint8_t* row = out + y * row_bytes;
    const uint8_t* up = y ? row - row_bytes : nullptr;
    switch (type) {
      case 0:
        for (long i = 0; i < row_bytes; ++i) row[i] = src[i];
        break;
      case 1:
        for (long i = 0; i < row_bytes; ++i)
          row[i] = src[i] + (i >= bpp ? row[i - bpp] : 0);
        break;
      case 2:
        for (long i = 0; i < row_bytes; ++i)
          row[i] = src[i] + (up ? up[i] : 0);
        break;
      case 3:
        for (long i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? row[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          row[i] = src[i] + static_cast<uint8_t>((a + b) >> 1);
        }
        break;
      case 4:
        for (long i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? row[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          row[i] = src[i] + paeth(a, b, c);
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}
