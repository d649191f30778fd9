// PNG row unfiltering on the host, with a plain C interface.
//
// Host code, not a port of a TPU kernel: the JAX package reads PNG files
// with cv2.imread (libpng), and the port's reader (dsl_tpu_torch/data/png.py)
// inflates the IDAT stream with zlib and unfilters the rows here before one
// pinned upload to the card. Its plain version is png.py::unfilter_reference
// (numpy); the two give the same bytes.
//
// The five filter types of the PNG specification (section 9), as libpng's
// png_read_filter_row applies them: None, Sub (left), Up (above), Average
// (floor of (left + above) / 2) and Paeth (the one of left, above and
// upper-left nearest to left + above - upper-left, ties in that order).
// "Left" is the byte bpp bytes back in the same row (0 before the first
// pixel), "above" the same byte of the previous unfiltered row (0 on the
// first row); bpp is the bytes of a whole pixel, at least 1. Average and
// Paeth depend on the result to their left, so a row runs byte by byte.

#include <cstddef>
#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  int pa = std::abs(b - c);
  int pb = std::abs(a - c);
  int pc = std::abs(a + b - 2 * c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

// src: `rows` rows of 1 + rowbytes bytes (filter type, then the filtered
// bytes); dst: `rows` rows of rowbytes unfiltered bytes. Returns 0, or -1
// at a filter type past 4 (dst is then written up to that row).
extern "C" int dsl_png_unfilter(const uint8_t* src, uint8_t* dst, int64_t rows,
                                int64_t rowbytes, int bpp) {
  const uint8_t* prev = nullptr;
  for (int64_t y = 0; y < rows; ++y) {
    const uint8_t* in = src + y * (rowbytes + 1);
    uint8_t* out = dst + y * rowbytes;
    const uint8_t type = in[0];
    ++in;
    switch (type) {
      case 0:
        for (int64_t x = 0; x < rowbytes; ++x) out[x] = in[x];
        break;
      case 1:
        for (int64_t x = 0; x < rowbytes; ++x)
          out[x] = static_cast<uint8_t>(in[x] + (x >= bpp ? out[x - bpp] : 0));
        break;
      case 2:
        for (int64_t x = 0; x < rowbytes; ++x)
          out[x] = static_cast<uint8_t>(in[x] + (prev ? prev[x] : 0));
        break;
      case 3:
        for (int64_t x = 0; x < rowbytes; ++x) {
          int left = x >= bpp ? out[x - bpp] : 0;
          int up = prev ? prev[x] : 0;
          out[x] = static_cast<uint8_t>(in[x] + ((left + up) >> 1));
        }
        break;
      case 4:
        for (int64_t x = 0; x < rowbytes; ++x) {
          int left = x >= bpp ? out[x - bpp] : 0;
          int up = prev ? prev[x] : 0;
          int upleft = (prev && x >= bpp) ? prev[x - bpp] : 0;
          out[x] = static_cast<uint8_t>(in[x] + paeth(left, up, upleft));
        }
        break;
      default:
        return -1;
    }
    prev = out;
  }
  return 0;
}
