// Undo the PNG row filters (PNG spec section 9) of a decompressed image.
//
// C ABI (bound with ctypes by native/__init__.py):
//   png_unfilter(raw, h, row_bytes, bpp, out) -> -1 on success, else the
//     first row whose filter type is not 0-4.
//     raw: h rows of 1 filter byte + row_bytes bytes (zlib's output);
//     out: h * row_bytes bytes; bpp: bytes per pixel (1, 3 or 4).
//   png_filter_version() -> ABI version int.
//
// Each row's Sub, Average and Paeth predictions depend on the row's own
// reconstructed bytes to the left, so the rows are undone in order, one
// byte at a time; numpy cannot vectorise that recurrence.

#include <cstdint>
#include <cstdlib>

extern "C" {

int png_filter_version() { return 1; }

int png_unfilter(const uint8_t* raw, int h, int row_bytes, int bpp,
                 uint8_t* out) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* f = raw + static_cast<size_t>(y) * (row_bytes + 1);
    const int type = f[0];
    ++f;
    uint8_t* x = out + static_cast<size_t>(y) * row_bytes;
    const uint8_t* up = y ? x - row_bytes : nullptr;
    for (int i = 0; i < row_bytes; ++i) {
      const int a = i >= bpp ? x[i - bpp] : 0;
      const int b = up ? up[i] : 0;
      const int c = (up && i >= bpp) ? up[i - bpp] : 0;
      int pred;
      switch (type) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return y;
      }
      x[i] = static_cast<uint8_t>(f[i] + pred);
    }
  }
  return -1;
}

}  // extern "C"
