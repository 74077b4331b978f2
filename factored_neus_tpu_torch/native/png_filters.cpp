// PNG row unfiltering (the five filter types of the PNG specification,
// section 9) for the port's PNG reader (factored_neus_tpu_torch/data/
// images.py): host-side native component of the PyTorch port (C ABI for
// ctypes).  Average and Paeth depend on the byte just decoded to their
// left, so they run byte by byte; here they run at C speed.
#include <cstdint>
#include <cstdlib>
#include <vector>

extern "C" {

// raw: H rows of [filter type byte | stride bytes]; out: H x stride bytes.
// Returns 0, or 1 + the row index of the first row with an unknown filter.
int64_t png_unfilter(const uint8_t* raw, int64_t H, int64_t stride,
                     int64_t bpp, uint8_t* out) {
  std::vector<uint8_t> zeros(stride, 0);
  for (int64_t y = 0; y < H; ++y) {
    const uint8_t ftype = raw[y * (stride + 1)];
    const uint8_t* line = raw + y * (stride + 1) + 1;
    const uint8_t* prev = y > 0 ? out + (y - 1) * stride : zeros.data();
    uint8_t* cur = out + y * stride;
    for (int64_t i = 0; i < stride; ++i) {
      const int a = i >= bpp ? cur[i - bpp] : 0;   // left
      const int b = prev[i];                        // up
      const int c = i >= bpp ? prev[i - bpp] : 0;   // up-left
      int pred;
      switch (ftype) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int pa = std::abs(b - c), pb = std::abs(a - c),
                    pc = std::abs(a + b - 2 * c);
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return y + 1;
      }
      cur[i] = (uint8_t)(line[i] + pred);
    }
  }
  return 0;
}

}  // extern "C"
