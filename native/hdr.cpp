// Native Radiance RGBE (.hdr) decoder.
//
// This framework's equivalent of the reference's native image loader (SOIL's
// `SOIL_load_OGL_HDR_texture`, used for the environment map at
// `Graphics.cpp:287`).  Decodes both flat and new-style RLE scanlines into
// linear float32 RGB.  Exposed over a C ABI for ctypes; `io/hdr.py` holds
// the pure-Python fallback with identical output.
//
// Build: make -C native  (emits raymarchrenderer/io/_native/libhdr.so)

#include <cmath>
#include <cstdio>
#include <cstdint>
#include <cstring>

extern "C" {

// Parse the header of an in-memory .hdr file.  Writes width/height and the
// byte offset of the first scanline.  Returns 0 on success.
int32_t rmr_hdr_probe(const uint8_t* data, int64_t n, int32_t* out_w,
                      int32_t* out_h, int64_t* out_pos) {
  if (n < 2 || data[0] != '#' || data[1] != '?') return -1;
  int64_t pos = 0;
  // header lines until the blank separator
  for (;;) {
    int64_t nl = pos;
    while (nl < n && data[nl] != '\n') ++nl;
    if (nl >= n) return -2;
    if (nl == pos) {  // blank line
      pos = nl + 1;
      break;
    }
    pos = nl + 1;
  }
  // resolution line: "-Y <h> +X <w>"
  int64_t nl = pos;
  while (nl < n && data[nl] != '\n') ++nl;
  if (nl >= n) return -3;
  char line[128];
  int64_t len = nl - pos;
  if (len >= (int64_t)sizeof(line)) return -4;
  memcpy(line, data + pos, len);
  line[len] = 0;
  int w = 0, h = 0;
  if (sscanf(line, "-Y %d +X %d", &h, &w) != 2 || w <= 0 || h <= 0)
    return -5;
  *out_w = w;
  *out_h = h;
  *out_pos = nl + 1;
  return 0;
}

// Decode scanlines into out (h * w * 3 float32).  Returns 0 on success.
int32_t rmr_hdr_decode(const uint8_t* data, int64_t n, int32_t w, int32_t h,
                       int64_t pos, float* out) {
  for (int y = 0; y < h; ++y) {
    uint8_t* row = new uint8_t[(size_t)w * 4];
    bool rle = w >= 8 && w < 32768 && pos + 4 <= n && data[pos] == 2 &&
               data[pos + 1] == 2 &&
               ((data[pos + 2] << 8) | data[pos + 3]) == w;
    if (rle) {
      pos += 4;
      for (int c = 0; c < 4; ++c) {
        int x = 0;
        while (x < w) {
          if (pos >= n) { delete[] row; return -6; }
          int count = data[pos++];
          if (count > 128) {  // run
            count -= 128;
            if (pos >= n || x + count > w) { delete[] row; return -7; }
            uint8_t v = data[pos++];
            for (int i = 0; i < count; ++i) row[(x + i) * 4 + c] = v;
            x += count;
          } else {  // literal
            if (pos + count > n || x + count > w) { delete[] row; return -8; }
            for (int i = 0; i < count; ++i)
              row[(x + i) * 4 + c] = data[pos + i];
            pos += count;
            x += count;
          }
        }
      }
    } else {
      if (pos + (int64_t)w * 4 > n) { delete[] row; return -9; }
      memcpy(row, data + pos, (size_t)w * 4);
      pos += (int64_t)w * 4;
    }
    float* orow = out + (int64_t)y * w * 3;
    for (int x = 0; x < w; ++x) {
      int e = row[x * 4 + 3];
      float scale = e == 0 ? 0.0f : ldexpf(1.0f, e - 136);
      orow[x * 3 + 0] = row[x * 4 + 0] * scale;
      orow[x * 3 + 1] = row[x * 4 + 1] * scale;
      orow[x * 3 + 2] = row[x * 4 + 2] * scale;
    }
    delete[] row;
  }
  return 0;
}

}  // extern "C"
