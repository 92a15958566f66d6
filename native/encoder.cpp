// Native image encode/save runtime.
//
// This framework's equivalent of the reference's C++ save path
// (`Graphics::SaveImage`, Graphics.cpp:754-799: glReadPixels -> per-pixel
// linear->sRGB transfer -> SOIL_save_image BMP).  The device keeps the
// accumulation buffer linear float32; this library does the host-side hot
// loop (sRGB OETF + quantize, ~50 MB at 4K) and file encode (BMP / PNG via
// zlib) without Python overhead.  Exposed over a plain C ABI for ctypes.
//
// Build: make -C native   (emits raymarchrenderer/io/_native/libencoder.so)

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <zlib.h>

extern "C" {

// linear float32 [0,1] -> sRGB uint8, the exact transfer of Graphics.cpp:761-786
// (c <= 0.0031308 ? 12.92 c : 1.055 c^(1/2.4) - 0.055).
void rmr_linear_to_srgb_u8(const float* linear, uint8_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    float c = linear[i];
    c = c < 0.0f ? 0.0f : (c > 1.0f ? 1.0f : c);
    float s = c <= 0.0031308f ? c * 12.92f
                              : 1.055f * powf(c, 1.0f / 2.4f) - 0.055f;
    float v = s * 255.0f + 0.5f;
    out[i] = (uint8_t)(v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v));
  }
}

// 24-bit BGR bottom-up BMP — the layout SOIL emits (Graphics.cpp:788-796).
int rmr_write_bmp(const char* path, const uint8_t* rgb, int32_t w, int32_t h) {
  const int row_size = (w * 3 + 3) & ~3;
  const int img_size = row_size * h;
  uint8_t header[54];
  memset(header, 0, sizeof(header));
  header[0] = 'B'; header[1] = 'M';
  const uint32_t file_size = 54 + img_size;
  memcpy(header + 2, &file_size, 4);
  const uint32_t off = 54;       memcpy(header + 10, &off, 4);
  const uint32_t ihdr = 40;      memcpy(header + 14, &ihdr, 4);
  memcpy(header + 18, &w, 4);
  memcpy(header + 22, &h, 4);
  const uint16_t planes = 1;     memcpy(header + 26, &planes, 2);
  const uint16_t bpp = 24;       memcpy(header + 28, &bpp, 2);
  const uint32_t isz = img_size; memcpy(header + 34, &isz, 4);
  const uint32_t ppm = 2835;
  memcpy(header + 38, &ppm, 4);
  memcpy(header + 42, &ppm, 4);

  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  if (fwrite(header, 1, 54, f) != 54) { fclose(f); return -2; }
  std::vector<uint8_t> row(row_size, 0);
  for (int y = h - 1; y >= 0; --y) {  // bottom-up
    const uint8_t* src = rgb + (int64_t)y * w * 3;
    for (int x = 0; x < w; ++x) {     // RGB -> BGR
      row[x * 3 + 0] = src[x * 3 + 2];
      row[x * 3 + 1] = src[x * 3 + 1];
      row[x * 3 + 2] = src[x * 3 + 0];
    }
    if (fwrite(row.data(), 1, row_size, f) != (size_t)row_size) {
      fclose(f);
      return -2;
    }
  }
  fclose(f);
  return 0;
}

static void put_be32(uint8_t* p, uint32_t v) {
  p[0] = v >> 24; p[1] = v >> 16; p[2] = v >> 8; p[3] = v;
}

static int write_chunk(FILE* f, const char tag[4], const uint8_t* data,
                       uint32_t len) {
  uint8_t hdr[8];
  put_be32(hdr, len);
  memcpy(hdr + 4, tag, 4);
  if (fwrite(hdr, 1, 8, f) != 8) return -1;
  if (len && fwrite(data, 1, len, f) != len) return -1;
  uint32_t crc = crc32(0L, Z_NULL, 0);
  crc = crc32(crc, (const Bytef*)tag, 4);
  if (len) crc = crc32(crc, data, len);
  uint8_t crcb[4];
  put_be32(crcb, crc);
  return fwrite(crcb, 1, 4, f) == 4 ? 0 : -1;
}

// 8-bit RGB PNG (filter 0 rows, zlib level 6) — matches io/image.py save_png.
int rmr_write_png(const char* path, const uint8_t* rgb, int32_t w, int32_t h) {
  const size_t stride = (size_t)w * 3 + 1;
  std::vector<uint8_t> raw(stride * h);
  for (int y = 0; y < h; ++y) {
    raw[y * stride] = 0;  // filter: none
    memcpy(&raw[y * stride + 1], rgb + (int64_t)y * w * 3, (size_t)w * 3);
  }
  uLongf comp_cap = compressBound(raw.size());
  std::vector<uint8_t> comp(comp_cap);
  if (compress2(comp.data(), &comp_cap, raw.data(), raw.size(), 6) != Z_OK)
    return -3;

  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  int rc = (int)fwrite(sig, 1, 8, f) == 8 ? 0 : -1;
  uint8_t ihdr[13];
  put_be32(ihdr, (uint32_t)w);
  put_be32(ihdr + 4, (uint32_t)h);
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // color type RGB
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  if (!rc) rc = write_chunk(f, "IHDR", ihdr, 13);
  if (!rc) rc = write_chunk(f, "IDAT", comp.data(), (uint32_t)comp_cap);
  if (!rc) rc = write_chunk(f, "IEND", nullptr, 0);
  fclose(f);
  return rc;
}

}  // extern "C"
