// Native image encoder for simplepathtracer_tpu.
//
// Native analog of the reference's stb_image_write dependency
// (reference include/IOHelpers.hpp:6-27 uses stbi_write_bmp for the final
// framebuffer).  Written from scratch: 24-bit BMP and zlib-PNG encoders plus
// a fused gamma+quantize resolve, exposed as a C ABI for ctypes (no pybind11
// in this environment).
//
// Build: make -C native   (g++ -O3 -shared -fPIC, links -lz)

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <zlib.h>

extern "C" {

// Fused resolve: linear fp32 accumulation -> gamma-corrected u8.
// Mirrors io::WritePixel semantics (gamma 2.0 == sqrt) generalized to any
// gamma; `count` divides the accumulation (progressive spp).
void resolve_gamma_u8(const float* accum, uint8_t* out, int64_t n,
                      float inv_count, float inv_gamma) {
  for (int64_t i = 0; i < n; ++i) {
    float v = accum[i] * inv_count;
    v = v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
    v = powf(v, inv_gamma);
    float q = v * 255.0f + 0.5f;
    out[i] = (uint8_t)(q > 255.f ? 255 : (q < 0.f ? 0 : (int)q));
  }
}

// 24-bit bottom-up BGR BMP. data is [h, w, 3] RGB u8 row-major, top-down.
int write_bmp(const char* path, const uint8_t* data, int w, int h) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  const int row_size = (w * 3 + 3) & ~3;
  const uint32_t pixel_bytes = (uint32_t)row_size * h;
  uint8_t header[54] = {0};
  header[0] = 'B'; header[1] = 'M';
  uint32_t file_size = 54 + pixel_bytes;
  memcpy(header + 2, &file_size, 4);
  uint32_t off = 54; memcpy(header + 10, &off, 4);
  uint32_t ihs = 40; memcpy(header + 14, &ihs, 4);
  memcpy(header + 18, &w, 4);
  memcpy(header + 22, &h, 4);
  uint16_t planes = 1; memcpy(header + 26, &planes, 2);
  uint16_t bpp = 24; memcpy(header + 28, &bpp, 2);
  memcpy(header + 34, &pixel_bytes, 4);
  uint32_t ppm = 2835; memcpy(header + 38, &ppm, 4); memcpy(header + 42, &ppm, 4);
  if (fwrite(header, 1, 54, f) != 54) { fclose(f); return -2; }
  std::vector<uint8_t> row(row_size, 0);
  for (int y = h - 1; y >= 0; --y) {
    const uint8_t* src = data + (size_t)y * w * 3;
    for (int x = 0; x < w; ++x) {  // RGB -> BGR
      row[x * 3 + 0] = src[x * 3 + 2];
      row[x * 3 + 1] = src[x * 3 + 1];
      row[x * 3 + 2] = src[x * 3 + 0];
    }
    if (fwrite(row.data(), 1, row_size, f) != (size_t)row_size) {
      fclose(f); return -2;
    }
  }
  fclose(f);
  return 0;
}

static void put_u32be(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back((x >> 24) & 0xff); v.push_back((x >> 16) & 0xff);
  v.push_back((x >> 8) & 0xff); v.push_back(x & 0xff);
}

static void put_chunk(std::vector<uint8_t>& out, const char tag[4],
                      const uint8_t* data, uint32_t len) {
  put_u32be(out, len);
  size_t start = out.size();
  out.insert(out.end(), tag, tag + 4);
  out.insert(out.end(), data, data + len);
  uint32_t crc = crc32(0L, out.data() + start, 4 + len);
  put_u32be(out, crc);
}

// 8-bit RGB PNG via zlib. data is [h, w, 3] RGB u8 top-down.
int write_png(const char* path, const uint8_t* data, int w, int h) {
  // Raw scanlines with filter byte 0.
  std::vector<uint8_t> raw((size_t)h * (1 + (size_t)w * 3));
  for (int y = 0; y < h; ++y) {
    uint8_t* dst = raw.data() + (size_t)y * (1 + (size_t)w * 3);
    dst[0] = 0;
    memcpy(dst + 1, data + (size_t)y * w * 3, (size_t)w * 3);
  }
  uLongf comp_cap = compressBound((uLong)raw.size());
  std::vector<uint8_t> comp(comp_cap);
  if (compress2(comp.data(), &comp_cap, raw.data(), (uLong)raw.size(), 6) != Z_OK)
    return -3;

  std::vector<uint8_t> out;
  const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  out.insert(out.end(), sig, sig + 8);
  uint8_t ihdr[13];
  ihdr[0] = (w >> 24) & 0xff; ihdr[1] = (w >> 16) & 0xff;
  ihdr[2] = (w >> 8) & 0xff;  ihdr[3] = w & 0xff;
  ihdr[4] = (h >> 24) & 0xff; ihdr[5] = (h >> 16) & 0xff;
  ihdr[6] = (h >> 8) & 0xff;  ihdr[7] = h & 0xff;
  ihdr[8] = 8; ihdr[9] = 2; ihdr[10] = 0; ihdr[11] = 0; ihdr[12] = 0;
  put_chunk(out, "IHDR", ihdr, 13);
  put_chunk(out, "IDAT", comp.data(), (uint32_t)comp_cap);
  put_chunk(out, "IEND", nullptr, 0);

  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  size_t n = fwrite(out.data(), 1, out.size(), f);
  fclose(f);
  return n == out.size() ? 0 : -2;
}

}  // extern "C"
