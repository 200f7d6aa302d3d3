// Native PNG codec for the dataset loader (grayscale + RGB decode/encode).
//
// Chunk parsing, zlib inflate and scanline unfiltering here; ctypes
// bindings in native/__init__.py; the pure-Python reader of
// data/png_io.py is the fallback where this file cannot be built.
//
// Supported: bit depth 8/16; color types 0 (gray), 2 (RGB), 4 (gray+alpha),
// 6 (RGBA); no interlacing.  png_read_gray converts 8-bit RGB to luma with
// PIL's exact fixed-point ITU-R 601 form (bit-equal to convert("L"));
// png_read_rgb
// returns PLANAR (3, rows, cols) float64 (gray sources replicate the
// channel — the vectorial/color model tier consumes this layout directly).
// Encode writes filter 0, one IDAT: 8-bit grayscale (png_write_gray) or
// 8-bit RGB from a planar buffer (png_write_rgb).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <zlib.h>

namespace {

struct Reader {
  const uint8_t* p;
  size_t n;
  size_t off = 0;
  bool ok = true;

  uint32_t u32() {
    if (off + 4 > n) { ok = false; return 0; }
    uint32_t v = (uint32_t(p[off]) << 24) | (uint32_t(p[off + 1]) << 16) |
                 (uint32_t(p[off + 2]) << 8) | uint32_t(p[off + 3]);
    off += 4;
    return v;
  }
  const uint8_t* bytes(size_t k) {
    if (off + k > n) { ok = false; return nullptr; }
    const uint8_t* q = p + off;
    off += k;
    return q;
  }
};

int paeth(int a, int b, int c) {
  int pp = a + b - c;
  int pa = abs(pp - a), pb = abs(pp - b), pc = abs(pp - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

bool inflate_all(const std::vector<uint8_t>& in, std::vector<uint8_t>& out) {
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = const_cast<Bytef*>(in.data());
  zs.avail_in = static_cast<uInt>(in.size());
  uint8_t buf[1 << 16];
  int ret;
  do {
    zs.next_out = buf;
    zs.avail_out = sizeof(buf);
    ret = inflate(&zs, Z_NO_FLUSH);
    if (ret != Z_OK && ret != Z_STREAM_END) {
      inflateEnd(&zs);
      return false;
    }
    out.insert(out.end(), buf, buf + (sizeof(buf) - zs.avail_out));
  } while (ret != Z_STREAM_END);
  inflateEnd(&zs);
  return true;
}

// Shared decode: file -> unfiltered scanline bytes + header metadata.
// Negative err codes match the original reader's convention.
struct Decoded {
  std::vector<uint8_t> img;  // H * stride unfiltered bytes
  uint32_t W = 0, H = 0;
  int bit_depth = 0, channels = 0;
  size_t stride = 0, bpp = 0;
  bool subbyte = false;
  int err = 0;
};

Decoded decode_png(const char* path) {
  Decoded d;
  FILE* f = fopen(path, "rb");
  if (!f) { d.err = -1; return d; }
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (sz < 8) {  // unseekable stream (ftell = -1) or impossibly small file
    fclose(f);
    d.err = -2;
    return d;
  }
  std::vector<uint8_t> data(sz);
  if (fread(data.data(), 1, sz, f) != static_cast<size_t>(sz)) {
    fclose(f);
    d.err = -2;
    return d;
  }
  fclose(f);

  static const uint8_t magic[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (sz < 8 || memcmp(data.data(), magic, 8) != 0) { d.err = -3; return d; }

  Reader r{data.data(), static_cast<size_t>(sz), 8};
  int color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;

  while (r.ok && r.off < r.n) {
    uint32_t len = r.u32();
    const uint8_t* type = r.bytes(4);
    if (!r.ok) { d.err = -4; return d; }
    const uint8_t* payload = r.bytes(len);
    if (!r.ok) { d.err = -4; return d; }
    r.u32();  // CRC (unchecked; zlib adler catches corruption downstream)
    if (memcmp(type, "IHDR", 4) == 0) {
      if (len < 13) { d.err = -5; return d; }
      d.W = (uint32_t(payload[0]) << 24) | (uint32_t(payload[1]) << 16) |
            (uint32_t(payload[2]) << 8) | payload[3];
      d.H = (uint32_t(payload[4]) << 24) | (uint32_t(payload[5]) << 16) |
            (uint32_t(payload[6]) << 8) | payload[7];
      d.bit_depth = payload[8];
      color_type = payload[9];
      interlace = payload[12];
    } else if (memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), payload, payload + len);
    } else if (memcmp(type, "IEND", 4) == 0) {
      break;
    }
  }
  if (d.W == 0 || d.H == 0 || interlace != 0) { d.err = -6; return d; }
  d.subbyte = d.bit_depth < 8;
  if (d.bit_depth != 8 && d.bit_depth != 16 &&
      !(d.subbyte && color_type == 0)) {
    d.err = -7;
    return d;
  }
  if (d.subbyte && d.bit_depth != 1 && d.bit_depth != 2 && d.bit_depth != 4) {
    d.err = -7;
    return d;
  }

  switch (color_type) {
    case 0: d.channels = 1; break;
    case 2: d.channels = 3; break;
    case 4: d.channels = 2; break;
    case 6: d.channels = 4; break;
    default: d.err = -8; return d;
  }

  std::vector<uint8_t> raw;
  if (!inflate_all(idat, raw)) { d.err = -9; return d; }

  // filtering operates on whole bytes; bpp = ceil(bits per pixel / 8)
  const size_t bits_per_pixel =
      static_cast<size_t>(d.channels) * d.bit_depth;
  d.bpp = d.subbyte ? 1 : bits_per_pixel / 8;
  d.stride = d.subbyte ? (bits_per_pixel * d.W + 7) / 8 : d.bpp * d.W;
  if (raw.size() < d.H * (d.stride + 1)) { d.err = -10; return d; }

  // Unfilter scanlines into d.img.
  d.img.resize(d.H * d.stride);
  for (uint32_t y = 0; y < d.H; ++y) {
    uint8_t filter = raw[y * (d.stride + 1)];
    const uint8_t* src = raw.data() + y * (d.stride + 1) + 1;
    uint8_t* dst = d.img.data() + y * d.stride;
    const uint8_t* up = y ? d.img.data() + (y - 1) * d.stride : nullptr;
    for (size_t x = 0; x < d.stride; ++x) {
      int a = x >= d.bpp ? dst[x - d.bpp] : 0;
      int b = up ? up[x] : 0;
      int c = (up && x >= d.bpp) ? up[x - d.bpp] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: d.err = -11; return d;
      }
      dst[x] = static_cast<uint8_t>(v);
    }
  }
  return d;
}

// Sub-byte (1/2/4-bit) grayscale sample in [0,1].
double subbyte_sample(const Decoded& d, uint32_t y, uint32_t x) {
  const uint8_t* row = d.img.data() + y * d.stride;
  size_t bit_off = static_cast<size_t>(x) * d.bit_depth;
  uint8_t byte = row[bit_off >> 3];
  int shift = 8 - d.bit_depth - static_cast<int>(bit_off & 7);
  int v = (byte >> shift) & ((1 << d.bit_depth) - 1);
  return v * (1.0 / ((1 << d.bit_depth) - 1));
}

// Channel ch of pixel (y, x) in [0,1] for 8/16-bit images.
double channel_sample(const Decoded& d, uint32_t y, uint32_t x, int ch) {
  const double scale = d.bit_depth == 8 ? 1.0 / 255.0 : 1.0 / 65535.0;
  const int step = d.bit_depth / 8;
  const uint8_t* s = d.img.data() + y * d.stride + x * d.bpp + ch * step;
  int v = d.bit_depth == 8 ? s[0] : ((s[0] << 8) | s[1]);
  return v * scale;
}

// Encode a filter-0, single-IDAT PNG from raw scanline bytes.
int encode_png(const char* path, const std::vector<uint8_t>& raw,
               uint32_t W, uint32_t H, uint8_t color_type) {
  uLongf comp_bound = compressBound(raw.size());
  std::vector<uint8_t> comp(comp_bound);
  if (compress2(comp.data(), &comp_bound, raw.data(), raw.size(),
                Z_BEST_SPEED) != Z_OK)
    return -1;
  comp.resize(comp_bound);

  FILE* f = fopen(path, "wb");
  if (!f) return -2;

  auto be32 = [](uint32_t v, uint8_t* b) {
    b[0] = v >> 24; b[1] = v >> 16; b[2] = v >> 8; b[3] = v;
  };
  auto write_chunk = [&](const char* type, const uint8_t* payload,
                         uint32_t len) {
    uint8_t hdr[8];
    be32(len, hdr);
    memcpy(hdr + 4, type, 4);
    fwrite(hdr, 1, 8, f);
    if (len) fwrite(payload, 1, len, f);
    uLong crc = crc32(0L, Z_NULL, 0);
    crc = crc32(crc, hdr + 4, 4);
    if (len) crc = crc32(crc, payload, len);
    uint8_t crcb[4];
    be32(static_cast<uint32_t>(crc), crcb);
    fwrite(crcb, 1, 4, f);
  };

  static const uint8_t magic[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  fwrite(magic, 1, 8, f);
  uint8_t ihdr[13];
  be32(W, ihdr);
  be32(H, ihdr + 4);
  ihdr[8] = 8;           // bit depth
  ihdr[9] = color_type;  // 0 = grayscale, 2 = RGB
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  write_chunk("IHDR", ihdr, 13);
  write_chunk("IDAT", comp.data(), static_cast<uint32_t>(comp.size()));
  write_chunk("IEND", nullptr, 0);
  fclose(f);
  return 0;
}

uint8_t quant8(double v) {
  if (!(v >= 0.0)) v = 0.0;  // also catches NaN (comparison false)
  if (v > 1.0) v = 1.0;
  return static_cast<uint8_t>(v * 255.0 + 0.5);
}

}  // namespace

extern "C" {

// Returns 0 on success; *out is malloc'd row-major (rows*cols) in [0,1].
int png_read_gray(const char* path, double** out, int* rows, int* cols) {
  Decoded d = decode_png(path);
  if (d.err) return d.err;

  double* result =
      static_cast<double*>(malloc(sizeof(double) * d.W * d.H));
  if (!result) return -12;
  for (uint32_t y = 0; y < d.H; ++y) {
    for (uint32_t x = 0; x < d.W; ++x) {
      double g;
      if (d.subbyte) {
        g = subbyte_sample(d, y, x);
      } else if (d.channels >= 3 && d.bit_depth == 8) {
        // ITU-R 601 luma in PIL's exact fixed-point form
        // (convert("L"): (R·19595 + G·38470 + B·7471 + 0x8000) >> 16)
        const uint8_t* px = d.img.data() + y * d.stride + x * d.bpp;
        int v = (px[0] * 19595 + px[1] * 38470 + px[2] * 7471 + 0x8000)
                >> 16;
        g = v / 255.0;
      } else if (d.channels >= 3) {
        g = 0.299 * channel_sample(d, y, x, 0) +
            0.587 * channel_sample(d, y, x, 1) +
            0.114 * channel_sample(d, y, x, 2);
      } else {
        g = channel_sample(d, y, x, 0);  // gray / gray+alpha
      }
      result[y * d.W + x] = g;
    }
  }
  *out = result;
  *rows = static_cast<int>(d.H);
  *cols = static_cast<int>(d.W);
  return 0;
}

// Returns 0 on success; *out is malloc'd PLANAR (3 * rows * cols) in [0,1]
// — plane-major (C, rows, cols), the layout the color model tier consumes.
// Grayscale sources replicate the single channel.
int png_read_rgb(const char* path, double** out, int* rows, int* cols) {
  Decoded d = decode_png(path);
  if (d.err) return d.err;

  const size_t plane = static_cast<size_t>(d.W) * d.H;
  double* result = static_cast<double*>(malloc(sizeof(double) * 3 * plane));
  if (!result) return -12;
  for (uint32_t y = 0; y < d.H; ++y) {
    for (uint32_t x = 0; x < d.W; ++x) {
      double r, g, b;
      if (d.subbyte) {
        r = g = b = subbyte_sample(d, y, x);
      } else if (d.channels >= 3) {
        r = channel_sample(d, y, x, 0);
        g = channel_sample(d, y, x, 1);
        b = channel_sample(d, y, x, 2);
      } else {
        r = g = b = channel_sample(d, y, x, 0);
      }
      const size_t i = static_cast<size_t>(y) * d.W + x;
      result[i] = r;
      result[plane + i] = g;
      result[2 * plane + i] = b;
    }
  }
  *out = result;
  *rows = static_cast<int>(d.H);
  *cols = static_cast<int>(d.W);
  return 0;
}

void png_free(double* p) { free(p); }

// Writes an 8-bit grayscale PNG (values clamped to [0,1]).  0 on success.
int png_write_gray(const char* path, const double* img, int rows, int cols) {
  const uint32_t W = cols, H = rows;
  std::vector<uint8_t> raw(H * (W + 1));
  for (uint32_t y = 0; y < H; ++y) {
    raw[y * (W + 1)] = 0;  // filter 0
    for (uint32_t x = 0; x < W; ++x)
      raw[y * (W + 1) + 1 + x] = quant8(img[y * W + x]);
  }
  return encode_png(path, raw, W, H, 0);
}

// Writes an 8-bit RGB PNG from a PLANAR (3, rows, cols) [0,1] buffer.
int png_write_rgb(const char* path, const double* img, int rows, int cols) {
  const uint32_t W = cols, H = rows;
  const size_t plane = static_cast<size_t>(W) * H;
  std::vector<uint8_t> raw(H * (3 * W + 1));
  for (uint32_t y = 0; y < H; ++y) {
    uint8_t* dst = raw.data() + y * (3 * W + 1);
    dst[0] = 0;  // filter 0
    for (uint32_t x = 0; x < W; ++x) {
      const size_t i = static_cast<size_t>(y) * W + x;
      dst[1 + 3 * x] = quant8(img[i]);
      dst[2 + 3 * x] = quant8(img[plane + i]);
      dst[3 + 3 * x] = quant8(img[2 * plane + i]);
    }
  }
  return encode_png(path, raw, W, H, 2);
}

}  // extern "C"
