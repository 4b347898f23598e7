// The per-pixel loops of Pillow's small raw and run-length formats and of
// its resampler, written to read the pixels and write the bytes of
// Pillow 12.1:
//
//   QOI      QoiImagePlugin's decoder and encoder (Python in Pillow): its
//            hash index filled only by the pixels it codes (never by a
//            run), an index miss read as transparent black, runs of at
//            most 62, and every read past the end an error;
//   TGA RLE  TgaRleDecode.c: run packets that may not cross a row, literal
//            packets that go on into the next rows;
//   SGI RLE  SgiRleDecode.c: the offset and length tables (a length is a
//            bound on packets, not checked against the file), expandrow
//            and expandrow2 with their bounds (a row that ends on a
//            nonzero count stops the image, silently), one row buffer
//            kept from row to row;
//   PCX      PcxDecode.c (the band shift of a padded stride) and
//            PcxEncode.c (runs of at most 63 per plane line, a lone byte
//            below 0xc0 written as itself, the even stride's pad byte);
//   PackBits PackBitsDecode.c, as PsdImagePlugin's tiles use it: one
//            stream per channel, a packet that passes a row's end cut
//            there (the rest dropped), the no-op 0x80 skipped;
//   resample Resample.c: precompute_coeffs with the LANCZOS filter (for
//            Image.thumbnail) or the BICUBIC one (a = -0.5, support 2; for
//            Image.resize's default), the 8-bit passes on 22-bit fixed-point
//            weights (horizontal, then vertical, each clipped to 8 bits) and
//            the 16-bit passes on double weights, no step contracted into a
//            fused multiply-add (Pillow's x86-64 build has none);
//   Sun RLE  SunRleDecode.c: 0x80 0 a literal 0x80, 0x80 n v a run of n + 1,
//            a run past a row's end carried into the next rows (its
//            length held in a byte, so a run of 256 that crosses a row
//            wraps), rows of (bits * width + 7) / 8 bytes, unpadded;
//   MSP RLE  MspImagePlugin's MspDecoder (Python in Pillow): the row map,
//            each row's runs written one after another into one byte
//            stream (rows not aligned), an empty row a white one;
//   XBM      XbmDecode.c: each "x" and the two characters after it a byte
//            (a character that is not a hex digit counts 0);
//   FLI      FliDecode.c: the frame chunk's subchunks (SS2, LC, BLACK, BRUN,
//            COPY; colour and stamp chunks passed over) on the bytes
//            ImageFile.load has handed over so far, returning what the C
//            decoder returns;
//   BLP DXT  BlpImagePlugin's decode_dxt1, decode_dxt3 and decode_dxt5
//            (Python in Pillow): 5:6:5 colours widened by a plain shift, the
//            two mixed colours divided with //, DXT1's 3-colour mode only
//            where color0 > color1 says so; not BcnDecode.c.
//
// The headers, palettes and the unpacking of rows are
// dspfun_tpu_torch/io/rawimg.py, io/ico.py, io/icns.py, io/psd.py,
// io/rasters.py, io/blp.py and io/containers.py.
#pragma GCC optimize("fp-contract=off")
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum {
  kOk = 0,
  kOverrun = -1,     // IMAGING_CODEC_OVERRUN
  kTruncated = -20,  // the file ended before the image did
};

constexpr int kPrecisionBits = 32 - 8 - 2;

inline uint8_t clip8(int in) {
  if (in >= (1 << kPrecisionBits << 8)) return 255;
  if (in <= 0) return 0;
  return static_cast<uint8_t>(in >> kPrecisionBits);
}

inline int clip8i(int v) { return v <= 0 ? 0 : (v >= 255 ? 255 : v); }

double sinc(double x) {
  if (x == 0.0) return 1.0;
  x = x * M_PI;
  return sin(x) / x;
}

double lanczos(double x) {
  if (-3.0 <= x && x < 3.0) return sinc(x) * sinc(x / 3);
  return 0.0;
}

double bicubic(double x) {
  constexpr double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

struct Filter {
  double (*fn)(double);
  double support;
};

// by the index io/ico.py passes: 0 LANCZOS, 1 BICUBIC
const Filter kFilters[] = {{lanczos, 3.0}, {bicubic, 2.0}};

// precompute_coeffs (box from 0 to in_size, as a float)
int coeffs(int in_size, int out_size, std::vector<int>& bounds, std::vector<double>& kk,
           const Filter& f) {
  float in0 = 0.0f, in1 = static_cast<float>(in_size);
  double scale = static_cast<double>(in1 - in0) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = f.support * filterscale;
  int ksize = static_cast<int>(ceil(support)) * 2 + 1;
  kk.assign(static_cast<size_t>(out_size) * ksize, 0.0);
  bounds.assign(static_cast<size_t>(out_size) * 2, 0);
  for (int xx = 0; xx < out_size; xx++) {
    double center = in0 + (xx + 0.5) * scale;
    double ww = 0.0, ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &kk[static_cast<size_t>(xx) * ksize];
    for (int x = 0; x < xmax; x++) {
      double w = f.fn((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; x++)
      if (ww != 0.0) k[x] /= ww;
    bounds[xx * 2] = xmin;
    bounds[xx * 2 + 1] = xmax;
  }
  return ksize;
}

std::vector<int> fixed(const std::vector<double>& kk) {
  std::vector<int> out(kk.size());
  for (size_t i = 0; i < kk.size(); i++)
    out[i] = kk[i] < 0 ? static_cast<int>(-0.5 + kk[i] * (1 << kPrecisionBits))
                       : static_cast<int>(0.5 + kk[i] * (1 << kPrecisionBits));
  return out;
}

int round_up(double f) { return static_cast<int>(f >= 0.0 ? f + 0.5F : f - 0.5F); }

// SGI's expandrow / expandrow2: n packets at most (none where the
// table's length is past INT_MAX), into dest every z samples; returns 0, a packet count of 1 (the row ended on a nonzero
// count: the image stops) or kOverrun.
int expandrow(uint8_t* dest, const uint8_t* src, int n, int z, int xsize,
              const uint8_t* end) {
  int x = 0;
  for (; n > 0; n--) {
    if (src > end) return -1;
    uint8_t pixel = *src++;
    if (n == 1 && pixel != 0) return static_cast<int>(n);
    int count = pixel & 0x7f;
    if (!count) return 0;
    if (x + count > xsize) return -1;
    x += count;
    if (pixel & 0x80) {
      if (src + count > end) return -1;
      while (count--) {
        *dest = *src++;
        dest += z;
      }
    } else {
      if (src > end) return -1;
      pixel = *src++;
      while (count--) {
        *dest = pixel;
        dest += z;
      }
    }
  }
  return 0;
}

int expandrow2(uint8_t* dest, const uint8_t* src, int n, int z, int xsize,
               const uint8_t* end) {
  int x = 0;
  for (; n > 0; n--) {
    if (src + 1 > end) return -1;
    uint8_t pixel = src[1];
    src += 2;
    if (n == 1 && pixel != 0) return static_cast<int>(n);
    int count = pixel & 0x7f;
    if (!count) return 0;
    if (x + count > xsize) return -1;
    x += count;
    if (pixel & 0x80) {
      if (src + 2 * count > end) return -1;
      while (count--) {
        memcpy(dest, src, 2);
        src += 2;
        dest += z * 2;
      }
    } else {
      if (src + 2 > end) return -1;
      while (count--) {
        memcpy(dest, src, 2);
        dest += z * 2;
      }
      src += 2;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// QOI: w*h pixels of `channels` (3 or 4) bytes from the chunks at
// data[pos:n]; kTruncated where a read passes the end.
int qoi_decode(const uint8_t* data, int64_t n, int64_t pos, int64_t npix, int channels,
               uint8_t* out) {
  uint8_t seen[64][4];
  bool have[64] = {false};
  uint8_t prev[4] = {0, 0, 0, 255};
  int64_t done = 0;
  while (done < npix) {
    if (pos >= n) return kTruncated;
    int byte = data[pos++];
    uint8_t v[4];
    if (byte == 0xfe) {
      if (pos + 3 > n) return kTruncated;
      v[0] = data[pos], v[1] = data[pos + 1], v[2] = data[pos + 2], v[3] = prev[3];
      pos += 3;
    } else if (byte == 0xff) {
      if (pos + 4 > n) return kTruncated;
      memcpy(v, data + pos, 4);
      pos += 4;
    } else {
      int op = byte >> 6;
      if (op == 0) {
        int i = byte & 63;
        if (have[i]) memcpy(v, seen[i], 4);
        else memset(v, 0, 4);
      } else if (op == 1) {
        v[0] = static_cast<uint8_t>(prev[0] + ((byte >> 4) & 3) - 2);
        v[1] = static_cast<uint8_t>(prev[1] + ((byte >> 2) & 3) - 2);
        v[2] = static_cast<uint8_t>(prev[2] + (byte & 3) - 2);
        v[3] = prev[3];
      } else if (op == 2) {
        if (pos >= n) return kTruncated;
        int second = data[pos++];
        int dg = (byte & 63) - 32, dr = (second >> 4) - 8, db = (second & 15) - 8;
        v[0] = static_cast<uint8_t>(prev[0] + dg + dr);
        v[1] = static_cast<uint8_t>(prev[1] + dg);
        v[2] = static_cast<uint8_t>(prev[2] + dg + db);
        v[3] = prev[3];
      } else {  // a run: not entered in the index
        int64_t run = (byte & 63) + 1;
        for (int64_t r = 0; r < run && done < npix; r++, done++)
          memcpy(out + done * channels, prev, channels);
        continue;
      }
    }
    memcpy(prev, v, 4);
    int h = (v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64;
    memcpy(seen[h], v, 4);
    have[h] = true;
    memcpy(out + done * channels, v, channels);
    done++;
  }
  return kOk;
}

// QOI chunks of w*h pixels of `channels` bytes, the 8-byte end marker
// included; out holds npix * 5 + 8 bytes.  Returns the length.
int64_t qoi_encode(const uint8_t* px, int64_t npix, int channels, uint8_t* out) {
  uint8_t seen[64][4];
  bool have[64] = {false};
  memset(seen[0], 0, 4);
  have[0] = true;
  uint8_t prev[4] = {0, 0, 0, 255};
  int64_t o = 0;
  int run = 0;
  for (int64_t i = 0; i < npix; i++) {
    uint8_t p[4] = {0, 0, 0, 255};
    memcpy(p, px + i * channels, channels);
    if (!memcmp(p, prev, 4)) {
      if (++run == 62) {
        out[o++] = static_cast<uint8_t>(0xc0 | (run - 1));
        run = 0;
      }
      continue;
    }
    if (run) {
      out[o++] = static_cast<uint8_t>(0xc0 | (run - 1));
      run = 0;
    }
    int h = (p[0] * 3 + p[1] * 5 + p[2] * 7 + p[3] * 11) % 64;
    if (have[h] && !memcmp(seen[h], p, 4)) {
      out[o++] = static_cast<uint8_t>(h);
    } else {
      memcpy(seen[h], p, 4);
      have[h] = true;
      if (prev[3] == p[3]) {
        int dr = static_cast<int8_t>(static_cast<uint8_t>(p[0] - prev[0]));
        int dg = static_cast<int8_t>(static_cast<uint8_t>(p[1] - prev[1]));
        int db = static_cast<int8_t>(static_cast<uint8_t>(p[2] - prev[2]));
        int dgr = static_cast<int8_t>(static_cast<uint8_t>(dr - dg));
        int dgb = static_cast<int8_t>(static_cast<uint8_t>(db - dg));
        if (-2 <= dr && dr < 2 && -2 <= dg && dg < 2 && -2 <= db && db < 2) {
          out[o++] = static_cast<uint8_t>(0x40 | (dr + 2) << 4 | (dg + 2) << 2 | (db + 2));
        } else if (-8 <= dgr && dgr < 8 && -32 <= dg && dg < 32 && -8 <= dgb && dgb < 8) {
          out[o++] = static_cast<uint8_t>(0x80 | (dg + 32));
          out[o++] = static_cast<uint8_t>((dgr + 8) << 4 | (dgb + 8));
        } else {
          out[o++] = 0xfe;
          memcpy(out + o, p, 3);
          o += 3;
        }
      } else {
        out[o++] = 0xff;
        memcpy(out + o, p, 4);
        o += 4;
      }
    }
    memcpy(prev, p, 4);
  }
  if (run) out[o++] = static_cast<uint8_t>(0xc0 | (run - 1));
  static const uint8_t kEnd[8] = {0, 0, 0, 0, 0, 0, 0, 1};
  memcpy(out + o, kEnd, 8);
  return o + 8;
}

// TGA RLE: h rows of rowbytes bytes, pixels of depth bytes, in the order
// they are stored.
int tga_rle_decode(const uint8_t* data, int64_t n, int64_t pos, int64_t rowbytes, int h,
                   int depth, uint8_t* rows) {
  int64_t x = 0;
  int y = 0;
  std::vector<uint8_t> buf(static_cast<size_t>(rowbytes));
  while (true) {
    if (pos >= n) return kTruncated;
    int64_t cnt = depth * ((data[pos] & 0x7f) + 1);
    int64_t extra = 0;
    if (data[pos] & 0x80) {
      if (n - pos < 1 + depth) return kTruncated;
      if (x + cnt > rowbytes) return kOverrun;
      for (int64_t i = 0; i < cnt; i += depth) memcpy(&buf[x + i], data + pos + 1, depth);
      pos += 1 + depth;
    } else {
      if (n - pos < 1 + cnt) return kTruncated;
      if (x + cnt > rowbytes) {
        extra = cnt - (rowbytes - x);
        cnt = rowbytes - x;
      }
      memcpy(&buf[x], data + pos + 1, cnt);
      pos += 1 + cnt;
    }
    while (true) {
      x += cnt;
      if (x >= rowbytes) {
        memcpy(rows + static_cast<int64_t>(y) * rowbytes, buf.data(), rowbytes);
        x = 0;
        if (++y >= h) return kOk;
      }
      if (extra == 0 || x > 0) break;
      cnt = extra >= rowbytes ? rowbytes : extra;
      memcpy(&buf[x], data + pos, cnt);
      pos += cnt;
      extra -= cnt;
    }
  }
}

// SGI RLE: out holds h rows of w * z * bpc bytes (bottom row first in
// the file, so row h - 1 of out first), zeros where the image stopped.
int sgi_rle_decode(const uint8_t* data, int64_t n, int w, int h, int z, int bpc, uint8_t* out) {
  int64_t bufsize = n - 512;
  int64_t tablen = static_cast<int64_t>(z) * h;
  if (bufsize < 8 * tablen) return kOverrun;
  const uint8_t* ptr = data + 512;
  auto be32 = [](const uint8_t* p) {
    return static_cast<uint32_t>(p[0]) << 24 | static_cast<uint32_t>(p[1]) << 16 |
           static_cast<uint32_t>(p[2]) << 8 | p[3];
  };
  int64_t rowbytes = static_cast<int64_t>(w) * z * bpc;
  std::vector<uint8_t> buf(static_cast<size_t>(w) * z * 2, 0);
  for (int row = 0; row < h; row++) {
    for (int ch = 0; ch < z; ch++) {
      int64_t t = row + static_cast<int64_t>(ch) * h;
      uint32_t off = be32(ptr + 4 * t), len = be32(ptr + 4 * (tablen + t));
      if (off < 512) return kOverrun;
      off -= 512;
      int n = static_cast<int>(len);  // Pillow passes the UINT32 length as an int
      int st = bpc == 1 ? expandrow(&buf[ch], ptr + off, n, z, w, ptr + bufsize - 1)
                        : expandrow2(&buf[ch * 2], ptr + off, n, z, w, ptr + bufsize - 1);
      if (st == -1) return kOverrun;
      if (st == 1) return kOk;
    }
    memcpy(out + static_cast<int64_t>(h - 1 - row) * rowbytes, buf.data(), rowbytes);
  }
  return kOk;
}

// PCX: h lines of `bytes` bytes (the planes' strides), the bands of a
// padded stride shifted as PcxDecode.c shifts them.
int pcx_decode(const uint8_t* data, int64_t n, int64_t pos, int64_t bytes, int64_t xsize, int h,
               uint8_t* rows) {
  std::vector<uint8_t> buf(static_cast<size_t>(bytes));
  int64_t x = 0;
  int y = 0;
  bool overrun = false;
  while (true) {
    if (pos >= n) return kTruncated;
    if ((data[pos] & 0xc0) == 0xc0) {
      if (n - pos < 2) return kTruncated;
      int cnt = data[pos] & 0x3f;
      while (cnt > 0) {
        if (x >= bytes) {
          overrun = true;
          break;
        }
        buf[x++] = data[pos + 1];
        cnt--;
      }
      pos += 2;
    } else {
      buf[x++] = data[pos++];
    }
    if (x >= bytes) {
      if (bytes % xsize && bytes > xsize) {
        int64_t bands = bytes / xsize, stride = bytes / bands;
        for (int64_t i = 1; i < bands; i++)
          memmove(&buf[i * xsize], &buf[i * stride], xsize);
      }
      memcpy(rows + static_cast<int64_t>(y) * bytes, buf.data(), bytes);
      x = 0;
      if (++y >= h) return overrun ? kOverrun : kOk;
    }
  }
}

// PackBits: h rows of `bytes` bytes from the packets at data[pos:n];
// kTruncated where the data ends first.
int packbits_decode(const uint8_t* data, int64_t n, int64_t pos, int64_t bytes, int64_t h,
                    uint8_t* rows) {
  if (bytes <= 0 || h <= 0) return kOk;
  int64_t x = 0, y = 0;
  uint8_t* row = rows;
  while (true) {
    if (pos >= n) return kTruncated;
    int b = data[pos];
    if (b & 0x80) {
      if (b == 0x80) {
        pos++;
        continue;
      }
      if (n - pos < 2) return kTruncated;
      for (int k = 257 - b; k > 0 && x < bytes; k--) row[x++] = data[pos + 1];
      pos += 2;
    } else {
      int64_t len = b + 1;
      if (n - pos < len + 1) return kTruncated;
      for (int64_t i = 1; i <= len && x < bytes; i++) row[x++] = data[pos + i];
      pos += len + 1;
    }
    if (x >= bytes) {
      x = 0;
      if (++y >= h) return kOk;
      row += bytes;
    }
  }
}

// Sun RLE: h rows of `bytes` bytes from data[pos:n]; kTruncated where the
// data ends first.
int sun_rle_decode(const uint8_t* data, int64_t n, int64_t pos, int64_t bytes, int64_t h,
                   uint8_t* rows) {
  if (bytes <= 0 || h <= 0) return kOk;
  std::vector<uint8_t> buf(bytes);
  int64_t x = 0, y = 0;
  uint8_t extra_data = 0, extra_bytes = 0;
  while (true) {
    if (pos >= n) return kTruncated;
    int64_t run = 1;
    if (data[pos] == 0x80) {
      if (n - pos < 2) return kTruncated;
      run = data[pos + 1];
      if (run == 0) {
        run = 1;
        buf[x] = 0x80;
        pos += 2;
      } else {
        if (n - pos < 3) return kTruncated;
        run += 1;
        if (x + run > bytes) {
          extra_bytes = static_cast<uint8_t>(run);
          run = bytes - x;
          extra_bytes = static_cast<uint8_t>(extra_bytes - run);
          extra_data = data[pos + 2];
        }
        std::memset(buf.data() + x, data[pos + 2], run);
        pos += 3;
      }
    } else {
      buf[x] = data[pos++];
    }
    while (true) {
      x += run;
      if (x >= bytes) {
        std::memcpy(rows + y * bytes, buf.data(), bytes);
        x = 0;
        if (++y >= h) return kOk;
      }
      if (extra_bytes == 0 || x > 0) break;
      run = extra_bytes >= bytes ? bytes : extra_bytes;
      std::memset(buf.data(), extra_data, run);
      extra_bytes = static_cast<uint8_t>(extra_bytes - run);
    }
  }
}

// MSP RLE: the stream of h rows (the row map of h 16-bit lengths at 32,
// the rows after it), its first cap bytes into out.  Returns the stream's
// length, or -2 (a short row map), -3 (a short row) or -4 (a run cut off)
// with the row in *row.
int64_t msp_rle_decode(const uint8_t* data, int64_t n, int64_t h, int64_t stride, int64_t cap,
                       uint8_t* out, int64_t* row) {
  if (32 + 2 * h > n) return -2;
  int64_t pos = 32 + 2 * h, len = 0;
  auto put = [&](const uint8_t* src, uint8_t value, int64_t count) {
    for (int64_t k = 0; k < count; k++, len++)
      if (len < cap) out[len] = src ? src[k] : value;
  };
  for (int64_t y = 0; y < h; y++) {
    *row = y;
    const int64_t rowlen = data[32 + 2 * y] | data[33 + 2 * y] << 8;
    if (rowlen == 0) {
      put(nullptr, 0xFF, stride);
      continue;
    }
    if (pos + rowlen > n) return -3;
    const uint8_t* r = data + pos;
    pos += rowlen;
    for (int64_t i = 0; i < rowlen;) {
      const int type = r[i++];
      if (type == 0) {
        if (rowlen - i < 2) return -4;
        put(nullptr, r[i + 1], r[i]);
        i += 2;
      } else {
        const int64_t count = std::min<int64_t>(type, rowlen - i);
        put(r + i, 0, count);
        i += type;
      }
    }
  }
  return len;
}

inline int hex_digit(uint8_t v) {
  if (v >= '0' && v <= '9') return v - '0';
  if (v >= 'a' && v <= 'f') return v - 'a' + 10;
  if (v >= 'A' && v <= 'F') return v - 'A' + 10;
  return 0;
}

// XBM: h rows of `bytes` bytes from the hex values at data[pos:n];
// kTruncated where the data ends first.
int xbm_decode(const uint8_t* data, int64_t n, int64_t pos, int64_t bytes, int64_t h,
               uint8_t* rows) {
  const int64_t total = bytes * h;
  for (int64_t k = 0; k < total; k++) {
    while (pos < n && data[pos] != 'x') pos++;
    if (n - pos < 3) return kTruncated;
    rows[k] = static_cast<uint8_t>(hex_digit(data[pos + 1]) << 4 | hex_digit(data[pos + 2]));
    pos += 3;
  }
  return kOk;
}

// PCX: h lines of planes * bpl bytes (each plane's bytes in turn) run-length
// coded plane line by plane line, each padded to an even stride.
int64_t pcx_encode(const uint8_t* lines, int h, int64_t bpl, int planes, uint8_t* out) {
  int64_t pad = bpl % 2, o = 0;
  for (int y = 0; y < h; y++) {
    const uint8_t* buf = lines + static_cast<int64_t>(y) * bpl * planes;
    int64_t x = 1;
    int count = 1;
    int last = buf[0];
    do {
      while (x % bpl) {
        if (count == 63) {
          out[o++] = static_cast<uint8_t>(0xc0 | count);
          out[o++] = static_cast<uint8_t>(last);
          count = 0;
        }
        int cur = buf[x];
        if (cur == last) {
          x++;
          count++;
        } else {
          if (count == 1 && last < 0xc0) {
            out[o++] = static_cast<uint8_t>(last);
          } else if (count > 0) {
            out[o++] = static_cast<uint8_t>(0xc0 | count);
            out[o++] = static_cast<uint8_t>(last);
          }
          last = cur;
          count = 1;
          x++;
        }
      }
      if (count == 1 && last < 0xc0) {
        out[o++] = static_cast<uint8_t>(last);
      } else if (count > 0) {
        out[o++] = static_cast<uint8_t>(0xc0 | count);
        out[o++] = static_cast<uint8_t>(last);
      }
      for (int64_t i = 0; i < pad; i++) out[o++] = 0;
      if (x < planes * bpl) {
        count = 1;
        last = buf[x];
        x++;
      }
    } while (x < planes * bpl);
  }
  return o;
}

// Image.resize(filter) of 8-bit samples [h, w, c] to [oh, ow, c].
void resample_8bpc(const uint8_t* in, int w, int h, int c, int ow, int oh, int filter,
                   uint8_t* out) {
  std::vector<int> bh, bv;
  std::vector<double> kh, kv;
  const Filter& f = kFilters[filter];
  int ksh = coeffs(w, ow, bh, kh, f), ksv = coeffs(h, oh, bv, kv, f);
  bool horiz = ow != w, vert = oh != h;
  int first = bv[0], last = bv[oh * 2 - 2] + bv[oh * 2 - 1];
  std::vector<uint8_t> tmp;
  const uint8_t* src = in;
  int sw = w, sh = h, y0 = 0;
  if (horiz) {
    std::vector<int> k = fixed(kh);
    sh = last - first;
    tmp.assign(static_cast<size_t>(sh) * ow * c, 0);
    for (int yy = 0; yy < sh; yy++) {
      const uint8_t* row = in + static_cast<int64_t>(yy + first) * w * c;
      for (int xx = 0; xx < ow; xx++) {
        int xmin = bh[xx * 2], xmax = bh[xx * 2 + 1];
        const int* kk = &k[static_cast<size_t>(xx) * ksh];
        for (int b = 0; b < c; b++) {
          int ss = 1 << (kPrecisionBits - 1);
          for (int x = 0; x < xmax; x++) ss += row[(x + xmin) * c + b] * kk[x];
          tmp[(static_cast<int64_t>(yy) * ow + xx) * c + b] = clip8(ss);
        }
      }
    }
    src = tmp.data();
    sw = ow;
    y0 = first;
  }
  if (!vert) {
    memcpy(out, src, static_cast<size_t>(oh) * sw * c);
    return;
  }
  std::vector<int> k = fixed(kv);
  for (int yy = 0; yy < oh; yy++) {
    int ymin = bv[yy * 2] - y0, ymax = bv[yy * 2 + 1];
    const int* kk = &k[static_cast<size_t>(yy) * ksv];
    for (int xx = 0; xx < sw; xx++) {
      for (int b = 0; b < c; b++) {
        int ss = 1 << (kPrecisionBits - 1);
        for (int y = 0; y < ymax; y++)
          ss += src[(static_cast<int64_t>(y + ymin) * sw + xx) * c + b] * kk[y];
        out[(static_cast<int64_t>(yy) * sw + xx) * c + b] = clip8(ss);
      }
    }
  }
  (void)sh;
}

// The same for 16-bit gray (Pillow's I;16), on double weights.
void resample_16bpc(const uint16_t* in, int w, int h, int ow, int oh, int filter,
                    uint16_t* out) {
  std::vector<int> bh, bv;
  std::vector<double> kh, kv;
  const Filter& f = kFilters[filter];
  int ksh = coeffs(w, ow, bh, kh, f), ksv = coeffs(h, oh, bv, kv, f);
  bool horiz = ow != w, vert = oh != h;
  int first = bv[0], last = bv[oh * 2 - 2] + bv[oh * 2 - 1];
  auto pack = [](double ss) {
    int v = round_up(ss);
    return static_cast<uint16_t>(clip8i(v % 256) | clip8i(v >> 8) << 8);
  };
  std::vector<uint16_t> tmp;
  const uint16_t* src = in;
  int sw = w, y0 = 0;
  if (horiz) {
    int sh = last - first;
    tmp.assign(static_cast<size_t>(sh) * ow, 0);
    for (int yy = 0; yy < sh; yy++) {
      const uint16_t* row = in + static_cast<int64_t>(yy + first) * w;
      for (int xx = 0; xx < ow; xx++) {
        int xmin = bh[xx * 2], xmax = bh[xx * 2 + 1];
        const double* kk = &kh[static_cast<size_t>(xx) * ksh];
        double ss = 0.0;
        for (int x = 0; x < xmax; x++) ss += row[x + xmin] * kk[x];
        tmp[static_cast<int64_t>(yy) * ow + xx] = pack(ss);
      }
    }
    src = tmp.data();
    sw = ow;
    y0 = first;
  }
  if (!vert) {
    memcpy(out, src, static_cast<size_t>(oh) * sw * 2);
    return;
  }
  for (int yy = 0; yy < oh; yy++) {
    int ymin = bv[yy * 2] - y0, ymax = bv[yy * 2 + 1];
    const double* kk = &kv[static_cast<size_t>(yy) * ksv];
    for (int xx = 0; xx < sw; xx++) {
      double ss = 0.0;
      for (int y = 0; y < ymax; y++) ss += src[static_cast<int64_t>(y + ymin) * sw + xx] * kk[y];
      out[static_cast<int64_t>(yy) * sw + xx] = pack(ss);
    }
  }
}

// FLI: one call of FliDecode.c on buf[0:bytes] (what ImageFile.load has
// read of the frame so far) into the P image im of h rows of w bytes.
// Returns the C decoder's status: 0 or a count of bytes consumed (it
// wants more data), or -1 (done), with its error code in *err (0, -2
// IMAGING_CODEC_OVERRUN, -3 IMAGING_CODEC_BROKEN, -4
// IMAGING_CODEC_UNKNOWN).
int64_t fli_decode(const uint8_t* buf, int64_t bytes, int w, int h, uint8_t* im, int* err) {
  auto i16 = [](const uint8_t* p) { return p[0] + (p[1] << 8); };
  auto i32 = [](const uint8_t* p) {
    return static_cast<int32_t>(static_cast<uint32_t>(p[0]) | static_cast<uint32_t>(p[1]) << 8 |
                                static_cast<uint32_t>(p[2]) << 16 |
                                static_cast<uint32_t>(p[3]) << 24);
  };
  *err = 0;
  if (bytes < 4) return 0;
  const uint8_t* ptr = buf;
  int64_t framesize = i32(ptr);
  if (bytes + (bytes % 2) < framesize) return 0;
  if (bytes < 8) {
    *err = -2;
    return -1;
  }
  if (i16(ptr + 4) != 0xF1FA) {
    *err = -4;
    return -1;
  }
  int chunks = i16(ptr + 6);
  ptr += 16;
  bytes -= 16;
#define FLI_OOB(offset)                 \
  if ((data + (offset)) > ptr + bytes) { \
    *err = -2;                          \
    return -1;                          \
  }
  for (int c = 0; c < chunks; c++) {
    if (bytes < 10) {
      *err = -2;
      return -1;
    }
    const uint8_t* data = ptr + 6;
    int x = 0, y, i = 0;
    switch (i16(ptr + 4)) {
      case 4:
      case 11:
      case 18:
        break;  // colour (read by the plugin) and stamp chunks
      case 7: {  // SS2, word delta
        int lines = i16(data), l;
        data += 2;
        for (l = y = 0; l < lines && y < h; l++, y++) {
          uint8_t* local = im + static_cast<int64_t>(y) * w;
          FLI_OOB(2)
          int packets = i16(data), p;
          data += 2;
          while (packets & 0x8000) {
            if (packets & 0x4000) {
              y += 65536 - packets;  // skip lines
              if (y >= h) {
                *err = -2;
                return -1;
              }
              local = im + static_cast<int64_t>(y) * w;
            } else {
              local[w - 1] = static_cast<uint8_t>(packets);  // the odd width's last byte
            }
            FLI_OOB(2)
            packets = i16(data);
            data += 2;
          }
          for (p = x = 0; p < packets; p++) {
            FLI_OOB(2)
            x += data[0];
            if (data[1] >= 128) {
              FLI_OOB(4)
              i = 256 - data[1];
              if (x + i + i > w) break;
              for (int j = 0; j < i; j++) {
                local[x++] = data[2];
                local[x++] = data[3];
              }
              data += 4;
            } else {
              i = 2 * static_cast<int>(data[1]);
              if (x + i > w) break;
              FLI_OOB(2 + i)
              memcpy(local + x, data + 2, i);
              data += 2 + i;
              x += i;
            }
          }
          if (p < packets) break;
        }
        if (l < lines) {
          *err = -2;
          return -1;
        }
        break;
      }
      case 12: {  // LC, byte delta
        y = i16(data);
        int ymax = y + i16(data + 2);
        data += 4;
        for (; y < ymax && y < h; y++) {
          uint8_t* out = im + static_cast<int64_t>(y) * w;
          FLI_OOB(1)
          int packets = *data++, p;
          for (p = x = 0; p < packets; p++, x += i) {
            FLI_OOB(2)
            x += data[0];
            if (data[1] & 0x80) {
              i = 256 - data[1];
              if (x + i > w) break;
              FLI_OOB(3)
              memset(out + x, data[2], i);
              data += 3;
            } else {
              i = data[1];
              if (x + i > w) break;
              FLI_OOB(2 + i)
              memcpy(out + x, data + 2, i);
              data += i + 2;
            }
          }
          if (p < packets) break;
        }
        if (y < ymax) {
          *err = -2;
          return -1;
        }
        break;
      }
      case 13:  // BLACK
        memset(im, 0, static_cast<size_t>(w) * h);
        break;
      case 15:  // BRUN
        for (y = 0; y < h; y++) {
          uint8_t* out = im + static_cast<int64_t>(y) * w;
          data += 1;  // the packet count, not read
          for (x = 0; x < w; x += i) {
            FLI_OOB(2)
            if (data[0] & 0x80) {
              i = 256 - data[0];
              if (x + i > w) break;
              FLI_OOB(i + 1)
              memcpy(out + x, data + 1, i);
              data += i + 1;
            } else {
              i = data[0];
              if (x + i > w) break;
              memset(out + x, data[1], i);
              data += 2;
            }
          }
          if (x != w) {
            *err = -2;
            return -1;
          }
        }
        break;
      case 16:  // COPY
        if (INT32_MAX / w < h) {
          *err = -2;
          return -1;
        }
        if (data + static_cast<int64_t>(w) * h > ptr + bytes) return ptr - buf;
        for (y = 0; y < h; y++, data += w) memcpy(im + static_cast<int64_t>(y) * w, data, w);
        break;
      default:
        *err = -4;
        return -1;
    }
    int64_t advance = i32(ptr);
    if (advance == 0) {
      *err = -3;
      return -1;
    }
    if (advance < 0 || advance > bytes) {
      *err = -2;
      return -1;
    }
    ptr += advance;
    bytes -= advance;
  }
#undef FLI_OOB
  return -1;
}

// BLP DXT: block_rows rows of blocks 8 (kind 1) or 16 (kinds 3 and 5)
// bytes long, decoded as BlpImagePlugin's decode_dxt1/3/5 into their
// stream: for each block row, its 4 pixel rows of 4 * blocks pixels, C =
// 4 bytes a pixel (3 for DXT1 without alpha).
void blp_dxt_decode(const uint8_t* data, int64_t blocks, int64_t block_rows, int kind, int alpha,
                    uint8_t* out) {
  const int C = kind == 1 && !alpha ? 3 : 4, size = kind == 1 ? 8 : 16;
  const int64_t row = 4 * blocks * C;
  for (int64_t yb = 0; yb < block_rows; yb++) {
    for (int64_t bx = 0; bx < blocks; bx++) {
      const uint8_t* s = data + (yb * blocks + bx) * size;
      const uint8_t* c = kind == 1 ? s : s + 8;
      int color0 = c[0] | c[1] << 8, color1 = c[2] | c[3] << 8;
      uint32_t code = c[4] | c[5] << 8 | c[6] << 16 | static_cast<uint32_t>(c[7]) << 24;
      int r0 = ((color0 >> 11) & 0x1F) << 3, g0 = ((color0 >> 5) & 0x3F) << 2,
          b0 = (color0 & 0x1F) << 3;
      int r1 = ((color1 >> 11) & 0x1F) << 3, g1 = ((color1 >> 5) & 0x3F) << 2,
          b1 = (color1 & 0x1F) << 3;
      bool four = kind != 1 || color0 > color1;
      uint32_t ac1 = s[4] | s[5] << 8 | s[6] << 16 | static_cast<uint32_t>(s[7]) << 24;
      uint32_t ac2 = s[2] | s[3] << 8;
      for (int j = 0; j < 4; j++) {
        uint8_t* px = out + (yb * 4 + j) * row + bx * 4 * C;
        for (int i = 0; i < 4; i++, px += C) {
          int k = 4 * j + i, ctl = (code >> (2 * k)) & 3, r, g, b, a = 255;
          if (ctl == 0) {
            r = r0, g = g0, b = b0;
          } else if (ctl == 1) {
            r = r1, g = g1, b = b1;
          } else if (ctl == 2) {
            if (four) {
              r = (2 * r0 + r1) / 3, g = (2 * g0 + g1) / 3, b = (2 * b0 + b1) / 3;
            } else {
              r = (r0 + r1) / 2, g = (g0 + g1) / 2, b = (b0 + b1) / 2;
            }
          } else if (four) {
            r = (2 * r1 + r0) / 3, g = (2 * g1 + g0) / 3, b = (2 * b1 + b0) / 3;
          } else {
            r = g = b = a = 0;
          }
          if (kind == 3) {
            int v = s[k / 2];
            a = (i & 1 ? v >> 4 : v & 0xF) * 17;
          } else if (kind == 5) {
            int a0 = s[0], a1 = s[1], idx = 3 * k, ac;
            if (idx <= 12) {
              ac = (ac2 >> idx) & 7;
            } else if (idx == 15) {
              ac = (ac2 >> 15) | ((ac1 << 1) & 6);
            } else {
              ac = (ac1 >> (idx - 16)) & 7;
            }
            if (ac == 0) {
              a = a0;
            } else if (ac == 1) {
              a = a1;
            } else if (a0 > a1) {
              a = ((8 - ac) * a0 + (ac - 1) * a1) / 7;
            } else if (ac == 6) {
              a = 0;
            } else if (ac == 7) {
              a = 255;
            } else {
              a = ((6 - ac) * a0 + (ac - 1) * a1) / 5;
            }
          }
          px[0] = static_cast<uint8_t>(r);
          px[1] = static_cast<uint8_t>(g);
          px[2] = static_cast<uint8_t>(b);
          if (C == 4) px[3] = static_cast<uint8_t>(a);
        }
      }
    }
  }
}

}  // extern "C"
