// GIF's LZW coding (GIF89a appendix F), written to read the pixels and
// write the bytes of Pillow's codec (libImaging GifDecode.c and
// GifEncode.c):
//
//   decode  minimum code sizes 0-12, codes widening to 12 bits, a clear
//           code at any point (a second clear right after the first does
//           nothing), a full table kept until the next clear (a
//           "deferred clear"), the four passes of interlaced rows, and
//           the data fed as Pillow's ImageFile.load feeds it: 65536
//           bytes at a time, a sub-block taken only when all of it is
//           there.  An end code stops the pass over the bytes
//           fed so far; the image then needs more bytes, as in Pillow, or
//           the file is truncated.  Pixels past the last row are dropped.
//   encode  8-bit codes: a clear code first, greedy matching, widths
//           growing as each new code needs, a clear code after the code
//           that fills the table (4096 codes), the end code, and
//           sub-blocks of 255 bytes laid out in buffers of
//           max(65536, 4 * width) bytes, as ImageFile._save hands them
//           to the encoder.
//
// The container (screen, palettes, extensions) is dspfun_tpu_torch/io/gif.py.
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

namespace {

enum {
  kOk = 0,
  kOverrun = -1,     // IMAGING_CODEC_OVERRUN
  kBroken = -2,      // IMAGING_CODEC_BROKEN: a code the table does not hold
  kConfig = -8,      // IMAGING_CODEC_CONFIG: a minimum code size past 12
  kTruncated = -20,  // the file ended before the image did
  kNoMemory = -21,
};

constexpr int kTable = 4096;

struct Decoder {
  // the frame: its rectangle in the screen image
  uint8_t* im;
  int stride, xoff, yoff, xsize, ysize;
  // GifDecode.c's state
  int state = 0, x = 0, y = 0, errcode = 0;
  int bits, interlace, step = 1;
  int clear = 0, end = 0, next = 0, codesize = 0, codemask = 0;
  int lastcode = 0, lastdata = 0, blocksize = 0, bitcount = 0;
  uint32_t bitbuffer = 0;
  int bufferindex = kTable;
  uint8_t buffer[kTable];
  uint8_t data[kTable];
  uint16_t link[kTable];
  uint8_t first = 0;

  uint8_t* row() { return im + (int64_t)(y + yoff) * stride + xoff; }

  // The next row of the frame; false when the image is complete.
  bool newline() {
    x = 0;
    y += step;
    while (y >= ysize) switch (interlace) {
        case 1:
          y = 4;
          interlace = 2;
          break;
        case 2:
          step = 4;
          y = 2;
          interlace = 3;
          break;
        case 3:
          step = 2;
          y = 1;
          interlace = 0;
          break;
        default:
          return false;
      }
    return true;
  }

  // ImagingGifDecode over buf[0:bytes): the bytes taken, or -1 when the
  // image is complete or an error (errcode) stopped it.
  int64_t decode(const uint8_t* buf, int64_t bytes) {
    const uint8_t* ptr = buf;
    if (!state) {
      if (bits < 0 || bits > 12) {
        errcode = kConfig;
        return -1;
      }
      clear = 1 << bits;
      end = clear + 1;
      if (interlace) {
        interlace = 1;
        step = 8;
      } else {
        step = 1;
      }
      state = 1;
    }
    for (;;) {
      if (state == 1) {
        next = clear + 2;
        codesize = bits + 1;
        codemask = (1 << codesize) - 1;
        bufferindex = kTable;
        state = 2;
      }
      const uint8_t* p;
      int n;
      if (bufferindex < kTable) {
        n = kTable - bufferindex;
        p = &buffer[bufferindex];
        bufferindex = kTable;
      } else {
        while (bitcount < codesize) {
          if (blocksize > 0) {
            int c = *ptr++;
            bytes--;
            blocksize--;
            bitbuffer |= (uint32_t)c << bitcount;
            bitcount += 8;
          } else {
            // a new sub-block, taken only whole
            if (bytes < 1) return ptr - buf;
            int c = *ptr;
            if (bytes < c + 1) return ptr - buf;
            blocksize = c;
            ptr++;
            bytes--;
          }
        }
        int c = (int)(bitbuffer & (uint32_t)codemask);
        bitbuffer >>= codesize;
        bitcount -= codesize;
        if (c == clear) {
          if (state != 2) state = 1;
          continue;
        }
        if (c == end) return ptr - buf;
        if (state == 2) {
          if (c > clear) {
            errcode = kBroken;
            return -1;
          }
          lastdata = lastcode = c;
          state = 3;
        } else {
          int thiscode = c;
          if (c > next) {
            errcode = kBroken;
            return -1;
          }
          if (c == next) {
            if (bufferindex <= 0) {
              errcode = kBroken;
              return -1;
            }
            buffer[--bufferindex] = (uint8_t)lastdata;
            c = lastcode;
          }
          while (c >= clear) {
            if (bufferindex <= 0 || c >= kTable) {
              errcode = kBroken;
              return -1;
            }
            buffer[--bufferindex] = data[c];
            c = link[c];
          }
          lastdata = c;
          if (next < kTable) {
            data[next] = (uint8_t)c;
            link[next] = (uint16_t)lastcode;
            if (next == codemask && codesize < 12) {
              codesize++;
              codemask = (1 << codesize) - 1;
            }
            next++;
          }
          lastcode = thiscode;
        }
        // this pass writes the string's first character; the next one
        // the rest, which the loop above stacked in buffer
        first = (uint8_t)lastdata;
        p = &first;
        n = 1;
      }
      if (y >= ysize) {
        errcode = kOverrun;
        return -1;
      }
      uint8_t* out = row() + x;
      for (int i = 0; i < n; i++) {
        *out++ = p[i];
        if (++x >= xsize) {
          if (!newline()) return -1;
          out = row();
        }
      }
    }
  }
};

}  // namespace

extern "C" {

// Decode one frame's LZW data into `im` (the screen, `stride` bytes a
// row, filled by the caller) at (xoff, yoff), xsize x ysize, feeding
// data[0:len) (the file from the byte after the minimum code size) as
// Pillow feeds it.  Returns 0, or one of the negative codes above.
int gif_decode(const uint8_t* data, int64_t len, int bits, int interlaced, uint8_t* im,
               int stride, int xoff, int yoff, int xsize, int ysize) {
  Decoder* d = new (std::nothrow) Decoder;
  if (!d) return kNoMemory;
  d->im = im;
  d->stride = stride;
  d->xoff = xoff;
  d->yoff = yoff;
  d->xsize = xsize;
  d->ysize = ysize;
  d->bits = bits;
  d->interlace = interlaced ? 1 : 0;
  int64_t taken = 0, fed = 0;
  int rc = kOk;
  for (;;) {
    if (fed >= len) {
      rc = kTruncated;
      break;
    }
    fed = fed + 65536 < len ? fed + 65536 : len;
    int64_t n = d->decode(data + taken, fed - taken);
    if (n < 0) {
      rc = d->errcode;
      break;
    }
    taken += n;
  }
  delete d;
  return rc;
}

// Encode `n` 8-bit indices (already in the order of the rows written)
// as GIF sub-blocks with minimum code size 8, without the terminating
// empty sub-block; `bufsize` is the encoder's buffer.  *out is malloc'd
// (free it with gif_free).
int gif_encode(const uint8_t* px, int64_t n, int64_t bufsize, uint8_t** out, int64_t* out_len) {
  const int bits = 8, clear = 1 << bits, end = clear + 1;
  std::vector<uint8_t> codes;  // the packed code stream
  uint32_t acc = 0;
  int nacc = 0;
  auto put = [&](int code, int width) {
    acc |= (uint32_t)code << nacc;
    nacc += width;
    while (nacc >= 8) {
      codes.push_back((uint8_t)acc);
      acc >>= 8;
      nacc -= 8;
    }
  };
  try {
    // (prefix code << 8 | byte) -> code, as an open-addressed table
    std::vector<int32_t> keys(1 << 14), vals(1 << 14);
    int next = end + 1, max_code = 2 * clear - 1, width = bits + 1;
    auto reset = [&]() {
      std::fill(keys.begin(), keys.end(), -1);
      next = end + 1;
      max_code = 2 * clear - 1;
      width = bits + 1;
    };
    reset();
    put(clear, width);
    if (n > 0) {
      int head = px[0];
      for (int64_t i = 1; i < n; i++) {
        int tail = px[i];
        int32_t key = head << 8 | tail;
        uint32_t h = ((uint32_t)key * 2654435761u) >> 18;
        bool found = false;
        while (keys[h] >= 0) {
          if (keys[h] == key) {
            head = vals[h];
            found = true;
            break;
          }
          h = (h + 1) & ((1 << 14) - 1);
        }
        if (found) continue;
        put(head, width);
        if (next < kTable) {
          keys[h] = key;
          vals[h] = next;
          if (next > max_code) {
            max_code = max_code * 2 + 1;
            width++;
          }
          next++;
        } else {
          put(clear, width);
          reset();
        }
        head = tail;
      }
      put(head, width);
    }
    put(end, width);
    if (nacc) codes.push_back((uint8_t)acc);
    // sub-blocks of up to 255 bytes, none across a buffer's end
    std::vector<uint8_t> blocks;
    blocks.reserve(codes.size() + codes.size() / 255 + 16);
    size_t pos = 0;
    while (pos < codes.size()) {
      int64_t room = bufsize;
      while (room >= 2 && pos < codes.size()) {
        size_t k = (size_t)(room < 256 ? room - 1 : 255);
        if (k > codes.size() - pos) k = codes.size() - pos;
        blocks.push_back((uint8_t)k);
        blocks.insert(blocks.end(), codes.begin() + pos, codes.begin() + pos + k);
        pos += k;
        room -= (int64_t)k + 1;
      }
    }
    uint8_t* buf = static_cast<uint8_t*>(std::malloc(blocks.size() ? blocks.size() : 1));
    if (!buf) return kNoMemory;
    std::memcpy(buf, blocks.data(), blocks.size());
    *out = buf;
    *out_len = (int64_t)blocks.size();
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
  return kOk;
}

void gif_free(uint8_t* p) { std::free(p); }

}  // extern "C"
