// WebP's two bitstreams and its alpha chunk, written to decode the pixels
// libwebp 1.6.0 decodes (the library Pillow 12 links), which
// dspfun_tpu_torch/io/webp.py walks the RIFF container for:
//
//   VP8L   the lossless bitstream (RFC 9649): prefix codes (the simple
//          one- and two-symbol form and the code-length code), the colour
//          cache, LZ77 backward references with the 120-entry distance map,
//          the meta prefix image, and the four transforms inverted in
//          reverse order (predictor modes 0-13, cross-colour,
//          subtract-green, colour indexing with pixel bundling).  A stream
//          that reads past its last byte is an error, as in
//          vp8l_dec.c (its 64-bit window: a stream of fewer than 8 bytes
//          reads up to 64 bits; an alpha stream of one colour-indexing
//          transform ends without error on its last pixels, as
//          DecodeAlphaData lets it).
//   ALPH   the alpha chunk: raw or VP8L-coded (alpha in green), then the
//          horizontal, vertical or gradient unfilter of filters.c, with
//          its first-row and first-column rules; the pre-processing bits
//          only choose dithering, which WebPAnimDecoder leaves off.
//   VP8    the lossy key frame (RFC 6386 as vp8_dec.c, tree_dec.c,
//          quant_dec.c, frame_dec.c and dsp/dec.c decode it): libwebp's
//          boolean decoder (its VP8GetSigned keeps a range of 256, which
//          the RFC's decoder never has), segments, the loop-filter header
//          and deltas, intra modes with the edge samples of
//          ReconstructRow (127 above the frame, 129 left of it), the
//          coefficient tokens, the inverse WHT and DCT (a full block in the
//          16-bit lanes of libwebp's Transform_SSE2, which Pillow runs and
//          which parts from the C transform only where a damaged stream's
//          coefficients overflow them), and the normal loop filter in
//          macroblock order.  The simple filter and several
//          token partitions, which no encoder setting of Pillow writes,
//          are decoded here but refused by io/webp.py:not_carried
//          (webp_vp8_features).
//   YUV    4:2:0 to RGBA as WebPDecode emits it by default: the fancy
//          upsampler of upsampling.c and the 14-bit fixed point of yuv.h.
//
// The constant tables are the standard's (RFC 6386 and RFC 9649) in
// libwebp's order (its intra 4x4 modes are B_DC, B_TM, B_VE, B_HE, B_RD,
// B_VR, B_LD, B_VL, B_HD, B_HU).
#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

namespace {

enum {
  kOk = 0,
  kBitstream = -1,   // VP8_STATUS_BITSTREAM_ERROR
  kNotEnough = -2,   // VP8_STATUS_NOT_ENOUGH_DATA
  kNoMemory = -3,
  kUnsupported = -4, // VP8_STATUS_UNSUPPORTED_FEATURE
};

static const uint8_t kCoeffsProba0[1056] = {
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
  189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
  106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
  1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
  181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
  78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
  1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
  184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
  77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
  1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
  170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
  37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
  1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
  207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
  102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
  1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
  177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
  80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
  1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
  131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
  68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
  1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
  184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
  81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
  1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
  99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
  23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
  1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
  109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
  44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
  1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
  94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
  22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
  1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
  124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
  35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
  1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
  121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
  45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
  1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
  203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
  253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
  175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
  73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
  1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
  239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
  155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
  1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
  201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
  69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
  1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
  223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
  141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
  149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
  213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
  55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
  126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
  61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
  1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
  166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
  39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
  1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
  124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
  24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
  1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
  149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
  28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
  1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
  123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
  20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
  1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
  168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
  47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
  1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
  141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
  42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
  1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
static const uint8_t kCoeffsUpdateProba[1056] = {
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
  250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
  234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
  255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
  234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
  251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
  255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
  248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
  255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
  255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
static const uint8_t kBModesProba[900] = {
  231, 120, 48, 89, 115, 113, 120, 152, 112,
  152, 179, 64, 126, 170, 118, 46, 70, 95,
  175, 69, 143, 80, 85, 82, 72, 155, 103,
  56, 58, 10, 171, 218, 189, 17, 13, 152,
  114, 26, 17, 163, 44, 195, 21, 10, 173,
  121, 24, 80, 195, 26, 62, 44, 64, 85,
  144, 71, 10, 38, 171, 213, 144, 34, 26,
  170, 46, 55, 19, 136, 160, 33, 206, 71,
  63, 20, 8, 114, 114, 208, 12, 9, 226,
  81, 40, 11, 96, 182, 84, 29, 16, 36,
  134, 183, 89, 137, 98, 101, 106, 165, 148,
  72, 187, 100, 130, 157, 111, 32, 75, 80,
  66, 102, 167, 99, 74, 62, 40, 234, 128,
  41, 53, 9, 178, 241, 141, 26, 8, 107,
  74, 43, 26, 146, 73, 166, 49, 23, 157,
  65, 38, 105, 160, 51, 52, 31, 115, 128,
  104, 79, 12, 27, 217, 255, 87, 17, 7,
  87, 68, 71, 44, 114, 51, 15, 186, 23,
  47, 41, 14, 110, 182, 183, 21, 17, 194,
  66, 45, 25, 102, 197, 189, 23, 18, 22,
  88, 88, 147, 150, 42, 46, 45, 196, 205,
  43, 97, 183, 117, 85, 38, 35, 179, 61,
  39, 53, 200, 87, 26, 21, 43, 232, 171,
  56, 34, 51, 104, 114, 102, 29, 93, 77,
  39, 28, 85, 171, 58, 165, 90, 98, 64,
  34, 22, 116, 206, 23, 34, 43, 166, 73,
  107, 54, 32, 26, 51, 1, 81, 43, 31,
  68, 25, 106, 22, 64, 171, 36, 225, 114,
  34, 19, 21, 102, 132, 188, 16, 76, 124,
  62, 18, 78, 95, 85, 57, 50, 48, 51,
  193, 101, 35, 159, 215, 111, 89, 46, 111,
  60, 148, 31, 172, 219, 228, 21, 18, 111,
  112, 113, 77, 85, 179, 255, 38, 120, 114,
  40, 42, 1, 196, 245, 209, 10, 25, 109,
  88, 43, 29, 140, 166, 213, 37, 43, 154,
  61, 63, 30, 155, 67, 45, 68, 1, 209,
  100, 80, 8, 43, 154, 1, 51, 26, 71,
  142, 78, 78, 16, 255, 128, 34, 197, 171,
  41, 40, 5, 102, 211, 183, 4, 1, 221,
  51, 50, 17, 168, 209, 192, 23, 25, 82,
  138, 31, 36, 171, 27, 166, 38, 44, 229,
  67, 87, 58, 169, 82, 115, 26, 59, 179,
  63, 59, 90, 180, 59, 166, 93, 73, 154,
  40, 40, 21, 116, 143, 209, 34, 39, 175,
  47, 15, 16, 183, 34, 223, 49, 45, 183,
  46, 17, 33, 183, 6, 98, 15, 32, 183,
  57, 46, 22, 24, 128, 1, 54, 17, 37,
  65, 32, 73, 115, 28, 128, 23, 128, 205,
  40, 3, 9, 115, 51, 192, 18, 6, 223,
  87, 37, 9, 115, 59, 77, 64, 21, 47,
  104, 55, 44, 218, 9, 54, 53, 130, 226,
  64, 90, 70, 205, 40, 41, 23, 26, 57,
  54, 57, 112, 184, 5, 41, 38, 166, 213,
  30, 34, 26, 133, 152, 116, 10, 32, 134,
  39, 19, 53, 221, 26, 114, 32, 73, 255,
  31, 9, 65, 234, 2, 15, 1, 118, 73,
  75, 32, 12, 51, 192, 255, 160, 43, 51,
  88, 31, 35, 67, 102, 85, 55, 186, 85,
  56, 21, 23, 111, 59, 205, 45, 37, 192,
  55, 38, 70, 124, 73, 102, 1, 34, 98,
  125, 98, 42, 88, 104, 85, 117, 175, 82,
  95, 84, 53, 89, 128, 100, 113, 101, 45,
  75, 79, 123, 47, 51, 128, 81, 171, 1,
  57, 17, 5, 71, 102, 57, 53, 41, 49,
  38, 33, 13, 121, 57, 73, 26, 1, 85,
  41, 10, 67, 138, 77, 110, 90, 47, 114,
  115, 21, 2, 10, 102, 255, 166, 23, 6,
  101, 29, 16, 10, 85, 128, 101, 196, 26,
  57, 18, 10, 102, 102, 213, 34, 20, 43,
  117, 20, 15, 36, 163, 128, 68, 1, 26,
  102, 61, 71, 37, 34, 53, 31, 243, 192,
  69, 60, 71, 38, 73, 119, 28, 222, 37,
  68, 45, 128, 34, 1, 47, 11, 245, 171,
  62, 17, 19, 70, 146, 85, 55, 62, 70,
  37, 43, 37, 154, 100, 163, 85, 160, 1,
  63, 9, 92, 136, 28, 64, 32, 201, 85,
  75, 15, 9, 9, 64, 255, 184, 119, 16,
  86, 6, 28, 5, 64, 255, 25, 248, 1,
  56, 8, 17, 132, 137, 255, 55, 116, 128,
  58, 15, 20, 82, 135, 57, 26, 121, 40,
  164, 50, 31, 137, 154, 133, 25, 35, 218,
  51, 103, 44, 131, 131, 123, 31, 6, 158,
  86, 40, 64, 135, 148, 224, 45, 183, 128,
  22, 26, 17, 131, 240, 154, 14, 1, 209,
  45, 16, 21, 91, 64, 222, 7, 1, 197,
  56, 21, 39, 155, 60, 138, 23, 102, 213,
  83, 12, 13, 54, 192, 255, 68, 47, 28,
  85, 26, 85, 85, 128, 128, 32, 146, 171,
  18, 11, 7, 63, 144, 171, 4, 4, 246,
  35, 27, 10, 146, 174, 171, 12, 26, 128,
  190, 80, 35, 99, 180, 80, 126, 54, 45,
  85, 126, 47, 87, 176, 51, 41, 20, 32,
  101, 75, 128, 139, 118, 146, 116, 128, 85,
  56, 41, 15, 176, 236, 85, 37, 9, 62,
  71, 30, 17, 119, 118, 255, 17, 18, 138,
  101, 38, 60, 138, 55, 70, 43, 26, 142,
  146, 36, 19, 30, 171, 255, 97, 27, 20,
  138, 45, 61, 62, 219, 1, 81, 188, 64,
  32, 41, 20, 117, 151, 142, 20, 21, 163,
  112, 19, 12, 61, 195, 128, 48, 4, 24,
};
static const uint8_t kCodeToPlane[120] = {
  24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
  56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
  71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
  75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
  68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
  102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
  120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
  118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
  0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
  81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};
static const uint8_t kDcTable[128] = {
  4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
  18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
  29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
  44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
  59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
  75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
  91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
  122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
static const uint16_t kAcTable[128] = {
  4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
  20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
  36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
  52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
  78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
  110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
  155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
  213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

// ---------------------------------------------------------------- VP8L

// VP8L's bit reader, as bit_reader_utils.h keeps it: least significant
// bit first through a 64-bit window of the last 8 bytes loaded.  A valid
// stream reads as any LSB-first reader would; past its end the window
// matters (libwebp reads bit_pos_ modulo 64, and clears it when it flags
// the end), which the 8-bit alpha path below tolerates on its last pixels.
struct LBits {
  const uint8_t* buf;
  size_t len, pos = 0;
  uint64_t val = 0;
  int bit_pos = 0, eos = 0;
  LBits(const uint8_t* b, size_t n) : buf(b), len(n) {
    const size_t k = std::min<size_t>(n, 8);
    for (size_t i = 0; i < k; ++i) val |= (uint64_t)buf[i] << (8 * i);
    pos = k;
  }
  uint32_t prefetch() const { return (uint32_t)(val >> (bit_pos & 63)); }
  bool at_end() const { return eos || (pos == len && bit_pos > 64); }  // VP8LIsEndOfStream
  void set_end() {
    eos = 1;
    bit_pos = 0;
  }
  void shift_bytes() {
    while (bit_pos >= 8 && pos < len) {
      val >>= 8;
      val |= (uint64_t)buf[pos] << 56;
      ++pos;
      bit_pos -= 8;
    }
    if (at_end()) set_end();
  }
  uint32_t read(int n) {  // VP8LReadBits, n <= 24
    if (!eos && n <= 24) {
      const uint32_t v = prefetch() & ((1u << n) - 1);
      bit_pos += n;
      shift_bytes();
      return v;
    }
    set_end();
    return 0;
  }
  void fill() {  // VP8LFillBitWindow
    if (bit_pos < 32) return;
    if (pos + 8 < len) {
      val >>= 32;
      bit_pos -= 32;
      uint32_t w;
      memcpy(&w, buf + pos, 4);
      val |= (uint64_t)w << 32;
      pos += 4;
      return;
    }
    shift_bytes();
  }
};

// A canonical prefix code: an 8-bit table of (length << 16 | symbol), with
// 0xff as the length of codes longer than 8 bits, which are read bit by bit.
struct Huff {
  uint32_t root[256];
  uint16_t count[16];
  std::vector<uint16_t> sorted;
};

constexpr uint32_t kSlow = 0xffu << 16;

// VP8LBuildHuffmanTable's rules: no symbol is an error, one symbol is a
// code of no bits, more must fill the code space exactly.
bool build_huff(Huff& h, const int* lens, int n) {
  memset(h.count, 0, sizeof(h.count));
  for (int s = 0; s < n; ++s) {
    if (lens[s] > 15) return false;
    ++h.count[lens[s]];
  }
  const int nsym = n - h.count[0];
  if (nsym == 0) return false;
  h.sorted.assign(nsym, 0);
  int offset[16];
  offset[1] = 0;
  for (int l = 1; l < 15; ++l) offset[l + 1] = offset[l] + h.count[l];
  for (int s = 0; s < n; ++s) {
    if (lens[s]) h.sorted[offset[lens[s]]++] = (uint16_t)s;
  }
  if (nsym == 1) {
    for (auto& e : h.root) e = h.sorted[0];
    return true;
  }
  int left = 1;
  for (int l = 1; l <= 15; ++l) {
    left = (left << 1) - h.count[l];
    if (left < 0) return false;
  }
  if (left != 0) return false;
  int code = 0, k = 0;
  for (int l = 1; l <= 15; ++l) {
    for (int i = 0; i < h.count[l]; ++i, ++k, ++code) {
      const int sym = h.sorted[k];
      if (l <= 8) {
        int rev = 0;
        for (int b = 0; b < l; ++b) rev |= ((code >> b) & 1) << (l - 1 - b);
        for (int e = rev; e < 256; e += 1 << l) h.root[e] = ((uint32_t)l << 16) | sym;
      } else {
        const int prefix = code >> (l - 8);
        int rev = 0;
        for (int b = 0; b < 8; ++b) rev |= ((prefix >> b) & 1) << (7 - b);
        h.root[rev] = kSlow;
      }
    }
    code <<= 1;
  }
  return true;
}

// ReadSymbol: the root table's 8 bits, and for a longer code the rest
// from a second prefetch 8 bits on (libwebp's second-level table).
inline int read_sym(const Huff& h, LBits& br) {
  const uint32_t v = br.prefetch();
  const uint32_t e = h.root[v & 0xff];
  if (e != kSlow) {
    br.bit_pos += e >> 16;
    return (int)(e & 0xffff);
  }
  br.bit_pos += 8;
  const uint32_t v2 = br.prefetch();
  int code = 0, first = 0, index = 0;
  for (int l = 1; l <= 15; ++l) {
    code |= (int)((l <= 8 ? v >> (l - 1) : v2 >> (l - 9)) & 1);
    const int c = h.count[l];
    if (code - first < c) {
      br.bit_pos += l - 8;
      return h.sorted[index + code - first];
    }
    index += c;
    first = (first + c) << 1;
    code <<= 1;
  }
  return 0;  // not reached: the code is complete
}

constexpr int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                      7,  8,  9, 10, 11, 12, 13, 14, 15};
constexpr int kAlphabet[5] = {256 + 24, 256, 256, 256, 40};

bool read_code_lengths(LBits& br, const int* cl_lens, int nsym, int* lens) {
  Huff t;
  if (!build_huff(t, cl_lens, 19)) return false;
  int max_symbol = nsym;
  if (br.read(1)) {
    const int nbits = 2 + 2 * (int)br.read(3);
    max_symbol = 2 + (int)br.read(nbits);
    if (max_symbol > nsym) return false;
  }
  int symbol = 0, prev = 8;
  while (symbol < nsym) {
    if (max_symbol-- == 0) break;
    br.fill();
    const int len = read_sym(t, br);
    if (len < 16) {
      lens[symbol++] = len;
      if (len) prev = len;
    } else {
      static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
      int repeat = (int)br.read(kExtra[len - 16]) + kOffset[len - 16];
      if (symbol + repeat > nsym) return false;
      const int v = len == 16 ? prev : 0;
      while (repeat-- > 0) lens[symbol++] = v;
    }
  }
  return true;
}

// ReadHuffmanCode: h may be null for a group the meta image never names;
// single says whether the code has one symbol (no bits).
bool read_huff(LBits& br, int alphabet, std::vector<int>& lens, Huff* h, bool* single) {
  lens.assign(alphabet, 0);
  if (br.read(1)) {  // simple code
    const int nsym = (int)br.read(1) + 1;
    const int first_bits = br.read(1) ? 8 : 1;
    int s = (int)br.read(first_bits);
    if (s < alphabet) lens[s] = 1;
    if (nsym == 2) {
      s = (int)br.read(8);
      if (s < alphabet) lens[s] = 1;
    }
  } else {
    int cl_lens[19] = {0};
    const int ncodes = (int)br.read(4) + 4;
    for (int i = 0; i < ncodes; ++i) cl_lens[kCodeLengthOrder[i]] = (int)br.read(3);
    if (!read_code_lengths(br, cl_lens, alphabet, lens.data())) return false;
  }
  if (br.eos) return false;
  Huff scratch;
  Huff& out = h ? *h : scratch;
  if (!build_huff(out, lens.data(), alphabet)) return false;
  *single = out.count[0] == alphabet - 1;
  return true;
}

struct Group {
  Huff h[5];  // green (+ lengths + cache), red, blue, alpha, distance
};

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

inline uint32_t add_px(uint32_t a, uint32_t b) {
  return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
         (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
}

inline int copy_value(int sym, LBits& br) {
  if (sym < 4) return sym + 1;
  const int extra = (sym - 2) >> 1;
  const int offset = (2 + (sym & 1)) << extra;
  return offset + (int)br.read(extra) + 1;
}

inline int plane_distance(int xsize, int code) {
  if (code > 120) return code - 120;
  const int dc = kCodeToPlane[code - 1];
  const int dist = (dc >> 4) * xsize + 8 - (dc & 0xf);
  return dist >= 1 ? dist : 1;
}

struct Transform {
  int type, bits, xsize, ysize;
  std::vector<uint32_t> data;
};

struct LDecoder {
  LBits br;
  bool alpha;  // an ALPH chunk's stream: the 8-bit path of DecodeAlphaData may apply
  std::vector<Transform> transforms;
  unsigned seen = 0;
  LDecoder(LBits b, bool alpha_stream) : br(b), alpha(alpha_stream) {}
  bool image_stream(int xsize, int ysize, bool level0, std::vector<uint32_t>& out, int* out_xsize);
  bool read_transform(int* xsize, int ysize);
};

bool LDecoder::read_transform(int* xsize, int ysize) {
  const int type = (int)br.read(2);
  if (seen & (1u << type)) return false;
  seen |= 1u << type;
  Transform t;
  t.type = type;
  t.xsize = *xsize;
  t.ysize = ysize;
  t.bits = 0;
  bool ok = true;
  if (type == 0 || type == 1) {  // predictor, cross-colour
    t.bits = (int)br.read(3) + 2;
    ok = image_stream(subsample(t.xsize, t.bits), subsample(ysize, t.bits), false, t.data,
                      nullptr);
  } else if (type == 3) {  // colour indexing
    const int ncolors = (int)br.read(8) + 1;
    t.bits = ncolors > 16 ? 0 : ncolors > 4 ? 1 : ncolors > 2 ? 2 : 3;
    *xsize = subsample(t.xsize, t.bits);
    std::vector<uint32_t> pal;
    ok = image_stream(ncolors, 1, false, pal, nullptr);
    if (ok) {  // ExpandColorMap: deltas per byte, black transparent after
      t.data.assign((size_t)1 << (8 >> t.bits), 0);
      t.data[0] = pal[0];
      for (int i = 1; i < ncolors; ++i) t.data[i] = add_px(pal[i], t.data[i - 1]);
    }
  }
  transforms.push_back(std::move(t));
  return ok;
}

bool LDecoder::image_stream(int xsize, int ysize, bool level0, std::vector<uint32_t>& out,
                            int* out_xsize) {
  int txs = xsize;
  if (level0) {
    while (br.read(1)) {
      if (!read_transform(&txs, ysize)) return false;
    }
  }
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = (int)br.read(4);
    if (cache_bits < 1 || cache_bits > 11) return false;
  }
  // the prefix codes, by meta image
  std::vector<uint32_t> meta;
  int meta_bits = 0, meta_xsize = 0, ngroups = 1;
  if (level0 && br.read(1)) {
    meta_bits = (int)br.read(3) + 2;
    meta_xsize = subsample(txs, meta_bits);
    if (!image_stream(meta_xsize, subsample(ysize, meta_bits), false, meta, nullptr)) return false;
    for (auto& m : meta) {
      m = (m >> 8) & 0xffff;
      ngroups = std::max(ngroups, (int)m + 1);
    }
  }
  if (br.eos) return false;
  // libwebp keeps every group up to the largest index, or only those the
  // meta image names past 1000 groups or one a pixel
  const bool mapped = ngroups > 1000 || (int64_t)ngroups > (int64_t)txs * ysize;
  std::vector<char> used(ngroups, meta.empty() ? 1 : 0);
  for (auto m : meta) used[m] = 1;
  std::vector<int> index(ngroups, -1);
  int nused = 0;
  for (int i = 0; i < ngroups; ++i) {
    if (used[i]) index[i] = nused++;
  }
  std::vector<Group> groups;
  try {
    groups.resize(nused);
  } catch (const std::bad_alloc&) {
    return false;
  }
  std::vector<int> lens;
  bool rba_single = true;  // Is8bOptimizable: red, blue and alpha of no bits
  for (int i = 0; i < ngroups; ++i) {
    for (int j = 0; j < 5; ++j) {
      const int alphabet = kAlphabet[j] + (j == 0 && cache_bits ? 1 << cache_bits : 0);
      bool single;
      if (!read_huff(br, alphabet, lens, index[i] >= 0 ? &groups[index[i]].h[j] : nullptr,
                     &single))
        return false;
      if (j >= 1 && j <= 3 && !single && (index[i] >= 0 || !mapped)) rba_single = false;
    }
  }
  for (auto& m : meta) m = index[m];
  const int64_t total = (int64_t)txs * ysize;
  out.assign(total, 0);
  uint32_t* data = out.data();
  const int mask = meta_bits ? (1 << meta_bits) - 1 : ~0;
  auto group_at = [&](int x, int y) -> const Group* {
    return meta_bits ? &groups[meta[(size_t)(y >> meta_bits) * meta_xsize + (x >> meta_bits)]]
                     : &groups[0];
  };
  int64_t pos = 0;
  int x = 0, y = 0;
  const Group* g = &groups[0];
  if (level0 && alpha && cache_bits == 0 && rba_single && transforms.size() == 1 &&
      transforms[0].type == 3) {
    // DecodeAlphaData: green only; an end of stream on the last pixels is
    // no error
    bool ok = true;
    while (!br.eos && pos < total) {
      if ((x & mask) == 0) g = group_at(x, y);
      br.fill();
      const int code = read_sym(g->h[0], br);
      if (code < 256) {
        data[pos++] = (uint32_t)code << 8;
        if (++x >= txs) {
          x = 0;
          ++y;
        }
      } else if (code < 280) {
        const int length = copy_value(code - 256, br);
        const int dsym = read_sym(g->h[4], br);
        br.fill();
        const int dist = plane_distance(txs, copy_value(dsym, br));
        if (!(pos >= dist && total - pos >= length)) {
          ok = false;
          break;
        }
        for (int i = 0; i < length; ++i, ++pos) data[pos] = data[pos - dist];
        x += length;
        while (x >= txs) {
          x -= txs;
          ++y;
        }
        if (pos < total && (x & mask)) g = group_at(x, y);
      } else {
        ok = false;
        break;
      }
      br.eos = br.at_end();
    }
    br.eos = br.at_end();
    if (!ok || (br.eos && pos < total)) return false;
    if (out_xsize) *out_xsize = txs;
    return true;
  }
  // DecodeImageData: an end of stream anywhere is an error
  std::vector<uint32_t> cache(cache_bits ? (size_t)1 << cache_bits : 0, 0);
  const int shift = 32 - cache_bits;
  while (pos < total) {
    if ((x & mask) == 0) g = group_at(x, y);
    br.fill();
    const int code = read_sym(g->h[0], br);
    if (br.at_end()) return false;
    if (code < 256 || code >= 280) {
      uint32_t px;
      if (code < 256) {
        const int r = read_sym(g->h[1], br);
        br.fill();
        const int b = read_sym(g->h[2], br), a = read_sym(g->h[3], br);
        if (br.at_end()) return false;
        px = ((uint32_t)a << 24) | (r << 16) | (code << 8) | b;
      } else {
        px = cache[code - 280];
      }
      data[pos++] = px;
      if (cache_bits) cache[(0x1e35a7bdu * px) >> shift] = px;
      if (++x == txs) {
        x = 0;
        ++y;
      }
    } else {
      const int length = copy_value(code - 256, br);
      const int dsym = read_sym(g->h[4], br);
      br.fill();
      const int dist = plane_distance(txs, copy_value(dsym, br));
      if (br.at_end()) return false;
      if (pos < dist || total - pos < length) return false;
      for (int i = 0; i < length; ++i, ++pos) {
        const uint32_t px = data[pos - dist];
        data[pos] = px;
        if (cache_bits) cache[(0x1e35a7bdu * px) >> shift] = px;
      }
      x += length;
      while (x >= txs) {
        x -= txs;
        ++y;
      }
      if (pos < total && (x & mask)) g = group_at(x, y);
    }
  }
  br.eos = br.at_end();
  if (out_xsize) *out_xsize = txs;
  return !br.eos;
}

inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }

inline uint32_t select_px(uint32_t t, uint32_t l, uint32_t tl) {
  int d = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (t >> s) & 0xff, b = (l >> s) & 0xff, c = (tl >> s) & 0xff;
    d += std::abs(b - c) - std::abs(a - c);
  }
  return d <= 0 ? t : l;
}

inline uint32_t add_sub_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (c0 >> s) & 0xff, b = (c1 >> s) & 0xff, c = (c2 >> s) & 0xff;
    out |= clip255((uint32_t)(a + b - c)) << s;
  }
  return out;
}

inline uint32_t add_sub_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (ave >> s) & 0xff, b = (c2 >> s) & 0xff;
    out |= clip255((uint32_t)(a + (a - b) / 2)) << s;
  }
  return out;
}

// The predictor of mode m for the pixel whose left is l and whose upper
// row is up (up[-1], up[0], up[1]).
inline uint32_t predict(int m, uint32_t l, const uint32_t* up) {
  switch (m) {
    case 1: return l;
    case 2: return up[0];
    case 3: return up[1];
    case 4: return up[-1];
    case 5: return average2(average2(l, up[1]), up[0]);
    case 6: return average2(l, up[-1]);
    case 7: return average2(l, up[0]);
    case 8: return average2(up[-1], up[0]);
    case 9: return average2(up[0], up[1]);
    case 10: return average2(average2(l, up[-1]), average2(up[0], up[1]));
    case 11: return select_px(up[0], l, up[-1]);
    case 12: return add_sub_full(l, up[0], up[-1]);
    case 13: return add_sub_half(l, up[0], up[-1]);
    default: return 0xff000000u;  // 0, and 14-15 as libwebp pads them
  }
}

inline int color_delta(int8_t pred, int8_t color) { return ((int)pred * color) >> 5; }

// The inverse transforms, last read first, on the whole image.
bool inverse_transforms(const std::vector<Transform>& ts, std::vector<uint32_t>& img) {
  for (int n = (int)ts.size() - 1; n >= 0; --n) {
    const Transform& t = ts[n];
    const int w = t.xsize, h = t.ysize;
    uint32_t* d = img.data();
    if (t.type == 0) {
      d[0] = add_px(d[0], 0xff000000u);
      for (int x = 1; x < w; ++x) d[x] = add_px(d[x], d[x - 1]);
      const int tw = subsample(w, t.bits);
      for (int y = 1; y < h; ++y) {
        uint32_t* row = d + (size_t)y * w;
        const uint32_t* up = row - w;
        const uint32_t* modes = t.data.data() + (size_t)(y >> t.bits) * tw;
        row[0] = add_px(row[0], up[0]);
        for (int x = 1; x < w; ++x)
          row[x] = add_px(row[x], predict((modes[x >> t.bits] >> 8) & 0xf, row[x - 1], up + x));
      }
    } else if (t.type == 1) {
      const int tw = subsample(w, t.bits);
      for (int y = 0; y < h; ++y) {
        uint32_t* row = d + (size_t)y * w;
        const uint32_t* codes = t.data.data() + (size_t)(y >> t.bits) * tw;
        for (int x = 0; x < w; ++x) {
          const uint32_t code = codes[x >> t.bits];
          const int8_t g2r = (int8_t)(code & 0xff), g2b = (int8_t)((code >> 8) & 0xff),
                       r2b = (int8_t)((code >> 16) & 0xff);
          const uint32_t argb = row[x];
          const int8_t green = (int8_t)(argb >> 8);
          int r = (argb >> 16) & 0xff, b = argb & 0xff;
          r = (r + color_delta(g2r, green)) & 0xff;
          b = (b + color_delta(g2b, green) + color_delta(r2b, (int8_t)r)) & 0xff;
          row[x] = (argb & 0xff00ff00u) | ((uint32_t)r << 16) | (uint32_t)b;
        }
      }
    } else if (t.type == 2) {
      const size_t total = (size_t)w * h;
      for (size_t i = 0; i < total; ++i) {
        const uint32_t argb = d[i], g = (argb >> 8) & 0xff;
        d[i] = (argb & 0xff00ff00u) | ((((argb >> 16) + g) & 0xff) << 16) | ((argb + g) & 0xff);
      }
    } else {
      const int in_w = subsample(w, t.bits);
      std::vector<uint32_t> out;
      try {
        out.resize((size_t)w * h);
      } catch (const std::bad_alloc&) {
        return false;
      }
      const uint32_t* cmap = t.data.data();
      if (t.bits == 0) {
        for (size_t i = 0; i < out.size(); ++i) out[i] = cmap[(d[i] >> 8) & 0xff];
      } else {
        const int bpp = 8 >> t.bits, ppb_mask = (1 << t.bits) - 1;
        const uint32_t mask = (1u << bpp) - 1;
        for (int y = 0; y < h; ++y) {
          const uint32_t* src = d + (size_t)y * in_w;
          uint32_t* dst = out.data() + (size_t)y * w;
          uint32_t packed = 0;
          for (int x = 0; x < w; ++x) {
            if ((x & ppb_mask) == 0) packed = (*src++ >> 8) & 0xff;
            dst[x] = cmap[packed & mask];
            packed >>= bpp;
          }
        }
      }
      img.swap(out);
    }
  }
  return true;
}

// A level-0 image stream of width x height (the VP8L header read or, for
// alpha, absent), transforms inverted: ARGB pixels.
int decode_argb(LBits br, int width, int height, bool alpha, std::vector<uint32_t>& argb) {
  LDecoder dec(br, alpha);
  int txs = 0;
  try {
    if (!dec.image_stream(width, height, true, argb, &txs)) return kBitstream;
    if (!inverse_transforms(dec.transforms, argb)) return kNoMemory;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
  return kOk;
}

// ---------------------------------------------------------------- ALPH

inline uint8_t gradient(int a, int b, int c) {
  const int g = a + b - c;
  return (uint8_t)((g & ~0xff) == 0 ? g : g < 0 ? 0 : 255);
}

// WebPUnfilters[filter](prev, in, out, width); prev is null on the first row.
void unfilter_row(int filter, const uint8_t* prev, const uint8_t* in, uint8_t* out, int width) {
  if (filter == 0) {
    memmove(out, in, width);
    return;
  }
  if (filter == 1 || prev == nullptr) {  // horizontal, and the first row of all
    uint8_t pred = prev == nullptr ? 0 : prev[0];
    for (int i = 0; i < width; ++i) {
      out[i] = (uint8_t)(pred + in[i]);
      pred = out[i];
    }
  } else if (filter == 2) {
    for (int i = 0; i < width; ++i) out[i] = (uint8_t)(prev[i] + in[i]);
  } else {
    uint8_t top = prev[0], top_left = top, left = top;
    for (int i = 0; i < width; ++i) {
      top = prev[i];
      left = (uint8_t)(in[i] + gradient(left, top, top_left));
      top_left = top;
      out[i] = left;
    }
  }
}

// ALPHInit and ALPHDecode: the alpha plane [height][width] of an ALPH
// chunk's payload.
int decode_alpha(const uint8_t* data, size_t size, int width, int height, uint8_t* alpha) {
  if (size <= 1) return kBitstream;
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3, pre = (data[0] >> 4) & 3,
            rsrv = (data[0] >> 6) & 3;
  if (method > 1 || pre > 1 || rsrv != 0) return kBitstream;
  const size_t n = (size_t)width * height;
  std::vector<uint8_t> deltas;
  const uint8_t* src;
  if (method == 0) {
    if (size - 1 < n) return kBitstream;
    src = data + 1;
  } else {
    std::vector<uint32_t> argb;
    const int rc = decode_argb(LBits(data + 1, size - 1), width, height, true, argb);
    if (rc) return rc;
    deltas.resize(n);
    for (size_t i = 0; i < n; ++i) deltas[i] = (uint8_t)(argb[i] >> 8);
    src = deltas.data();
  }
  const uint8_t* prev = nullptr;
  for (int y = 0; y < height; ++y) {
    uint8_t* out = alpha + (size_t)y * width;
    unfilter_row(filter, prev, src + (size_t)y * width, out, width);
    prev = out;
  }
  return kOk;
}

// ----------------------------------------------------------------- VP8

// libwebp's boolean decoder (bit_reader_utils.h and
// bit_reader_inl_utils.h) on a 64-bit host: 56 bits loaded at a time while
// 8 bytes are left, then one byte at a time; the range is kept minus one,
// and eof is set the first time a bit is wanted past the end (one zero
// byte is shifted in then).  The 56-bit loads keep only the low 8 bits of
// a value that a damaged stream has let reach past the range, as there.
struct BoolDec {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  uint32_t range = 254;
  int bits = -8, eof = 0;

  void init(const uint8_t* start, size_t size) {
    buf = start;
    end = start + size;
    value = 0;
    range = 254;
    bits = -8;
    eof = 0;
    load();
  }
  void load() {
    if (buf + 8 <= end) {
      uint64_t in;
      memcpy(&in, buf, 8);
      buf += 7;
      value = (__builtin_bswap64(in) >> 8) | (value << 56);
      bits += 56;
    } else if (buf < end) {
      bits += 8;
      value = (uint64_t)(*buf++) | (value << 8);
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = 1;
    } else {
      bits = 0;
    }
  }
  int get_bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * (uint32_t)prob) >> 8;
    const uint32_t v = (uint32_t)(value >> pos);
    const int bit = v > split;
    if (bit) {
      r -= split;
      value -= (uint64_t)(split + 1) << pos;
    } else {
      r = split + 1;
    }
    const int shift = 7 ^ (31 - __builtin_clz(r));
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  // VP8GetSigned
  int get_signed(int v) {
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t val = (uint32_t)(value >> pos);
    const int32_t mask = (int32_t)(split - val) >> 31;
    bits -= 1;
    range += (uint32_t)mask;
    range |= 1;
    value -= (uint64_t)((split + 1) & (uint32_t)mask) << pos;
    return (v ^ mask) - mask;
  }
  int get_value(int nbits) {
    int v = 0;
    while (nbits-- > 0) v |= get_bit(0x80) << nbits;
    return v;
  }
  int get_signed_value(int nbits) {
    const int v = get_value(nbits);
    return get_value(1) ? -v : v;
  }
};

constexpr int kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
constexpr int kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
constexpr uint8_t kCat3[] = {173, 148, 140, 0};
constexpr uint8_t kCat4[] = {176, 155, 140, 135, 0};
constexpr uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
constexpr uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
constexpr const uint8_t* kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };

struct FInfo {
  int limit = 0, ilevel = 0, inner = 0, hev = 0;
};

struct MBInfo {  // the parse of one macroblock
  int segment = 0, skip = 0, is_i4x4 = 0;
  uint8_t imodes[16];
  int uvmode = 0;
};

struct Quant {
  int y1[2], y2[2], uv[2];
};

struct VP8Dec {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  BoolDec br;
  BoolDec parts[8];
  int num_parts = 1;
  // segment header
  int use_segment = 0, update_map = 0, absolute_delta = 1;
  int quantizer[4] = {0}, filter_strength[4] = {0};
  uint8_t segment_proba[3] = {255, 255, 255};
  // filter header
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
  int filter_type = 0;
  Quant dqm[4];
  uint8_t proba[4][8][3][11];
  int use_skip_proba = 0, skip_p = 0;
  FInfo fstrengths[4][2];
};

int get_large_value(BoolDec& br, const uint8_t* p) {
  int v;
  if (!br.get_bit(p[3])) {
    if (!br.get_bit(p[4])) {
      v = 2;
    } else {
      v = 3 + br.get_bit(p[5]);
    }
  } else {
    if (!br.get_bit(p[6])) {
      if (!br.get_bit(p[7])) {
        v = 5 + br.get_bit(159);
      } else {
        v = 7 + 2 * br.get_bit(165);
        v += br.get_bit(145);
      }
    } else {
      const int bit1 = br.get_bit(p[8]);
      const int bit0 = br.get_bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get_bit(*tab);
      v += 3 + (8 << cat);
    }
  }
  return v;
}

// GetCoeffs: the tokens of one 4x4 block from position n; returns the
// position after the last token read as non-zero (16 after a run of zeros
// to the end).
int get_coeffs(BoolDec& br, const uint8_t (*bands)[3][11], int ctx, const int* dq, int n,
               int16_t* out) {
  const uint8_t* p = bands[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.get_bit(p[0])) return n;
    while (!br.get_bit(p[1])) {
      p = bands[kBands[++n]][0];
      if (n == 16) return 16;
    }
    const uint8_t (*p_ctx)[11] = bands[kBands[n + 1]];
    int v;
    if (!br.get_bit(p[2])) {
      v = 1;
      p = p_ctx[1];
    } else {
      v = get_large_value(br, p);
      p = p_ctx[2];
    }
    out[kZigzag[n]] = (int16_t)(br.get_signed(v) * dq[n > 0]);
  }
  return 16;
}

inline int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

int parse_headers(VP8Dec& d, const uint8_t* buf, size_t size) {
  if (size < 4) return kNotEnough;
  const uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
  const int key_frame = !(bits & 1), profile = (bits >> 1) & 7, show = (bits >> 4) & 1;
  const uint32_t part_len = bits >> 5;
  if (profile > 3) return kBitstream;
  if (!show) return kUnsupported;
  buf += 3;
  size -= 3;
  if (!key_frame) return kUnsupported;
  if (size < 7) return kNotEnough;
  if (buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a) return kBitstream;
  d.width = ((buf[4] << 8) | buf[3]) & 0x3fff;
  d.height = ((buf[6] << 8) | buf[5]) & 0x3fff;
  buf += 7;
  size -= 7;
  d.mb_w = (d.width + 15) >> 4;
  d.mb_h = (d.height + 15) >> 4;
  memcpy(d.proba, kCoeffsProba0, sizeof(d.proba));
  if (part_len > size) return kNotEnough;
  BoolDec& br = d.br;
  br.init(buf, part_len);
  buf += part_len;
  size -= part_len;
  br.get_value(1);  // colour space
  br.get_value(1);  // clamping type: libwebp always clamps
  // ParseSegmentHeader
  d.use_segment = br.get_value(1);
  if (d.use_segment) {
    d.update_map = br.get_value(1);
    if (br.get_value(1)) {
      d.absolute_delta = br.get_value(1);
      for (int s = 0; s < 4; ++s) d.quantizer[s] = br.get_value(1) ? br.get_signed_value(7) : 0;
      for (int s = 0; s < 4; ++s)
        d.filter_strength[s] = br.get_value(1) ? br.get_signed_value(6) : 0;
    }
    if (d.update_map) {
      for (int s = 0; s < 3; ++s) d.segment_proba[s] = br.get_value(1) ? br.get_value(8) : 255;
    }
  } else {
    d.update_map = 0;
  }
  if (br.eof) return kBitstream;
  // ParseFilterHeader
  d.simple = br.get_value(1);
  d.level = br.get_value(6);
  d.sharpness = br.get_value(3);
  d.use_lf_delta = br.get_value(1);
  if (d.use_lf_delta && br.get_value(1)) {
    for (int i = 0; i < 4; ++i) {
      if (br.get_value(1)) d.ref_lf_delta[i] = br.get_signed_value(6);
    }
    for (int i = 0; i < 4; ++i) {
      if (br.get_value(1)) d.mode_lf_delta[i] = br.get_signed_value(6);
    }
  }
  d.filter_type = d.level == 0 ? 0 : d.simple ? 1 : 2;
  if (br.eof) return kBitstream;
  // ParsePartitions
  d.num_parts = 1 << br.get_value(2);
  const size_t last = d.num_parts - 1;
  if (size < 3 * last) return kNotEnough;
  const uint8_t* sz = buf;
  const uint8_t* part_start = buf + last * 3;
  size_t left = size - last * 3;
  for (size_t p = 0; p < last; ++p) {
    size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > left) psize = left;
    d.parts[p].init(part_start, psize);
    part_start += psize;
    left -= psize;
    sz += 3;
  }
  d.parts[last].init(part_start, left);
  if (part_start >= buf + size) return kNotEnough;  // VP8_STATUS_SUSPENDED
  // VP8ParseQuant
  const int base_q0 = br.get_value(7);
  const int dqy1_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
  const int dqy2_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
  const int dqy2_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
  const int dquv_dc = br.get_value(1) ? br.get_signed_value(4) : 0;
  const int dquv_ac = br.get_value(1) ? br.get_signed_value(4) : 0;
  for (int i = 0; i < 4; ++i) {
    int q;
    if (d.use_segment) {
      q = d.quantizer[i] + (d.absolute_delta ? 0 : base_q0);
    } else if (i > 0) {
      d.dqm[i] = d.dqm[0];
      continue;
    } else {
      q = base_q0;
    }
    Quant& m = d.dqm[i];
    m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
    m.y1[1] = kAcTable[clip(q, 127)];
    m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
    m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
  }
  br.get_value(1);  // update_proba, ignored
  // VP8ParseProba
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p) {
          const int i = ((t * 8 + b) * 3 + c) * 11 + p;
          d.proba[t][b][c][p] =
              br.get_bit(kCoeffsUpdateProba[i]) ? br.get_value(8) : kCoeffsProba0[i];
        }
  d.use_skip_proba = br.get_value(1);
  if (d.use_skip_proba) d.skip_p = br.get_value(8);
  return kOk;
}

void precompute_filter_strengths(VP8Dec& d) {
  if (d.filter_type == 0) return;
  for (int s = 0; s < 4; ++s) {
    int base_level;
    if (d.use_segment) {
      base_level = d.filter_strength[s] + (d.absolute_delta ? 0 : d.level);
    } else {
      base_level = d.level;
    }
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      FInfo& info = d.fstrengths[s][i4x4];
      int level = base_level;
      if (d.use_lf_delta) {
        level += d.ref_lf_delta[0];
        if (i4x4) level += d.mode_lf_delta[0];
      }
      level = level < 0 ? 0 : level > 63 ? 63 : level;
      if (level > 0) {
        int ilevel = level;
        if (d.sharpness > 0) {
          ilevel >>= d.sharpness > 4 ? 2 : 1;
          if (ilevel > 9 - d.sharpness) ilevel = 9 - d.sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        info.ilevel = ilevel;
        info.limit = 2 * level + ilevel;
        info.hev = level >= 40 ? 2 : level >= 15 ? 1 : 0;
      } else {
        info.limit = 0;
      }
      info.inner = i4x4;
    }
  }
}

void parse_intra_mode(BoolDec& br, const VP8Dec& d, uint8_t* top, uint8_t* left, MBInfo& b) {
  if (d.update_map) {
    b.segment = !br.get_bit(d.segment_proba[0]) ? br.get_bit(d.segment_proba[1])
                                                 : br.get_bit(d.segment_proba[2]) + 2;
  } else {
    b.segment = 0;
  }
  b.skip = d.use_skip_proba ? br.get_bit(d.skip_p) : 0;
  b.is_i4x4 = !br.get_bit(145);
  if (!b.is_i4x4) {
    const int ymode = br.get_bit(156) ? (br.get_bit(128) ? B_TM : B_HE)
                                      : (br.get_bit(163) ? B_VE : B_DC);
    b.imodes[0] = (uint8_t)ymode;
    memset(top, ymode, 4);
    memset(left, ymode, 4);
  } else {
    uint8_t* modes = b.imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* prob = kBModesProba + (top[x] * 10 + ymode) * 9;
        ymode = !br.get_bit(prob[0])   ? B_DC
                : !br.get_bit(prob[1]) ? B_TM
                : !br.get_bit(prob[2]) ? B_VE
                : !br.get_bit(prob[3])
                    ? (!br.get_bit(prob[4]) ? B_HE : (!br.get_bit(prob[5]) ? B_RD : B_VR))
                    : (!br.get_bit(prob[6])
                           ? B_LD
                           : (!br.get_bit(prob[7]) ? B_VL
                                                   : (!br.get_bit(prob[8]) ? B_HD : B_HU)));
        top[x] = (uint8_t)ymode;
      }
      memcpy(modes, top, 4);
      modes += 4;
      left[y] = (uint8_t)ymode;
    }
  }
  b.uvmode = !br.get_bit(142) ? B_DC : !br.get_bit(114) ? B_VE : br.get_bit(183) ? B_TM : B_HE;
}

inline uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
  return nz_coeffs;
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

// ParseResiduals: the coefficients of one macroblock; returns whether it
// has none (then its inner edges are not filtered unless it is 4x4).
// codes[24] get each block's transform: 0 none, 1 DC only, 2 the first
// three coefficients, 3 full.
int parse_residuals(VP8Dec& d, BoolDec& br, const MBInfo& b, uint8_t& top_nz, uint8_t& top_nz_dc,
                    uint8_t& left_nz, uint8_t& left_nz_dc, int16_t* coeffs, uint8_t* codes) {
  const Quant& q = d.dqm[b.segment];
  int16_t* dst = coeffs;
  memset(dst, 0, 384 * sizeof(*dst));
  const uint8_t (*ac_proba)[3][11];
  int first;
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  if (!b.is_i4x4) {
    int16_t dc[16] = {0};
    const int ctx = top_nz_dc + left_nz_dc;
    const int nz = get_coeffs(br, d.proba[1], ctx, q.y2, 0, dc);
    top_nz_dc = left_nz_dc = (nz > 0);
    if (nz > 1) {
      transform_wht(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 16 * 16; i += 16) dst[i] = (int16_t)dc0;
    }
    first = 1;
    ac_proba = d.proba[0];
  } else {
    first = 0;
    ac_proba = d.proba[3];
  }
  uint32_t tnz = top_nz & 0x0f, lnz = left_nz & 0x0f;
  int k = 0;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    uint32_t nz_coeffs = 0;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + (tnz & 1);
      const int nz = get_coeffs(br, ac_proba, ctx, q.y1, first, dst);
      l = (nz > first);
      tnz = (tnz >> 1) | (l << 7);
      nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
      codes[k++] = (uint8_t)(nz_coeffs & 3);
      dst += 16;
    }
    tnz >>= 4;
    lnz = (lnz >> 1) | (l << 7);
    non_zero_y = (non_zero_y << 8) | nz_coeffs;
  }
  uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nz_coeffs = 0;
    tnz = top_nz >> (4 + ch);
    lnz = left_nz >> (4 + ch);
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(br, d.proba[2], ctx, q.uv, 0, dst);
        l = (nz > 0);
        tnz = (tnz >> 1) | (l << 3);
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        codes[k++] = (uint8_t)(nz_coeffs & 3);
        dst += 16;
      }
      tnz >>= 2;
      lnz = (lnz >> 1) | (l << 5);
    }
    non_zero_uv |= nz_coeffs << (4 * ch);
    out_t_nz |= (tnz << 4) << ch;
    out_l_nz |= (lnz & 0xf0) << ch;
  }
  top_nz = (uint8_t)out_t_nz;
  left_nz = (uint8_t)out_l_nz;
  return !(non_zero_y | non_zero_uv);
}

// The work buffer of ReconstructRow: BPS-strided, the macroblock with its
// left column and upper row (and the upper-right samples of 4x4 blocks).
constexpr int BPS = 32;
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;
constexpr int kScan[16] = {0 + 0 * BPS,  4 + 0 * BPS,  8 + 0 * BPS,  12 + 0 * BPS,
                           0 + 4 * BPS,  4 + 4 * BPS,  8 + 4 * BPS,  12 + 4 * BPS,
                           0 + 8 * BPS,  4 + 8 * BPS,  8 + 8 * BPS,  12 + 8 * BPS,
                           0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};

inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }
inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

inline void store(uint8_t* dst, int x, int y, int v) {
  dst[x + y * BPS] = clip8(dst[x + y * BPS] + (v >> 3));
}

void transform_one(const int16_t* in, uint8_t* dst) {
  int C[16];
  int* tmp = C;
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {  // horizontal pass
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    store(dst, 0, 0, a + d);
    store(dst, 1, 0, b + c);
    store(dst, 2, 0, b - c);
    store(dst, 3, 0, a - d);
    tmp++;
    dst += BPS;
  }
}

void transform_dc(const int16_t* in, uint8_t* dst) {
  const int DC = in[0] + 4;
  for (int j = 0; j < 4; ++j)
    for (int i = 0; i < 4; ++i) store(dst, i, j, DC);
}

// Transform_SSE2, which Pillow's libwebp runs for a full block: the same
// steps in 16-bit lanes that wrap (35468 as 65536 - 30068), so a damaged
// stream's large coefficients come out as there.
inline int16_t w16(int v) { return (int16_t)v; }
inline int16_t mulhi(int16_t x, int k) { return (int16_t)(((int32_t)x * k) >> 16); }

void transform_sse2(const int16_t* in, uint8_t* dst) {
  int16_t C[16];
  for (int i = 0; i < 4; ++i) {  // vertical pass, column i
    const int16_t in0 = in[i], in1 = in[4 + i], in2 = in[8 + i], in3 = in[12 + i];
    const int16_t a = w16(in0 + in2), b = w16(in0 - in2);
    const int16_t c = w16(w16(in1 - in3) + w16(mulhi(in1, -30068) - mulhi(in3, 20091)));
    const int16_t d = w16(w16(in1 + in3) + w16(mulhi(in1, 20091) + mulhi(in3, -30068)));
    C[4 * i + 0] = w16(a + d);
    C[4 * i + 1] = w16(b + c);
    C[4 * i + 2] = w16(b - c);
    C[4 * i + 3] = w16(a - d);
  }
  for (int i = 0; i < 4; ++i) {  // horizontal pass, row i
    const int16_t T0 = C[i], T1 = C[4 + i], T2 = C[8 + i], T3 = C[12 + i];
    const int16_t dc = w16(T0 + 4);
    const int16_t a = w16(dc + T2), b = w16(dc - T2);
    const int16_t c = w16(w16(T1 - T3) + w16(mulhi(T1, -30068) - mulhi(T3, 20091)));
    const int16_t d = w16(w16(T1 + T3) + w16(mulhi(T1, 20091) + mulhi(T3, -30068)));
    const int16_t out[4] = {w16(a + d), w16(b + c), w16(b - c), w16(a - d)};
    for (int j = 0; j < 4; ++j) dst[j + i * BPS] = clip8(dst[j + i * BPS] + (out[j] >> 3));
  }
}

// DoTransform: a full block as Transform_SSE2, three coefficients as
// TransformAC3_C (int), a DC alone as TransformDC_C.
inline void do_transform(int code, const int16_t* src, uint8_t* dst) {
  if (code == 3) {
    transform_sse2(src, dst);
  } else if (code == 2) {
    transform_one(src, dst);
  } else if (code == 1) {
    transform_dc(src, dst);
  }
}

// intra predictions (dsp/dec.c)
#define DST(x, y) dst[(x) + (y) * BPS]
#define AVG3(a, b, c) ((uint8_t)(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) (((a) + (b) + 1) >> 1)

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + l - tl);
    dst += BPS;
  }
}

void pred_fill(uint8_t* dst, int v, int size) {
  for (int j = 0; j < size; ++j) memset(dst + j * BPS, v, size);
}

void pred_ve(uint8_t* dst, int size) {
  for (int j = 0; j < size; ++j) memcpy(dst + j * BPS, dst - BPS, size);
}

void pred_he(uint8_t* dst, int size) {
  for (int j = 0; j < size; ++j) memset(dst + j * BPS, dst[j * BPS - 1], size);
}

// 16x16 and chroma: DC by the edges the macroblock has (CheckMode)
void pred_dc(uint8_t* dst, int size, int has_top, int has_left) {
  const int shift = size == 16 ? 4 : 3;
  int dc = 0;
  if (has_top && has_left) {
    for (int j = 0; j < size; ++j) dc += dst[j - BPS] + dst[-1 + j * BPS];
    dc = (dc + size) >> (shift + 1);
  } else if (has_top) {
    for (int j = 0; j < size; ++j) dc += dst[j - BPS];
    dc = (dc + (size >> 1)) >> shift;
  } else if (has_left) {
    for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
    dc = (dc + (size >> 1)) >> shift;
  } else {
    dc = 0x80;
  }
  pred_fill(dst, dc, size);
}

void pred_block(uint8_t* dst, int mode, int size, int mb_x, int mb_y) {
  switch (mode) {
    case B_DC: pred_dc(dst, size, mb_y > 0, mb_x > 0); break;
    case B_TM: true_motion(dst, size); break;
    case B_VE: pred_ve(dst, size); break;
    default: pred_he(dst, size); break;
  }
}

void pred4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  switch (mode) {
    case B_DC: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      pred_fill(dst, dc >> 3, 4);
      break;
    }
    case B_TM: true_motion(dst, 4); break;
    case B_VE: {
      const uint8_t vals[4] = {AVG3(top[-1], top[0], top[1]), AVG3(top[0], top[1], top[2]),
                               AVG3(top[1], top[2], top[3]), AVG3(top[2], top[3], top[4])};
      for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE: {
      const int A = dst[-1 - BPS], B = dst[-1], C = dst[-1 + BPS], D = dst[-1 + 2 * BPS],
                E = dst[-1 + 3 * BPS];
      memset(dst + 0 * BPS, AVG3(A, B, C), 4);
      memset(dst + 1 * BPS, AVG3(B, C, D), 4);
      memset(dst + 2 * BPS, AVG3(C, D, E), 4);
      memset(dst + 3 * BPS, AVG3(D, E, E), 4);
      break;
    }
    case B_RD: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS], X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS],
                C = dst[2 - BPS], D = dst[3 - BPS];
      DST(0, 3) = AVG3(J, K, L);
      DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
      DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
      DST(3, 0) = AVG3(D, C, B);
      break;
    }
    case B_LD: {
      const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS],
                E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
      DST(0, 0) = AVG3(A, B, C);
      DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
      DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
      DST(3, 3) = AVG3(G, H, H);
      break;
    }
    case B_VR: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS],
                D = dst[3 - BPS];
      DST(0, 0) = DST(1, 2) = AVG2(X, A);
      DST(1, 0) = DST(2, 2) = AVG2(A, B);
      DST(2, 0) = DST(3, 2) = AVG2(B, C);
      DST(3, 0) = AVG2(C, D);
      DST(0, 3) = AVG3(K, J, I);
      DST(0, 2) = AVG3(J, I, X);
      DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
      DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
      DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
      DST(3, 1) = AVG3(B, C, D);
      break;
    }
    case B_VL: {
      const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS],
                E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
      DST(0, 0) = AVG2(A, B);
      DST(1, 0) = DST(0, 2) = AVG2(B, C);
      DST(2, 0) = DST(1, 2) = AVG2(C, D);
      DST(3, 0) = DST(2, 2) = AVG2(D, E);
      DST(0, 1) = AVG3(A, B, C);
      DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
      DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
      DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
      DST(3, 2) = AVG3(E, F, G);
      DST(3, 3) = AVG3(F, G, H);
      break;
    }
    case B_HD: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS], X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS],
                C = dst[2 - BPS];
      DST(0, 0) = DST(2, 1) = AVG2(I, X);
      DST(0, 1) = DST(2, 2) = AVG2(J, I);
      DST(0, 2) = DST(2, 3) = AVG2(K, J);
      DST(0, 3) = AVG2(L, K);
      DST(3, 0) = AVG3(A, B, C);
      DST(2, 0) = AVG3(X, A, B);
      DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
      DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
      DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
      DST(1, 3) = AVG3(L, K, J);
      break;
    }
    default: {  // B_HU
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS];
      DST(0, 0) = AVG2(I, J);
      DST(2, 0) = DST(0, 1) = AVG2(J, K);
      DST(2, 1) = DST(0, 2) = AVG2(K, L);
      DST(1, 0) = AVG3(I, J, K);
      DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
      DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = (uint8_t)L;
      break;
    }
  }
}

#undef DST
#undef AVG3
#undef AVG2

// loop filters (dsp/dec.c)
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline int hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return (std::abs(p1 - p0) > thresh) || (std::abs(q1 - q0) > thresh);
}

inline int needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return (4 * std::abs(p0 - q0) + std::abs(p1 - q1)) <= t;
}

inline int needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if ((4 * std::abs(p0 - q0) + std::abs(p1 - q1)) > t) return 0;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride) {
    if (needs_filter(p, hstride, thresh2)) do_filter2(p, hstride);
  }
}

void filter_loop26(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                   int hev_thresh) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) {
        do_filter2(p, hstride);
      } else {
        do_filter6(p, hstride);
      }
    }
    p += vstride;
  }
}

void filter_loop24(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                   int hev_thresh) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) {
        do_filter2(p, hstride);
      } else {
        do_filter4(p, hstride);
      }
    }
    p += vstride;
  }
}

struct Planes {
  int ys, uvs;  // strides
  std::vector<uint8_t> y, u, v;
};

// DoFilter on macroblock (mb_x, mb_y) of the whole frame.
void do_filter(int filter_type, const FInfo& f, Planes& pl, int mb_x, int mb_y) {
  const int limit = f.limit;
  if (limit == 0) return;
  const int ys = pl.ys;
  uint8_t* y_dst = pl.y.data() + (size_t)mb_y * 16 * ys + mb_x * 16;
  if (filter_type == 1) {
    if (mb_x > 0) simple_filter(y_dst, 1, ys, limit + 4);
    if (f.inner)
      for (int k = 1; k < 4; ++k) simple_filter(y_dst + 4 * k, 1, ys, limit);
    if (mb_y > 0) simple_filter(y_dst, ys, 1, limit + 4);
    if (f.inner)
      for (int k = 1; k < 4; ++k) simple_filter(y_dst + 4 * k * ys, ys, 1, limit);
    return;
  }
  const int uvs = pl.uvs, il = f.ilevel, ht = f.hev;
  uint8_t* u_dst = pl.u.data() + (size_t)mb_y * 8 * uvs + mb_x * 8;
  uint8_t* v_dst = pl.v.data() + (size_t)mb_y * 8 * uvs + mb_x * 8;
  if (mb_x > 0) {
    filter_loop26(y_dst, 1, ys, 16, limit + 4, il, ht);
    filter_loop26(u_dst, 1, uvs, 8, limit + 4, il, ht);
    filter_loop26(v_dst, 1, uvs, 8, limit + 4, il, ht);
  }
  if (f.inner) {
    for (int k = 1; k < 4; ++k) filter_loop24(y_dst + 4 * k, 1, ys, 16, limit, il, ht);
    filter_loop24(u_dst + 4, 1, uvs, 8, limit, il, ht);
    filter_loop24(v_dst + 4, 1, uvs, 8, limit, il, ht);
  }
  if (mb_y > 0) {
    filter_loop26(y_dst, ys, 1, 16, limit + 4, il, ht);
    filter_loop26(u_dst, uvs, 1, 8, limit + 4, il, ht);
    filter_loop26(v_dst, uvs, 1, 8, limit + 4, il, ht);
  }
  if (f.inner) {
    for (int k = 1; k < 4; ++k) filter_loop24(y_dst + 4 * k * ys, ys, 1, 16, limit, il, ht);
    filter_loop24(u_dst + 4 * uvs, uvs, 1, 8, limit, il, ht);
    filter_loop24(v_dst + 4 * uvs, uvs, 1, 8, limit, il, ht);
  }
}

// The frame's macroblocks parsed, reconstructed and filtered: the planes
// at whole macroblocks.
int decode_frame(VP8Dec& d, Planes& pl) {
  const int mb_w = d.mb_w, mb_h = d.mb_h;
  pl.ys = mb_w * 16;
  pl.uvs = mb_w * 8;
  try {
    pl.y.assign((size_t)pl.ys * mb_h * 16, 0);
    pl.u.assign((size_t)pl.uvs * mb_h * 8, 0);
    pl.v.assign((size_t)pl.uvs * mb_h * 8, 0);
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
  precompute_filter_strengths(d);
  std::vector<uint8_t> intra_t(4 * mb_w, B_DC), top_nz(mb_w, 0), top_nz_dc(mb_w, 0);
  std::vector<MBInfo> row(mb_w);
  std::vector<FInfo> finfo((size_t)mb_w * mb_h);
  struct Top {
    uint8_t y[16], u[8], v[8];
  };
  std::vector<Top> yuv_t(mb_w);
  alignas(16) uint8_t yuv_b[YUV_SIZE];
  alignas(16) int16_t coeffs[384];
  uint8_t codes[24];
  uint8_t* const y_dst = yuv_b + Y_OFF;
  uint8_t* const u_dst = yuv_b + U_OFF;
  uint8_t* const v_dst = yuv_b + V_OFF;
  memset(yuv_b, 0, sizeof(yuv_b));
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    uint8_t intra_l[4];
    memset(intra_l, B_DC, 4);
    for (int mb_x = 0; mb_x < mb_w; ++mb_x)
      parse_intra_mode(d.br, d, &intra_t[4 * mb_x], intra_l, row[mb_x]);
    if (d.br.eof) return kNotEnough;  // premature end of partition 0
    BoolDec& token_br = d.parts[mb_y & (d.num_parts - 1)];
    uint8_t left_nz = 0, left_nz_dc = 0;
    // ReconstructRow's edges: 129 left of the frame, 127 above it
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      memset(u_dst - BPS - 1, 127, 8 + 1);
      memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MBInfo& b = row[mb_x];
      // VP8DecodeMB
      int skip = b.skip;
      if (!skip) {
        skip = parse_residuals(d, token_br, b, top_nz[mb_x], top_nz_dc[mb_x], left_nz,
                               left_nz_dc, coeffs, codes);
      } else {
        left_nz = top_nz[mb_x] = 0;
        if (!b.is_i4x4) left_nz_dc = top_nz_dc[mb_x] = 0;
        memset(codes, 0, sizeof(codes));
      }
      if (d.filter_type > 0) {
        FInfo f = d.fstrengths[b.segment][b.is_i4x4];
        f.inner |= !skip;
        finfo[(size_t)mb_y * mb_w + mb_x] = f;
      }
      if (token_br.eof) return kNotEnough;  // premature end of file
      // ReconstructRow
      if (mb_x > 0) {
        for (int j = -1; j < 16; ++j) memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
        for (int j = -1; j < 8; ++j) {
          memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
          memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
        }
      }
      Top* const top_yuv = &yuv_t[mb_x];
      if (mb_y > 0) {
        memcpy(y_dst - BPS, top_yuv[0].y, 16);
        memcpy(u_dst - BPS, top_yuv[0].u, 8);
        memcpy(v_dst - BPS, top_yuv[0].v, 8);
      }
      if (b.is_i4x4) {
        uint8_t* const top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w - 1) {
            memset(top_right, top_yuv[0].y[15], 4);
          } else {
            memcpy(top_right, top_yuv[1].y, 4);
          }
        }
        for (int r = 1; r <= 3; ++r) memcpy(top_right + 4 * r * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n) {
          uint8_t* const dst = y_dst + kScan[n];
          pred4(dst, b.imodes[n]);
          do_transform(codes[n], coeffs + n * 16, dst);
        }
      } else {
        pred_block(y_dst, b.imodes[0], 16, mb_x, mb_y);
        for (int n = 0; n < 16; ++n) do_transform(codes[n], coeffs + n * 16, y_dst + kScan[n]);
      }
      pred_block(u_dst, b.uvmode, 8, mb_x, mb_y);
      pred_block(v_dst, b.uvmode, 8, mb_x, mb_y);
      // DoUVTransform: all four blocks of a plane as Transform_SSE2 where
      // one has more than a DC, else TransformDC_C
      for (int plane = 0; plane < 2; ++plane) {
        const uint8_t* pc = codes + 16 + 4 * plane;
        const bool full = pc[0] >= 2 || pc[1] >= 2 || pc[2] >= 2 || pc[3] >= 2;
        uint8_t* const base = plane ? v_dst : u_dst;
        for (int n = 0; n < 4; ++n) {
          const int16_t* src = coeffs + (16 + 4 * plane + n) * 16;
          uint8_t* const dst = base + (n & 1) * 4 + (n >> 1) * 4 * BPS;
          if (full) {
            transform_sse2(src, dst);
          } else if (pc[n]) {
            transform_dc(src, dst);
          }
        }
      }
      if (mb_y < mb_h - 1) {
        memcpy(top_yuv[0].y, y_dst + 15 * BPS, 16);
        memcpy(top_yuv[0].u, u_dst + 7 * BPS, 8);
        memcpy(top_yuv[0].v, v_dst + 7 * BPS, 8);
      }
      for (int j = 0; j < 16; ++j)
        memcpy(pl.y.data() + (size_t)(mb_y * 16 + j) * pl.ys + mb_x * 16, y_dst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        memcpy(pl.u.data() + (size_t)(mb_y * 8 + j) * pl.uvs + mb_x * 8, u_dst + j * BPS, 8);
        memcpy(pl.v.data() + (size_t)(mb_y * 8 + j) * pl.uvs + mb_x * 8, v_dst + j * BPS, 8);
      }
    }
  }
  if (d.filter_type > 0) {
    for (int mb_y = 0; mb_y < mb_h; ++mb_y)
      for (int mb_x = 0; mb_x < mb_w; ++mb_x)
        do_filter(d.filter_type, finfo[(size_t)mb_y * mb_w + mb_x], pl, mb_x, mb_y);
  }
  return kOk;
}

// yuv.h: 14-bit coefficients, 6 fractional bits kept
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline int yuv_clip8(int v) { return (v & ~16383) == 0 ? (v >> 6) : (v < 0) ? 0 : 255; }

inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgba) {
  rgba[0] = (uint8_t)yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgba[1] = (uint8_t)yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgba[2] = (uint8_t)yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// UpsampleRgbaLinePair: luma rows top_y (and bottom_y, or null) between
// chroma rows top_u/v and cur_u/v.
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u,
                   const uint8_t* top_v, const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  const int last_pair = (len - 1) >> 1;
  int tl_u = top_u[0], tl_v = top_v[0], l_u = cur_u[0], l_v = cur_v[0];
  yuv_to_rgb(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst);
  if (bottom_y)
    yuv_to_rgb(bottom_y[0], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2, bottom_dst);
  for (int x = 1; x <= last_pair; ++x) {
    const int t_u = top_u[x], t_v = top_v[x], u = cur_u[x], v = cur_v[x];
    const int avg_u = tl_u + t_u + l_u + u + 8, avg_v = tl_v + t_v + l_v + v + 8;
    const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int d03_u = (avg_u + 2 * (tl_u + u)) >> 3, d03_v = (avg_v + 2 * (tl_v + v)) >> 3;
    yuv_to_rgb(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1,
               top_dst + (2 * x - 1) * 4);
    yuv_to_rgb(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, top_dst + 2 * x * 4);
    if (bottom_y) {
      yuv_to_rgb(bottom_y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1,
                 bottom_dst + (2 * x - 1) * 4);
      yuv_to_rgb(bottom_y[2 * x], (d12_u + u) >> 1, (d12_v + v) >> 1, bottom_dst + 2 * x * 4);
    }
    tl_u = t_u;
    tl_v = t_v;
    l_u = u;
    l_v = v;
  }
  if (!(len & 1)) {
    yuv_to_rgb(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
               top_dst + (len - 1) * 4);
    if (bottom_y)
      yuv_to_rgb(bottom_y[len - 1], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2,
                 bottom_dst + (len - 1) * 4);
  }
}

// EmitFancyRGB over the whole picture (width x height of the planes).
void emit_fancy(const Planes& pl, int width, int height, uint8_t* rgba) {
  const size_t stride = (size_t)width * 4;
  const uint8_t *y = pl.y.data(), *u = pl.u.data(), *v = pl.v.data();
  upsample_pair(y, nullptr, u, v, u, v, rgba, nullptr, width);
  int row = 0;
  for (; row + 2 < height; row += 2) {
    const size_t k = row / 2;
    upsample_pair(y + (size_t)(row + 1) * pl.ys, y + (size_t)(row + 2) * pl.ys,
                  u + k * pl.uvs, v + k * pl.uvs, u + (k + 1) * pl.uvs, v + (k + 1) * pl.uvs,
                  rgba + (row + 1) * stride, rgba + (row + 2) * stride, width);
  }
  if (!(height & 1)) {
    const size_t k = row / 2;
    upsample_pair(y + (size_t)(row + 1) * pl.ys, nullptr, u + k * pl.uvs, v + k * pl.uvs,
                  u + k * pl.uvs, v + k * pl.uvs, rgba + (row + 1) * stride, nullptr, width);
  }
}

}  // namespace

extern "C" {

// The RGBA pixels [height][width][4] of a VP8L bitstream (from its
// signature byte; size runs to the end of the decoder's input, padding
// included).  width and height are those of its header.
int webp_vp8l_decode(const uint8_t* data, int64_t size, int width, int height, uint8_t* rgba) {
  if (size < 5 || data[0] != 0x2f || (data[4] >> 5) != 0) return kBitstream;
  LBits br(data, (size_t)size);
  br.read(8);
  const int w = (int)br.read(14) + 1, h = (int)br.read(14) + 1;
  br.read(1);
  if (br.read(3) != 0 || br.eos || w != width || h != height) return kBitstream;
  std::vector<uint32_t> argb;
  const int rc = decode_argb(br, w, h, false, argb);
  if (rc) return rc;
  const size_t n = (size_t)w * h;
  for (size_t i = 0; i < n; ++i) {
    const uint32_t p = argb[i];
    rgba[4 * i + 0] = (uint8_t)(p >> 16);
    rgba[4 * i + 1] = (uint8_t)(p >> 8);
    rgba[4 * i + 2] = (uint8_t)p;
    rgba[4 * i + 3] = (uint8_t)(p >> 24);
  }
  return kOk;
}

// The header fields io/webp.py refuses by: info[0] the filter type (0
// none, 1 simple, 2 normal), info[1] the number of token partitions.
int webp_vp8_features(const uint8_t* data, int64_t size, int* info) {
  VP8Dec d;
  const int rc = parse_headers(d, data, (size_t)size);
  info[0] = d.filter_type;
  info[1] = d.num_parts;
  return rc;
}

// The RGBA pixels [height][width][4] of a VP8 key frame (from its frame
// tag; size runs to the end of the decoder's input), with the alpha of an
// ALPH chunk's payload (alph null: 255).
int webp_vp8_decode(const uint8_t* data, int64_t size, const uint8_t* alph, int64_t alph_size,
                    int width, int height, uint8_t* rgba) {
  VP8Dec d;
  int rc = parse_headers(d, data, (size_t)size);
  if (rc == kOk && (d.width != width || d.height != height)) rc = kBitstream;
  Planes pl;
  if (rc == kOk) rc = decode_frame(d, pl);
  if (rc) return rc;
  emit_fancy(pl, width, height, rgba);
  if (alph) {
    std::vector<uint8_t> alpha;
    try {
      alpha.resize((size_t)width * height);
    } catch (const std::bad_alloc&) {
      return kNoMemory;
    }
    rc = decode_alpha(alph, (size_t)alph_size, width, height, alpha.data());
    if (rc) return rc;
    for (size_t i = 0; i < alpha.size(); ++i) rgba[4 * i + 3] = alpha[i];
  } else {
    const size_t n = (size_t)width * height;
    for (size_t i = 0; i < n; ++i) rgba[4 * i + 3] = 255;
  }
  return kOk;
}

}  // extern "C"
