// CCITT fax decoding of TIFF strips and tiles (compressions 2, 3, 4 and
// 32771) for dspfun_tpu_torch/io/imgcodecs.py, as libtiff's tif_fax3.c
// decodes them under Pillow, so that what Pillow reads from a damaged
// strip (libtiff recovers from a bad code at the next row, and fills the
// row it stops in) the port reads too.
//
// The state machine follows tif_fax3.h: bits are taken least significant
// first from bytes bit-reversed by the fill order (FillOrder 1 reversed),
// codes are looked up in tables indexed by those bits (a 7-bit table of
// the 2-D modes, 12- and 13-bit tables of white and black runs, made from
// the T.4 code lists as libtiff's mkg3states makes its tables), a row is
// held as run lengths (white, black, white, ...) and written as bits, 1
// for a black run, most significant bit first.
//
// Built at first use by dspfun_tpu_torch/_hostbuild.py (g++ -O3
// -march=native ... -shared); loaded with ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum State : uint8_t {
  S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB, S_MakeUpW, S_MakeUpB,
  S_MakeUp, S_EOL
};

struct Ent {
  uint8_t state = S_Null;
  uint8_t width = 0;
  uint32_t param = 0;
};

// T.4's code words, most significant (first) bit first
const char* const kWhiteTerm[64] = {
    "00110101", "000111",   "0111",     "1000",     "1011",     "1100",     "1110",
    "1111",     "10011",    "10100",    "00111",    "01000",    "001000",   "000011",
    "110100",   "110101",   "101010",   "101011",   "0100111",  "0001100",  "0001000",
    "0010111",  "0000011",  "0000100",  "0101000",  "0101011",  "0010011",  "0100100",
    "0011000",  "00000010", "00000011", "00011010", "00011011", "00010010", "00010011",
    "00010100", "00010101", "00010110", "00010111", "00101000", "00101001", "00101010",
    "00101011", "00101100", "00101101", "00000100", "00000101", "00001010", "00001011",
    "01010010", "01010011", "01010100", "01010101", "00100100", "00100101", "01011000",
    "01011001", "01011010", "01011011", "01001010", "01001011", "00110010", "00110011",
    "00110100"};
const char* const kBlackTerm[64] = {
    "0000110111",   "010",          "11",           "10",           "011",
    "0011",         "0010",         "00011",        "000101",       "000100",
    "0000100",      "0000101",      "0000111",      "00000100",     "00000111",
    "000011000",    "0000010111",   "0000011000",   "0000001000",   "00001100111",
    "00001101000",  "00001101100",  "00000110111",  "00000101000",  "00000010111",
    "00000011000",  "000011001010", "000011001011", "000011001100", "000011001101",
    "000001101000", "000001101001", "000001101010", "000001101011", "000011010010",
    "000011010011", "000011010100", "000011010101", "000011010110", "000011010111",
    "000001101100", "000001101101", "000011011010", "000011011011", "000001010100",
    "000001010101", "000001010110", "000001010111", "000001100100", "000001100101",
    "000001010010", "000001010011", "000000100100", "000000110111", "000000111000",
    "000000100111", "000000101000", "000001011000", "000001011001", "000000101011",
    "000000101100", "000001011010", "000001100110", "000001100111"};
const char* const kWhiteMakeUp[27] = {   // 64, 128, ... 1728
    "11011",     "10010",     "010111",    "0110111",   "00110110",  "00110111",  "01100100",
    "01100101",  "01101000",  "01100111",  "011001100", "011001101", "011010010", "011010011",
    "011010100", "011010101", "011010110", "011010111", "011011000", "011011001", "011011010",
    "011011011", "010011000", "010011001", "010011010", "011000",    "010011011"};
const char* const kBlackMakeUp[27] = {
    "0000001111",    "000011001000",  "000011001001",  "000001011011",  "000000110011",
    "000000110100",  "000000110101",  "0000001101100", "0000001101101", "0000001001010",
    "0000001001011", "0000001001100", "0000001001101", "0000001110010", "0000001110011",
    "0000001110100", "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010", "0000001011011",
    "0000001100100", "0000001100101"};
const char* const kExtMakeUp[13] = {   // 1792, 1856, ... 2560, either colour
    "00000001000",  "00000001100",  "00000001101",  "000000010010", "000000010011",
    "000000010100", "000000010101", "000000010110", "000000010111", "000000011100",
    "000000011101", "000000011110", "000000011111"};

// mkg3states.c FillTable: every index whose low bits are the code (taken
// first bit lowest) gets the entry
void fill_table(Ent* t, int size, const char* code, State st, uint32_t param) {
  int width = static_cast<int>(std::strlen(code));
  int idx = 0;
  for (int i = 0; i < width; i++)
    if (code[i] == '1') idx |= 1 << i;
  for (int c = idx; c < (1 << size); c += 1 << width)
    t[c] = Ent{st, static_cast<uint8_t>(width), param};
}

struct Tables {
  Ent main[128];
  Ent white[4096];
  Ent black[8192];
  Tables() {
    fill_table(main, 7, "0001", S_Pass, 0);
    fill_table(main, 7, "001", S_Horiz, 0);
    fill_table(main, 7, "1", S_V0, 0);
    fill_table(main, 7, "011", S_VR, 1);
    fill_table(main, 7, "000011", S_VR, 2);
    fill_table(main, 7, "0000011", S_VR, 3);
    fill_table(main, 7, "010", S_VL, 1);
    fill_table(main, 7, "000010", S_VL, 2);
    fill_table(main, 7, "0000010", S_VL, 3);
    fill_table(main, 7, "0000001", S_Ext, 0);
    fill_table(main, 7, "0000000", S_EOL, 0);
    for (int i = 0; i < 27; i++) {
      fill_table(white, 12, kWhiteMakeUp[i], S_MakeUpW, 64u * (i + 1));
      fill_table(black, 13, kBlackMakeUp[i], S_MakeUpB, 64u * (i + 1));
    }
    for (int i = 0; i < 13; i++) {
      fill_table(white, 12, kExtMakeUp[i], S_MakeUp, 1792u + 64u * i);
      fill_table(black, 13, kExtMakeUp[i], S_MakeUp, 1792u + 64u * i);
    }
    for (int i = 0; i < 64; i++) {
      fill_table(white, 12, kWhiteTerm[i], S_TermW, i);
      fill_table(black, 13, kBlackTerm[i], S_TermB, i);
    }
    fill_table(white, 12, "00000000000", S_EOL, 0);   // an EOL's 11 zeros
    fill_table(black, 13, "00000000000", S_EOL, 0);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

uint8_t kBitRev[256];
struct BitRevInit {
  BitRevInit() {
    for (int i = 0; i < 256; i++) {
      int r = 0;
      for (int b = 0; b < 8; b++)
        if (i & (1 << b)) r |= 0x80 >> b;
      kBitRev[i] = static_cast<uint8_t>(r);
    }
  }
} bitrev_init;
uint8_t kNoRev[256];
struct NoRevInit {
  NoRevInit() {
    for (int i = 0; i < 256; i++) kNoRev[i] = static_cast<uint8_t>(i);
  }
} norev_init;

enum Outcome { kDone, kEof, kFatal };

struct Fax {
  const uint8_t* start;
  const uint8_t* cp;
  const uint8_t* ep;
  const uint8_t* bitmap;
  uint32_t acc = 0;
  int avail = 0;
  int eolcnt = 0;
  int lastx;
  int a0 = 0;
  int run_length = 0;
  std::vector<uint32_t> runs;
  uint32_t* thisrun = nullptr;
  uint32_t* curruns = nullptr;
  uint32_t* refruns = nullptr;
  uint32_t* pa = nullptr;
  uint32_t* pb = nullptr;
  int b1 = 0;
  int64_t nruns;
  const Tables* t = &tables();

  Fax(const uint8_t* data, int64_t len, int width, bool lsb_first, bool two_d)
      : start(data), cp(data), ep(data + len), bitmap(lsb_first ? kNoRev : kBitRev), lastx(width) {
    // Fax3SetupState: width + 1 runs rounded up to 32, twice that where
    // a 2-D row needs its reference row
    nruns = ((static_cast<int64_t>(width) + 1 + 31) / 32) * 32;
    if (two_d) nruns *= 2;
    runs.assign(static_cast<size_t>(2 * nruns), 0);
    curruns = runs.data();
    refruns = runs.data() + nruns;
    refruns[0] = static_cast<uint32_t>(width);   // the reference row before the first: white
    refruns[1] = 0;
  }

  // back to the strip's first bit (the runs and the reference row kept)
  void rewind() {
    cp = start;
    acc = 0;
    avail = 0;
    eolcnt = 0;
  }

  // NeedBits8 / NeedBits16: false where the data ended with no bit left
  // (the caller's EOF label); bits past the end are zeros
  bool need8(int n) {
    if (avail < n) {
      if (cp >= ep) {
        if (avail == 0) return false;
        avail = n;
      } else {
        acc |= static_cast<uint32_t>(bitmap[*cp++]) << avail;
        avail += 8;
      }
    }
    return true;
  }
  bool need16(int n) {
    if (avail < n) {
      if (cp >= ep) {
        if (avail == 0) return false;
        avail = n;
      } else {
        acc |= static_cast<uint32_t>(bitmap[*cp++]) << avail;
        if ((avail += 8) < n) {
          if (cp >= ep) {
            avail = n;
          } else {
            acc |= static_cast<uint32_t>(bitmap[*cp++]) << avail;
            avail += 8;
          }
        }
      }
    }
    return true;
  }
  uint32_t get(int n) const { return acc & ((1u << n) - 1); }
  void clr(int n) {
    avail -= n;
    acc >>= n;
  }
  const Ent* lookup8(int wid, const Ent* tab) {
    if (!need8(wid)) return nullptr;
    const Ent* e = tab + get(wid);
    clr(e->width);
    return e;
  }
  const Ent* lookup16(int wid, const Ent* tab) {
    if (!need16(wid)) return nullptr;
    const Ent* e = tab + get(wid);
    clr(e->width);
    return e;
  }
  bool full() const { return pa >= thisrun + nruns; }
  bool setvalue(uint32_t x) {
    if (full()) return false;
    *pa++ = static_cast<uint32_t>(run_length) + x;
    a0 = static_cast<int>(static_cast<uint32_t>(a0) + x);
    run_length = 0;
    return true;
  }
  // CLEANUP_RUNS: the row's runs made to end at lastx
  void cleanup() {
    if (run_length) setvalue(0);
    if (a0 != lastx) {
      while (a0 > lastx && pa > thisrun) a0 = static_cast<int>(static_cast<uint32_t>(a0) - *--pa);
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if ((pa - thisrun) & 1) setvalue(0);
        setvalue(static_cast<uint32_t>(lastx - a0));
      } else if (a0 > lastx) {
        setvalue(static_cast<uint32_t>(lastx));
        setvalue(0);
      }
    }
  }
  bool check_b1() {
    if (pa != thisrun)
      while (b1 <= a0 && b1 < lastx) {
        if (pb + 1 >= refruns + nruns) return false;
        b1 = static_cast<int>(static_cast<uint32_t>(b1) + pb[0] + pb[1]);
        pb += 2;
      }
    return true;
  }

  // SYNC_EOL: past the EOL that starts a row (and any fill before it):
  // 0, or 1 where the data ends looking for its 11 zeros, 2 where it ends
  // past them (no EOL found: the strip has none)
  int sync_eol() {
    if (eolcnt == 0) {
      for (;;) {
        if (!need16(11)) return 1;
        if (get(11) == 0) break;
        clr(1);
      }
    }
    for (;;) {
      if (!need8(8)) return 2;
      if (get(8)) break;
      clr(8);
    }
    while (get(1) == 0) clr(1);
    clr(1);
    eolcnt = 0;
    return 0;
  }

  // one colour's run of a row (make-up codes, then a terminating one):
  // kDone with the run set, kEof, kFatal, or 1 + the bad table's colour
  int one_run(bool black, bool allow_eol) {
    const Ent* tab = black ? t->black : t->white;
    for (;;) {
      const Ent* e = lookup16(black ? 13 : 12, tab);
      if (!e) return kEof;
      if (e->state == (black ? S_TermB : S_TermW)) return setvalue(e->param) ? kDone : kFatal;
      if (e->state == (black ? S_MakeUpB : S_MakeUpW) || e->state == S_MakeUp) {
        a0 = static_cast<int>(static_cast<uint32_t>(a0) + e->param);
        run_length = static_cast<int>(static_cast<uint32_t>(run_length) + e->param);
        continue;
      }
      if (allow_eol && e->state == S_EOL) return 10;
      return 11;     // unexpected code
    }
  }

  // EXPAND1D
  Outcome expand1d() {
    for (;;) {
      for (bool black : {false, true}) {
        int r = one_run(black, true);
        if (r == kEof) {
          cleanup();
          return kEof;
        }
        if (r == kFatal) return kFatal;
        if (r == 10) eolcnt = 1;
        if (r >= 10 || a0 >= lastx) {
          cleanup();
          return kDone;
        }
      }
      if (*(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;
    }
  }

  // EXPAND2D
  Outcome expand2d() {
    const uint32_t* ref_end = refruns + nruns;
    while (a0 < lastx) {
      if (full()) return kFatal;
      const Ent* e = lookup8(7, t->main);
      if (!e) goto eof2d;
      switch (e->state) {
        case S_Pass:
          if (!check_b1() || pb >= ref_end) return kFatal;
          b1 = static_cast<int>(static_cast<uint32_t>(b1) + *pb++);
          run_length += b1 - a0;
          a0 = b1;
          if (pb >= ref_end) return kFatal;
          b1 = static_cast<int>(static_cast<uint32_t>(b1) + *pb++);
          break;
        case S_Horiz: {
          bool black_first = (pa - thisrun) & 1;
          for (bool black : {black_first, !black_first}) {
            int r = one_run(black, false);
            if (r == kEof) goto eof2d;
            if (r == kFatal) return kFatal;
            if (r != kDone) goto eol2d;     // badBlack2d / badWhite2d
          }
          if (!check_b1()) return kFatal;
          break;
        }
        case S_V0:
          if (!check_b1() || !setvalue(static_cast<uint32_t>(b1 - a0)) || pb >= ref_end)
            return kFatal;
          b1 = static_cast<int>(static_cast<uint32_t>(b1) + *pb++);
          break;
        case S_VR:
          if (!check_b1() || !setvalue(static_cast<uint32_t>(b1 - a0) + e->param) ||
              pb >= ref_end)
            return kFatal;
          b1 = static_cast<int>(static_cast<uint32_t>(b1) + *pb++);
          break;
        case S_VL:
          if (!check_b1()) return kFatal;
          if (b1 < static_cast<int>(static_cast<uint32_t>(a0) + e->param)) goto eol2d;
          if (!setvalue(static_cast<uint32_t>(b1 - a0) - e->param)) return kFatal;
          b1 = static_cast<int>(static_cast<uint32_t>(b1) - *--pb);
          break;
        case S_Ext:             // uncompressed mode: libtiff does not support it
          *pa++ = static_cast<uint32_t>(lastx - a0);
          goto eol2d;
        case S_EOL:
          *pa++ = static_cast<uint32_t>(lastx - a0);
          if (!need8(4)) goto eof2d;
          clr(4);
          eolcnt = 1;
          goto eol2d;
        default:
          goto eol2d;
      }
    }
    if (run_length) {
      if (run_length + a0 < lastx) {    // a final V0 is due
        if (!need8(1)) goto eof2d;
        if (!get(1)) goto eol2d;
        clr(1);
      }
      if (!setvalue(0)) return kFatal;
    }
  eol2d:
    cleanup();
    return kDone;
  eof2d:
    cleanup();
    return kEof;
  }
};

// _TIFFFax3fillruns: the runs of a row as bits (white 0, black 1), each
// run cut at the row's end (in the run array too, which the next row
// takes for its reference)
void fill_runs(uint8_t* buf, uint32_t* runs, uint32_t* erun, uint32_t lastx) {
  if ((erun - runs) & 1) *erun++ = 0;
  uint32_t x = 0;
  auto span = [&](uint32_t from, uint32_t n, bool black) {
    for (uint32_t i = from; i < from + n; i++) {
      uint8_t m = static_cast<uint8_t>(0x80 >> (i & 7));
      buf[i >> 3] = black ? (buf[i >> 3] | m) : (buf[i >> 3] & ~m);
    }
  };
  for (; runs < erun; runs += 2) {
    for (int k = 0; k < 2; k++) {
      uint32_t run = runs[k];
      if (x + run > lastx || run > lastx) run = runs[k] = lastx - x;
      if (run) {
        span(x, run, k == 1);
        x += runs[k];
      }
    }
  }
}

}  // namespace

extern "C" {

// Decode one strip or tile of `rows` rows of `width` pixels into `out`
// (rows of (width + 7) / 8 bytes, most significant bit first, 1 for a
// black run; rows the decoder does not reach are left as they are).
//   scheme: 2 Modified Huffman (each row byte-aligned), 16 the same with
//           each row aligned to 16 bits from the strip's start (RLE-W,
//           compression 32771: libtiff's FAXMODE_WORDALIGN, whose test of
//           the pointer amounts to that in its word-aligned buffer), 3 T.4 1-D rows
//           behind EOLs, 32 T.4 with 2-D rows (a tag bit after each EOL),
//           4 T.6; where a T.4 row's EOL is never found, the strip is
//           read again from its start without EOLs into that row and the
//           rows after it (libtiff's RETRY_WITHOUT_EOL), and *no_eol is set:
//           libtiff keeps that mode for the strips after it (pass it back);
//   lsb_first: FillOrder 2.
// Returns 1, or -1 where libtiff's decoder returns an error (the data
// ends before the last row, but for T.6 once a row is decoded; more runs
// than a row holds); *rows_done = the rows decoded in full.
int fax_decode(const uint8_t* data, int64_t len, int scheme, int lsb_first, int width,
               int rows, uint8_t* out, int64_t* rows_done, int* no_eol) {
  const int64_t rowbytes = (static_cast<int64_t>(width) + 7) / 8;
  const bool two_d = scheme == 32 || scheme == 4;
  Fax f(data, len, width, lsb_first != 0, two_d);
  uint8_t* buf = out;
  bool noeol = *no_eol != 0;     // FAXMODE_NOEOL, once set kept for the strips after
  *rows_done = 0;
  for (int line = 0; line < rows; line++) {
    int sync = 0;
    if ((scheme == 3 || scheme == 32) && !noeol) {
      sync = f.sync_eol();
      if (sync == 2) {      // no EOL found: libtiff reads the strip again from its
        noeol = true;       // start without EOLs, into this row and the ones after
        *no_eol = 1;
        sync = 0;
        f.rewind();
      }
    }
    f.a0 = 0;
    f.run_length = 0;
    f.pa = f.thisrun = f.curruns;
    Outcome o;
    if (scheme == 2 || scheme == 16) {
      o = f.expand1d();
      if (o == kFatal) return -1;
      fill_runs(buf, f.thisrun, f.pa, static_cast<uint32_t>(width));
      if (o == kEof) return -1;
      if (scheme == 2) {
        f.clr(f.avail - (f.avail & ~7));   // FAXMODE_BYTEALIGN
      } else {                             // FAXMODE_WORDALIGN, from the strip's start
        f.clr(f.avail - (f.avail & ~15));
        if (f.avail == 0 && ((f.cp - f.start) & 1)) f.cp++;
      }
    } else if (scheme == 3) {
      if (sync) {
        f.cleanup();
        fill_runs(buf, f.thisrun, f.pa, static_cast<uint32_t>(width));
        return -1;
      }
      o = f.expand1d();
      if (o == kFatal) return -1;
      fill_runs(buf, f.thisrun, f.pa, static_cast<uint32_t>(width));
      if (o == kEof) return -1;
    } else if (scheme == 32) {
      bool is1d = false;
      if (sync || !f.need8(1)) {
        f.cleanup();
        fill_runs(buf, f.thisrun, f.pa, static_cast<uint32_t>(width));
        return -1;
      }
      is1d = f.get(1) != 0;
      f.clr(1);
      f.pb = f.refruns;
      f.b1 = static_cast<int>(*f.pb++);
      o = is1d ? f.expand1d() : f.expand2d();
      if (o == kFatal) return -1;
      fill_runs(buf, f.thisrun, f.pa, static_cast<uint32_t>(width));
      if (o == kEof) return -1;
      if (!f.full()) f.setvalue(0);     // an imaginary change for the reference
      std::swap(f.curruns, f.refruns);
    } else {
      f.pb = f.refruns;
      f.b1 = static_cast<int>(*f.pb++);
      o = f.expand2d();
      if (o == kFatal) return -1;
      if (o == kEof || f.eolcnt) {      // EOFB, or the data's end: this row is the last
        fill_runs(buf, f.thisrun, f.pa, static_cast<uint32_t>(width));
        return line ? 1 : -1;           // "don't error on badly-terminated strips"
      }
      fill_runs(buf, f.thisrun, f.pa, static_cast<uint32_t>(width));
      if (!f.setvalue(0)) return -1;
      std::swap(f.curruns, f.refruns);
    }
    buf += rowbytes;
    *rows_done = line + 1;
  }
  return 1;
}

}  // extern "C"
