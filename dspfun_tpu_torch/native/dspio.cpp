// dspio — native I/O & host-side runtime for dspfun-tpu.
//
// The reference delegates its hot host-side loops to C libraries
// (FFmpeg demux/decode, MagickWand pixel import; reference
// include/ffapi.c).  This library is the TPU framework's native
// counterpart for the host paths that feed the device:
//
//  * y4m / fvid container demuxing: header parse + frame indexing +
//    bulk pread of frame payloads (replaces the per-frame Python read
//    loop for large clips);
//  * a background prefetching frame reader (double/triple-buffered
//    ring, one reader thread) so container I/O overlaps device compute
//    — the host->device staging pipeline of SURVEY.md section 2.8;
//  * pel conversion kernels: uint8 plane <-> float32 0..255,
//    interleave/deinterleave;
//  * sequential Floyd-Steinberg dithering (reference
//    motion/motion.c:778-787) — the one genuinely serial per-pixel
//    loop in the framework, natively vectorised per row.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>

#include <atomic>
#include <condition_variable>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Container demuxing
// ---------------------------------------------------------------------------

struct DspioReader {
    FILE* f = nullptr;
    int64_t width = 0, height = 0;
    int64_t rate_num = 25, rate_den = 1;
    char pixfmt[32] = {0};
    char ctag[32] = {0};
    int is_fvid = 0;
    int indexed = 0;           // payload-offset mode (NUT etc.): the
                               // host parser supplies absolute payload
                               // offsets; no marker parsing here
    int64_t frame_bytes = 0;   // payload bytes per frame
    int64_t data_start = 0;    // offset of first FRAME marker
    int64_t nframes = -1;      // -1 = unknown (pipe)
    int64_t next_frame = 0;
    // marker offset of every frame, built at open for seekable files:
    // y4m FRAME lines may carry parameters ("FRAME Xfoo\n"), so frame
    // positions are NOT a fixed stride apart in general
    std::vector<int64_t> offsets;
    // plane geometry
    int nplanes = 0;
    int64_t plane_w[4] = {0}, plane_h[4] = {0};
    int bytes_per_sample = 1;
};

static int64_t compute_frame_bytes(DspioReader* r) {
    int64_t total = 0;
    for (int i = 0; i < r->nplanes; i++)
        total += r->plane_w[i] * r->plane_h[i];
    return total * r->bytes_per_sample;
}

static void set_planes_from_ctag(DspioReader* r) {
    r->bytes_per_sample = 1;
    // high-bit-depth y4m tags: "420p16"/"422p12"/"444p10"/"mono16"
    // (2-byte little-endian samples, as ffmpeg's y4m muxer writes them)
    const char* hd = strstr(r->ctag, "p1");
    if ((hd && (hd[2] == '0' || hd[2] == '2' || hd[2] == '6')) ||
        !strcmp(r->ctag, "mono16"))
        r->bytes_per_sample = 2;
    if (!strncmp(r->ctag, "mono", 4)) {
        r->nplanes = 1;
        r->plane_w[0] = r->width; r->plane_h[0] = r->height;
        return;
    }
    r->nplanes = 3;
    r->plane_w[0] = r->width; r->plane_h[0] = r->height;
    int sub_w = 1, sub_h = 1;
    if (!strncmp(r->ctag, "420", 3)) { sub_w = 2; sub_h = 2; }
    else if (!strncmp(r->ctag, "422", 3)) { sub_w = 2; sub_h = 1; }
    for (int i = 1; i < 3; i++) {
        r->plane_w[i] = (r->width + sub_w - 1) / sub_w;
        r->plane_h[i] = (r->height + sub_h - 1) / sub_h;
    }
}

static void set_planes_from_fvid(DspioReader* r) {
    r->bytes_per_sample = 4;  // all fvid formats are float32
    const char* p = r->pixfmt;
    if (!strncmp(p, "gray", 4)) {
        r->nplanes = 1;
        r->plane_w[0] = r->width; r->plane_h[0] = r->height;
        return;
    }
    r->nplanes = 3;
    int sub_w = 1, sub_h = 1;
    if (strstr(p, "420")) { sub_w = 2; sub_h = 2; }
    else if (strstr(p, "422")) { sub_w = 2; }
    r->plane_w[0] = r->width; r->plane_h[0] = r->height;
    for (int i = 1; i < 3; i++) {
        if (!strncmp(p, "gbr", 3)) {  // rgb planar: no subsampling
            r->plane_w[i] = r->width; r->plane_h[i] = r->height;
        } else {
            r->plane_w[i] = (r->width + sub_w - 1) / sub_w;
            r->plane_h[i] = (r->height + sub_h - 1) / sub_h;
        }
    }
}

// Parse one header line ending in '\n'.  Returns 0 on success.
static int parse_header(DspioReader* r) {
    // y4m headers can exceed 1 KiB (long/many X parameters); a short
    // fixed buffer would silently treat the header tail as frame data
    // and misplace data_start.  64 KiB covers anything sane; if no
    // newline fits, fail cleanly so open_input falls back to the
    // pure-Python reader instead of indexing garbage.
    char line[65536];
    if (!fgets(line, sizeof line, r->f)) return -1;
    if (!strchr(line, '\n')) return -3;
    char* save = nullptr;
    char* tok = strtok_r(line, " \n", &save);
    if (!tok) return -1;
    if (!strcmp(tok, "YUV4MPEG2")) {
        r->is_fvid = 0;
        strcpy(r->ctag, "420jpeg");
    } else if (!strcmp(tok, "DSPFVID")) {
        r->is_fvid = 1;
        strcpy(r->pixfmt, "gbrpf32le");
    } else {
        return -2;
    }
    while ((tok = strtok_r(nullptr, " \n", &save))) {
        switch (tok[0]) {
            case 'W': r->width = atoll(tok + 1); break;
            case 'H': r->height = atoll(tok + 1); break;
            case 'F': {
                char* colon = strchr(tok + 1, ':');
                if (colon) {
                    *colon = 0;
                    r->rate_num = atoll(tok + 1);
                    r->rate_den = atoll(colon + 1);
                }
                break;
            }
            case 'C':
                if (r->is_fvid)
                    snprintf(r->pixfmt, sizeof r->pixfmt, "%s", tok + 1);
                else
                    snprintf(r->ctag, sizeof r->ctag, "%s", tok + 1);
                break;
            default: break;  // I/A/X/R/T/S/P/L tags: metadata only
        }
    }
    if (r->is_fvid) set_planes_from_fvid(r); else set_planes_from_ctag(r);
    r->frame_bytes = compute_frame_bytes(r);
    r->data_start = ftell(r->f);
    return 0;
}

DspioReader* dspio_open(const char* path) {
    DspioReader* r = new DspioReader();
    r->f = fopen(path, "rb");
    if (!r->f) { delete r; return nullptr; }
    if (parse_header(r) != 0) { fclose(r->f); delete r; return nullptr; }
    // Index frame offsets (seekable files only).  Each marker line is
    // "FRAME[ params]\n" — parameters make positions irregular, so the
    // index is the only correct basis for counting and seeking.
    if (fseek(r->f, 0, SEEK_END) == 0) {
        int64_t end = ftell(r->f);
        fseek(r->f, r->data_start, SEEK_SET);
        for (;;) {
            int64_t pos = ftell(r->f);
            char marker[8];
            size_t got = fread(marker, 1, 6, r->f);
            if (got == 0) break;                       // clean EOF
            if (got != 6 || strncmp(marker, "FRAME", 5)) break;  // garbage tail
            if (marker[5] != '\n') {
                int ch;
                while ((ch = fgetc(r->f)) != EOF && ch != '\n') {}
            }
            int64_t payload = ftell(r->f);
            if (payload + r->frame_bytes > end) break; // truncated tail
            if (fseek(r->f, payload + r->frame_bytes, SEEK_SET) != 0) break;
            r->offsets.push_back(pos);
        }
        r->nframes = (int64_t)r->offsets.size();
        fseek(r->f, r->data_start, SEEK_SET);
    }
    return r;
}

int64_t dspio_width(DspioReader* r)      { return r->width; }
int64_t dspio_height(DspioReader* r)     { return r->height; }
int64_t dspio_nframes(DspioReader* r)    { return r->nframes; }
int64_t dspio_rate_num(DspioReader* r)   { return r->rate_num; }
int64_t dspio_rate_den(DspioReader* r)   { return r->rate_den; }
int     dspio_nplanes(DspioReader* r)    { return r->nplanes; }
int64_t dspio_plane_w(DspioReader* r, int i) { return r->plane_w[i]; }
int64_t dspio_plane_h(DspioReader* r, int i) { return r->plane_h[i]; }
int     dspio_is_float(DspioReader* r)   { return r->bytes_per_sample == 4; }
int     dspio_sample_bytes(DspioReader* r) { return r->bytes_per_sample; }
int64_t dspio_frame_bytes(DspioReader* r) { return r->frame_bytes; }
const char* dspio_pixfmt(DspioReader* r) { return r->is_fvid ? r->pixfmt : r->ctag; }

// Indexed-payload reader (round 4): any container whose frame payloads
// the host parser can index (the native NUT demux path — the Python
// NutReader walks the packet structure once and hands the offsets
// down; frame payload reads and the prefetch ring then run natively).
DspioReader* dspio_open_indexed(const char* path, const int64_t* offsets,
                                int64_t n, int64_t frame_bytes,
                                int nplanes, const int64_t* plane_w,
                                const int64_t* plane_h, int sample_bytes,
                                int64_t w, int64_t h,
                                int64_t rate_num, int64_t rate_den) {
    DspioReader* r = new DspioReader();
    r->f = fopen(path, "rb");
    if (!r->f) { delete r; return nullptr; }
    r->indexed = 1;
    r->width = w; r->height = h;
    r->rate_num = rate_num; r->rate_den = rate_den;
    r->frame_bytes = frame_bytes;
    r->nplanes = nplanes > 4 ? 4 : nplanes;
    for (int i = 0; i < r->nplanes; i++) {
        r->plane_w[i] = plane_w[i];
        r->plane_h[i] = plane_h[i];
    }
    r->bytes_per_sample = sample_bytes;
    r->offsets.assign(offsets, offsets + n);
    r->nframes = n;
    return r;
}

// Read frame payload (raw container bytes) into buf; returns 1 on
// success, 0 on EOF, negative on error.
int dspio_read_frame(DspioReader* r, uint8_t* buf) {
    if (r->indexed) {
        if (r->next_frame >= (int64_t)r->offsets.size()) return 0;
        if (fseek(r->f, r->offsets[(size_t)r->next_frame], SEEK_SET) != 0)
            return -1;
        if ((int64_t)fread(buf, 1, r->frame_bytes, r->f) != r->frame_bytes)
            return -1;
        r->next_frame++;
        return 1;
    }
    char marker[8];
    size_t got = fread(marker, 1, 6, r->f);
    if (got == 0) return 0;
    if (got != 6 || strncmp(marker, "FRAME", 5)) return -1;
    // tolerate y4m per-frame parameters ("FRAME Xfoo\n"): consume to EOL
    if (marker[5] != '\n') {
        int ch;
        while ((ch = fgetc(r->f)) != EOF && ch != '\n') {}
    }
    if ((int64_t)fread(buf, 1, r->frame_bytes, r->f) != r->frame_bytes)
        return 0;
    r->next_frame++;
    return 1;
}

int dspio_seek(DspioReader* r, int64_t frame) {
    if (r->nframes < 0 || frame < 0) return -1;
    int64_t off;
    if (frame >= (int64_t)r->offsets.size()) {
        if (r->offsets.empty()) return -1;
        off = -1;  // past-the-end: park at EOF so reads return 0
    } else {
        off = r->offsets[(size_t)frame];
    }
    if (off < 0) {
        if (fseek(r->f, 0, SEEK_END) != 0) return -1;
    } else if (fseek(r->f, off, SEEK_SET) != 0) {
        return -1;
    }
    r->next_frame = frame;
    return 0;
}

void dspio_close(DspioReader* r) {
    if (r) { if (r->f) fclose(r->f); delete r; }
}

// ---------------------------------------------------------------------------
// Prefetching reader: one background thread filling a frame ring.
// ---------------------------------------------------------------------------

struct DspioPrefetcher {
    DspioReader* r = nullptr;
    int depth = 0;
    std::vector<std::vector<uint8_t>> ring;
    std::vector<int> status;  // 0=empty, 1=full, 2=eof-marker, 3=error
    int64_t head = 0, tail = 0;  // head = next to consume, tail = next to fill
    std::mutex mu;
    std::condition_variable cv_full, cv_empty;
    std::thread th;
    std::atomic<bool> stop{false};
};

static void prefetch_loop(DspioPrefetcher* p) {
    for (;;) {
        std::unique_lock<std::mutex> lk(p->mu);
        p->cv_empty.wait(lk, [&] {
            return p->stop.load() || p->tail - p->head < p->depth;
        });
        if (p->stop.load()) return;
        int slot = p->tail % p->depth;
        lk.unlock();
        int rc = dspio_read_frame(p->r, p->ring[slot].data());
        lk.lock();
        p->status[slot] = (rc == 1) ? 1 : (rc == 0 ? 2 : 3);
        p->tail++;
        p->cv_full.notify_all();
        if (rc != 1) return;  // EOF/error: leave marker, stop
    }
}

DspioPrefetcher* dspio_prefetch_start(DspioReader* r, int depth) {
    DspioPrefetcher* p = new DspioPrefetcher();
    p->r = r;
    p->depth = depth > 0 ? depth : 4;
    p->ring.resize(p->depth);
    p->status.assign(p->depth, 0);
    for (auto& b : p->ring) b.resize(r->frame_bytes);
    p->th = std::thread(prefetch_loop, p);
    return p;
}

// Blocks until the next frame is available; returns 1 and copies into
// buf, 0 at EOF, or -1 on a mid-stream read error (corrupt marker —
// distinct from EOF so callers can fail instead of silently
// truncating).
int dspio_prefetch_next(DspioPrefetcher* p, uint8_t* buf) {
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv_full.wait(lk, [&] { return p->head < p->tail; });
    int slot = p->head % p->depth;
    int st = p->status[slot];
    if (st == 2) return 0;
    if (st == 3) return -1;
    memcpy(buf, p->ring[slot].data(), p->r->frame_bytes);
    p->status[slot] = 0;
    p->head++;
    p->cv_empty.notify_all();
    return 1;
}

void dspio_prefetch_stop(DspioPrefetcher* p) {
    if (!p) return;
    p->stop.store(true);
    p->cv_empty.notify_all();
    if (p->th.joinable()) p->th.join();
    delete p;
}

// ---------------------------------------------------------------------------
// Pel conversion
// ---------------------------------------------------------------------------

void dspio_u8_to_f32(const uint8_t* src, float* dst, int64_t n, float scale) {
    for (int64_t i = 0; i < n; i++) dst[i] = (float)src[i] * scale;
}

void dspio_f32_to_u8(const float* src, uint8_t* dst, int64_t n, float scale) {
    for (int64_t i = 0; i < n; i++) {
        float v = src[i] * scale;
        v = v < 0.f ? 0.f : (v > 255.f ? 255.f : v);
        dst[i] = (uint8_t)lrintf(v);
    }
}

// deinterleave [h*w, c] -> c planes of [h*w]
void dspio_deinterleave(const float* src, float* dst, int64_t n, int c) {
    for (int ch = 0; ch < c; ch++)
        for (int64_t i = 0; i < n; i++)
            dst[(int64_t)ch * n + i] = src[i * c + ch];
}

void dspio_interleave(const float* src, float* dst, int64_t n, int c) {
    for (int ch = 0; ch < c; ch++)
        for (int64_t i = 0; i < n; i++)
            dst[i * c + ch] = src[(int64_t)ch * n + i];
}

// ---------------------------------------------------------------------------
// Floyd-Steinberg dithering (reference motion/motion.c:778-787):
// in-place over a [h, w] float slice of pel values 0..255; returns the
// quantised values in-place.  Error diffusion in pel units (the
// coefficient-space scalings cancel; see
// dspfun_tpu/models/motion_pipeline.py:_dither_blocks).
// ---------------------------------------------------------------------------

void dspio_dither_fs(float* img, int64_t h, int64_t w) {
    std::vector<float> err_next(w + 2, 0.f);
    std::vector<float> err_cur(w + 2, 0.f);
    for (int64_t y = 0; y < h; y++) {
        std::swap(err_cur, err_next);
        std::fill(err_next.begin(), err_next.end(), 0.f);
        float err_right = 0.f;
        for (int64_t x = 0; x < w; x++) {
            float v = img[y * w + x] + err_cur[x + 1] + err_right;
            float q = v < 0.f ? 0.f : (v > 255.f ? 255.f : floorf(v + 0.5f));
            float dp = v - q;
            img[y * w + x] = q;
            err_right = dp * (7.f / 16.f);
            err_next[x] += dp * (3.f / 16.f);
            err_next[x + 1] += dp * (5.f / 16.f);
            err_next[x + 2] += dp * (1.f / 16.f);
        }
    }
}

// batched: [n, h, w]
void dspio_dither_fs_batch(float* img, int64_t n, int64_t h, int64_t w) {
    for (int64_t i = 0; i < n; i++) dspio_dither_fs(img + i * h * w, h, w);
}

}  // extern "C"
