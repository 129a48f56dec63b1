// The serial half of the port's image codec (lameness_tpu_torch/video/image.py):
// baseline JPEG Huffman decoding and encoding, and PNG unfiltering with
// Adam7 de-interlacing.  The transforms (dequantisation, IDCT, upsampling,
// colour conversion and their inverses) run as tensor ops on the caller's
// device; this file only moves bits.
//
// Plain C interface, loaded with ctypes (ops/_host.py), built with
// g++ -O3 -shared -fPIC.  Every entry returns 0 (or a byte count) on
// success and a negative LT_E* code on malformed input; nothing here
// allocates memory the caller must free.
#include <cstdint>
#include <cstring>

namespace {

enum {
    LT_OK = 0,
    LT_EBADTABLE = -1,     // a Huffman table that is not a prefix code
    LT_EBADCODE = -2,      // a bit pattern no code of the table matches
    LT_ERESTART = -3,      // the expected RSTn marker is not there
    LT_ETRUNCATED = -4,    // the scan needed bits past its end
    LT_ESYMBOL = -5,       // a symbol the encoder's table has no code for
    LT_EOVERFLOW = -6,     // the output buffer is too small
    LT_EFILTER = -7,       // a PNG row's filter type is not 0-4
    LT_ESHORT = -8,        // PNG image data shorter than the image
    LT_EBADSCAN = -9,      // a scan's components, sampling or table ids
};

// A scan's description as the file gave it: 1-4 components, sampling 1-4,
// DC and AC table ids 0-3, MCU counts and restart interval not negative.
// Checked before anything is indexed by it.
bool scan_in_range(int32_t ncomp, const int32_t *comp, int32_t mcus_x,
                   int32_t mcus_y) {
    if (ncomp < 1 || ncomp > 4 || mcus_x < 0 || mcus_y < 0) return false;
    for (int c = 0; c < ncomp; ++c) {
        const int32_t *cs = comp + c * 5;
        if (cs[0] < 1 || cs[0] > 4 || cs[1] < 1 || cs[1] > 4) return false;
        if (cs[2] < 0 || cs[2] > 3 || cs[3] < 0 || cs[3] > 3) return false;
        if (cs[4] < 0) return false;
    }
    return true;
}

// zigzag position -> natural (row-major) index
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ---------------------------------------------------------------------------
// JPEG decoding
// ---------------------------------------------------------------------------
struct DecTable {
    int32_t maxcode[18];     // largest code of each length, -1 if none
    int32_t valoffset[17];   // code + valoffset[len] = index into vals
    uint8_t vals[256];
    uint8_t look_len[256];   // codes of <= 8 bits by their first 8 bits
    uint8_t look_sym[256];
};

// bits[16]: the count of codes of each length 1..16 (as in DHT), vals[256]
int build_dec_table(const uint8_t *bits, const uint8_t *vals, DecTable *t) {
    int32_t code = 0, k = 0;
    std::memset(t->look_len, 0, sizeof(t->look_len));
    for (int len = 1; len <= 16; ++len) {
        int n = bits[len - 1];
        t->valoffset[len] = k - code;
        for (int i = 0; i < n; ++i, ++code, ++k) {
            if (k >= 256) return LT_EBADTABLE;
            if (len <= 8) {
                int shift = 8 - len;
                for (int j = 0; j < (1 << shift); ++j) {
                    t->look_len[(code << shift) | j] = (uint8_t)len;
                    t->look_sym[(code << shift) | j] = vals[k];
                }
            }
        }
        if (code > (1 << len)) return LT_EBADTABLE;
        t->maxcode[len] = n ? code - 1 : -1;
        code <<= 1;
    }
    t->maxcode[17] = 0x7fffffff;
    std::memcpy(t->vals, vals, 256);
    return LT_OK;
}

struct BitReader {
    const uint8_t *p, *end;
    uint64_t acc = 0;      // left-aligned
    int nbits = 0;
    int fake = 0;          // zero bits inserted past a marker or the end
    bool at_marker = false;

    void fill() {
        while (nbits <= 56) {
            uint32_t byte = 0;
            if (at_marker || p >= end) {
                fake += 8;
            } else if (*p != 0xFF) {
                byte = *p++;
            } else {
                const uint8_t *q = p + 1;
                while (q < end && *q == 0xFF) ++q;     // fill bytes
                if (q < end && *q == 0x00) {
                    byte = 0xFF;
                    p = q + 1;
                } else {                               // a marker
                    at_marker = true;
                    p = q - 1;
                    fake += 8;
                }
            }
            acc |= (uint64_t)byte << (56 - nbits);
            nbits += 8;
        }
    }
    uint32_t get(int n) {
        if (n == 0) return 0;
        if (nbits < n) fill();
        uint32_t v = (uint32_t)(acc >> (64 - n));
        acc <<= n;
        nbits -= n;
        return v;
    }
    int decode(const DecTable &t) {
        if (nbits < 16) fill();
        int look = (int)(acc >> 56);
        int len = t.look_len[look];
        if (len) {
            acc <<= len;
            nbits -= len;
            return t.look_sym[look];
        }
        len = 9;
        int32_t code = (int32_t)(acc >> (64 - 9));
        while (code > t.maxcode[len]) {
            if (++len > 16) return LT_EBADCODE;
            code = (int32_t)(acc >> (64 - len));
        }
        acc <<= len;
        nbits -= len;
        return t.vals[code + t.valoffset[len]];
    }
    bool overrun() const { return nbits < fake; }
};

inline int32_t extend(uint32_t v, int s) {
    return v < (1u << (s - 1)) ? (int32_t)v - (1 << s) + 1 : (int32_t)v;
}

}  // namespace

extern "C" {

// One scan of a baseline (or extended 8-bit Huffman) JPEG.
//   data, len:   the entropy-coded segment, from just after the SOS header
//   ncomp:       components in the scan (1-4)
//   comp:        ncomp x 5 int32: h, v (1, 1 for a one-component scan),
//                DC table, AC table (0-3), the buffer's row stride in blocks;
//                out of range: LT_EBADSCAN, before anything is read
//   coefs:       ncomp pointers to int16 blocks (64 each, natural order),
//                each holding mcus_y * v rows of mcus_x * h blocks (the
//                caller's bound: the library cannot see the buffers' sizes)
//   bits, vals:  8 tables (DC 0-3, then AC 0-3) of 16 counts and 256 symbols
//   mcus_x/y:    MCUs across and down; restart: MCUs an interval (0: none)
//   end:         out, the offset of the first byte not consumed
int lt_jpeg_decode_scan(const uint8_t *data, int64_t len, int32_t ncomp,
                        const int32_t *comp, int16_t **coefs,
                        const uint8_t *bits, const uint8_t *vals,
                        int32_t mcus_x, int32_t mcus_y, int32_t restart,
                        int64_t *end) {
    if (!scan_in_range(ncomp, comp, mcus_x, mcus_y) || restart < 0 || len < 0)
        return LT_EBADSCAN;
    DecTable tables[8];
    for (int c = 0; c < ncomp; ++c)
        for (int which = 0; which < 2; ++which) {
            int t = comp[c * 5 + 2 + which] + 4 * which;
            int rc = build_dec_table(bits + 16 * t, vals + 256 * t, &tables[t]);
            if (rc) return rc;
        }
    BitReader br;
    br.p = data;
    br.end = data + len;
    int32_t pred[4] = {0, 0, 0, 0};
    int64_t n_mcus = (int64_t)mcus_x * mcus_y;
    int rst = 0;
    for (int64_t m = 0; m < n_mcus; ++m) {
        if (restart && m && m % restart == 0) {
            if (br.overrun()) return LT_ETRUNCATED;
            // the rest of the byte is padding; the marker must come next
            br.acc = 0;
            br.nbits = 0;
            br.fake = 0;
            br.at_marker = false;
            const uint8_t *q = br.p;
            while (q < br.end && *q == 0xFF) ++q;
            if (q == br.p || q >= br.end || *q != 0xD0 + rst) return LT_ERESTART;
            br.p = q + 1;
            rst = (rst + 1) & 7;
            for (int c = 0; c < 4; ++c) pred[c] = 0;
        }
        int64_t mx = m % mcus_x, my = m / mcus_x;
        for (int c = 0; c < ncomp; ++c) {
            const int32_t *cs = comp + c * 5;
            const DecTable &dc = tables[cs[2]];
            const DecTable &ac = tables[4 + cs[3]];
            for (int by = 0; by < cs[1]; ++by)
                for (int bx = 0; bx < cs[0]; ++bx) {
                    int64_t row = my * cs[1] + by, col = mx * cs[0] + bx;
                    int16_t *blk = coefs[c] + (row * cs[4] + col) * 64;
                    std::memset(blk, 0, 64 * sizeof(int16_t));
                    int s = br.decode(dc);
                    if (s < 0) return s;
                    if (s > 15) return LT_EBADCODE;
                    if (s) pred[c] += extend(br.get(s), s);
                    blk[0] = (int16_t)pred[c];
                    for (int k = 1; k < 64; ++k) {
                        int rs = br.decode(ac);
                        if (rs < 0) return rs;
                        int r = rs >> 4;
                        s = rs & 15;
                        if (s) {
                            k += r;
                            // libjpeg's natural order runs on to 63 past k = 63
                            blk[k > 63 ? 63 : kNatural[k]] =
                                (int16_t)extend(br.get(s), s);
                        } else if (r == 15) {
                            k += 15;
                        } else {
                            break;
                        }
                    }
                }
        }
    }
    if (br.overrun()) return LT_ETRUNCATED;
    *end = br.p - data;
    return LT_OK;
}

// ---------------------------------------------------------------------------
// JPEG encoding (one interleaved or one-component scan, no restarts)
// ---------------------------------------------------------------------------
// Arguments as lt_jpeg_decode_scan's, the blocks read (quantised, natural
// order); the entropy-coded bytes go to out (capacity cap), stuffed and
// padded with 1-bits as libjpeg pads them.  Returns the byte count.
int64_t lt_jpeg_encode_scan(int32_t ncomp, const int32_t *comp,
                            int16_t *const *coefs, const uint8_t *bits,
                            const uint8_t *vals, int32_t mcus_x,
                            int32_t mcus_y, uint8_t *out, int64_t cap) {
    if (!scan_in_range(ncomp, comp, mcus_x, mcus_y)) return LT_EBADSCAN;
    uint16_t code[8][256];
    uint8_t size[8][256];
    std::memset(size, 0, sizeof(size));
    for (int t = 0; t < 8; ++t) {
        uint32_t c = 0;
        int k = 0;
        for (int len = 1; len <= 16; ++len) {
            for (int i = 0; i < bits[16 * t + len - 1]; ++i, ++c, ++k) {
                if (k >= 256) return LT_EBADTABLE;
                uint8_t sym = vals[256 * t + k];
                code[t][sym] = (uint16_t)c;
                size[t][sym] = (uint8_t)len;
            }
            if (c > (1u << len)) return LT_EBADTABLE;
            c <<= 1;
        }
    }
    int64_t n = 0;
    uint64_t acc = 0;      // right-aligned pending bits
    int nacc = 0;
    bool full = false;
    auto put = [&](uint32_t v, int nb) {
        acc = (acc << nb) | (v & ((1u << nb) - 1));
        nacc += nb;
        while (nacc >= 8) {
            uint8_t b = (uint8_t)(acc >> (nacc - 8));
            nacc -= 8;
            if (n + 2 > cap) { full = true; return; }
            out[n++] = b;
            if (b == 0xFF) out[n++] = 0;
        }
    };
    auto sym = [&](int t, int s) -> bool {
        if (!size[t][s]) return false;
        put(code[t][s], size[t][s]);
        return true;
    };
    int32_t pred[4] = {0, 0, 0, 0};
    int64_t n_mcus = (int64_t)mcus_x * mcus_y;
    for (int64_t m = 0; m < n_mcus && !full; ++m) {
        int64_t mx = m % mcus_x, my = m / mcus_x;
        for (int c = 0; c < ncomp; ++c) {
            const int32_t *cs = comp + c * 5;
            int dct = cs[2], act = 4 + cs[3];
            for (int by = 0; by < cs[1]; ++by)
                for (int bx = 0; bx < cs[0]; ++bx) {
                    int64_t row = my * cs[1] + by, col = mx * cs[0] + bx;
                    const int16_t *blk = coefs[c] + (row * cs[4] + col) * 64;
                    int32_t diff = blk[0] - pred[c];
                    pred[c] = blk[0];
                    int32_t mag = diff < 0 ? -diff : diff;
                    int nb = 0;
                    while (mag >> nb) ++nb;
                    if (!sym(dct, nb)) return LT_ESYMBOL;
                    if (nb) put((uint32_t)(diff < 0 ? diff - 1 : diff), nb);
                    int run = 0;
                    for (int k = 1; k < 64; ++k) {
                        int32_t v = blk[kNatural[k]];
                        if (v == 0) { ++run; continue; }
                        while (run > 15) {
                            if (!sym(act, 0xF0)) return LT_ESYMBOL;
                            run -= 16;
                        }
                        mag = v < 0 ? -v : v;
                        nb = 0;
                        while (mag >> nb) ++nb;
                        if (nb > 15 || !sym(act, (run << 4) | nb)) return LT_ESYMBOL;
                        put((uint32_t)(v < 0 ? v - 1 : v), nb);
                        run = 0;
                    }
                    if (run && !sym(act, 0x00)) return LT_ESYMBOL;
                }
        }
    }
    if (nacc) put(0x7F, 8 - nacc);
    return full ? LT_EOVERFLOW : n;
}

// ---------------------------------------------------------------------------
// PNG
// ---------------------------------------------------------------------------
// The inflated IDAT stream of a w x h image at `depth` bits per sample and
// `channels` samples per pixel (after the palette index, 1), interlaced
// (Adam7) or not: each row unfiltered, its samples unpacked (MSB first
// below 8 bits, big-endian at 16) into out[(y * w + x) * channels + c].
int lt_png_decode(const uint8_t *raw, int64_t len, int32_t w, int32_t h,
                  int32_t depth, int32_t channels, int32_t interlace,
                  uint16_t *out, uint8_t *scratch) {
    static const int kPass[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                                    {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                                    {0, 1, 1, 2}};
    static const int kWhole[1][4] = {{0, 0, 1, 1}};
    const int (*passes)[4] = interlace ? kPass : kWhole;
    int n_passes = interlace ? 7 : 1;
    int64_t pix_bits = (int64_t)depth * channels;
    int bpp = (int)((pix_bits + 7) / 8);         // the filters' byte distance
    int64_t pos = 0;
    for (int p = 0; p < n_passes; ++p) {
        int x0 = passes[p][0], y0 = passes[p][1];
        int dx = passes[p][2], dy = passes[p][3];
        int64_t pw = w > x0 ? (w - x0 + dx - 1) / dx : 0;
        int64_t ph = h > y0 ? (h - y0 + dy - 1) / dy : 0;
        if (pw == 0 || ph == 0) continue;
        int64_t rowbytes = (pw * pix_bits + 7) / 8;
        uint8_t *prev = scratch, *cur = scratch + rowbytes;
        std::memset(prev, 0, rowbytes);
        for (int64_t r = 0; r < ph; ++r) {
            if (pos + 1 + rowbytes > len) return LT_ESHORT;
            int f = raw[pos];
            const uint8_t *src = raw + pos + 1;
            pos += 1 + rowbytes;
            for (int64_t i = 0; i < rowbytes; ++i) {
                int a = i >= bpp ? cur[i - bpp] : 0;
                int b = prev[i];
                int c = i >= bpp ? prev[i - bpp] : 0;
                int x = src[i];
                switch (f) {
                    case 0: break;
                    case 1: x += a; break;
                    case 2: x += b; break;
                    case 3: x += (a + b) >> 1; break;
                    case 4: {
                        int pp = a + b - c;
                        int pa = pp > a ? pp - a : a - pp;
                        int pb = pp > b ? pp - b : b - pp;
                        int pc = pp > c ? pp - c : c - pp;
                        x += (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                        break;
                    }
                    default: return LT_EFILTER;
                }
                cur[i] = (uint8_t)x;
            }
            int64_t y = y0 + r * dy;
            for (int64_t col = 0; col < pw; ++col) {
                int64_t x = x0 + col * dx;
                uint16_t *dst = out + (y * w + x) * channels;
                for (int c = 0; c < channels; ++c) {
                    int64_t s = col * channels + c;
                    uint16_t v;
                    if (depth == 8) {
                        v = cur[s];
                    } else if (depth == 16) {
                        v = (uint16_t)((cur[2 * s] << 8) | cur[2 * s + 1]);
                    } else {
                        int64_t bit = s * depth;
                        int shift = 8 - depth - (int)(bit & 7);
                        v = (uint16_t)((cur[bit >> 3] >> shift) & ((1 << depth) - 1));
                    }
                    dst[c] = v;
                }
            }
            uint8_t *t = prev;
            prev = cur;
            cur = t;
        }
    }
    return LT_OK;
}

}  // extern "C"
