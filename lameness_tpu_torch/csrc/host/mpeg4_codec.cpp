// The bitstream half of the port's MPEG-4 Part 2 codec
// (lameness_tpu_torch/video/mpeg4.py): Simple Profile headers, macroblock
// syntax, the variable-length codes, and the intra DC/AC and motion-vector
// predictions, which are sequential.  The transforms (inverse quantisation,
// IDCT, motion compensation, and the forward path of the encoder) run as
// tensor ops on the caller's device; this file only moves bits.
//
// The decoder follows FFmpeg's mpeg4 decoder (the yardstick OpenCV's reader
// uses) where the standard leaves room: the DC marker bit is not checked,
// a video packet's neighbours are those of the packet, and the third
// escape's marker bits are.  Advanced Simple Profile tools, shapes other
// than rectangular, data partitioning and the other optional VOL tools are
// refused with their own error code.
//
// Plain C interface, loaded with ctypes (ops/_host.py), built with
// g++ -O3 -shared -fPIC.  Every entry returns 0 (or a byte count) on
// success and a negative LT_E* code on malformed or unsupported input; every
// read is bounded by the buffer it reads and every write by the buffer's
// size the caller passes.
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

enum {
    LT_OK = 0,
    LT_ETRUNCATED = -1,    // the stream needed bits past its end
    LT_EBADCODE = -2,      // a bit pattern no code of the table matches
    LT_EMARKER = -3,       // a marker bit the syntax requires is 0
    LT_ENOVOL = -4,        // a VOP before any video object layer header
    LT_ENOVOP = -5,        // a sample with no VOP start code
    LT_EINDEX = -6,        // a coefficient run past the block's 64th
    LT_EPACKET = -7,       // a video packet header that does not follow on
    LT_ESIZE = -8,         // the picture does not fit the caller's buffers
    LT_EOVERFLOW = -9,     // the output buffer is too small
    LT_EBADVALUE = -10,    // a field outside its range (f_code 0, QP 0, ...)
    LT_ESHAPE = -20,       // video_object_layer_shape other than rectangular
    LT_EINTERLACED = -21,  // interlaced video
    LT_ESPRITE = -22,      // sprites or global motion compensation
    LT_ENOT8BIT = -23,     // not_8_bit
    LT_EMPEGQUANT = -24,   // quant_type 1 (MPEG quantisation matrices)
    LT_EQPEL = -25,        // quarter_sample
    LT_ECOMPLEXITY = -26,  // complexity estimation headers
    LT_EPARTITION = -27,   // data partitioning
    LT_ENEWPRED = -28,     // newpred
    LT_EREDUCED = -29,     // reduced resolution VOPs
    LT_ESCALABLE = -30,    // scalability
    LT_EBVOP = -31,        // a B-VOP
    LT_ESVOP = -32,        // an S-VOP
    LT_ECHROMA = -33,      // a chroma format other than 4:2:0
    LT_EPACKED = -34,      // two VOPs in one sample (packed bitstream)
    LT_EDC = -11,          // a DC size past 9, or a negative DC (FFmpeg's
                           // decoder refuses both)
};

// ---------------------------------------------------------------------------
// tables (ISO/IEC 14496-2 Annex B; H.263 for MCBPC, CBPY and MVD)
// ---------------------------------------------------------------------------
struct Code { uint16_t code; uint8_t len; };

// I-VOP MCBPC: index = 4 * dquant + cbpc, 8 = stuffing
const Code kIntraMcbpc[9] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}, {1, 4},
                             {1, 6}, {2, 6}, {3, 6}, {1, 9}};
// P-VOP MCBPC: index = 4 * type + cbpc with type 0 inter, 1 intra,
// 2 inter+q, 3 intra+q, 4 inter4v; 20 = stuffing
const Code kInterMcbpc[21] = {
    {1, 1}, {3, 4}, {2, 4}, {5, 6}, {3, 5}, {4, 8}, {3, 8}, {3, 7},
    {3, 3}, {7, 7}, {6, 7}, {5, 9}, {4, 6}, {4, 9}, {3, 9}, {2, 9},
    {2, 3}, {5, 7}, {4, 7}, {5, 8}, {1, 9}};
// CBPY by the intra value (inter MBs code 15 - cbpy)
const Code kCbpy[16] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4},
                        {2, 6}, {11, 4}, {2, 5}, {3, 6}, {5, 4}, {10, 4},
                        {4, 4}, {8, 4}, {6, 4}, {3, 2}};
const Code kDcLum[13] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3}, {1, 4}, {1, 5},
                         {1, 6}, {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}};
const Code kDcChrom[13] = {{3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4}, {1, 5},
                           {1, 6}, {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11},
                           {1, 12}};
// MVD by |value| (a sign bit follows every code but the first)
const Code kMvd[33] = {
    {1, 1}, {1, 2}, {1, 3}, {1, 4}, {3, 6}, {5, 7}, {4, 7}, {3, 7},
    {11, 9}, {10, 9}, {9, 9}, {17, 10}, {16, 10}, {15, 10}, {14, 10},
    {13, 10}, {12, 10}, {11, 10}, {10, 10}, {9, 10}, {8, 10}, {7, 10},
    {6, 10}, {5, 10}, {4, 10}, {7, 11}, {6, 11}, {5, 11}, {4, 11}, {3, 11},
    {2, 11}, {3, 12}, {2, 12}};

// TCOEF: 102 (last, run, level) events then the escape; the events with
// index >= the table's `last` start have last = 1
const Code kIntraTcoef[103] = {
    {2, 2}, {6, 3}, {15, 4}, {13, 5}, {12, 5}, {21, 6}, {19, 6}, {18, 6},
    {23, 7}, {31, 8}, {30, 8}, {29, 8}, {37, 9}, {36, 9}, {35, 9}, {33, 9},
    {33, 10}, {32, 10}, {15, 10}, {14, 10}, {7, 11}, {6, 11}, {32, 11},
    {33, 11}, {80, 12}, {81, 12}, {82, 12}, {14, 4}, {20, 6}, {22, 7},
    {28, 8}, {32, 9}, {31, 9}, {13, 10}, {34, 11}, {83, 12}, {85, 12},
    {11, 5}, {21, 7}, {30, 9}, {12, 10}, {86, 12}, {17, 6}, {27, 8},
    {29, 9}, {11, 10}, {16, 6}, {34, 9}, {10, 10}, {13, 6}, {28, 9},
    {8, 10}, {18, 7}, {27, 9}, {84, 12}, {20, 7}, {26, 9}, {87, 12},
    {25, 8}, {9, 10}, {24, 8}, {35, 11}, {23, 8}, {25, 9}, {24, 9},
    {7, 10}, {88, 12}, {7, 4}, {12, 6}, {22, 8}, {23, 9}, {6, 10},
    {5, 11}, {4, 11}, {89, 12}, {15, 6}, {22, 9}, {5, 10}, {14, 6},
    {4, 10}, {17, 7}, {36, 11}, {16, 7}, {37, 11}, {19, 7}, {90, 12},
    {21, 8}, {91, 12}, {20, 8}, {19, 8}, {26, 8}, {21, 9}, {20, 9},
    {19, 9}, {18, 9}, {17, 9}, {38, 11}, {39, 11}, {92, 12}, {93, 12},
    {94, 12}, {95, 12}, {3, 7}};
const int8_t kIntraRun[102] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2,
    3, 3, 3, 3, 4, 4, 4, 5, 5, 5, 6, 6, 6, 7, 7, 7, 8, 8, 9, 9, 10,
    11, 12, 13, 14, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 2, 2, 3, 3, 4,
    4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20};
const int8_t kIntraLevel[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 1, 2, 3,
    4, 5, 1, 2, 3, 4, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 1, 2,
    1, 1, 1, 1, 1, 1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3, 1, 2, 1, 2, 1, 2,
    1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
const int kIntraLast = 67;
const Code kInterTcoef[103] = {
    {2, 2}, {15, 4}, {21, 6}, {23, 7}, {31, 8}, {37, 9}, {36, 9}, {33, 10},
    {32, 10}, {7, 11}, {6, 11}, {32, 11}, {6, 3}, {20, 6}, {30, 8},
    {15, 10}, {33, 11}, {80, 12}, {14, 4}, {29, 8}, {14, 10}, {81, 12},
    {13, 5}, {35, 9}, {13, 10}, {12, 5}, {34, 9}, {82, 12}, {11, 5},
    {12, 10}, {83, 12}, {19, 6}, {11, 10}, {84, 12}, {18, 6}, {10, 10},
    {17, 6}, {9, 10}, {16, 6}, {8, 10}, {22, 7}, {85, 12}, {21, 7},
    {20, 7}, {28, 8}, {27, 8}, {33, 9}, {32, 9}, {31, 9}, {30, 9},
    {29, 9}, {28, 9}, {27, 9}, {26, 9}, {34, 11}, {35, 11}, {86, 12},
    {87, 12}, {7, 4}, {25, 9}, {5, 11}, {15, 6}, {4, 11}, {14, 6},
    {13, 6}, {12, 6}, {19, 7}, {18, 7}, {17, 7}, {16, 7}, {26, 8},
    {25, 8}, {24, 8}, {23, 8}, {22, 8}, {21, 8}, {20, 8}, {19, 8},
    {24, 9}, {23, 9}, {22, 9}, {21, 9}, {20, 9}, {19, 9}, {18, 9},
    {17, 9}, {7, 10}, {6, 10}, {5, 10}, {4, 10}, {36, 11}, {37, 11},
    {38, 11}, {39, 11}, {88, 12}, {89, 12}, {90, 12}, {91, 12}, {92, 12},
    {93, 12}, {94, 12}, {95, 12}, {3, 7}};
const int8_t kInterRun[102] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 2, 2, 2,
    2, 3, 3, 3, 4, 4, 4, 5, 5, 5, 6, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10,
    11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 0, 0, 0,
    1, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37,
    38, 39, 40};
const int8_t kInterLevel[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 1, 2, 3, 4, 5, 6, 1, 2, 3,
    4, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 2, 1, 2,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 3, 1, 2, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
const int kInterLast = 58;

// scan position -> natural (row-major) index
const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
const uint8_t kAltHorizontal[64] = {
    0,  1,  2,  3,  8,  9,  16, 17, 10, 11, 4,  5,  6,  7,  15, 14,
    13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
    30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
    46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
const uint8_t kAltVertical[64] = {
    0,  8,  16, 24, 1,  9,  2,  10, 17, 25, 32, 40, 48, 56, 57, 49,
    41, 33, 26, 18, 3,  11, 4,  12, 19, 27, 34, 42, 50, 58, 35, 43,
    51, 59, 20, 28, 5,  13, 6,  14, 21, 29, 36, 44, 52, 60, 37, 45,
    53, 61, 22, 30, 7,  15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};

const uint8_t kYDcScale[32] = {0,  8,  8,  8,  8,  10, 12, 14, 16, 17, 18,
                               19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
                               30, 31, 32, 34, 36, 38, 40, 42, 44, 46};
const uint8_t kCDcScale[32] = {0,  8,  8,  8,  8,  9,  9,  10, 10, 11, 11,
                               12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17,
                               17, 18, 18, 19, 20, 21, 22, 23, 24, 25};
const int kDquant[4] = {-1, -2, 1, 2};
// intra_dc_vlc_thr -> the QP from which intra DC is coded as an AC
// coefficient (32: never)
const int kDcThreshold[8] = {32, 13, 15, 17, 19, 21, 23, 0};

// A prefix code looked up by its next 13 bits.
const int kLookBits = 13;
struct Lookup {
    int16_t sym[1 << kLookBits];
    uint8_t len[1 << kLookBits];   // 0: no code starts with these bits
};

void build_lookup(const Code *codes, int n, Lookup *t) {
    std::memset(t->len, 0, sizeof(t->len));
    for (int s = 0; s < n; ++s) {
        int shift = kLookBits - codes[s].len;
        for (int j = 0; j < (1 << shift); ++j) {
            int i = (codes[s].code << shift) | j;
            t->sym[i] = (int16_t)s;
            t->len[i] = codes[s].len;
        }
    }
}

struct RlTable {
    const Code *codes;
    const int8_t *run;
    const int8_t *level;
    int last;                   // first index with last = 1
    int8_t max_level[2][64];    // LMAX by (last, run), 0 past the table
    int8_t max_run[2][65];      // RMAX by (last, level), -1 past the table
    int16_t index[2][64][28];   // event -> code index, -1 if none
    Lookup look;
};

void build_rl(RlTable *t, const Code *codes, const int8_t *run,
              const int8_t *level, int last) {
    t->codes = codes;
    t->run = run;
    t->level = level;
    t->last = last;
    std::memset(t->max_level, 0, sizeof(t->max_level));
    std::memset(t->max_run, -1, sizeof(t->max_run));
    std::memset(t->index, -1, sizeof(t->index));
    for (int i = 0; i < 102; ++i) {
        int l = i >= last, r = run[i], v = level[i];
        if (v > t->max_level[l][r]) t->max_level[l][r] = (int8_t)v;
        if (r > t->max_run[l][v]) t->max_run[l][v] = (int8_t)r;
        t->index[l][r][v] = (int16_t)i;
    }
    build_lookup(codes, 103, &t->look);
}

struct Tables {
    Lookup intra_mcbpc, inter_mcbpc, cbpy, dc_lum, dc_chrom, mvd;
    RlTable intra, inter;
    Tables() {
        build_lookup(kIntraMcbpc, 9, &intra_mcbpc);
        build_lookup(kInterMcbpc, 21, &inter_mcbpc);
        build_lookup(kCbpy, 16, &cbpy);
        build_lookup(kDcLum, 13, &dc_lum);
        build_lookup(kDcChrom, 13, &dc_chrom);
        build_lookup(kMvd, 33, &mvd);
        build_rl(&intra, kIntraTcoef, kIntraRun, kIntraLevel, kIntraLast);
        build_rl(&inter, kInterTcoef, kInterRun, kInterLevel, kInterLast);
    }
};

const Tables &tables() {
    static const Tables t;
    return t;
}

// ---------------------------------------------------------------------------
// bits
// ---------------------------------------------------------------------------
struct BitReader {
    const uint8_t *d;
    int64_t nbits;
    int64_t pos = 0;
    BitReader(const uint8_t *data, int64_t n) : d(data), nbits(n * 8) {}
    // the next k <= 25 bits, zeros past the end
    uint32_t peek(int k) const {
        uint32_t v = 0;
        int64_t byte = pos >> 3;
        for (int i = 0; i < 4; ++i) {
            v <<= 8;
            if (byte + i < (nbits >> 3) && byte + i >= 0) v |= d[byte + i];
        }
        return (v << (pos & 7)) >> (32 - k);
    }
    uint32_t get(int k) {
        if (k == 0) return 0;
        uint32_t v = peek(k);
        pos += k;
        return v;
    }
    int32_t get_signed(int k) {
        int32_t v = (int32_t)get(k);
        return v >= (1 << (k - 1)) ? v - (1 << k) : v;
    }
    bool overrun() const { return pos > nbits; }
    int64_t left() const { return nbits - pos; }
    void align() { pos = (pos + 7) & ~int64_t(7); }
    // a VLC symbol, or -1 for a pattern no code matches
    int vlc(const Lookup &t) {
        uint32_t i = peek(kLookBits);
        if (!t.len[i]) return -1;
        pos += t.len[i];
        return t.sym[i];
    }
};

struct BitWriter {
    uint8_t *out;
    int64_t cap;
    int64_t n = 0;        // whole bytes written
    uint64_t acc = 0;
    int nacc = 0;
    bool full = false;
    BitWriter(uint8_t *o, int64_t c) : out(o), cap(c) {}
    void put(uint32_t v, int k) {
        if (k == 0) return;
        acc = (acc << k) | (v & ((k == 32) ? 0xFFFFFFFFu : ((1u << k) - 1)));
        nacc += k;
        while (nacc >= 8) {
            nacc -= 8;
            if (n < cap) out[n] = (uint8_t)(acc >> nacc);
            else full = true;
            ++n;
        }
    }
    void put_code(const Code &c) { put(c.code, c.len); }
    int bits() const { return (int)((n * 8 + nacc) & 7); }
    // MPEG-4 stuffing: a 0 then 1s to the byte boundary (a whole byte
    // 0x7F when already aligned)
    void stuffing() {
        put(0, 1);
        int k = (8 - bits()) & 7;
        put((1u << k) - 1, k);
    }
    void start_code(uint32_t code) { put(0, 16); put(0x100 | code, 16); }
};

// the first start code 00 00 01 xx at or after byte `from`, or -1
int64_t find_start(const uint8_t *d, int64_t n, int64_t from) {
    for (int64_t i = from; i + 3 < n; ++i)
        if (d[i] == 0 && d[i + 1] == 0 && d[i + 2] == 1) return i;
    return -1;
}

// ---------------------------------------------------------------------------
// headers
// ---------------------------------------------------------------------------
// The VOL state the caller keeps between samples (int32 vol[16]).
enum {
    V_HAVE = 0, V_WIDTH, V_HEIGHT, V_TIME_RES, V_TINC_BITS, V_RESYNC_DISABLE,
    V_VERID, V_LOW_DELAY, V_COUNT = 16
};

int parse_vol(BitReader &br, int32_t *vol) {
    br.get(1);                               // random_accessible_vol
    br.get(8);                               // video_object_type_indication
    int verid = 1;
    if (br.get(1)) {                         // is_object_layer_identifier
        verid = (int)br.get(4);
        br.get(3);                           // priority
    }
    if (br.get(4) == 15) br.get(16);         // aspect ratio: par w, h
    int low_delay = 1;
    if (br.get(1)) {                         // vol_control_parameters
        if (br.get(2) != 1) return LT_ECHROMA;
        low_delay = (int)br.get(1);
        if (br.get(1)) {                     // vbv_parameters
            br.get(15); br.get(1); br.get(15); br.get(1);
            br.get(15); br.get(1); br.get(3); br.get(11); br.get(1);
            br.get(15); br.get(1);
        }
    }
    if (br.get(2) != 0) return LT_ESHAPE;
    if (!br.get(1)) return LT_EMARKER;
    int time_res = (int)br.get(16);
    if (time_res == 0) return LT_EBADVALUE;
    if (!br.get(1)) return LT_EMARKER;
    int bits = 1;
    while ((1 << bits) < time_res) ++bits;   // av_log2(res - 1) + 1, >= 1
    if (br.get(1)) br.get(bits);             // fixed_vop_rate, increment
    if (!br.get(1)) return LT_EMARKER;
    int width = (int)br.get(13);
    if (!br.get(1)) return LT_EMARKER;
    int height = (int)br.get(13);
    if (!br.get(1)) return LT_EMARKER;
    if (br.get(1)) return LT_EINTERLACED;
    br.get(1);                               // obmc_disable
    if (br.get(verid == 1 ? 1 : 2)) return LT_ESPRITE;
    if (br.get(1)) return LT_ENOT8BIT;
    if (br.get(1)) return LT_EMPEGQUANT;
    if (verid != 1 && br.get(1)) return LT_EQPEL;
    if (!br.get(1)) return LT_ECOMPLEXITY;
    int resync_disable = (int)br.get(1);
    if (br.get(1)) return LT_EPARTITION;
    if (verid != 1) {
        if (br.get(1)) return LT_ENEWPRED;
        if (br.get(1)) return LT_EREDUCED;
    }
    if (br.get(1)) return LT_ESCALABLE;
    if (br.overrun()) return LT_ETRUNCATED;
    if (width <= 0 || height <= 0) return LT_EBADVALUE;
    vol[V_HAVE] = 1;
    vol[V_WIDTH] = width;
    vol[V_HEIGHT] = height;
    vol[V_TIME_RES] = time_res;
    vol[V_TINC_BITS] = bits;
    vol[V_RESYNC_DISABLE] = resync_disable;
    vol[V_VERID] = verid;
    vol[V_LOW_DELAY] = low_delay;
    return LT_OK;
}

// Walk the start codes of `d`: VOS, VO, VOL, GOV and user data are read
// (a VOL into `vol`); returns the offset of the first VOP start code, -1
// when there is none, or a negative LT_E* below -1.
int64_t read_headers(const uint8_t *d, int64_t n, int32_t *vol) {
    int64_t at = find_start(d, n, 0);
    while (at >= 0) {
        uint8_t code = d[at + 3];
        if (code == 0xB6) return at;
        if (code >= 0x20 && code <= 0x2F) {
            BitReader br(d + at + 4, n - at - 4);
            int rc = parse_vol(br, vol);
            if (rc) return rc < -1 ? rc : LT_EBADVALUE;
        }
        at = find_start(d, n, at + 4);
    }
    return -1;
}

// ---------------------------------------------------------------------------
// decoding
// ---------------------------------------------------------------------------
// VOP description returned to the caller (int32 vop[12]).
enum {
    P_TYPE = 0, P_CODED, P_ROUNDING, P_FCODE, P_QUANT, P_DC_THR,
    P_MODULO, P_TIME_INC, P_PACKETS, P_BITS, P_COUNT = 12
};
enum { MB_INTRA = 0, MB_INTER = 1, MB_INTER4V = 2, MB_SKIP = 3 };

struct Vop {
    int mbw, mbh, nmb;
    int type, fcode, qp, dc_thr;
    int16_t *levels;        // (nmb, 6, 64), natural order
    int8_t *mbtype;
    int8_t *mbqp;
    int16_t *mv;            // (nmb, 4, 2), half-pel
    // prediction state of this VOP
    int32_t *packet;        // per MB: its video packet, -1 not yet decoded
    int16_t *dc;            // per block (nmb, 6): stored DC (dequantised)
    int16_t *ac;            // per block (nmb, 6, 16): first column, row
    int resync_mb;          // first MB of the current packet
};

inline int clip(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }

// (mb, block) of the block left of, above-left of and above block n of MB
// (mbx, mby); -1 outside the picture
void neighbours(const Vop &v, int mbx, int mby, int n, int *a, int *b,
                int *c) {
    auto at = [&](int x, int y, int blk) {
        return (x < 0 || y < 0) ? -1 : (y * v.mbw + x) * 6 + blk;
    };
    if (n >= 4) {
        *a = at(mbx - 1, mby, n);
        *b = at(mbx - 1, mby - 1, n);
        *c = at(mbx, mby - 1, n);
        return;
    }
    int bx = 2 * mbx + (n & 1), by = 2 * mby + (n >> 1);
    auto lum = [&](int x, int y) {
        return (x < 0 || y < 0) ? -1 : at(x >> 1, y >> 1, (x & 1) | ((y & 1) << 1));
    };
    *a = lum(bx - 1, by);
    *b = lum(bx - 1, by - 1);
    *c = lum(bx, by - 1);
}

// a neighbour block usable for intra prediction: decoded, intra, and in
// the current video packet
bool usable(const Vop &v, int blk, int packet) {
    if (blk < 0) return false;
    int mb = blk / 6;
    return v.packet[mb] == packet && v.mbtype[mb] == MB_INTRA;
}

// The DC predictor of block n (FFmpeg's ff_mpeg4_pred_dc): returns the
// predicted quantised DC; *dir 0 = from the left, 1 = from above.
int pred_dc(const Vop &v, int mbx, int mby, int n, int scale, int *dir) {
    int a, b, c, packet = v.packet[mby * v.mbw + mbx];
    neighbours(v, mbx, mby, n, &a, &b, &c);
    int da = usable(v, a, packet) ? v.dc[a] : 1024;
    int db = usable(v, b, packet) ? v.dc[b] : 1024;
    int dcv = usable(v, c, packet) ? v.dc[c] : 1024;
    int pred;
    if (std::abs(da - db) < std::abs(db - dcv)) {
        pred = dcv;
        *dir = 1;
    } else {
        pred = da;
        *dir = 0;
    }
    return (pred + (scale >> 1)) / scale;
}

// ROUNDED_DIV of FFmpeg
inline int rounded_div(int a, int b) {
    return (a > 0 ? a + (b >> 1) : a - (b >> 1)) / b;
}

// AC prediction of block n's first column (dir 0) or row (dir 1) from its
// neighbour, rescaled to this MB's QP; then the block's own first column
// and row are stored for its successors.
void pred_ac(Vop &v, int mbx, int mby, int n, int dir, bool ac_pred,
             int qp, int16_t *blk) {
    int mb = mby * v.mbw + mbx;
    int16_t *store = v.ac + ((int64_t)mb * 6 + n) * 16;
    if (ac_pred) {
        int a, b, c;
        neighbours(v, mbx, mby, n, &a, &b, &c);
        int src = dir == 0 ? a : c;
        if (usable(v, src, v.packet[mb])) {
            const int16_t *p = v.ac + (int64_t)src * 16;
            int nqp = v.mbqp[src / 6];
            for (int i = 1; i < 8; ++i) {
                int pv = dir == 0 ? p[i] : p[8 + i];
                if (nqp != qp) pv = rounded_div(pv * nqp, qp);
                int16_t &dst = dir == 0 ? blk[i << 3] : blk[i];
                dst = (int16_t)(dst + pv);
            }
        }
    }
    for (int i = 1; i < 8; ++i) {
        store[i] = blk[i << 3];
        store[8 + i] = blk[i];
    }
}

int decode_dc_diff(BitReader &br, bool lum, int *out) {
    const Tables &t = tables();
    int size = br.vlc(lum ? t.dc_lum : t.dc_chrom);
    if (size < 0) return LT_EBADCODE;
    if (size > 9) return LT_EDC;              // FFmpeg: "illegal dc vlc"
    if (size == 0) {
        *out = 0;
        return LT_OK;
    }
    int code = (int)br.get(size);
    *out = (code >> (size - 1)) ? code : code - ((1 << size) - 1);
    if (size > 8) br.get(1);                 // marker, unchecked as FFmpeg
    return LT_OK;
}

// The TCOEF events of one block into blk (natural order) from scan
// position `first`: levels as coded (not dequantised).
int decode_coefs(BitReader &br, const RlTable &t, const uint8_t *scan,
                 int first, int16_t *blk) {
    int i = first - 1;
    for (;;) {
        int s = br.vlc(t.look);
        if (s < 0) return LT_EBADCODE;
        int last, run, level;
        if (s == 102) {                      // escape
            if (br.peek(1) == 0) {           // 1: level + LMAX
                br.get(1);
                int e = br.vlc(t.look);
                if (e < 0 || e == 102) return LT_EBADCODE;
                last = e >= t.last;
                run = t.run[e];
                level = t.level[e] + t.max_level[last][run];
            } else if (br.peek(2) == 2) {    // 2: run + RMAX + 1
                br.get(2);
                int e = br.vlc(t.look);
                if (e < 0 || e == 102) return LT_EBADCODE;
                last = e >= t.last;
                level = t.level[e];
                run = t.run[e] + t.max_run[last][level] + 1;
            } else {                         // 3: fixed length
                br.get(2);
                last = (int)br.get(1);
                run = (int)br.get(6);
                if (!br.get(1)) return LT_EMARKER;
                level = br.get_signed(12);
                if (!br.get(1)) return LT_EMARKER;
                if (level == 0) return LT_EBADVALUE;
                if (br.overrun()) return LT_ETRUNCATED;
                i += run + 1;
                if (i > 63) return LT_EINDEX;
                blk[scan[i]] = (int16_t)level;
                if (last) return LT_OK;
                continue;
            }
            if (br.get(1)) level = -level;
        } else {
            last = s >= t.last;
            run = t.run[s];
            level = t.level[s];
            if (br.get(1)) level = -level;
        }
        if (br.overrun()) return LT_ETRUNCATED;
        i += run + 1;
        if (i > 63) return LT_EINDEX;
        blk[scan[i]] = (int16_t)level;
        if (last) return LT_OK;
    }
}

// One intra MB's six blocks (after its header): DC, coefficients, and the
// DC and AC predictions undone.
int decode_intra_blocks(BitReader &br, Vop &v, int mbx, int mby, int cbp,
                        bool ac_pred, bool dc_vlc) {
    const Tables &t = tables();
    int mb = mby * v.mbw + mbx, qp = v.mbqp[mb];
    for (int n = 0; n < 6; ++n) {
        int16_t *blk = v.levels + ((int64_t)mb * 6 + n) * 64;
        int scale = n < 4 ? kYDcScale[qp] : kCDcScale[qp];
        int dir;
        int pred = pred_dc(v, mbx, mby, n, scale, &dir);
        int first = 0;
        if (dc_vlc) {
            int diff;
            int rc = decode_dc_diff(br, n < 4, &diff);
            if (rc) return rc;
            blk[0] = (int16_t)diff;
            first = 1;
        }
        if (cbp & (32 >> n)) {
            const uint8_t *scan = !ac_pred ? kZigzag
                                  : dir == 0 ? kAltVertical : kAltHorizontal;
            int rc = decode_coefs(br, t.intra, scan, first, blk);
            if (rc) return rc;
        }
        int level = blk[0] + pred;           // the quantised DC
        // FFmpeg takes a negative DC from its DC VLC for an error code
        if (dc_vlc && level < 0) return LT_EDC;
        blk[0] = (int16_t)level;
        int stored = level * scale;
        if (stored & ~2047) stored = stored < 0 ? 0 : 2047;
        v.dc[mb * 6 + n] = (int16_t)stored;
        pred_ac(v, mbx, mby, n, dir, ac_pred, qp, blk);
    }
    return LT_OK;
}

inline int mid3(int a, int b, int c) {
    int mx = a > b ? a : b, mn = a > b ? b : a;
    return c > mx ? mx : c < mn ? mn : c;
}

// The MV predictor of luma block n, as FFmpeg's ff_h263_pred_motion forms
// it: the median of the left (A), above (B) and above-right (C) vectors,
// those outside the picture (and intra MBs') being zero; in the first
// `mbw` MBs of a video packet the candidates above are replaced as FFmpeg
// replaces them.
void pred_mv(const Vop &v, int mbx, int mby, int n, int *px, int *py) {
    int bx = 2 * mbx + (n & 1), by = 2 * mby + (n >> 1);
    auto mv_at = [&](int x, int y, int *cx, int *cy) {
        *cx = *cy = 0;
        if (x < 0 || y < 0 || x >= 2 * v.mbw) return;
        int m = (y >> 1) * v.mbw + (x >> 1), k = (x & 1) | ((y & 1) << 1);
        *cx = v.mv[m * 8 + k * 2];
        *cy = v.mv[m * 8 + k * 2 + 1];
    };
    int mb = mby * v.mbw + mbx;
    int rx = v.resync_mb % v.mbw;
    bool first_line = mb - v.resync_mb < v.mbw;
    int ax, ay, bx_, by_, cx, cy;
    mv_at(bx - 1, by, &ax, &ay);
    if (first_line && n < 3) {
        if (n == 0) {
            if (mbx == rx) {
                *px = *py = 0;
            } else if (mbx + 1 == rx) {
                mv_at(bx + 2, by - 1, &cx, &cy);
                *px = mbx == 0 ? cx : mid3(ax, 0, cx);
                *py = mbx == 0 ? cy : mid3(ay, 0, cy);
            } else {
                *px = ax;
                *py = ay;
            }
        } else if (n == 1) {
            if (mbx + 1 == rx) {
                mv_at(bx + 1, by - 1, &cx, &cy);
                *px = mid3(ax, 0, cx);
                *py = mid3(ay, 0, cy);
            } else {
                *px = ax;
                *py = ay;
            }
        } else {
            mv_at(bx, by - 1, &bx_, &by_);
            mv_at(bx + 1, by - 1, &cx, &cy);
            if (mbx == rx) ax = ay = 0;
            *px = mid3(ax, bx_, cx);
            *py = mid3(ay, by_, cy);
        }
        return;
    }
    int off = n == 0 ? 2 : n == 3 ? -1 : 1;
    mv_at(bx, by - 1, &bx_, &by_);
    mv_at(bx + off, by - 1, &cx, &cy);
    *px = mid3(ax, bx_, cx);
    *py = mid3(ay, by_, cy);
}

int decode_mv_component(BitReader &br, int pred, int fcode, int *out) {
    int code = br.vlc(tables().mvd);
    if (code < 0) return LT_EBADCODE;
    if (code == 0) {
        *out = pred;
        return LT_OK;
    }
    int sign = (int)br.get(1), shift = fcode - 1, val = code;
    if (shift) {
        val = (val - 1) << shift;
        val |= (int)br.get(shift);
        ++val;
    }
    if (sign) val = -val;
    val += pred;
    int bits = 5 + fcode;                    // modular: into the f_code range
    val = (int)((uint32_t)val << (32 - bits)) >> (32 - bits);
    *out = val;
    return LT_OK;
}

int decode_inter_blocks(BitReader &br, Vop &v, int mb, int cbp) {
    const Tables &t = tables();
    for (int n = 0; n < 6; ++n) {
        if (!(cbp & (32 >> n))) continue;
        int rc = decode_coefs(br, t.inter, kZigzag, 0,
                              v.levels + ((int64_t)mb * 6 + n) * 64);
        if (rc) return rc;
    }
    return LT_OK;
}

void clear_intra_state(Vop &v, int mb) {
    for (int n = 0; n < 6; ++n) v.dc[mb * 6 + n] = 1024;
    std::memset(v.ac + (int64_t)mb * 96, 0, 96 * sizeof(int16_t));
}

int decode_mb(BitReader &br, Vop &v, int mb, int *qp) {
    const Tables &t = tables();
    int mbx = mb % v.mbw, mby = mb / v.mbw;
    int16_t *mv = v.mv + mb * 8;
    std::memset(mv, 0, 8 * sizeof(int16_t));
    int cbpc, dquant, intra;
    if (v.type == 1) {
        for (;;) {
            if (br.get(1)) {                 // not_coded
                v.mbtype[mb] = MB_SKIP;
                v.mbqp[mb] = (int8_t)*qp;
                clear_intra_state(v, mb);
                return br.overrun() ? LT_ETRUNCATED : LT_OK;
            }
            cbpc = br.vlc(t.inter_mcbpc);
            if (cbpc < 0) return LT_EBADCODE;
            if (cbpc != 20) break;
            if (br.overrun()) return LT_ETRUNCATED;
        }
        dquant = (cbpc & 8) && cbpc < 16;
        intra = (cbpc & 4) && cbpc < 16;
    } else {
        do {
            cbpc = br.vlc(t.intra_mcbpc);
            if (cbpc < 0) return LT_EBADCODE;
            if (br.overrun()) return LT_ETRUNCATED;
        } while (cbpc == 8);
        dquant = cbpc & 4;
        intra = 1;
    }
    if (intra) {
        bool ac_pred = br.get(1);
        int cbpy = br.vlc(t.cbpy);
        if (cbpy < 0) return LT_EBADCODE;
        int cbp = (cbpc & 3) | (cbpy << 2);
        bool dc_vlc = *qp < kDcThreshold[v.dc_thr];
        if (dquant) *qp = clip(*qp + kDquant[br.get(2)], 1, 31);
        v.mbtype[mb] = MB_INTRA;
        v.mbqp[mb] = (int8_t)*qp;
        int rc = decode_intra_blocks(br, v, mbx, mby, cbp, ac_pred, dc_vlc);
        if (rc) return rc;
        return br.overrun() ? LT_ETRUNCATED : LT_OK;
    }
    int cbpy = br.vlc(t.cbpy);
    if (cbpy < 0) return LT_EBADCODE;
    int cbp = (cbpc & 3) | ((cbpy ^ 15) << 2);
    if (dquant) *qp = clip(*qp + kDquant[br.get(2)], 1, 31);
    v.mbqp[mb] = (int8_t)*qp;
    clear_intra_state(v, mb);
    if (cbpc < 16) {                         // one vector
        v.mbtype[mb] = MB_INTER;
        int px, py, mx, my;
        pred_mv(v, mbx, mby, 0, &px, &py);
        int rc = decode_mv_component(br, px, v.fcode, &mx);
        if (!rc) rc = decode_mv_component(br, py, v.fcode, &my);
        if (rc) return rc;
        for (int k = 0; k < 4; ++k) {
            mv[2 * k] = (int16_t)mx;
            mv[2 * k + 1] = (int16_t)my;
        }
    } else {                                 // four vectors
        v.mbtype[mb] = MB_INTER4V;
        for (int k = 0; k < 4; ++k) {
            int px, py, mx, my;
            pred_mv(v, mbx, mby, k, &px, &py);
            int rc = decode_mv_component(br, px, v.fcode, &mx);
            if (!rc) rc = decode_mv_component(br, py, v.fcode, &my);
            if (rc) return rc;
            mv[2 * k] = (int16_t)mx;
            mv[2 * k + 1] = (int16_t)my;
        }
    }
    int rc = decode_inter_blocks(br, v, mb, cbp);
    if (rc) return rc;
    return br.overrun() ? LT_ETRUNCATED : LT_OK;
}

// Whether a resync marker follows (after MB stuffing and the byte-align
// stuffing), as FFmpeg's mpeg4_is_resync checks it.
bool at_resync(const BitReader &br0, int prefix_zeros, int type) {
    BitReader br = br0;
    int stuff = type == 1 ? 10 : 9;          // (not_coded 0 +) MCBPC stuffing
    while (br.left() >= stuff && br.peek(stuff) == 1) br.pos += stuff;
    int k = 8 - (int)(br.pos & 7);
    if (br.left() < k + prefix_zeros + 1) return false;
    if (br.peek(k) != (1u << (k - 1)) - 1) return false;
    br.pos += k;
    for (int z = 0; z < prefix_zeros; ++z)
        if (br.get(1)) return false;
    return br.get(1) == 1;
}

int decode_packet_header(BitReader &br, Vop &v, int prefix_zeros,
                         int tinc_bits, int *qp) {
    int stuff = v.type == 1 ? 10 : 9;
    while (br.left() >= stuff && br.peek(stuff) == 1) br.pos += stuff;
    br.get(1);
    br.align();
    for (int z = 0; z < prefix_zeros; ++z)
        if (br.get(1)) return LT_EPACKET;
    if (!br.get(1)) return LT_EPACKET;
    int bits = 1;
    while ((1 << bits) < v.nmb) ++bits;      // av_log2(nmb - 1) + 1
    int mbn = (int)br.get(bits);
    int q = (int)br.get(5);
    if (q) *qp = q;
    if (br.get(1)) {                         // header_extension_code
        int guard = 0;
        while (br.get(1))
            if (++guard > 64 || br.overrun()) return LT_ETRUNCATED;
        br.get(1);
        br.get(tinc_bits);
        br.get(1);
        br.get(2);                           // vop_coding_type
        br.get(3);                           // intra_dc_vlc_thr (ignored)
        if (v.type == 1 && br.get(3) == 0) return LT_EBADVALUE;
    }
    if (br.overrun()) return LT_ETRUNCATED;
    return mbn;
}

}  // namespace

extern "C" {

// Read the VOL header in a decoder configuration (an esds's
// DecoderSpecificInfo) or any buffer of start codes into vol[16].
// Returns 0, LT_ENOVOL when there is none, or the VOL's LT_E* code.
int lt_m4v_read_config(const uint8_t *data, int64_t n, int32_t *vol) {
    if (n < 0) return LT_ETRUNCATED;
    int32_t tmp[V_COUNT];
    std::memcpy(tmp, vol, sizeof(tmp));
    int64_t at = read_headers(data, n, tmp);
    if (at < -1) return (int)at;
    if (!tmp[V_HAVE]) return LT_ENOVOL;
    std::memcpy(vol, tmp, sizeof(tmp));
    return LT_OK;
}

// Decode one sample (the headers it carries, then one VOP) into the
// caller's buffers, sized for `cap_mb` macroblocks:
//   vop[12]      the VOP's type (0 I, 1 P), coded flag, rounding type,
//                f_code, quantiser, intra_dc_vlc_thr, modulo_time_base,
//                time increment, video packets, bits read;
//   levels       (nmb, 6, 64) int16 quantised levels in natural order with
//                the DC and AC predictions undone (zeroed here first);
//   mbtype       per MB: 0 intra, 1 inter, 2 inter with four vectors,
//                3 not coded;
//   mbqp         per MB: its quantiser;
//   mv           (nmb, 4, 2) int16 half-pel vectors of the four luma blocks;
//   work         scratch of (nmb * 6 * 17 + nmb) int32, the prediction state.
// `vol` (in/out) is the layer the stream's headers set up.
int lt_m4v_decode_vop(int32_t *vol, const uint8_t *data, int64_t n,
                      int32_t cap_mb, int32_t *vop, int16_t *levels,
                      int8_t *mbtype, int8_t *mbqp, int16_t *mv,
                      int32_t *work) {
    if (n < 0 || cap_mb < 0) return LT_ETRUNCATED;
    int64_t at = read_headers(data, n, vol);
    if (at < -1) return (int)at;
    if (at < 0) return LT_ENOVOP;
    if (!vol[V_HAVE]) return LT_ENOVOL;
    Vop v;
    v.mbw = (vol[V_WIDTH] + 15) / 16;
    v.mbh = (vol[V_HEIGHT] + 15) / 16;
    if ((int64_t)v.mbw * v.mbh > cap_mb) return LT_ESIZE;
    v.nmb = v.mbw * v.mbh;
    BitReader br(data + at + 4, n - at - 4);
    int type = (int)br.get(2);
    if (type == 2) return LT_EBVOP;
    if (type == 3) return LT_ESVOP;
    int modulo = 0;
    while (br.get(1)) {
        if (br.overrun()) return LT_ETRUNCATED;
        ++modulo;
    }
    br.get(1);                               // marker (FFmpeg only warns)
    int tinc = (int)br.get(vol[V_TINC_BITS]);
    br.get(1);
    std::memset(vop, 0, P_COUNT * sizeof(int32_t));
    vop[P_TYPE] = type;
    vop[P_MODULO] = modulo;
    vop[P_TIME_INC] = tinc;
    if (!br.get(1)) {                        // vop_coded == 0
        vop[P_BITS] = (int32_t)br.pos;
        return br.overrun() ? LT_ETRUNCATED : LT_OK;
    }
    vop[P_CODED] = 1;
    if (type == 1) vop[P_ROUNDING] = (int)br.get(1);
    int dc_thr = (int)br.get(3);
    int qp = (int)br.get(5);
    int fcode = type == 1 ? (int)br.get(3) : 1;
    if (br.overrun()) return LT_ETRUNCATED;
    if (qp == 0 || fcode == 0) return LT_EBADVALUE;
    vop[P_FCODE] = fcode;
    vop[P_QUANT] = qp;
    vop[P_DC_THR] = dc_thr;
    v.type = type;
    v.fcode = fcode;
    v.qp = qp;
    v.dc_thr = dc_thr;
    v.levels = levels;
    v.mbtype = mbtype;
    v.mbqp = mbqp;
    v.mv = mv;
    v.packet = work;
    v.dc = reinterpret_cast<int16_t *>(work + v.nmb);
    v.ac = v.dc + (int64_t)v.nmb * 6;
    std::memset(levels, 0, (size_t)v.nmb * 6 * 64 * sizeof(int16_t));
    std::memset(mv, 0, (size_t)v.nmb * 8 * sizeof(int16_t));
    for (int i = 0; i < v.nmb; ++i) v.packet[i] = -1;
    int prefix = type == 1 ? fcode + 15 : 16;
    int packet = 0;
    v.resync_mb = 0;
    for (int mb = 0; mb < v.nmb; ++mb) {
        if (mb > 0 && !vol[V_RESYNC_DISABLE] && at_resync(br, prefix, type)) {
            int next = decode_packet_header(br, v, prefix, vol[V_TINC_BITS],
                                            &qp);
            if (next < 0) return next;
            if (next != mb) return LT_EPACKET;
            ++packet;
            v.resync_mb = mb;
        }
        v.packet[mb] = packet;
        int rc = decode_mb(br, v, mb, &qp);
        if (rc) return rc;
    }
    vop[P_PACKETS] = packet + 1;
    vop[P_BITS] = (int32_t)br.pos;
    // a second VOP in the sample is a packed (B-frame) bitstream
    int64_t end = at + 4 + (br.pos + 7) / 8;
    for (int64_t s = find_start(data, n, end); s >= 0;
         s = find_start(data, n, s + 4))
        if (data[s + 3] == 0xB6) return LT_EPACKED;
    return LT_OK;
}

// ---------------------------------------------------------------------------
// encoding: intra-only Simple Profile
// ---------------------------------------------------------------------------
// The decoder configuration: VOS (Simple Profile, level 1 as FFmpeg marks
// it), visual object, video object and VOL headers.  Returns its length.
int64_t lt_m4v_write_config(int32_t width, int32_t height, int32_t time_res,
                            uint8_t *out, int64_t cap) {
    if (width <= 0 || height <= 0 || width >= 8192 || height >= 8192 ||
        time_res <= 0 || time_res > 65535)
        return LT_EBADVALUE;
    BitWriter bw(out, cap);
    bw.start_code(0xB0);
    bw.put(0x01, 8);                         // profile_and_level_indication
    bw.start_code(0xB5);
    bw.put(1, 1);                            // is_visual_object_identifier
    bw.put(1, 4);                            // visual_object_verid
    bw.put(1, 3);                            // priority
    bw.put(1, 4);                            // visual_object_type: video
    bw.put(0, 1);                            // video_signal_type
    bw.stuffing();
    bw.start_code(0x00);                     // video_object_start_code
    bw.start_code(0x20);                     // video_object_layer_start_code
    bw.put(0, 1);                            // random_accessible_vol
    bw.put(1, 8);                            // simple object type
    bw.put(1, 1);                            // is_object_layer_identifier
    bw.put(1, 4);                            // verid 1
    bw.put(1, 3);                            // priority
    bw.put(1, 4);                            // aspect ratio 1:1
    bw.put(1, 1);                            // vol_control_parameters
    bw.put(1, 2);                            // chroma 4:2:0
    bw.put(1, 1);                            // low_delay
    bw.put(0, 1);                            // vbv_parameters
    bw.put(0, 2);                            // rectangular
    bw.put(1, 1);
    bw.put((uint32_t)time_res, 16);
    bw.put(1, 1);
    bw.put(0, 1);                            // fixed_vop_rate
    bw.put(1, 1);
    bw.put((uint32_t)width, 13);
    bw.put(1, 1);
    bw.put((uint32_t)height, 13);
    bw.put(1, 1);
    bw.put(0, 1);                            // interlaced
    bw.put(1, 1);                            // obmc_disable
    bw.put(0, 1);                            // sprite_enable
    bw.put(0, 1);                            // not_8_bit
    bw.put(0, 1);                            // quant_type: H.263
    bw.put(1, 1);                            // complexity_estimation_disable
    bw.put(1, 1);                            // resync_marker_disable
    bw.put(0, 1);                            // data_partitioned
    bw.put(0, 1);                            // scalability
    bw.stuffing();
    return bw.full ? (int64_t)LT_EOVERFLOW : bw.n;
}

// One I-VOP of an intra-only stream, a GOV header before it:
//   p[8]     width, height, time_res, quantiser, seconds of the GOV's time
//            code, time increment, 0, 0;
//   coefs    (nmb, 6, 64) int16 in transmission order: [0] the DC
//            difference (predicted), [1..63] the AC levels in the block's
//            scan (zigzag, or the alternate scan its prediction picks),
//            predicted where the MB's ac_pred is set;
//   acpred   per MB: the ac_pred_flag.
// Returns the bytes written, or LT_EOVERFLOW / LT_EBADVALUE.
int64_t lt_m4v_encode_ivop(const int32_t *p, const int16_t *coefs,
                           const uint8_t *acpred, uint8_t *out, int64_t cap) {
    const Tables &t = tables();
    int width = p[0], height = p[1], time_res = p[2], qp = p[3];
    int64_t seconds = p[4];
    int tinc = p[5];
    if (width <= 0 || height <= 0 || time_res <= 0 || qp < 1 || qp > 31 ||
        seconds < 0 || tinc < 0 || tinc >= time_res)
        return LT_EBADVALUE;
    int bits = 1;
    while ((1 << bits) < time_res) ++bits;
    int nmb = ((width + 15) / 16) * ((height + 15) / 16);
    BitWriter bw(out, cap);
    bw.start_code(0xB3);                     // group_of_vop
    bw.put((uint32_t)((seconds / 3600) % 24), 5);
    bw.put((uint32_t)((seconds / 60) % 60), 6);
    bw.put(1, 1);
    bw.put((uint32_t)(seconds % 60), 6);
    bw.put(0, 1);                            // closed_gov
    bw.put(0, 1);                            // broken_link
    bw.stuffing();
    bw.start_code(0xB6);
    bw.put(0, 2);                            // I-VOP
    bw.put(0, 1);                            // modulo_time_base: same second
    bw.put(1, 1);
    bw.put((uint32_t)tinc, bits);
    bw.put(1, 1);
    bw.put(1, 1);                            // vop_coded
    bw.put(0, 3);                            // intra_dc_vlc_thr: DC VLC
    bw.put((uint32_t)qp, 5);
    for (int mb = 0; mb < nmb; ++mb) {
        const int16_t *c = coefs + (int64_t)mb * 384;
        int cbp = 0;
        for (int n = 0; n < 6; ++n)
            for (int i = 1; i < 64; ++i)
                if (c[n * 64 + i]) {
                    cbp |= 32 >> n;
                    break;
                }
        bw.put_code(kIntraMcbpc[cbp & 3]);
        bw.put(acpred[mb] ? 1 : 0, 1);
        bw.put_code(kCbpy[cbp >> 2]);
        for (int n = 0; n < 6; ++n) {
            const int16_t *b = c + n * 64;
            int dc = b[0], a = dc < 0 ? -dc : dc, size = 0;
            while ((1 << size) <= a) ++size;
            if (size > 12) return LT_EBADVALUE;
            bw.put_code(n < 4 ? kDcLum[size] : kDcChrom[size]);
            if (size) {
                bw.put((uint32_t)(dc < 0 ? dc + (1 << size) - 1 : dc), size);
                if (size > 8) bw.put(1, 1);
            }
            if (!(cbp & (32 >> n))) continue;
            int lastpos = 63;
            while (!b[lastpos]) --lastpos;
            int run = 0;
            for (int i = 1; i <= lastpos; ++i) {
                int level = b[i];
                if (!level) {
                    ++run;
                    continue;
                }
                int last = i == lastpos, mag = level < 0 ? -level : level;
                int sign = level < 0;
                if (mag > 2047) return LT_EBADVALUE;
                const RlTable &rl = t.intra;
                int idx = mag < 28 ? rl.index[last][run][mag] : -1;
                if (idx >= 0) {
                    bw.put_code(rl.codes[idx]);
                    bw.put(sign, 1);
                } else {
                    int l1 = mag - rl.max_level[last][run];
                    int i1 = (l1 >= 1 && l1 < 28) ? rl.index[last][run][l1] : -1;
                    int r2 = mag < 28 ? run - rl.max_run[last][mag] - 1 : -1;
                    int i2 = (mag < 28 && r2 >= 0) ? rl.index[last][r2][mag] : -1;
                    bw.put_code(rl.codes[102]);
                    if (i1 >= 0) {
                        bw.put(0, 1);
                        bw.put_code(rl.codes[i1]);
                        bw.put(sign, 1);
                    } else if (i2 >= 0) {
                        bw.put(2, 2);
                        bw.put_code(rl.codes[i2]);
                        bw.put(sign, 1);
                    } else {
                        bw.put(3, 2);
                        bw.put((uint32_t)last, 1);
                        bw.put((uint32_t)run, 6);
                        bw.put(1, 1);
                        bw.put((uint32_t)level & 0xFFF, 12);
                        bw.put(1, 1);
                    }
                }
                run = 0;
            }
        }
    }
    bw.stuffing();
    return bw.full ? (int64_t)LT_EOVERFLOW : bw.n;
}

}  // extern "C"
