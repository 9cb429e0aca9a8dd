// libde265_tpu native front-end: serial HEVC Main-profile bitstream decoding
// (NAL / headers / CABAC / CTU syntax / motion derivation) producing batched
// decode-plan arrays for the device back-end.
//
// This is the C++ counterpart of libde265_tpu/bitstream/*.py + motion.py —
// same algorithms (spec 7.3/8.5/9.3), same plan layout; the Python front-end
// is its differential-test oracle. It plays the role the reference's native
// decoder core plays (/root/reference/libde265/{cabac,slice,motion}.cc) but
// emits structure-of-arrays plans instead of decoding pixels in place.
//
// Build: g++ -O3 -fPIC -shared -o libhevc_frontend.so frontend.cc

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <climits>
#include <functional>
#include <vector>
#include <map>
#include <algorithm>
#include <string>
#include <memory>
#include <mutex>
#include <condition_variable>
#include <atomic>
#include <thread>

namespace {

// ============================= constants ==================================
// CABAC tables (spec Tables 9-46/9-47)
static const uint8_t LPS_TABLE[64][4] = {
  {128,176,208,240},{128,167,197,227},{128,158,187,216},{123,150,178,205},
  {116,142,169,195},{111,135,160,185},{105,128,152,175},{100,122,144,166},
  { 95,116,137,158},{ 90,110,130,150},{ 85,104,123,142},{ 81, 99,117,135},
  { 77, 94,111,128},{ 73, 89,105,122},{ 69, 85,100,116},{ 66, 80, 95,110},
  { 62, 76, 90,104},{ 59, 72, 86, 99},{ 56, 69, 81, 94},{ 53, 65, 77, 89},
  { 51, 62, 73, 85},{ 48, 59, 69, 80},{ 46, 56, 66, 76},{ 43, 53, 63, 72},
  { 41, 50, 59, 69},{ 39, 48, 56, 65},{ 37, 45, 54, 62},{ 35, 43, 51, 59},
  { 33, 41, 48, 56},{ 32, 39, 46, 53},{ 30, 37, 43, 50},{ 29, 35, 41, 48},
  { 27, 33, 39, 45},{ 26, 31, 37, 43},{ 24, 30, 35, 41},{ 23, 28, 33, 39},
  { 22, 27, 32, 37},{ 21, 26, 30, 35},{ 20, 24, 29, 33},{ 19, 23, 27, 31},
  { 18, 22, 26, 30},{ 17, 21, 25, 28},{ 16, 20, 23, 27},{ 15, 19, 22, 25},
  { 14, 18, 21, 24},{ 14, 17, 20, 23},{ 13, 16, 19, 22},{ 12, 15, 18, 21},
  { 12, 14, 17, 20},{ 11, 14, 16, 19},{ 11, 13, 15, 18},{ 10, 12, 15, 17},
  { 10, 12, 14, 16},{  9, 11, 13, 15},{  9, 11, 12, 14},{  8, 10, 12, 14},
  {  8,  9, 11, 13},{  7,  9, 11, 12},{  7,  9, 10, 12},{  7,  8, 10, 11},
  {  6,  8,  9, 11},{  6,  7,  9, 10},{  6,  7,  8,  9},{  2,  2,  2,  2},
};
static const uint8_t TRANS_LPS[64] = {
   0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9,11,11,12,
  13,13,15,15,16,16,18,18,19,19,21,21,22,22,23,24,
  24,25,26,26,27,27,28,29,29,30,30,30,31,32,32,33,
  33,33,34,34,35,35,35,36,36,36,37,37,37,38,38,63,
};

static const uint8_t CTX_IDX_MAP_4x4[16] = {0,1,4,5,2,3,4,5,6,6,8,8,7,7,8,8};
static const uint8_t CHROMA_QP_TAB[14] = {29,30,31,32,33,33,34,34,35,35,36,36,37,37};

// context-model init values (spec 9.3.2.2), laid out identically to
// contextmodel.py so trace comparisons line up.
struct CtxDef { const char* name; int n; const uint8_t* init[3]; };
#define CD(name, n, a, b, c) {name, n, {a, b, c}}
static const uint8_t iv_sao_merge[3][1]   = {{153},{153},{153}};
static const uint8_t iv_sao_type[3][1]    = {{200},{185},{160}};
static const uint8_t iv_split_cu[3][3]    = {{139,141,157},{107,139,126},{107,139,126}};
static const uint8_t iv_tqbypass[3][1]    = {{154},{154},{154}};
static const uint8_t iv_skip[3][3]        = {{197,185,201},{197,185,201},{197,185,201}};
static const uint8_t iv_predmode[3][1]    = {{149},{149},{134}};
static const uint8_t iv_partmode[3][4]    = {{184,154,139,154},{154,139,154,154},{154,139,154,154}};
static const uint8_t iv_previntra[3][1]   = {{184},{154},{183}};
static const uint8_t iv_chromamode[3][1]  = {{63},{152},{152}};
static const uint8_t iv_rqt_root[3][1]    = {{79},{79},{79}};
static const uint8_t iv_mergeflag[3][1]   = {{110},{110},{154}};
static const uint8_t iv_mergeidx[3][1]    = {{122},{122},{137}};
static const uint8_t iv_interdir[3][5]    = {{95,79,63,31,31},{95,79,63,31,31},{95,79,63,31,31}};
static const uint8_t iv_refidx[3][2]      = {{153,153},{153,153},{153,153}};
static const uint8_t iv_mvd[3][2]         = {{140,198},{140,198},{169,198}};
static const uint8_t iv_mvp[3][1]         = {{168},{168},{168}};
static const uint8_t iv_splittrafo[3][3]  = {{153,138,138},{124,138,94},{224,167,122}};
static const uint8_t iv_cbfluma[3][2]     = {{111,141},{153,111},{153,111}};
static const uint8_t iv_cbfchroma[3][5]   = {{94,138,182,154,154},{149,107,167,154,154},{149,92,167,154,154}};
static const uint8_t iv_tskip[3][2]       = {{139,139},{139,139},{139,139}};
static const uint8_t iv_lastx[3][18] = {
  {110,110,124,125,140,153,125,127,140,109,111,143,127,111, 79,108,123, 63},
  {125,110, 94,110, 95, 79,125,111,110, 78,110,111,111, 95, 94,108,123,108},
  {125,110,124,110, 95, 94,125,111,111, 79,125,126,111,111, 79,108,123, 93}};
static const uint8_t iv_csbf[3][4] = {{91,171,134,141},{121,140,61,154},{121,140,61,154}};
static const uint8_t iv_sig[3][44] = {
  {111,111,125,110,110, 94,124,108,124,107,125,141,179,153,125,107,
   125,141,179,153,125,107,125,141,179,153,125,140,139,182,182,152,
   136,152,136,153,136,139,111,136,139,111,141,111},
  {155,154,139,153,139,123,123, 63,153,166,183,140,136,153,154,166,
   183,140,136,153,154,166,183,140,136,153,154,170,153,123,123,107,
   121,107,121,167,151,183,140,151,183,140,140,140},
  {170,154,139,153,139,123,123, 63,124,166,183,140,136,153,154,166,
   183,140,136,153,154,166,183,140,136,153,154,170,153,138,138,122,
   121,122,121,167,151,183,140,151,183,140,140,140}};
static const uint8_t iv_g1[3][24] = {
  {140, 92,137,138,140,152,138,139,153, 74,149, 92,139,107,122,152,
   140,179,166,182,140,227,122,197},
  {154,196,196,167,154,152,167,182,182,134,149,136,153,121,136,137,
   169,194,166,167,154,167,137,182},
  {154,196,167,167,154,152,167,182,182,134,149,136,153,121,136,122,
   169,208,166,167,154,152,167,182}};
static const uint8_t iv_g2[3][6] = {{138,153,136,167,152,152},
                                    {107,167, 91,122,107,167},
                                    {107,167, 91,107,107,167}};
static const uint8_t iv_cuqp[3][2] = {{154,154},{154,154},{154,154}};
// range-extension contexts (contextmodel.py:72-77)
static const uint8_t iv_cuchroff[3][2] = {{154,154},{154,154},{154,154}};
static const uint8_t iv_resscale[3][8] = {
    {154,154,154,154,154,154,154,154},
    {154,154,154,154,154,154,154,154},
    {154,154,154,154,154,154,154,154}};
static const uint8_t iv_ressign[3][2] = {{154,154},{154,154},{154,154}};
static const uint8_t iv_erdpcm[3][2] = {{139,139},{139,139},{139,139}};
static const uint8_t iv_erdpcmdir[3][2] = {{139,139},{139,139},{139,139}};

// flat context layout
enum CtxSlot {
  CTX_SAO_MERGE = 0,
  CTX_SAO_TYPE,
  CTX_SPLIT_CU,          // 3
  CTX_TQBYPASS = CTX_SPLIT_CU + 3,
  CTX_SKIP,              // 3
  CTX_PREDMODE = CTX_SKIP + 3,
  CTX_PARTMODE,          // 4
  CTX_PREVINTRA = CTX_PARTMODE + 4,
  CTX_CHROMAMODE,
  CTX_RQT_ROOT,
  CTX_MERGEFLAG,
  CTX_MERGEIDX,
  CTX_INTERDIR,          // 5
  CTX_REFIDX = CTX_INTERDIR + 5,  // 2
  CTX_MVD = CTX_REFIDX + 2,       // 2
  CTX_MVP = CTX_MVD + 2,
  CTX_SPLITTRAFO,        // 3
  CTX_CBF_LUMA = CTX_SPLITTRAFO + 3,  // 2
  CTX_CBF_CHROMA = CTX_CBF_LUMA + 2,  // 5
  CTX_TSKIP = CTX_CBF_CHROMA + 5,     // 2
  CTX_LAST_X = CTX_TSKIP + 2,         // 18
  CTX_LAST_Y = CTX_LAST_X + 18,       // 18
  CTX_CSBF = CTX_LAST_Y + 18,         // 4
  CTX_SIG = CTX_CSBF + 4,             // 44
  CTX_G1 = CTX_SIG + 44,              // 24
  CTX_G2 = CTX_G1 + 24,               // 6
  CTX_CUQP = CTX_G2 + 6,              // 2
  // range extension (same relative order as contextmodel.py)
  CTX_CUCHROFF = CTX_CUQP + 2,        // 2: flag, idx
  CTX_RESSCALE = CTX_CUCHROFF + 2,    // 8
  CTX_RESSIGN = CTX_RESSCALE + 8,     // 2
  CTX_ERDPCM = CTX_RESSIGN + 2,       // 2
  CTX_ERDPCMDIR = CTX_ERDPCM + 2,     // 2
  CTX_COUNT = CTX_ERDPCMDIR + 2
};

struct CtxModel { uint8_t state; uint8_t mps; };

static inline int clip3(int lo, int hi, int v) { return v < lo ? lo : (v > hi ? hi : v); }

static void init_ctx_span(CtxModel* t, int slot, const uint8_t* vals, int n, int qp) {
  for (int i = 0; i < n; i++) {
    int iv = vals[i];
    int slope = (iv >> 4) * 5 - 45;
    int offs = ((iv & 15) << 3) - 16;
    int pre = clip3(1, 126, ((slope * clip3(0, 51, qp)) >> 4) + offs);
    if (pre <= 63) { t[slot + i].state = 63 - pre; t[slot + i].mps = 0; }
    else           { t[slot + i].state = pre - 64; t[slot + i].mps = 1; }
  }
}

struct ContextTable {
  CtxModel m[CTX_COUNT];
  // persistent-Rice StatCoeff (range ext, spec 9.3.2.3): carried here so
  // WPP/dependent-slice snapshots copy it with the models (the reference
  // keeps it in thread_context, slice.cc:1507-1517)
  uint8_t stat_coeff[4] = {0, 0, 0, 0};
  void init(int init_type, int qp) {
    stat_coeff[0] = stat_coeff[1] = stat_coeff[2] = stat_coeff[3] = 0;
    init_ctx_span(m, CTX_SAO_MERGE, iv_sao_merge[init_type], 1, qp);
    init_ctx_span(m, CTX_SAO_TYPE, iv_sao_type[init_type], 1, qp);
    init_ctx_span(m, CTX_SPLIT_CU, iv_split_cu[init_type], 3, qp);
    init_ctx_span(m, CTX_TQBYPASS, iv_tqbypass[init_type], 1, qp);
    init_ctx_span(m, CTX_SKIP, iv_skip[init_type], 3, qp);
    init_ctx_span(m, CTX_PREDMODE, iv_predmode[init_type], 1, qp);
    init_ctx_span(m, CTX_PARTMODE, iv_partmode[init_type], 4, qp);
    init_ctx_span(m, CTX_PREVINTRA, iv_previntra[init_type], 1, qp);
    init_ctx_span(m, CTX_CHROMAMODE, iv_chromamode[init_type], 1, qp);
    init_ctx_span(m, CTX_RQT_ROOT, iv_rqt_root[init_type], 1, qp);
    init_ctx_span(m, CTX_MERGEFLAG, iv_mergeflag[init_type], 1, qp);
    init_ctx_span(m, CTX_MERGEIDX, iv_mergeidx[init_type], 1, qp);
    init_ctx_span(m, CTX_INTERDIR, iv_interdir[init_type], 5, qp);
    init_ctx_span(m, CTX_REFIDX, iv_refidx[init_type], 2, qp);
    init_ctx_span(m, CTX_MVD, iv_mvd[init_type], 2, qp);
    init_ctx_span(m, CTX_MVP, iv_mvp[init_type], 1, qp);
    init_ctx_span(m, CTX_SPLITTRAFO, iv_splittrafo[init_type], 3, qp);
    init_ctx_span(m, CTX_CBF_LUMA, iv_cbfluma[init_type], 2, qp);
    init_ctx_span(m, CTX_CBF_CHROMA, iv_cbfchroma[init_type], 5, qp);
    init_ctx_span(m, CTX_TSKIP, iv_tskip[init_type], 2, qp);
    init_ctx_span(m, CTX_LAST_X, iv_lastx[init_type], 18, qp);
    init_ctx_span(m, CTX_LAST_Y, iv_lastx[init_type], 18, qp);
    init_ctx_span(m, CTX_CSBF, iv_csbf[init_type], 4, qp);
    init_ctx_span(m, CTX_SIG, iv_sig[init_type], 44, qp);
    init_ctx_span(m, CTX_G1, iv_g1[init_type], 24, qp);
    init_ctx_span(m, CTX_G2, iv_g2[init_type], 6, qp);
    init_ctx_span(m, CTX_CUQP, iv_cuqp[init_type], 2, qp);
    init_ctx_span(m, CTX_CUCHROFF, iv_cuchroff[init_type], 2, qp);
    init_ctx_span(m, CTX_RESSCALE, iv_resscale[init_type], 8, qp);
    init_ctx_span(m, CTX_RESSIGN, iv_ressign[init_type], 2, qp);
    init_ctx_span(m, CTX_ERDPCM, iv_erdpcm[init_type], 2, qp);
    init_ctx_span(m, CTX_ERDPCMDIR, iv_erdpcmdir[init_type], 2, qp);
  }
};

// ============================ bitreader ===================================
struct Bitreader {
  const uint8_t* data; size_t len; size_t pos;  // bit position
  Bitreader(const uint8_t* d, size_t l) : data(d), len(l), pos(0) {}
  int bit() {
    size_t byte = pos >> 3;
    int b = byte < len ? (data[byte] >> (7 - (pos & 7))) & 1 : 0;
    pos++;
    return b;
  }
  uint32_t bits(int n) { uint32_t v = 0; while (n--) v = (v << 1) | bit(); return v; }
  uint32_t uvlc() {
    int zeros = 0;
    while (bit() == 0) { if (++zeros > 63) return 0; }
    if (!zeros) return 0;
    return (1u << zeros) - 1 + bits(zeros);
  }
  int32_t svlc() {
    uint32_t v = uvlc();
    if (!v) return 0;
    return (v & 1) ? (int32_t)((v + 1) >> 1) : -(int32_t)(v >> 1);
  }
  void align() { pos = (pos + 7) & ~(size_t)7; }
};

// =============================== CABAC ====================================
static FILE* g_trace = nullptr;
static void trace_open() {
  static bool tried = false;
  if (!tried) { tried = true;
    const char* p = getenv("FE_TRACE");
    if (p) g_trace = fopen(p, "w");
  }
}
struct Cabac {
  const uint8_t* data; size_t len;
  size_t bytepos;        // next byte to load into the cache
  uint64_t cache;        // MSB-first bit cache
  int cache_bits;        // valid bits in cache
  uint32_t range, offset;
  Cabac(const uint8_t* d, size_t l, size_t start) : data(d), len(l),
      bytepos(start), cache(0), cache_bits(0) { init_engine(); }
  void init_engine() {
    range = 510; offset = 0;
    for (int i = 0; i < 9; i++) offset = (offset << 1) | read_bit();
  }
  inline void refill() {
    while (cache_bits <= 56) {
      uint64_t b = bytepos < len ? data[bytepos] : 0;
      bytepos++;
      cache |= b << (56 - cache_bits);
      cache_bits += 8;
    }
  }
  inline int read_bit() {
    if (cache_bits == 0) refill();
    int b = (int)(cache >> 63);
    cache <<= 1;
    cache_bits--;
    return b;
  }
  inline uint32_t read_bits(int n) {
    if (cache_bits < n) refill();
    uint32_t v = (uint32_t)(cache >> (64 - n));
    cache <<= n;
    cache_bits -= n;
    return v;
  }
  // total bits consumed from the stream so far
  size_t bit_pos() const { return bytepos * 8 - cache_bits; }
  void seek_bits(size_t bitpos) {
    bytepos = bitpos >> 3;
    cache = 0; cache_bits = 0;
    int skip = (int)(bitpos & 7);
    for (int i = 0; i < skip; i++) read_bit();
  }
  inline int bin(CtxModel& c) {
    int st_before = c.state, mps_before = c.mps;
    uint32_t lps = LPS_TABLE[c.state][(range >> 6) & 3];
    range -= lps;
    int b;
    if (offset >= range) {
      b = 1 - c.mps;
      offset -= range; range = lps;
      if (c.state == 0) c.mps = 1 - c.mps;
      c.state = TRANS_LPS[c.state];
      // LPS renorm: range=lps in [2,240] -> 1..7 shifts, done in one step
      int sh = __builtin_clz(range) - 23;
      range <<= sh;
      offset = (offset << sh) | read_bits(sh);
    } else {
      b = c.mps;
      if (c.state < 62) c.state++;
      // MPS renorm: range >= 128 always, at most one shift
      if (range < 256) { range <<= 1; offset = (offset << 1) | read_bit(); }
    }
    if (g_trace) fprintf(g_trace, "b%d.%u.%d.%d\n", b, range, st_before, mps_before);
    return b;
  }
  int bypass() {
    offset = (offset << 1) | read_bit();
    int b = 0;
    if (offset >= range) { offset -= range; b = 1; }
    if (g_trace) fprintf(g_trace, "y%d.%u\n", b, range);
    return b;
  }
  uint32_t bypass_bits(int n) {
    // n iterations of binary restoring division == one 64-bit div/mod:
    //   offset0*2^n + inbits = v*range + offset_n  (offset_n < range, v < 2^n)
    if (n <= 1 || n > 32 || g_trace) {
      uint32_t v = 0; while (n--) v = (v << 1) | bypass(); return v;
    }
    uint64_t acc = ((uint64_t)offset << n) | read_bits(n);
    uint32_t v = (uint32_t)(acc / range);
    offset = (uint32_t)(acc % range);
    return v;
  }
  int term() {
    range -= 2;
    if (offset >= range) { if (g_trace) fprintf(g_trace, "t1.%u\n", range); return 1; }
    while (range < 256) { range <<= 1; offset = (offset << 1) | read_bit(); }
    if (g_trace) fprintf(g_trace, "t0.%u\n", range);
    return 0;
  }
  int tu_bypass(int cmax) {
    for (int i = 0; i < cmax; i++) if (!bypass()) return i;
    return cmax;
  }
  uint32_t eg_bypass(int k) {
    int nz = 0;
    while (bypass()) { if (++nz > 32) return 0; }
    uint32_t v = (1u << nz) - 1;
    return (v << k) + bypass_bits(nz + k);
  }
  size_t byte_offset() const { return (bit_pos() + 7) >> 3; }
};

// ============================ parameter sets ==============================
struct ShortTermRPS {
  std::vector<int> d0, d1;        // DeltaPocS0/S1
  std::vector<uint8_t> u0, u1;    // UsedByCurr
};

struct SPS {
  int sps_id = 0;
  int chroma_format_idc = 1;
  int separate_colour_plane = 0;
  int width = 0, height = 0;
  int conf_win[4] = {0,0,0,0};
  int conformance_window = 0;
  int bd_luma = 8, bd_chroma = 8;
  int log2_max_poc_lsb = 8;
  int max_dec_pic_buffering = 4, max_num_reorder = 0;
  int log2_min_cb = 3, log2_ctb = 5;
  int log2_min_tb = 2, log2_max_tb = 5;
  int max_trafo_depth_inter = 0, max_trafo_depth_intra = 0;
  int scaling_list_enabled = 0, scaling_list_present = 0;
  uint8_t sl4[6][16]; uint8_t sl8[6][64]; uint8_t sl16[6][64]; uint8_t sl32[2][64];
  int sl_dc16[6] = {16,16,16,16,16,16}; int sl_dc32[2] = {16,16};
  int amp = 0, sao = 0;
  int pcm_enabled = 0, pcm_bd_luma = 8, pcm_bd_chroma = 8;
  int pcm_log2_min = 3, pcm_log2_diff = 0, pcm_loop_filter_disable = 0;
  std::vector<ShortTermRPS> rps;
  int long_term_present = 0, num_lt_sps = 0;
  int lt_poc_lsb[33]; int lt_used[33];
  int temporal_mvp = 0, strong_intra_smoothing = 0;
  // range extension (sps_range_extension, sps.h:66-83)
  int ts_rotation = 0, ts_context = 0, implicit_rdpcm = 0,
      explicit_rdpcm = 0, intra_smoothing_disabled = 0,
      persistent_rice = 0, cabac_bypass_align = 0;
  // derived
  int ctb_size, min_cb, pic_w_ctbs, pic_h_ctbs, pic_size_ctbs;
  int chroma_array_type, subw, subh;
  void derive() {
    ctb_size = 1 << log2_ctb;
    min_cb = 1 << log2_min_cb;
    pic_w_ctbs = (width + ctb_size - 1) >> log2_ctb;
    pic_h_ctbs = (height + ctb_size - 1) >> log2_ctb;
    pic_size_ctbs = pic_w_ctbs * pic_h_ctbs;
    chroma_array_type = separate_colour_plane ? 0 : chroma_format_idc;
    subw = (chroma_format_idc == 1 || chroma_format_idc == 2) ? 2 : 1;
    subh = (chroma_format_idc == 1) ? 2 : 1;
  }
};

struct PPS {
  int pps_id = 0, sps_id = 0;
  int dependent_slices = 0, output_flag_present = 0, extra_bits = 0;
  int sign_data_hiding = 0, cabac_init_present = 0;
  int num_ref_l0 = 1, num_ref_l1 = 1;
  int init_qp = 26;
  int constrained_intra = 0, transform_skip = 0;
  int cu_qp_delta = 0, diff_cu_qp_depth = 0;
  int cb_qp_offset = 0, cr_qp_offset = 0, slice_chroma_qp = 0;
  int weighted_pred = 0, weighted_bipred = 0, tq_bypass_enabled = 0;
  int tiles = 0, wpp = 0;
  int num_tile_cols = 1, num_tile_rows = 1, uniform_spacing = 1;
  std::vector<int> col_bd, row_bd;
  int lf_across_tiles = 1, lf_across_slices = 0;
  int deblock_control = 0, deblock_override = 0, disable_deblock = 0;
  int beta_off = 0, tc_off = 0;
  int scaling_list_present = 0;
  int lists_modification = 0, log2_pml = 2, sh_ext = 0;
  int log2_max_tskip = 2;
  // range extension (pps_range_extension, pps.h:36-55)
  int ccp_enabled = 0, chroma_qp_list_enabled = 0;
  int diff_cu_chroma_qp_depth = 0, chroma_qp_list_len = 0;
  int cb_qp_list[6] = {0}, cr_qp_list[6] = {0};
  // derived maps
  std::vector<int> rs_to_ts, ts_to_rs, tile_id;
  void derive(const SPS& sps) {
    int W = sps.pic_w_ctbs, H = sps.pic_h_ctbs;
    int nC = tiles ? num_tile_cols : 1, nR = tiles ? num_tile_rows : 1;
    if (uniform_spacing || !tiles) {
      col_bd.resize(nC + 1); row_bd.resize(nR + 1);
      for (int i = 0; i <= nC; i++) col_bd[i] = i * W / nC;
      for (int i = 0; i <= nR; i++) row_bd[i] = i * H / nR;
    } else {
      col_bd.push_back(W); row_bd.push_back(H); // ends appended by parser
    }
    rs_to_ts.assign(W * H, 0); ts_to_rs.assign(W * H, 0); tile_id.assign(W * H, 0);
    int ts = 0, t = 0;
    for (int tr = 0; tr < nR; tr++)
      for (int tc = 0; tc < nC; tc++, t++)
        for (int y = row_bd[tr]; y < row_bd[tr + 1]; y++)
          for (int x = col_bd[tc]; x < col_bd[tc + 1]; x++) {
            int rs = y * W + x;
            tile_id[rs] = t; rs_to_ts[rs] = ts; ts_to_rs[ts] = rs; ts++;
          }
  }
};

struct PredWeight {
  int luma_denom = 0, chroma_denom = 0;
  int lw[2][16], lo[2][16], cw[2][16][2], co[2][16][2];
};

struct Frame;

struct SliceHeader {
  int nal_type = 0, tid = 0;
  int first_slice = 1, dependent = 0;
  int pps_id = 0, seg_addr = 0, slice_addr_rs = 0;
  int type = 2;                        // 0 B, 1 P, 2 I
  int pic_output = 1;
  int poc_lsb = 0;
  int rps_sps_flag = 1, rps_idx = 0;
  ShortTermRPS slice_rps; bool has_slice_rps = false;
  int num_lt_sps = 0, num_lt_pics = 0;
  int lt_poc[33], lt_used[33], lt_msb_present[33], lt_msb_cycle[33];
  int temporal_mvp = 0;
  int sao_luma = 0, sao_chroma = 0;
  int nref[2] = {0, 0};
  int list_mod[2] = {0, 0};
  std::vector<int> list_entry[2];
  int mvd_l1_zero = 0, cabac_init = 0;
  int col_from_l0 = 1, col_ref_idx = 0;
  PredWeight pw; bool has_pw = false;
  int max_merge = 5;
  int qp = 26;
  int cb_qp_off = 0, cr_qp_off = 0;
  int cu_chroma_qp_offset_enabled = 0;  // range ext (slice.cc:759-768)
  int deblock_override = 0, disable_deblock = 0;
  int beta_off = 0, tc_off = 0;
  int lf_across = 0;
  std::vector<int> entry_points;
  size_t header_bytes = 0;
  int init_type = 0;
  // ref lists (decode-order frame ids + poc + lt)
  int ref_frame[2][16]; int ref_poc[2][16]; uint8_t ref_lt[2][16];
  // colocated picture for TMVP, resolved at header-process time so motion
  // derivation can run after (possibly parallel) syntax parse
  Frame* col_frame = nullptr;
};

// Raw inter-PU syntax captured during CABAC parse. Motion derivation
// (merge/AMVP/TMVP) is replayed later from these records: no CABAC bin
// depends on derived motion values, which makes the per-frame syntax parse
// side-effect-free across frames and therefore frame-parallel.
struct RawPU {
  int16_t xc, yc, x0, y0, w, h;
  int16_t slice_idx;
  int8_t pidx, part_mode;
  uint8_t merge; int8_t merge_idx;
  int8_t inter_dir; int8_t ref_idx[2]; int8_t mvp[2];
  int16_t mvd[2][2];
};

// ============================ frame plan ==================================
struct TU {
  int8_t cidx; uint8_t log2; int32_t x, y;
  int16_t intra_mode; int16_t qp;
  uint8_t transform_skip, tq_bypass, pred_mode;  // pred_mode 1=intra
  int32_t coeff_off;  // -1 if none, else offset into coeff pool (n*n int16)
  int16_t ccp_alpha = 0;   // cross-component ResScaleVal (range ext)
  int8_t rdpcm = -1;       // explicit RDPCM: -1 none, 1 horiz, 2 vert
};
struct PU {
  int32_t x, y, w, h;
  uint8_t pf[2]; int16_t mv[2][2]; int8_t ref[2];
  int32_t ref_poc[2]; int32_t ref_frame[2];   // decode-order frame id
  int32_t slice_idx;
};

struct Frame {
  int poc = 0, frame_id = 0, nal_type = 0, output_flag = 1;
  int W = 0, H = 0, gw = 0, gh = 0, nctbx = 0, nctby = 0;
  const SPS* sps = nullptr; const PPS* pps = nullptr;
  // 4x4 grids
  std::vector<uint8_t> pred_mode, skip_flag, intra_y, intra_c, ct_depth,
      log2_cb, tq_bypass, pcm_flag, cbf_luma, tu_bound, pb_bound, cb_bound;
  // chroma mode was intra_chroma_pred_mode==4 (copy of luma): gates CCP
  // for intra CUs (range ext; reference is_IntraPredModeC_Mode4).
  // Parse-internal — not exported (recon reads per-TU ccp_alpha).
  std::vector<uint8_t> cmode4;
  std::vector<int8_t> qp_y;
  std::vector<int16_t> mv;          // gh*gw*2*2
  std::vector<int8_t> ref_idx;      // gh*gw*2
  std::vector<uint8_t> pred_flag;   // gh*gw*2
  std::vector<int32_t> refpoc;      // gh*gw*2
  std::vector<uint8_t> ref_lt;      // gh*gw*2
  // CTB grids
  std::vector<int32_t> slice_addr, ctb_slice_seg;
  // SAO: per ctb per comp
  std::vector<uint8_t> sao_type, sao_eo, sao_band;
  std::vector<int16_t> sao_off;     // nctb*3*4
  // work lists
  std::vector<TU> tus;
  std::vector<PU> pus;
  std::vector<int16_t> coeff_pool;
  std::vector<int16_t> pcm_pool;    // raw pcm samples y then cb,cr per pcm TU
  std::vector<SliceHeader> slices;
  std::vector<RawPU> raw_pus;       // inter-PU syntax awaiting derivation
  // compressed motion (16x16) for TMVP by later frames
  int mw = 0, mh = 0;
  std::vector<int16_t> cmv; std::vector<uint8_t> cpf; std::vector<int32_t> cpoc;
  std::vector<uint8_t> clt, cintra;

  void init(const SPS* s, const PPS* p, int poc_) {
    sps = s; pps = p; poc = poc_;
    W = s->width; H = s->height;
    gw = (W + 3) >> 2; gh = (H + 3) >> 2;
    nctbx = s->pic_w_ctbs; nctby = s->pic_h_ctbs;
    size_t g = (size_t)gw * gh;
    pred_mode.assign(g, 1); skip_flag.assign(g, 0);
    intra_y.assign(g, 255); intra_c.assign(g, 255);
    ct_depth.assign(g, 0); log2_cb.assign(g, 0);
    tq_bypass.assign(g, 0); pcm_flag.assign(g, 0); cbf_luma.assign(g, 0);
    cmode4.assign(g, 0);
    tu_bound.assign(g, 0); pb_bound.assign(g, 0); cb_bound.assign(g, 0);
    qp_y.assign(g, 0);
    mv.assign(g * 4, 0); ref_idx.assign(g * 2, -1);
    pred_flag.assign(g * 2, 0); refpoc.assign(g * 2, 0); ref_lt.assign(g * 2, 0);
    slice_addr.assign((size_t)nctbx * nctby, -1);
    ctb_slice_seg.assign((size_t)nctbx * nctby, -1);
    size_t nc = (size_t)nctbx * nctby * 3;
    sao_type.assign(nc, 0); sao_eo.assign(nc, 0); sao_band.assign(nc, 0);
    sao_off.assign(nc * 4, 0);
    mw = (W + 15) >> 4; mh = (H + 15) >> 4;
    cmv.assign((size_t)mw * mh * 4, 0); cpf.assign((size_t)mw * mh * 2, 0);
    cpoc.assign((size_t)mw * mh * 2, 0); clt.assign((size_t)mw * mh * 2, 0);
    cintra.assign((size_t)mw * mh, 1);
  }
  void compress_motion() {
    for (int my = 0; my < mh; my++)
      for (int mx = 0; mx < mw; mx++) {
        int gx = mx * 4, gy = my * 4;
        size_t gi = (size_t)gy * gw + gx, mi = (size_t)my * mw + mx;
        for (int l = 0; l < 2; l++) {
          cmv[mi * 4 + l * 2]     = mv[gi * 4 + l * 2];
          cmv[mi * 4 + l * 2 + 1] = mv[gi * 4 + l * 2 + 1];
          cpf[mi * 2 + l] = pred_flag[gi * 2 + l];
          cpoc[mi * 2 + l] = refpoc[gi * 2 + l];
          clt[mi * 2 + l] = ref_lt[gi * 2 + l];
        }
        cintra[mi] = pred_mode[gi] == 1;
      }
  }
};

}  // namespace

namespace {

// ============================ scan orders =================================
struct Scan { std::vector<uint8_t> x, y; std::vector<int16_t> idx_of; };
// scans[log2n][scanIdx] for n x n blocks (log2n up to 5); idx_of maps y*n+x->pos
static Scan g_scans[6][3];
static bool g_scans_init = false;

static void build_scan(int n, int scan_idx, Scan& s) {
  s.x.clear(); s.y.clear();
  if (scan_idx == 0) {  // up-right diagonal (spec 6.5.3)
    int x = 0, y = 0; bool stop = false;
    while (!stop) {
      while (y >= 0) {
        if (x < n && y < n) { s.x.push_back(x); s.y.push_back(y); }
        y--; x++;
      }
      y = x; x = 0;
      if ((int)s.x.size() >= n * n) stop = true;
    }
  } else if (scan_idx == 1) {  // horizontal
    for (int y = 0; y < n; y++) for (int x = 0; x < n; x++) { s.x.push_back(x); s.y.push_back(y); }
  } else {                      // vertical
    for (int x = 0; x < n; x++) for (int y = 0; y < n; y++) { s.x.push_back(x); s.y.push_back(y); }
  }
  s.idx_of.assign(n * n, 0);
  for (size_t i = 0; i < s.x.size(); i++) s.idx_of[s.y[i] * n + s.x[i]] = (int16_t)i;
}
// Significance-context lookup tables (same idea as the reference's
// precomputed ctxIdxLookup, slice.cc:1964-2240): for 4x4 subblocks of
// TBs >4x4 the per-position base pattern depends only on (scan order,
// neighbor-csbf "prev"); the remaining term is one per-subblock constant.
// g_map4 is CTX_IDX_MAP_4x4 reordered into scan position order.
static uint8_t g_sigbase[3][4][16];
static uint8_t g_map4[3][16];

static void init_sig_luts() {
  for (int scan = 0; scan < 3; scan++) {
    const Scan& cs = g_scans[2][scan];
    for (int n = 0; n < 16; n++) {
      int xP = cs.x[n], yP = cs.y[n];
      g_map4[scan][n] = CTX_IDX_MAP_4x4[(yP << 2) + xP];
      for (int prev = 0; prev < 4; prev++) {
        int sig;
        if (prev == 0) sig = (xP + yP == 0) ? 2 : (xP + yP < 3 ? 1 : 0);
        else if (prev == 1) sig = yP == 0 ? 2 : (yP == 1 ? 1 : 0);
        else if (prev == 2) sig = xP == 0 ? 2 : (xP == 1 ? 1 : 0);
        else sig = 2;
        g_sigbase[scan][prev][n] = (uint8_t)sig;
      }
    }
  }
}

static void init_scans() {
  if (g_scans_init) return;
  for (int l = 0; l <= 5; l++)
    for (int k = 0; k < 3; k++) build_scan(1 << l, k, g_scans[l][k]);
  init_sig_luts();
  g_scans_init = true;
}

// ======================= NAL / emulation prevention =======================
static void unescape(const uint8_t* src, size_t len, std::vector<uint8_t>& out,
                     std::vector<int>& skipped) {
  out.clear(); skipped.clear();
  int zeros = 0;
  for (size_t i = 0; i < len; i++) {
    uint8_t b = src[i];
    if (zeros >= 2 && b == 3) { skipped.push_back((int)out.size()); zeros = 0; continue; }
    out.push_back(b);
    zeros = (b == 0) ? zeros + 1 : 0;
  }
}

// ============================ header parsing ==============================
static void skip_ptl(Bitreader& br, int max_sub_layers) {
  br.bits(8);            // space/tier/idc
  br.bits(32);           // compat
  br.bits(32); br.bits(16);  // constraints (48)
  br.bits(8);            // level
  std::vector<int> sp, sl;
  for (int i = 0; i < max_sub_layers - 1; i++) { sp.push_back(br.bit()); sl.push_back(br.bit()); }
  if (max_sub_layers > 1) for (int i = max_sub_layers - 1; i < 8; i++) br.bits(2);
  for (int i = 0; i < max_sub_layers - 1; i++) {
    if (sp[i]) { br.bits(32); br.bits(32); br.bits(24); }  // 88 bits
    if (sl[i]) br.bits(8);
  }
}

static const uint8_t def_sl8_intra[64] = {
  16,16,16,16,17,18,21,24, 16,16,16,16,17,19,22,25, 16,16,17,18,20,22,25,29,
  16,16,18,21,24,27,31,36, 17,17,20,24,30,35,41,47, 18,19,22,27,35,44,54,65,
  21,22,25,31,41,54,70,88, 24,25,29,36,47,65,88,115};
static const uint8_t def_sl8_inter[64] = {
  16,16,16,16,17,18,20,24, 16,16,16,17,18,20,24,25, 16,16,17,18,20,24,25,28,
  16,17,18,20,24,25,28,33, 17,18,20,24,25,28,33,41, 18,20,24,25,28,33,41,54,
  20,24,25,28,33,41,54,71, 24,25,28,33,41,54,71,91};

static void default_sl(SPS& s) {
  for (int m = 0; m < 6; m++) {
    memset(s.sl4[m], 16, 16);
    memcpy(s.sl8[m], m < 3 ? def_sl8_intra : def_sl8_inter, 64);
    memcpy(s.sl16[m], m < 3 ? def_sl8_intra : def_sl8_inter, 64);
  }
  memcpy(s.sl32[0], def_sl8_intra, 64);
  memcpy(s.sl32[1], def_sl8_inter, 64);
}

static void read_scaling_list_data(Bitreader& br, SPS& s) {
  init_scans();
  default_sl(s);
  for (int size_id = 0; size_id < 4; size_id++) {
    int n_mat = size_id == 3 ? 2 : 6;
    for (int m = 0; m < n_mat; m++) {
      int pred = br.bit();
      uint8_t* dst = size_id == 0 ? s.sl4[m] : size_id == 1 ? s.sl8[m]
                     : size_id == 2 ? s.sl16[m] : s.sl32[m];
      if (!pred) {
        int delta = br.uvlc();
        if (delta == 0) {
          const uint8_t* def = size_id == 0 ? (const uint8_t*)nullptr
              : ((size_id == 3 ? m < 1 : m < 3) ? def_sl8_intra : def_sl8_inter);
          if (size_id == 0) memset(dst, 16, 16); else memcpy(dst, def, 64);
          if (size_id == 2) s.sl_dc16[m] = 16;
          if (size_id == 3) s.sl_dc32[m] = 16;
        } else {
          int ref = m - delta * (size_id == 3 ? 3 : 1);
          if (ref < 0 || ref >= n_mat) ref = 0;   // corrupt-stream guard
          const uint8_t* src = size_id == 0 ? s.sl4[ref] : size_id == 1 ? s.sl8[ref]
                               : size_id == 2 ? s.sl16[ref] : s.sl32[ref];
          memcpy(dst, src, size_id == 0 ? 16 : 64);
          if (size_id == 2) s.sl_dc16[m] = s.sl_dc16[ref];
          if (size_id == 3) s.sl_dc32[m] = s.sl_dc32[ref];
        }
      } else {
        int coefs = size_id == 0 ? 16 : 64;
        int next = 8;
        if (size_id > 1) {
          next = br.svlc() + 8;
          if (size_id == 2) s.sl_dc16[m] = next; else s.sl_dc32[m] = next;
        }
        int side = size_id == 0 ? 4 : 8;
        const Scan& sc = g_scans[size_id == 0 ? 2 : 3][0];
        for (int i = 0; i < coefs; i++) {
          next = (next + br.svlc() + 256) % 256;
          dst[sc.y[i] * side + sc.x[i]] = (uint8_t)next;
        }
      }
    }
  }
}

static void read_strps(Bitreader& br, std::vector<ShortTermRPS>& list, int idx,
                       int num_sets, bool in_slice, ShortTermRPS& out) {
  int inter_pred = 0;
  if (idx != 0) inter_pred = br.bit();
  if (inter_pred) {
    int delta_idx = 1;
    if (in_slice && idx == num_sets) delta_idx = br.uvlc() + 1;
    const ShortTermRPS& ref = list[idx - delta_idx];
    int sign = br.bit();
    int abs_d = br.uvlc() + 1;
    int drps = (1 - 2 * sign) * abs_d;
    int nref = (int)(ref.d0.size() + ref.d1.size());
    std::vector<int> used(nref + 1), use_delta(nref + 1);
    for (int j = 0; j <= nref; j++) {
      used[j] = br.bit();
      use_delta[j] = used[j] ? 1 : br.bit();
    }
    int n0 = (int)ref.d0.size(), n1 = (int)ref.d1.size();
    out.d0.clear(); out.u0.clear(); out.d1.clear(); out.u1.clear();
    for (int j = n1 - 1; j >= 0; j--) {
      int d = ref.d1[j] + drps;
      if (d < 0 && use_delta[n0 + j]) { out.d0.push_back(d); out.u0.push_back(used[n0 + j]); }
    }
    if (drps < 0 && use_delta[nref]) { out.d0.push_back(drps); out.u0.push_back(used[nref]); }
    for (int j = 0; j < n0; j++) {
      int d = ref.d0[j] + drps;
      if (d < 0 && use_delta[j]) { out.d0.push_back(d); out.u0.push_back(used[j]); }
    }
    for (int j = n0 - 1; j >= 0; j--) {
      int d = ref.d0[j] + drps;
      if (d > 0 && use_delta[j]) { out.d1.push_back(d); out.u1.push_back(used[j]); }
    }
    if (drps > 0 && use_delta[nref]) { out.d1.push_back(drps); out.u1.push_back(used[nref]); }
    for (int j = 0; j < n1; j++) {
      int d = ref.d1[j] + drps;
      if (d > 0 && use_delta[n0 + j]) { out.d1.push_back(d); out.u1.push_back(used[n0 + j]); }
    }
  } else {
    int nn = br.uvlc(), np = br.uvlc();
    int last = 0;
    out.d0.clear(); out.u0.clear(); out.d1.clear(); out.u1.clear();
    for (int i = 0; i < nn; i++) {
      last -= (int)br.uvlc() + 1;
      out.d0.push_back(last); out.u0.push_back(br.bit());
    }
    last = 0;
    for (int i = 0; i < np; i++) {
      last += (int)br.uvlc() + 1;
      out.d1.push_back(last); out.u1.push_back(br.bit());
    }
  }
}

static void skip_vui(Bitreader& br, int max_sub_layers) {
  if (br.bit()) { int idc = br.bits(8); if (idc == 255) br.bits(32); }
  if (br.bit()) br.bit();
  if (br.bit()) { br.bits(4); if (br.bit()) br.bits(24); }
  if (br.bit()) { br.uvlc(); br.uvlc(); }
  br.bits(3);
  if (br.bit()) { br.uvlc(); br.uvlc(); br.uvlc(); br.uvlc(); }
  if (br.bit()) {   // timing
    br.bits(32); br.bits(32);
    if (br.bit()) br.uvlc();
    if (br.bit()) {  // hrd
      int nal_hrd = br.bit(), vcl_hrd = br.bit(), sub_pic = 0;
      if (nal_hrd || vcl_hrd) {
        sub_pic = br.bit();
        if (sub_pic) { br.bits(8); br.bits(5); br.bits(31); br.bits(8); br.bits(8); }
        br.bits(8);
        if (sub_pic) br.bits(4);
        br.bits(15);
      }
      for (int i = 0; i < max_sub_layers; i++) {
        int fixed = br.bit();
        if (!fixed) fixed = br.bit();
        int low_delay = 0;
        if (fixed) br.uvlc(); else low_delay = br.bit();
        int cpb = low_delay ? 1 : (int)br.uvlc() + 1;
        for (int h = 0; h < 2; h++) {
          if ((h == 0 && nal_hrd) || (h == 1 && vcl_hrd))
            for (int c = 0; c < cpb; c++) {
              br.uvlc(); br.uvlc();
              if (sub_pic) { br.uvlc(); br.uvlc(); }
              br.bit();
            }
        }
      }
    }
  }
  if (br.bit()) { br.bits(3); for (int i = 0; i < 5; i++) br.uvlc(); }
}

static bool parse_sps(const uint8_t* d, size_t len, SPS& s) {
  Bitreader br(d + 2, len - 2);
  br.bits(4);
  int max_sub = br.bits(3) + 1;
  br.bit();
  skip_ptl(br, max_sub);
  s.sps_id = br.uvlc();
  s.chroma_format_idc = br.uvlc();
  if (s.chroma_format_idc == 3) s.separate_colour_plane = br.bit();
  s.width = br.uvlc(); s.height = br.uvlc();
  s.conformance_window = br.bit();
  if (s.conformance_window) for (int i = 0; i < 4; i++) s.conf_win[i] = br.uvlc();
  s.bd_luma = br.uvlc() + 8; s.bd_chroma = br.uvlc() + 8;
  s.log2_max_poc_lsb = br.uvlc() + 4;
  int ord = br.bit();
  int first = ord ? 0 : max_sub - 1;
  for (int i = first; i < max_sub; i++) {
    s.max_dec_pic_buffering = br.uvlc() + 1;
    s.max_num_reorder = br.uvlc();
    br.uvlc();
  }
  s.log2_min_cb = br.uvlc() + 3;
  s.log2_ctb = s.log2_min_cb + br.uvlc();
  s.log2_min_tb = br.uvlc() + 2;
  s.log2_max_tb = s.log2_min_tb + br.uvlc();
  s.max_trafo_depth_inter = br.uvlc();
  s.max_trafo_depth_intra = br.uvlc();
  s.scaling_list_enabled = br.bit();
  if (s.scaling_list_enabled) {
    s.scaling_list_present = br.bit();
    if (s.scaling_list_present) read_scaling_list_data(br, s);
    else default_sl(s);
  }
  s.amp = br.bit();
  s.sao = br.bit();
  s.pcm_enabled = br.bit();
  if (s.pcm_enabled) {
    s.pcm_bd_luma = br.bits(4) + 1;
    s.pcm_bd_chroma = br.bits(4) + 1;
    s.pcm_log2_min = br.uvlc() + 3;
    s.pcm_log2_diff = br.uvlc();
    s.pcm_loop_filter_disable = br.bit();
  }
  int nsets = br.uvlc();
  s.rps.clear();
  for (int i = 0; i < nsets; i++) {
    ShortTermRPS r;
    read_strps(br, s.rps, i, nsets, false, r);
    s.rps.push_back(r);
  }
  s.long_term_present = br.bit();
  if (s.long_term_present) {
    s.num_lt_sps = br.uvlc();
    for (int i = 0; i < s.num_lt_sps; i++) {
      s.lt_poc_lsb[i] = br.bits(s.log2_max_poc_lsb);
      s.lt_used[i] = br.bit();
    }
  }
  s.temporal_mvp = br.bit();
  s.strong_intra_smoothing = br.bit();
  if (br.bit()) skip_vui(br, max_sub);
  if (br.bit()) {                       // sps_extension_present
    int range_ext = br.bit();
    br.bits(3); br.bits(4);             // multilayer/3d/scc/reserved
    if (range_ext) {                    // sps_range_extension (sps.h:66-83)
      s.ts_rotation = br.bit();
      s.ts_context = br.bit();
      s.implicit_rdpcm = br.bit();
      s.explicit_rdpcm = br.bit();
      br.bit();                         // extended_precision_processing
      s.intra_smoothing_disabled = br.bit();
      br.bit();                         // high_precision_offsets
      s.persistent_rice = br.bit();
      s.cabac_bypass_align = br.bit();
    }
  }
  s.derive();
  // corrupted-stream guards (reference counterpart: sps.cc sanity checks
  // + sps.h:39-40 size bound): dimensions must be positive min-CB
  // multiples within spec bounds, tree/bit-depth params in range —
  // otherwise metadata grid writes in the CTB walk can run off the end.
  if (s.width <= 0 || s.height <= 0 || s.width > 17408 ||
      s.height > 17408 || s.log2_min_cb < 3 || s.log2_min_cb > 6 ||
      s.log2_ctb < s.log2_min_cb || s.log2_ctb > 6 ||
      (s.width & ((1 << s.log2_min_cb) - 1)) ||
      (s.height & ((1 << s.log2_min_cb) - 1)) ||
      s.log2_min_tb < 2 || s.log2_max_tb > 5 ||
      s.log2_max_tb < s.log2_min_tb || s.bd_luma < 8 || s.bd_luma > 16 ||
      s.bd_chroma < 8 || s.bd_chroma > 16 || s.chroma_format_idc > 3 ||
      s.log2_max_poc_lsb > 16)
    return false;
  return true;
}

static bool parse_pps(const uint8_t* d, size_t len, PPS& p, const SPS& sps) {
  Bitreader br(d + 2, len - 2);
  p.pps_id = br.uvlc();
  p.sps_id = br.uvlc();
  p.dependent_slices = br.bit();
  p.output_flag_present = br.bit();
  p.extra_bits = br.bits(3);
  p.sign_data_hiding = br.bit();
  p.cabac_init_present = br.bit();
  p.num_ref_l0 = br.uvlc() + 1;
  p.num_ref_l1 = br.uvlc() + 1;
  p.init_qp = br.svlc() + 26;
  p.constrained_intra = br.bit();
  p.transform_skip = br.bit();
  p.cu_qp_delta = br.bit();
  if (p.cu_qp_delta) p.diff_cu_qp_depth = br.uvlc();
  p.cb_qp_offset = br.svlc();
  p.cr_qp_offset = br.svlc();
  p.slice_chroma_qp = br.bit();
  p.weighted_pred = br.bit();
  p.weighted_bipred = br.bit();
  p.tq_bypass_enabled = br.bit();
  p.tiles = br.bit();
  p.wpp = br.bit();
  if (p.tiles) {
    p.num_tile_cols = br.uvlc() + 1;
    p.num_tile_rows = br.uvlc() + 1;
    p.uniform_spacing = br.bit();
    if (!p.uniform_spacing) {
      p.col_bd.assign(1, 0); p.row_bd.assign(1, 0);
      for (int i = 0; i < p.num_tile_cols - 1; i++)
        p.col_bd.push_back(p.col_bd.back() + br.uvlc() + 1);
      p.col_bd.push_back(sps.pic_w_ctbs);
      for (int i = 0; i < p.num_tile_rows - 1; i++)
        p.row_bd.push_back(p.row_bd.back() + br.uvlc() + 1);
      p.row_bd.push_back(sps.pic_h_ctbs);
    }
    p.lf_across_tiles = br.bit();
  }
  p.lf_across_slices = br.bit();
  p.deblock_control = br.bit();
  if (p.deblock_control) {
    p.deblock_override = br.bit();
    p.disable_deblock = br.bit();
    if (!p.disable_deblock) { p.beta_off = br.svlc() * 2; p.tc_off = br.svlc() * 2; }
  }
  p.scaling_list_present = br.bit();
  if (p.scaling_list_present) { SPS tmp = sps; read_scaling_list_data(br, tmp); }
  p.lists_modification = br.bit();
  p.log2_pml = br.uvlc() + 2;
  p.sh_ext = br.bit();
  if (br.bit()) {                       // pps_extension_present
    int range_ext = br.bit();
    br.bits(7);
    if (range_ext) {                    // pps_range_extension (pps.h:36-55)
      if (p.transform_skip) p.log2_max_tskip = br.uvlc() + 2;
      p.ccp_enabled = br.bit();
      p.chroma_qp_list_enabled = br.bit();
      if (p.chroma_qp_list_enabled) {
        p.diff_cu_chroma_qp_depth = br.uvlc();
        p.chroma_qp_list_len = br.uvlc() + 1;
        if (p.chroma_qp_list_len > 6) return false;
        for (int i = 0; i < p.chroma_qp_list_len; i++) {
          p.cb_qp_list[i] = br.svlc();
          p.cr_qp_list[i] = br.svlc();
        }
      }
      br.uvlc(); br.uvlc();             // log2_sao_offset_scale l/c
                                        // (recon-side; python pps keeps them)
    }
  }
  p.derive(sps);
  return true;
}

}  // namespace

namespace {

// ======================= NAL type helpers (spec Table 7-1) ================
static bool is_idr(int t) { return t == 19 || t == 20; }
static bool is_bla(int t) { return t >= 16 && t <= 18; }
static bool is_rap(int t) { return t >= 16 && t <= 23; }
static bool is_rasl(int t) { return t == 8 || t == 9; }
static bool is_radl(int t) { return t == 6 || t == 7; }
static bool is_sublayer_non_ref(int t) {
  return t == 0 || t == 2 || t == 4 || t == 6 || t == 8 || t == 10 || t == 12 || t == 14;
}

// =========================== slice header =================================
static bool parse_slice_header(const uint8_t* d, size_t len, int nal_type,
                               int tid, std::map<int, PPS>& ppss,
                               std::map<int, SPS>& spss, SliceHeader& sh) {
  Bitreader br(d + 2, len - 2);
  sh.nal_type = nal_type; sh.tid = tid;
  sh.first_slice = br.bit();
  if (is_rap(nal_type)) br.bit();  // no_output_of_prior_pics
  sh.pps_id = br.uvlc();
  if (!ppss.count(sh.pps_id)) return false;
  PPS& pps = ppss[sh.pps_id];
  SPS& sps = spss[pps.sps_id];
  sh.dependent = 0; sh.seg_addr = 0;
  if (!sh.first_slice) {
    if (pps.dependent_slices) sh.dependent = br.bit();
    int bits = 1; while ((1 << bits) < sps.pic_size_ctbs) bits++;
    if (sps.pic_size_ctbs == 1) bits = 0;
    // ceil(log2(PicSizeInCtbsY)) bits
    bits = 0; { int v = sps.pic_size_ctbs - 1; while (v > 0) { bits++; v >>= 1; } }
    sh.seg_addr = bits ? br.bits(bits) : 0;
    if (sh.seg_addr >= sps.pic_size_ctbs) return false;  // corrupt guard
  }
  if (!sh.dependent) {
    for (int i = 0; i < pps.extra_bits; i++) br.bit();
    sh.type = br.uvlc();
    sh.pic_output = pps.output_flag_present ? br.bit() : 1;
    if (sps.separate_colour_plane) br.bits(2);
    if (!is_idr(nal_type)) {
      sh.poc_lsb = br.bits(sps.log2_max_poc_lsb);
      sh.rps_sps_flag = br.bit();
      if (!sh.rps_sps_flag) {
        read_strps(br, spss[pps.sps_id].rps, (int)sps.rps.size(),
                   (int)sps.rps.size(), true, sh.slice_rps);
        sh.has_slice_rps = true;
      } else if (sps.rps.size() > 1) {
        int bits = 0; { int v = (int)sps.rps.size() - 1; while (v > 0) { bits++; v >>= 1; } }
        sh.rps_idx = bits ? br.bits(bits) : 0;
      } else sh.rps_idx = 0;
      if (sps.long_term_present) {
        if (sps.num_lt_sps > 0) sh.num_lt_sps = br.uvlc();
        sh.num_lt_pics = br.uvlc();
        for (int i = 0; i < sh.num_lt_sps + sh.num_lt_pics; i++) {
          if (i < sh.num_lt_sps) {
            int idx = 0;
            if (sps.num_lt_sps > 1) {
              int bits = 0; { int v = sps.num_lt_sps - 1; while (v > 0) { bits++; v >>= 1; } }
              idx = bits ? br.bits(bits) : 0;
            }
            sh.lt_poc[i] = sps.lt_poc_lsb[idx];
            sh.lt_used[i] = sps.lt_used[idx];
          } else {
            sh.lt_poc[i] = br.bits(sps.log2_max_poc_lsb);
            sh.lt_used[i] = br.bit();
          }
          sh.lt_msb_present[i] = br.bit();
          sh.lt_msb_cycle[i] = sh.lt_msb_present[i] ? br.uvlc() : 0;
        }
      }
      if (sps.temporal_mvp) sh.temporal_mvp = br.bit();
    }
    if (sps.sao) {
      sh.sao_luma = br.bit();
      if (sps.chroma_array_type) sh.sao_chroma = br.bit();
    }
    if (sh.type != 2) {
      sh.nref[0] = pps.num_ref_l0; sh.nref[1] = pps.num_ref_l1;
      if (br.bit()) {
        sh.nref[0] = br.uvlc() + 1;
        if (sh.type == 0) sh.nref[1] = br.uvlc() + 1;
      }
      if (sh.type != 0) sh.nref[1] = 0;
      if (pps.lists_modification) {
        // NumPicTotalCurr
        int n = 0;
        const ShortTermRPS* rp = sh.has_slice_rps ? &sh.slice_rps :
            (sh.rps_idx < (int)sps.rps.size() ? &sps.rps[sh.rps_idx] : nullptr);
        if (rp) {
          for (auto u : rp->u0) n += u;
          for (auto u : rp->u1) n += u;
        }
        for (int i = 0; i < sh.num_lt_sps + sh.num_lt_pics; i++) n += sh.lt_used[i];
        if (n > 1) {
          int bits = 1; { int v = n - 1; bits = 0; while (v > 0) { bits++; v >>= 1; } if (!bits) bits = 1; }
          sh.list_mod[0] = br.bit();
          if (sh.list_mod[0])
            for (int i = 0; i < sh.nref[0]; i++) sh.list_entry[0].push_back(br.bits(bits));
          if (sh.type == 0) {
            sh.list_mod[1] = br.bit();
            if (sh.list_mod[1])
              for (int i = 0; i < sh.nref[1]; i++) sh.list_entry[1].push_back(br.bits(bits));
          }
        }
      }
      if (sh.type == 0) sh.mvd_l1_zero = br.bit();
      if (pps.cabac_init_present) sh.cabac_init = br.bit();
      if (sh.temporal_mvp) {
        if (sh.type == 0) sh.col_from_l0 = br.bit();
        int na = sh.col_from_l0 ? sh.nref[0] : sh.nref[1];
        if (na > 1) sh.col_ref_idx = br.uvlc();
      }
      if ((pps.weighted_pred && sh.type == 1) ||
          (pps.weighted_bipred && sh.type == 0)) {
        sh.has_pw = true;
        PredWeight& w = sh.pw;
        w.luma_denom = br.uvlc();
        if (sps.chroma_array_type) w.chroma_denom = w.luma_denom + br.svlc();
        int nlists = sh.type == 0 ? 2 : 1;
        for (int l = 0; l < nlists; l++) {
          int n = sh.nref[l];
          int lflag[16], cflag[16];
          for (int i = 0; i < n; i++) lflag[i] = br.bit();
          for (int i = 0; i < n; i++) cflag[i] = sps.chroma_array_type ? br.bit() : 0;
          for (int i = 0; i < n; i++) {
            if (lflag[i]) { w.lw[l][i] = (1 << w.luma_denom) + br.svlc(); w.lo[l][i] = br.svlc(); }
            else { w.lw[l][i] = 1 << w.luma_denom; w.lo[l][i] = 0; }
            for (int c = 0; c < 2; c++) {
              if (cflag[i]) {
                int dw = br.svlc(), dof = br.svlc();
                int wc = (1 << w.chroma_denom) + dw;
                w.cw[l][i][c] = wc;
                w.co[l][i][c] = clip3(-128, 127, (128 + dof) - ((128 * wc) >> w.chroma_denom));
              } else { w.cw[l][i][c] = 1 << w.chroma_denom; w.co[l][i][c] = 0; }
            }
          }
        }
      }
      sh.max_merge = 5 - br.uvlc();
    }
    sh.qp = pps.init_qp + br.svlc();
    if (pps.slice_chroma_qp) { sh.cb_qp_off = br.svlc(); sh.cr_qp_off = br.svlc(); }
    if (pps.chroma_qp_list_enabled)
      sh.cu_chroma_qp_offset_enabled = br.bit();
    if (pps.deblock_control) {
      if (pps.deblock_override) sh.deblock_override = br.bit();
      if (sh.deblock_override) {
        sh.disable_deblock = br.bit();
        if (!sh.disable_deblock) { sh.beta_off = br.svlc() * 2; sh.tc_off = br.svlc() * 2; }
      } else {
        sh.disable_deblock = pps.disable_deblock;
        sh.beta_off = pps.beta_off; sh.tc_off = pps.tc_off;
      }
    } else { sh.beta_off = pps.beta_off; sh.tc_off = pps.tc_off; }
    if (sh.sao_luma || sh.sao_chroma || !sh.disable_deblock) {
      if (pps.lf_across_slices) sh.lf_across = br.bit();
    } else sh.lf_across = pps.lf_across_slices;
  }
  if (pps.tiles || pps.wpp) {
    int n = br.uvlc();
    if (n > 0) {
      int olen = br.uvlc() + 1;
      for (int i = 0; i < n; i++) sh.entry_points.push_back(br.bits(olen) + 1);
    }
  }
  if (ppss[sh.pps_id].sh_ext) { int el = br.uvlc(); for (int i = 0; i < el; i++) br.bits(8); }
  if (br.bit() != 1) return false;  // alignment_bit
  br.align();
  sh.header_bytes = 2 + (br.pos >> 3);
  if (sh.type == 2) sh.init_type = 0;
  else if (sh.type == 1) sh.init_type = sh.cabac_init ? 2 : 1;
  else sh.init_type = sh.cabac_init ? 1 : 2;
  return true;
}

}  // namespace

namespace {

// ============================ decoder context =============================
struct RefPic {        // decode-order frame bookkeeping for RPS/TMVP
  int poc = 0;
  int state = 0;       // 0 unused, 1 short-term, 2 long-term
  int frame_id = -1;   // decode-order id
  Frame* plan = nullptr;
};

struct Context;

// forward decl of slice reader entry
// per-picture CABAC context inheritance state (WPP row snapshots +
// dependent-slice continuation) — local to one picture's parse, so
// pictures can parse concurrently
struct PicState {
  std::map<int, ContextTable> wpp_ctx;
  ContextTable dep_ctx; bool has_dep_ctx = false;
};

static bool decode_slice_data(PicState& ps, Frame& f, SliceHeader& sh,
                              const uint8_t* data, size_t dlen, int sidx);

struct Context {
  std::map<int, SPS> spss;
  std::map<int, PPS> ppss;
  std::vector<Frame*> frames;       // decode order, owned
  std::vector<RefPic> dpb;          // slots
  Frame* cur = nullptr;
  int cur_slot = -1;
  int poc = 0, prev_tid0_poc = 0;
  bool first_pic = true;
  int next_frame_id = 0;
  // current-picture RPS result (dpb slot lists)
  std::vector<int> st_before, st_after, lt_curr;
  std::string error;
  // parse jobs: one per picture; syntax parse is frame-parallel, motion
  // derivation + TMVP compression replay serially in decode order
  struct PicJob {
    Frame* f = nullptr;
    struct SD { int slice_idx; std::vector<uint8_t> payload; };
    std::vector<SD> slices;
    bool failed = false;
  };
  std::vector<std::unique_ptr<PicJob>> jobs;
  size_t jobs_done = 0;
  PicJob* cur_job = nullptr;
  int num_threads = 0;  // 0 = auto

  void derive_motion(Frame& f);  // defined after SliceReader
  void derive_motion_wavefront(Frame& f, int nt);
  bool flush_jobs();

  // persistent wavefront-replay helpers (created lazily; cv-parked
  // between frames so they cost nothing while the CABAC pool owns the
  // cores). One job generation = one frame's run list.
  struct ReplayPool {
    std::vector<std::thread> th;
    std::mutex m;
    std::condition_variable cv, cv_done;
    std::function<void()> fn;
    uint64_t gen = 0;
    int done_for_gen = 0;
    bool stop_ = false;
    void ensure(int nw) {
      while ((int)th.size() < nw)
        th.emplace_back([this] {
          uint64_t seen = 0;
          for (;;) {
            std::function<void()> f;
            {
              std::unique_lock<std::mutex> lk(m);
              cv.wait(lk, [&] { return stop_ || gen != seen; });
              if (stop_) return;
              seen = gen;
              f = fn;
            }
            f();
            {
              std::lock_guard<std::mutex> lk(m);
              done_for_gen++;
            }
            cv_done.notify_all();
          }
        });
    }
    // dispatch f to the helpers and run it on the caller too; returns
    // after every participant finished (each generation is run exactly
    // once per helper — no helper from a previous generation can be
    // live here because the previous run() waited them all out)
    void run(int nw, const std::function<void()>& f) {
      ensure(nw);
      {
        std::lock_guard<std::mutex> lk(m);
        fn = f;
        done_for_gen = 0;
        gen++;
      }
      cv.notify_all();
      f();
      std::unique_lock<std::mutex> lk(m);
      cv_done.wait(lk, [&] { return done_for_gen == (int)th.size(); });
    }
    ~ReplayPool() {
      {
        std::lock_guard<std::mutex> lk(m);
        stop_ = true;
      }
      cv.notify_all();
      for (auto& t : th) t.join();
    }
  };
  ReplayPool replay_pool;

  ~Context() { for (auto* f : frames) delete f; }

  int free_slot() {
    for (size_t i = 0; i < dpb.size(); i++)
      if (dpb[i].state == 0) return (int)i;
    dpb.push_back(RefPic());
    return (int)dpb.size() - 1;
  }

  void compute_poc(const SliceHeader& sh, const SPS& sps) {
    int t = sh.nal_type;
    int max_lsb = 1 << sps.log2_max_poc_lsb;
    if (is_idr(t)) { poc = 0; prev_tid0_poc = 0; first_pic = false; return; }
    int prev = prev_tid0_poc;
    int prev_lsb = ((prev % max_lsb) + max_lsb) % max_lsb;
    int prev_msb = prev - prev_lsb;
    int lsb = sh.poc_lsb, msb;
    if (is_rap(t) && (first_pic || is_bla(t))) { msb = 0; poc = lsb; }
    else {
      if (lsb < prev_lsb && prev_lsb - lsb >= max_lsb / 2) msb = prev_msb + max_lsb;
      else if (lsb > prev_lsb && lsb - prev_lsb > max_lsb / 2) msb = prev_msb - max_lsb;
      else msb = prev_msb;
      poc = msb + lsb;
    }
    if (sh.tid == 0 && !is_rasl(t) && !is_radl(t) && !is_sublayer_non_ref(t))
      prev_tid0_poc = poc;
    first_pic = false;
  }

  int find_poc(int p) {
    for (size_t i = 0; i < dpb.size(); i++)
      if (dpb[i].state == 2 && dpb[i].poc == p) return (int)i;
    for (size_t i = 0; i < dpb.size(); i++)
      if (dpb[i].state == 1 && dpb[i].poc == p) return (int)i;
    return -1;
  }
  int find_poc_lsb(int lsb, int max_lsb) {
    for (int want_lt = 1; want_lt >= 0; want_lt--)
      for (size_t i = 0; i < dpb.size(); i++) {
        if (dpb[i].state == 0) continue;
        if ((dpb[i].state == 2) != (want_lt == 1)) continue;
        if (((dpb[i].poc % max_lsb) + max_lsb) % max_lsb == lsb) return (int)i;
      }
    return -1;
  }

  void process_rps(const SliceHeader& sh, const SPS& sps) {
    st_before.clear(); st_after.clear(); lt_curr.clear();
    const ShortTermRPS* rps = sh.has_slice_rps ? &sh.slice_rps :
        (sh.rps_idx < (int)sps.rps.size() ? &sps.rps[sh.rps_idx] : nullptr);
    std::vector<int> marked;
    if (rps) {
      for (size_t i = 0; i < rps->d0.size(); i++) {
        int p = poc + rps->d0[i];
        int s = find_poc(p);
        if (s < 0) { s = conceal_ref(p); }
        dpb[s].state = 1;
        if (rps->u0[i]) st_before.push_back(s);
        marked.push_back(s);
      }
      for (size_t i = 0; i < rps->d1.size(); i++) {
        int p = poc + rps->d1[i];
        int s = find_poc(p);
        if (s < 0) { s = conceal_ref(p); }
        dpb[s].state = 1;
        if (rps->u1[i]) st_after.push_back(s);
        marked.push_back(s);
      }
    }
    int max_lsb = 1 << sps.log2_max_poc_lsb;
    for (int i = 0; i < sh.num_lt_sps + sh.num_lt_pics; i++) {
      int plt = sh.lt_poc[i];
      int s;
      if (sh.lt_msb_present[i]) {
        plt = poc - sh.lt_msb_cycle[i] * max_lsb - (sh.poc_lsb - sh.lt_poc[i]);
        s = find_poc(plt);
      } else s = find_poc_lsb(plt, max_lsb);
      if (s < 0) s = conceal_ref(plt);
      dpb[s].state = 2;
      if (sh.lt_used[i]) lt_curr.push_back(s);
      marked.push_back(s);
    }
    for (size_t i = 0; i < dpb.size(); i++) {
      if ((int)i == cur_slot) continue;
      if (dpb[i].state != 0 &&
          std::find(marked.begin(), marked.end(), (int)i) == marked.end())
        dpb[i].state = 0;
    }
  }

  int conceal_ref(int p) {
    // grey concealment frame: metadata-only plan (all-intra => no TMVP use)
    int s = free_slot();
    Frame* f = new Frame();
    const SPS& sps = spss.begin()->second;
    const PPS& pps = ppss.begin()->second;
    f->init(&sps, &pps, p);
    f->frame_id = next_frame_id++;
    f->output_flag = 0;
    f->nal_type = -1;  // concealment marker
    frames.push_back(f);
    dpb[s] = RefPic{p, 1, f->frame_id, f};
    return s;
  }

  void build_ref_lists(SliceHeader& sh) {
    for (int l = 0; l < 2; l++) {
      int n_active = sh.nref[l];
      std::vector<int> base;
      if (l == 0) {
        base = st_before;
        base.insert(base.end(), st_after.begin(), st_after.end());
      } else {
        base = st_after;
        base.insert(base.end(), st_before.begin(), st_before.end());
      }
      base.insert(base.end(), lt_curr.begin(), lt_curr.end());
      std::vector<int> out;
      if (!base.empty()) {
        std::vector<int> full = base;
        while ((int)full.size() < n_active)
          full.insert(full.end(), base.begin(), base.end());
        if (sh.list_mod[l]) {
          for (int i = 0; i < n_active; i++) out.push_back(full[sh.list_entry[l][i]]);
        } else {
          out.assign(full.begin(), full.begin() + n_active);
        }
      }
      for (int i = 0; i < (int)out.size() && i < 16; i++) {
        sh.ref_frame[l][i] = dpb[out[i]].frame_id;
        sh.ref_poc[l][i] = dpb[out[i]].poc;
        sh.ref_lt[l][i] = dpb[out[i]].state == 2;
      }
      sh.nref[l] = std::min(sh.nref[l], 16);
    }
  }

  Frame* col_plan(const SliceHeader& sh) {
    if (!sh.temporal_mvp) return nullptr;
    int l = sh.col_from_l0 ? 0 : 1;
    if (sh.col_ref_idx >= sh.nref[l]) return nullptr;
    int fid = sh.ref_frame[l][sh.col_ref_idx];
    for (auto& rp : dpb) if (rp.state && rp.frame_id == fid) return rp.plan;
    return nullptr;
  }

  bool decode_nal(const uint8_t* data, size_t len,
                  const std::vector<int>& skipped) {
    if (len < 2) return true;
    int nal_type = (data[0] >> 1) & 0x3F;
    int tid = (data[1] & 7) - 1;
    int layer = ((data[0] & 1) << 5) | (data[1] >> 3);
    if (layer) return true;
    if (nal_type == 33) {
      SPS s; if (!parse_sps(data, len, s)) return false;
      // queued parse jobs hold SPS/PPS pointers: drain before mutating
      if (spss.count(s.sps_id)) { finish_picture(); if (!flush_jobs()) return false; }
      spss[s.sps_id] = s; return true;
    }
    if (nal_type == 34) {
      PPS p2;
      // need sps id first: peek
      { Bitreader br(data + 2, len - 2); br.uvlc(); int sid = br.uvlc();
        if (!spss.count(sid)) return false;
        if (!parse_pps(data, len, p2, spss[sid])) return false; }
      if (ppss.count(p2.pps_id)) { finish_picture(); if (!flush_jobs()) return false; }
      ppss[p2.pps_id] = p2;
      return true;
    }
    if (nal_type >= 32) return true;  // VPS/SEI/AUD etc.
    // slice NAL
    SliceHeader sh;
    if (!parse_slice_header(data, len, nal_type, tid, ppss, spss, sh)) {
      error = "slice header parse failed";
      return false;
    }
    PPS& pps = ppss[sh.pps_id];
    SPS& sps = spss[pps.sps_id];
    if (sh.first_slice) start_picture(sh, sps, pps);
    if (!cur) return false;
    if (!sh.dependent) {
      sh.slice_addr_rs = sh.seg_addr;
      cur_indep = sh;
    } else {
      SliceHeader parent = cur_indep;
      int seg = sh.seg_addr, dep = sh.dependent; size_t hb = sh.header_bytes;
      std::vector<int> ep = sh.entry_points;
      sh = parent;
      sh.seg_addr = seg; sh.dependent = dep; sh.header_bytes = hb;
      sh.first_slice = 0;
      sh.entry_points = ep;
      sh.slice_addr_rs = parent.slice_addr_rs;
    }
    if (sh.type != 2) {
      process_lists_for_slice(sh, sps);
    }
    // entry point fixup for removed emulation-prevention bytes
    if (!sh.entry_points.empty() && !skipped.empty()) {
      std::vector<int> rel;
      for (int s : skipped) if (s >= (int)sh.header_bytes) rel.push_back(s - (int)sh.header_bytes);
      std::sort(rel.begin(), rel.end());
      std::vector<int> fixed;
      long prev_stripped = 0, acc = 0;
      for (int off : sh.entry_points) {
        acc += off;
        long n = 0;
        for (size_t k = 0; k < rel.size(); k++) {
          if (rel[k] + (long)k < acc) n = k + 1; else break;
        }
        long sp = acc - n;
        fixed.push_back((int)(sp - prev_stripped));
        prev_stripped = sp;
      }
      sh.entry_points = fixed;
    }
    cur->slices.push_back(sh);
    int sidx = (int)cur->slices.size() - 1;
    cur_job->slices.push_back(
        {sidx, std::vector<uint8_t>(data + sh.header_bytes, data + len)});
    return true;
  }

  SliceHeader cur_indep;

  void process_lists_for_slice(SliceHeader& sh, const SPS& sps) {
    build_ref_lists(sh);
    sh.col_frame = col_plan(sh);
  }

  void start_picture(const SliceHeader& sh, SPS& sps, PPS& pps) {
    finish_picture();
    compute_poc(sh, sps);
    if (is_idr(sh.nal_type)) {
      for (auto& rp : dpb) rp.state = 0;
      st_before.clear(); st_after.clear(); lt_curr.clear();
    }
    cur_slot = free_slot();
    Frame* f = new Frame();
    f->init(&sps, &pps, poc);
    f->frame_id = next_frame_id++;
    f->nal_type = sh.nal_type;
    frames.push_back(f);
    cur = f;
    dpb[cur_slot] = RefPic{poc, 1, f->frame_id, f};
    if (!is_idr(sh.nal_type)) process_rps(sh, sps);
    jobs.emplace_back(new PicJob());
    cur_job = jobs.back().get();
    cur_job->f = f;
  }

  void finish_picture() {
    if (!cur) return;
    cur = nullptr;
    cur_slot = -1;
    cur_job = nullptr;
  }
};

}  // namespace

namespace {

// ============================ slice reader ================================
struct SliceReader {
  PicState* ps;       // null in motion-derivation (replay) mode
  Frame& f;
  SliceHeader& sh;
  const SPS& sps;
  const PPS& pps;
  const uint8_t* data; size_t dlen;
  ContextTable ct;
  Cabac* cb = nullptr;
  Frame* col = nullptr;

  // QP state
  int qp_prev, cu_qp_delta = 0; bool qp_delta_coded = false;
  int qg_x = 0, qg_y = 0, last_cu_qp, cur_cu_qp;
  bool cur_tq_bypass = false;
  int cur_pred_mode = 1, cur_part_mode = 0, cur_intra_split = 0, cur_log2_cb = 0;
  bool merge_2nx2n = false;
  bool last_ts_flag = false;
  // range-extension residual state
  int last_rdpcm = -1;                 // explicit RDPCM of last residual()
  int cu_qp_off_cb = 0, cu_qp_off_cr = 0;   // TU-level chroma QP offsets
  bool chroma_qp_offset_coded = false;
  int ctb_log2, ctb_size, min_cb_log2, W, H, wctbs;
  int slice_idx;

  SliceReader(PicState* p, Frame& fr, SliceHeader& s, const uint8_t* d,
              size_t l, int sidx)
      : ps(p), f(fr), sh(s), sps(*fr.sps), pps(*fr.pps), data(d), dlen(l) {
    qp_prev = sh.qp; last_cu_qp = sh.qp; cur_cu_qp = sh.qp;
    ctb_log2 = sps.log2_ctb; ctb_size = sps.ctb_size;
    min_cb_log2 = sps.log2_min_cb;
    W = f.W; H = f.H; wctbs = sps.pic_w_ctbs;
    col = s.col_frame;
    slice_idx = sidx;
  }

  // ---- availability (spec 6.4.1) ----
  int zorder(int x, int y) const {
    // table-driven bit spread (this runs ~8x per PU in the motion
    // replay's availability checks — the loop version showed up in the
    // derive_motion profile)
    static const struct Spread {
      uint16_t t[256];
      Spread() {
        for (int v = 0; v < 256; v++) {
          int z = 0;
          for (int b = 0; b < 8; b++) z |= ((v >> b) & 1) << (2 * b);
          t[v] = (uint16_t)z;
        }
      }
    } sp;
    int xr = (x & (ctb_size - 1)) >> 2, yr = (y & (ctb_size - 1)) >> 2;
    return sp.t[xr] | (sp.t[yr] << 1);
  }
  bool avail(int xc, int yc, int xn, int yn) const {
    if (xn < 0 || yn < 0 || xn >= W || yn >= H) return false;
    int rs_c = (yc >> ctb_log2) * wctbs + (xc >> ctb_log2);
    int rs_n = (yn >> ctb_log2) * wctbs + (xn >> ctb_log2);
    int ts_c = pps.rs_to_ts[rs_c], ts_n = pps.rs_to_ts[rs_n];
    if (ts_n > ts_c) return false;
    if (ts_n == ts_c && zorder(xn, yn) >= zorder(xc, yc)) return false;
    if (f.slice_addr[rs_n] != f.slice_addr[rs_c]) return false;
    if (pps.tile_id[rs_n] != pps.tile_id[rs_c]) return false;
    return true;
  }
  bool avail_pred(int xc, int yc, int xn, int yn) const {
    if (!avail(xc, yc, xn, yn)) return false;
    return f.pred_mode[(size_t)(yn >> 2) * f.gw + (xn >> 2)] == 0;  // inter
  }

  size_t G(int gx, int gy) const { return (size_t)gy * f.gw + gx; }

  // =============== top-level substream loop ===============
  bool run() {
    if (sh.dependent && ps->has_dep_ctx) ct = ps->dep_ctx;
    else ct.init(sh.init_type, clip3(0, 51, sh.qp));
    int ctb_ts = pps.rs_to_ts[sh.seg_addr];
    std::vector<size_t> offs; offs.push_back(0);
    for (int e : sh.entry_points) offs.push_back(offs.back() + e);
    offs.push_back(dlen);
    int substream = 0;
    Cabac cabac(data, dlen, offs[0]);
    cb = &cabac;
    bool first = true;
    while (true) {
      int rs = pps.ts_to_rs[ctb_ts];
      int cx = rs % wctbs, cy = rs / wctbs;
      int xctb = cx << ctb_log2, yctb = cy << ctb_log2;
      bool tile_start = ctb_ts == 0 ||
          pps.tile_id[rs] != pps.tile_id[pps.ts_to_rs[ctb_ts - 1]];
      bool row_start = cx == 0;
      f.ctb_slice_seg[rs] = sh.seg_addr;     // record before availability use
      f.slice_addr[rs] = sh.slice_addr_rs;
      if (!first) {
        if (pps.tiles && tile_start) {
          substream++;
          cabac = Cabac(data, dlen, offs[substream]);
          ct.init(sh.init_type, clip3(0, 51, sh.qp));
          qp_prev = sh.qp; last_cu_qp = sh.qp;
        } else if (pps.wpp && row_start) {
          substream++;
          cabac = Cabac(data, dlen, offs[substream]);
          // 1-CTB-wide pictures: the reference re-initializes the models
          // per row (slice.cc:4696-4703); no snapshot restore at width 1.
          auto it = ps->wpp_ctx.find(cy - 1);
          bool ar_ok = wctbs > 1 &&
              avail(xctb, yctb, xctb + ctb_size, yctb - ctb_size);
          if (it != ps->wpp_ctx.end() && ar_ok) ct = it->second;
          else ct.init(sh.init_type, clip3(0, 51, sh.qp));
          qp_prev = sh.qp; last_cu_qp = sh.qp;
        }
      } else if (pps.wpp && row_start && cy > 0) {
        auto it = ps->wpp_ctx.find(cy - 1);
        if (sh.dependent) {
          // a dependent segment starting at a row start takes the WPP
          // model of the row above, OVERRIDING the dependent-
          // continuation ctx (reference decode_substream,
          // slice.cc:4679-4702: the sync restore runs whenever
          // !first_independent_substream). Found by the adversarial
          // wpp x dependent-slices vector (round 4). Width-1 pictures
          // re-init instead (slice.cc:4696-4703).
          if (wctbs == 1) ct.init(sh.init_type, clip3(0, 51, sh.qp));
          else if (it != ps->wpp_ctx.end()) ct = it->second;
        } else if (wctbs > 1) {
          bool ar_ok = avail(xctb, yctb, xctb + ctb_size, yctb - ctb_size);
          if (it != ps->wpp_ctx.end() && ar_ok) ct = it->second;
        }
      }
      f.ctb_slice_seg[rs] = sh.seg_addr;
      f.slice_addr[rs] = sh.slice_addr_rs;
      if (sh.sao_luma || sh.sao_chroma) read_sao(cx, cy, xctb, yctb);
      if (!coding_quadtree(xctb, yctb, ctb_log2, 0)) return false;
      if (pps.wpp && cx == 1)   // width-1 pictures never snapshot
        ps->wpp_ctx[cy] = ct;
      int end = cb->term();
      first = false;
      ctb_ts++;
      if (end) break;
      if (ctb_ts >= sps.pic_size_ctbs) break;
      int nrs = pps.ts_to_rs[ctb_ts];
      bool ntile = pps.tile_id[nrs] != pps.tile_id[rs];
      bool nrow = (nrs % wctbs) == 0;
      if ((pps.tiles && ntile) || (pps.wpp && nrow)) cb->term();
    }
    ps->dep_ctx = ct; ps->has_dep_ctx = true;
    return true;
  }

  // ======================== SAO (7.3.8.3) ========================
  void read_sao(int cx, int cy, int xctb, int yctb) {
    size_t base = ((size_t)cy * f.nctbx + cx) * 3;
    bool merged = false;
    if (cx > 0 && avail(xctb, yctb, xctb - 1, yctb)) {
      if (cb->bin(ct.m[CTX_SAO_MERGE])) {
        size_t src = ((size_t)cy * f.nctbx + cx - 1) * 3;
        for (int c = 0; c < 3; c++) {
          f.sao_type[base + c] = f.sao_type[src + c];
          f.sao_eo[base + c] = f.sao_eo[src + c];
          f.sao_band[base + c] = f.sao_band[src + c];
          for (int k = 0; k < 4; k++)
            f.sao_off[(base + c) * 4 + k] = f.sao_off[(src + c) * 4 + k];
        }
        merged = true;
      }
    }
    if (!merged && cy > 0 && avail(xctb, yctb, xctb, yctb - 1)) {
      if (cb->bin(ct.m[CTX_SAO_MERGE])) {
        size_t src = ((size_t)(cy - 1) * f.nctbx + cx) * 3;
        for (int c = 0; c < 3; c++) {
          f.sao_type[base + c] = f.sao_type[src + c];
          f.sao_eo[base + c] = f.sao_eo[src + c];
          f.sao_band[base + c] = f.sao_band[src + c];
          for (int k = 0; k < 4; k++)
            f.sao_off[(base + c) * 4 + k] = f.sao_off[(src + c) * 4 + k];
        }
        merged = true;
      }
    }
    if (merged) return;
    for (int c = 0; c < 3; c++) {
      if (c == 0 && !sh.sao_luma) continue;
      if (c > 0 && !sh.sao_chroma) continue;
      int t;
      if (c == 2) t = f.sao_type[base + 1];
      else {
        if (cb->bin(ct.m[CTX_SAO_TYPE])) t = cb->bypass() ? 2 : 1;
        else t = 0;
      }
      f.sao_type[base + c] = t;
      if (!t) continue;
      // sao_offset_abs cMax uses the COMPONENT's bit depth (7.4.9.3)
      int bd_comp = c == 0 ? sps.bd_luma : sps.bd_chroma;
      int cmax = (1 << (std::min(bd_comp, 10) - 5)) - 1;
      int offs[4];
      for (int k = 0; k < 4; k++) offs[k] = cb->tu_bypass(cmax);
      if (t == 1) {
        for (int k = 0; k < 4; k++)
          if (offs[k] && cb->bypass()) offs[k] = -offs[k];
        f.sao_band[base + c] = cb->bypass_bits(5);
      } else {
        offs[2] = -offs[2]; offs[3] = -offs[3];
        if (c == 0) f.sao_eo[base] = cb->bypass_bits(2);
        else if (c == 1) {
          int eo = cb->bypass_bits(2);
          f.sao_eo[base + 1] = eo; f.sao_eo[base + 2] = eo;
        }
      }
      for (int k = 0; k < 4; k++) f.sao_off[(base + c) * 4 + k] = offs[k];
    }
  }

  // ==================== quadtree / CU (7.3.8.4/5) ====================
  bool coding_quadtree(int x0, int y0, int log2, int depth) {
    bool split;
    if (x0 + (1 << log2) <= W && y0 + (1 << log2) <= H && log2 > min_cb_log2) {
      int inc = 0;
      if (avail(x0, y0, x0 - 1, y0) && f.ct_depth[G((x0 - 1) >> 2, y0 >> 2)] > depth) inc++;
      if (avail(x0, y0, x0, y0 - 1) && f.ct_depth[G(x0 >> 2, (y0 - 1) >> 2)] > depth) inc++;
      split = cb->bin(ct.m[CTX_SPLIT_CU + inc]);
    } else split = log2 > min_cb_log2;
    if (pps.cu_qp_delta && log2 >= ctb_log2 - pps.diff_cu_qp_depth) {
      qp_delta_coded = false; cu_qp_delta = 0;
      qg_x = x0; qg_y = y0;
      qp_prev = last_cu_qp;
    }
    // chroma QP offset group (range ext, slice.cc:4621-4624)
    if (sh.cu_chroma_qp_offset_enabled &&
        log2 >= ctb_log2 - pps.diff_cu_chroma_qp_depth)
      chroma_qp_offset_coded = false;
    if (split) {
      int half = 1 << (log2 - 1);
      if (!coding_quadtree(x0, y0, log2 - 1, depth + 1)) return false;
      if (x0 + half < W && !coding_quadtree(x0 + half, y0, log2 - 1, depth + 1)) return false;
      if (y0 + half < H && !coding_quadtree(x0, y0 + half, log2 - 1, depth + 1)) return false;
      if (x0 + half < W && y0 + half < H &&
          !coding_quadtree(x0 + half, y0 + half, log2 - 1, depth + 1)) return false;
      return true;
    }
    return coding_unit(x0, y0, log2, depth);
  }

  template <typename T>
  void fill_grid(std::vector<T>& g, int x0, int y0, int size, T v) {
    int gx = x0 >> 2, gy = y0 >> 2, gs = size >> 2;
    for (int y = 0; y < gs; y++)
      for (int x = 0; x < gs; x++) g[G(gx + x, gy + y)] = v;
  }

  void derive_cu_qp(int x0, int y0) {
    if (!pps.cu_qp_delta) { cur_cu_qp = sh.qp; return; }
    int qa, qb;
    if (avail(qg_x, qg_y, qg_x - 1, qg_y) &&
        ((qg_x - 1) >> ctb_log2 == qg_x >> ctb_log2))
      qa = f.qp_y[G((qg_x - 1) >> 2, qg_y >> 2)];
    else qa = qp_prev;
    if (avail(qg_x, qg_y, qg_x, qg_y - 1) &&
        ((qg_y - 1) >> ctb_log2 == qg_y >> ctb_log2))
      qb = f.qp_y[G(qg_x >> 2, (qg_y - 1) >> 2)];
    else qb = qp_prev;
    int pred = (qa + qb + 1) >> 1;
    cur_cu_qp = ((pred + cu_qp_delta + 104) % 52);
  }

  bool coding_unit(int x0, int y0, int log2, int depth) {
    int size = 1 << log2;
    int gx = x0 >> 2, gy = y0 >> 2, gs = size >> 2;
    fill_grid(f.ct_depth, x0, y0, size, (uint8_t)depth);
    fill_grid(f.log2_cb, x0, y0, size, (uint8_t)log2);
    for (int y = 0; y < gs; y++) f.cb_bound[G(gx, gy + y)] |= 1;
    for (int x = 0; x < gs; x++) f.cb_bound[G(gx + x, gy)] |= 2;

    cur_tq_bypass = false;
    if (pps.tq_bypass_enabled) cur_tq_bypass = cb->bin(ct.m[CTX_TQBYPASS]);
    fill_grid(f.tq_bypass, x0, y0, size, (uint8_t)(cur_tq_bypass ? 1 : 0));

    bool skip = false;
    if (sh.type != 2) {
      int inc = 0;
      if (avail(x0, y0, x0 - 1, y0) && f.skip_flag[G(gx - 1, gy)]) inc++;
      if (avail(x0, y0, x0, y0 - 1) && f.skip_flag[G(gx, gy - 1)]) inc++;
      skip = cb->bin(ct.m[CTX_SKIP + inc]);
    }
    fill_grid(f.skip_flag, x0, y0, size, (uint8_t)(skip ? 1 : 0));
    derive_cu_qp(x0, y0);
    fill_grid(f.qp_y, x0, y0, size, (int8_t)cur_cu_qp);
    cur_cu_x = x0; cur_cu_y = y0; cur_log2_cb = log2;

    if (skip) {
      fill_grid(f.pred_mode, x0, y0, size, (uint8_t)0);
      prediction_unit(x0, y0, x0, y0, size, size, true, 0, 1, depth, 0);
      last_cu_qp = cur_cu_qp;
      return true;
    }
    int pred_mode = 1;
    if (sh.type != 2) pred_mode = cb->bin(ct.m[CTX_PREDMODE]) ? 1 : 0;
    fill_grid(f.pred_mode, x0, y0, size, (uint8_t)pred_mode);

    int part_mode = 0;  // 2Nx2N
    if (pred_mode != 1 || log2 == min_cb_log2) {
      if (pred_mode == 1) {
        if (log2 == min_cb_log2)
          part_mode = cb->bin(ct.m[CTX_PARTMODE]) ? 0 : 3;  // 2Nx2N : NxN
      } else part_mode = decode_part_mode_inter(log2);
    }

    bool pcm = false;
    if (pred_mode == 1) {
      if (part_mode == 0 && sps.pcm_enabled &&
          log2 >= sps.pcm_log2_min &&
          log2 <= sps.pcm_log2_min + sps.pcm_log2_diff)
        pcm = cb->term();
      if (pcm) {
        fill_grid(f.pcm_flag, x0, y0, size, (uint8_t)1);
        read_pcm(x0, y0, log2);
        last_cu_qp = cur_cu_qp;
        return true;
      }
      intra_pred_info(x0, y0, log2, part_mode);
    } else {
      inter_pred_info(x0, y0, log2, part_mode, depth);
    }

    bool rqt_root = true;
    if (pred_mode != 1 && !(part_mode == 0 && merge_2nx2n))
      rqt_root = cb->bin(ct.m[CTX_RQT_ROOT]);
    if (rqt_root) {
      cur_intra_split = (pred_mode == 1 && part_mode == 3) ? 1 : 0;
      int max_depth = pred_mode == 1
          ? sps.max_trafo_depth_intra + cur_intra_split
          : sps.max_trafo_depth_inter;
      cur_pred_mode = pred_mode; cur_part_mode = part_mode;
      if (!transform_tree(x0, y0, x0, y0, log2, 0, 0, max_depth, 1, 1))
        return false;
    }
    last_cu_qp = cur_cu_qp;
    return true;
  }
  int cur_cu_x = 0, cur_cu_y = 0;

  int decode_part_mode_inter(int log2) {
    if (cb->bin(ct.m[CTX_PARTMODE])) return 0;
    if (log2 > min_cb_log2) {
      if (!sps.amp) return cb->bin(ct.m[CTX_PARTMODE + 1]) ? 1 : 2;
      int b1 = cb->bin(ct.m[CTX_PARTMODE + 1]);
      int b2 = cb->bin(ct.m[CTX_PARTMODE + 3]);
      if (b1) { if (b2) return 1; return cb->bypass() ? 5 : 4; }
      else { if (b2) return 2; return cb->bypass() ? 7 : 6; }
    } else {
      if (cb->bin(ct.m[CTX_PARTMODE + 1])) return 1;
      if (log2 == 3) return 2;
      return cb->bin(ct.m[CTX_PARTMODE + 2]) ? 2 : 3;
    }
  }

  // ---------------- intra info (7.3.8.5, 8.4.2) ----------------
  int neigh_mode(int x, int y, int nx, int ny, bool same_row) {
    if (!avail(x, y, nx, ny)) return 1;
    if (same_row && (ny >> ctb_log2) != (y >> ctb_log2)) return 1;
    size_t g = G(nx >> 2, ny >> 2);
    if (f.pred_mode[g] != 1 || f.pcm_flag[g]) return 1;
    return f.intra_y[g];
  }
  int derive_intra(int x, int y, int prev, int val) {
    int ca = neigh_mode(x, y, x - 1, y, false);
    int cbm = neigh_mode(x, y, x, y - 1, true);
    int mpm[3];
    if (ca == cbm) {
      if (ca < 2) { mpm[0] = 0; mpm[1] = 1; mpm[2] = 26; }
      else { mpm[0] = ca; mpm[1] = 2 + ((ca + 29) % 32); mpm[2] = 2 + ((ca - 1) % 32); }
    } else {
      mpm[0] = ca; mpm[1] = cbm;
      if (ca != 0 && cbm != 0) mpm[2] = 0;
      else if (ca + cbm < 2) mpm[2] = 26;
      else mpm[2] = 1;
    }
    if (prev) return mpm[val];
    int m[3] = {mpm[0], mpm[1], mpm[2]};
    std::sort(m, m + 3);
    int mode = val;
    for (int i = 0; i < 3; i++) if (mode >= m[i]) mode++;
    return mode;
  }
  void intra_pred_info(int x0, int y0, int log2, int part_mode) {
    int n_parts = part_mode == 3 ? 4 : 1;
    int pb = (1 << log2) >> (n_parts == 4 ? 1 : 0);
    int prev[4], val[4];
    for (int i = 0; i < n_parts; i++) prev[i] = cb->bin(ct.m[CTX_PREVINTRA]);
    for (int i = 0; i < n_parts; i++) {
      if (prev[i]) val[i] = cb->tu_bypass(2);
      else val[i] = cb->bypass_bits(5);
    }
    int mode0 = 0;
    for (int i = 0; i < n_parts; i++) {
      int px = x0 + (i & 1) * pb, py = y0 + (i >> 1) * pb;
      int mode = derive_intra(px, py, prev[i], val[i]);
      if (i == 0) mode0 = mode;
      fill_grid(f.intra_y, px, py, pb, (uint8_t)mode);
    }
    // chroma mode: one per CU (4:2:0/4:2:2, remapped via Table 8-23 for
    // 4:2:2) or one per PB (4:4:4; slice.cc:4447-4470)
    static const uint8_t map422[35] = {
      0, 1, 2, 2, 2, 2, 3, 5, 7, 8, 10, 12, 13, 15, 17, 18, 19, 20,
      21, 22, 23, 23, 24, 24, 25, 25, 26, 27, 27, 28, 28, 29, 29, 30, 31};
    bool cmode4 = false;
    auto read_cmode = [&](int luma_mode) {
      int cmode;
      if (cb->bin(ct.m[CTX_CHROMAMODE])) {
        static const int cands[4] = {0, 26, 10, 1};
        int c = cands[cb->bypass_bits(2)];
        cmode = (c == luma_mode) ? 34 : c;
        cmode4 = false;
      } else { cmode = luma_mode; cmode4 = true; }  // mode 4: luma copy
      if (sps.chroma_array_type == 2) cmode = map422[cmode];
      return cmode;
    };
    if (sps.chroma_array_type == 3) {
      for (int i = 0; i < n_parts; i++) {
        int px = x0 + (i & 1) * pb, py = y0 + (i >> 1) * pb;
        int lm = f.intra_y[G(px >> 2, py >> 2)];
        fill_grid(f.intra_c, px, py, pb, (uint8_t)read_cmode(lm));
        fill_grid(f.cmode4, px, py, pb, (uint8_t)(cmode4 ? 1 : 0));
      }
    } else if (sps.chroma_array_type) {
      fill_grid(f.intra_c, x0, y0, 1 << log2, (uint8_t)read_cmode(mode0));
      fill_grid(f.cmode4, x0, y0, 1 << log2, (uint8_t)(cmode4 ? 1 : 0));
    }
  }

  void read_pcm(int x0, int y0, int log2) {
    // flush CABAC to byte boundary, read raw samples, restart engine.
    // The spec engine has consumed bit_pos() bits but holds 9 look-ahead
    // offset bits; raw PCM data begins at the aligned position of the
    // engine's *consumed* stream position.
    size_t pos = (cb->bit_pos() + 7) & ~(size_t)7;
    int size = 1 << log2;
    int nbits_y = sps.pcm_bd_luma, nbits_c = sps.pcm_bd_chroma;
    int shift_y = sps.bd_luma - nbits_y, shift_c = sps.bd_chroma - nbits_c;
    auto rb = [&](int n) {
      uint32_t v = 0;
      for (int i = 0; i < n; i++) {
        size_t byte = pos >> 3;
        v = (v << 1) | (byte < dlen ? (data[byte] >> (7 - (pos & 7))) & 1 : 0);
        pos++;
      }
      return v;
    };
    TU tu{};
    tu.cidx = -1; tu.x = x0; tu.y = y0; tu.log2 = (uint8_t)log2;
    tu.pred_mode = 1; tu.coeff_off = (int32_t)f.pcm_pool.size();
    for (int i = 0; i < size * size; i++)
      f.pcm_pool.push_back((int16_t)(rb(nbits_y) << shift_y));
    if (sps.chroma_array_type) {
      int cw = size / sps.subw, chh = size / sps.subh;
      for (int c = 0; c < 2; c++)
        for (int i = 0; i < cw * chh; i++)
          f.pcm_pool.push_back((int16_t)(rb(nbits_c) << shift_c));
    }
    f.tus.push_back(tu);
    cb->seek_bits((pos + 7) & ~(size_t)7);
    cb->init_engine();
  }

  // ---------------- transform tree / unit (7.3.8.8/10) ----------------
  bool transform_tree(int x0, int y0, int xb, int yb, int log2, int depth,
                      int blk, int max_depth, int pcb, int pcr) {
    // pcb/pcr are cbf BIT MASKS: bit0 = (top) TB, bit1 = 4:2:2 bottom TB
    bool inter_split = sps.max_trafo_depth_inter == 0 && cur_pred_mode == 0 &&
                       cur_part_mode != 0 && depth == 0;
    bool split;
    if (log2 <= sps.log2_max_tb && log2 > sps.log2_min_tb &&
        depth < max_depth && !(cur_intra_split && depth == 0))
      split = cb->bin(ct.m[CTX_SPLITTRAFO + 5 - log2]);
    else
      split = log2 > sps.log2_max_tb || (cur_intra_split && depth == 0) || inter_split;

    int cbf_cb = pcb, cbf_cr = pcr;
    int cat = sps.chroma_array_type;
    if ((log2 > 2 && cat) || cat == 3) {
      bool two = cat == 2 && (!split || log2 == 3);
      if (depth == 0 || pcb) {
        cbf_cb = cb->bin(ct.m[CTX_CBF_CHROMA + depth]);
        if (two) cbf_cb |= cb->bin(ct.m[CTX_CBF_CHROMA + depth]) << 1;
      } else cbf_cb = 0;
      if (depth == 0 || pcr) {
        cbf_cr = cb->bin(ct.m[CTX_CBF_CHROMA + depth]);
        if (two) cbf_cr |= cb->bin(ct.m[CTX_CBF_CHROMA + depth]) << 1;
      } else cbf_cr = 0;
    } else if (!cat) { cbf_cb = cbf_cr = 0; }

    if (split) {
      int half = 1 << (log2 - 1);
      return transform_tree(x0, y0, x0, y0, log2 - 1, depth + 1, 0, max_depth, cbf_cb, cbf_cr)
          && transform_tree(x0 + half, y0, x0, y0, log2 - 1, depth + 1, 1, max_depth, cbf_cb, cbf_cr)
          && transform_tree(x0, y0 + half, x0, y0, log2 - 1, depth + 1, 2, max_depth, cbf_cb, cbf_cr)
          && transform_tree(x0 + half, y0 + half, x0, y0, log2 - 1, depth + 1, 3, max_depth, cbf_cb, cbf_cr);
    }
    bool cbf_luma = true;
    if (cur_pred_mode == 1 || depth != 0 || cbf_cb || cbf_cr)
      cbf_luma = cb->bin(ct.m[CTX_CBF_LUMA + (depth == 0 ? 1 : 0)]);
    return transform_unit(x0, y0, xb, yb, log2, depth, blk, cbf_luma, cbf_cb, cbf_cr);
  }

  int chroma_qp(int cidx) {
    int off = cidx == 1 ? pps.cb_qp_offset + sh.cb_qp_off + cu_qp_off_cb
                        : pps.cr_qp_offset + sh.cr_qp_off + cu_qp_off_cr;
    int qpi = clip3(-6 * (sps.bd_chroma - 8), 57, cur_cu_qp + off);
    int qpc;
    if (sps.chroma_array_type == 1) {
      if (qpi < 30) qpc = qpi;
      else if (qpi > 43) qpc = qpi - 6;
      else qpc = CHROMA_QP_TAB[qpi - 30];
    } else qpc = std::min(qpi, 51);
    return qpc + 6 * (sps.bd_chroma - 8);
  }

  void decode_cu_qp_delta() {
    int prefix = 0;
    if (cb->bin(ct.m[CTX_CUQP])) {
      prefix = 1;
      while (prefix < 5 && cb->bin(ct.m[CTX_CUQP + 1])) prefix++;
    }
    int val = prefix;
    if (prefix == 5) val = 5 + cb->eg_bypass(0);
    if (val > 0 && cb->bypass()) val = -val;
    cu_qp_delta = val;
    qp_delta_coded = true;
    derive_cu_qp(cur_cu_x, cur_cu_y);
    fill_grid(f.qp_y, cur_cu_x, cur_cu_y, 1 << cur_log2_cb, (int8_t)cur_cu_qp);
  }

  bool transform_unit(int x0, int y0, int xb, int yb, int log2, int depth,
                      int blk, bool cbf_l, int cbf_cb, int cbf_cr) {
    int size = 1 << log2;
    int gx = x0 >> 2, gy = y0 >> 2, gs = size >> 2;
    for (int y = 0; y < gs; y++) f.tu_bound[G(gx, gy + y)] |= 1;
    for (int x = 0; x < gs; x++) f.tu_bound[G(gx + x, gy)] |= 2;
    fill_grid(f.cbf_luma, x0, y0, size, (uint8_t)(cbf_l ? 1 : 0));
    int cat_u = sps.chroma_array_type;
    bool chroma_here = cat_u == 3 || (cat_u && (log2 > 2 || blk == 3));
    // qp-delta presence tests the RAW cbf masks (slice.cc:3583), not
    // whether this leaf carries the chroma TBs
    if (cbf_l || cbf_cb || cbf_cr) {
      if (pps.cu_qp_delta && !qp_delta_coded) decode_cu_qp_delta();
      // TU-level chroma QP offset (range ext, slice.cc:3610-3635); the
      // reference reads cu_chroma_qp_offset_idx as ONE bin regardless of
      // list length — mirrored here (and in ctu.py)
      if (sh.cu_chroma_qp_offset_enabled && (cbf_cb || cbf_cr) &&
          !cur_tq_bypass && !chroma_qp_offset_coded) {
        int flag = cb->bin(ct.m[CTX_CUCHROFF]);
        int idx = 0;
        if (flag && pps.chroma_qp_list_len > 1)
          idx = cb->bin(ct.m[CTX_CUCHROFF + 1]);
        chroma_qp_offset_coded = true;
        cu_qp_off_cb = flag ? pps.cb_qp_list[idx] : 0;
        cu_qp_off_cr = flag ? pps.cr_qp_list[idx] : 0;
      }
    }
    // luma TU
    TU tu{};
    tu.cidx = 0; tu.x = x0; tu.y = y0; tu.log2 = (uint8_t)log2;
    tu.intra_mode = cur_pred_mode == 1 ? f.intra_y[G(gx, gy)] : -1;
    tu.qp = (int16_t)(cur_cu_qp + 6 * (sps.bd_luma - 8));  // QP' luma
    tu.tq_bypass = cur_tq_bypass; tu.pred_mode = (uint8_t)cur_pred_mode;
    tu.coeff_off = -1;
    tu.rdpcm = -1;
    if (cbf_l) {
      tu.coeff_off = (int32_t)f.coeff_pool.size();
      if (!residual(x0, y0, log2, 0)) return false;
      tu.transform_skip = last_ts_flag;
      tu.rdpcm = (int8_t)last_rdpcm;
    }
    f.tus.push_back(tu);
    if (chroma_here) {
      int lx, ly, clog2;
      if (cat_u == 3) { lx = x0; ly = y0; clog2 = log2; }
      else if (log2 > 2) { lx = x0; ly = y0; clog2 = log2 - 1; }
      else { lx = xb; ly = yb; clog2 = 2; }
      int cx = lx / sps.subw, cy = ly / sps.subh;
      int cmode = cur_pred_mode == 1 ? f.intra_c[G(lx >> 2, ly >> 2)] : -1;
      // 4:2:2: two stacked square chroma TBs per plane (slice.cc:3671-3712)
      int n_tb = cat_u == 2 ? 2 : 1;
      const int cbfs[2] = {cbf_cb, cbf_cr};
      // cross-component prediction (range ext, 4:4:4 only): one
      // (scale, sign) pair per chroma component before its residual,
      // gated on cbf_luma and inter / chroma-mode-4
      // (slice.cc:3678-3692, 3530-3558)
      bool do_ccp = cat_u == 3 && pps.ccp_enabled && cbf_l &&
          (cur_pred_mode != 1 || f.cmode4[G(x0 >> 2, y0 >> 2)]);
      for (int ci = 1; ci <= 2; ci++) {
        int res_scale = 0;
        if (do_ccp) {
          int v = 0;
          for (int b = 0; b < 4; b++) {
            if (cb->bin(ct.m[CTX_RESSCALE + 4 * (ci - 1) + b])) v++;
            else break;
          }
          if (v) {
            int sgn = cb->bin(ct.m[CTX_RESSIGN + (ci - 1)]);
            res_scale = (1 << (v - 1)) * (1 - 2 * sgn);
          }
        }
        for (int tb = 0; tb < n_tb; tb++) {
          TU ctu{};
          ctu.cidx = (int8_t)ci; ctu.x = cx; ctu.y = cy + (tb << clog2);
          ctu.log2 = (uint8_t)clog2;
          ctu.intra_mode = (int16_t)cmode;
          ctu.qp = (int16_t)chroma_qp(ci);
          ctu.tq_bypass = cur_tq_bypass; ctu.pred_mode = (uint8_t)cur_pred_mode;
          ctu.coeff_off = -1;
          ctu.ccp_alpha = (int16_t)res_scale;
          ctu.rdpcm = -1;
          if (cbfs[ci - 1] & (1 << tb)) {
            ctu.coeff_off = (int32_t)f.coeff_pool.size();
            if (!residual(cx, cy + (tb << clog2), clog2, ci)) return false;
            ctu.transform_skip = last_ts_flag;
            ctu.rdpcm = (int8_t)last_rdpcm;
          }
          f.tus.push_back(ctu);
        }
      }
    }
    return true;
  }

  // ---------------- residual coding (7.3.8.11) ----------------
  int decode_remaining(int rice) {
    int prefix = 0;
    while (prefix <= 32 && cb->bypass()) prefix++;
    if (prefix > 32) return 0;
    if (prefix <= 3)
      return (prefix << rice) + (rice ? cb->bypass_bits(rice) : 0);
    int nbits = prefix - 3 + rice;
    return (((1 << (prefix - 3)) + 2) << rice) + cb->bypass_bits(nbits);
  }

  int last_prefix(int slot, int log2, int ctx_off, int ctx_shift) {
    int cmax = (log2 << 1) - 1;
    int v = 0;
    while (v < cmax && cb->bin(ct.m[slot + (v >> ctx_shift) + ctx_off])) v++;
    return v;
  }

  bool residual(int x0, int y0, int log2, int cidx) {
    init_scans();
    int size = 1 << log2;
    last_ts_flag = false;
    if (pps.transform_skip && !cur_tq_bypass && log2 <= pps.log2_max_tskip)
      last_ts_flag = cb->bin(ct.m[CTX_TSKIP + (cidx ? 1 : 0)]);
    // explicit RDPCM (range ext): inter CUs with ts/bypass residual
    // (slice.cc:2937-2951)
    last_rdpcm = -1;
    if (cur_pred_mode != 1 && sps.explicit_rdpcm &&
        (last_ts_flag || cur_tq_bypass)) {
      if (cb->bin(ct.m[CTX_ERDPCM + (cidx ? 1 : 0)])) {
        int d = cb->bin(ct.m[CTX_ERDPCMDIR + (cidx ? 1 : 0)]);
        last_rdpcm = d ? 2 : 1;
      }
    }
    // persistent Rice state class + ts sig-ctx gate (slice.cc:2957-2961)
    int sb_type = (cidx == 0 ? 2 : 0) +
        ((last_ts_flag || cur_tq_bypass) ? 1 : 0);
    bool persistent = sps.persistent_rice != 0;
    bool ts_ctx = sps.ts_context && (cur_tq_bypass || last_ts_flag);
    int scan = 0;
    if (cur_pred_mode == 1 &&
        (log2 == 2 || (log2 == 3 && cidx == 0) ||
         (log2 == 3 && sps.chroma_array_type == 3))) {
      int pm = cidx == 0 ? f.intra_y[G(x0 >> 2, y0 >> 2)]
                         : f.intra_c[G((x0 * sps.subw) >> 2,
                                       (y0 * sps.subh) >> 2)];
      if (pm >= 6 && pm <= 14) scan = 2;
      else if (pm >= 22 && pm <= 30) scan = 1;
    }
    int ctx_off, ctx_shift;
    if (cidx == 0) {
      ctx_off = 3 * (log2 - 2) + ((log2 - 1) >> 2);
      ctx_shift = (log2 + 1) >> 2;
    } else { ctx_off = 15; ctx_shift = log2 - 2; }
    int lastx = last_prefix(CTX_LAST_X, log2, ctx_off, ctx_shift);
    int lasty = last_prefix(CTX_LAST_Y, log2, ctx_off, ctx_shift);
    if (lastx > 3) {
      int nb = (lastx >> 1) - 1;
      lastx = ((2 + (lastx & 1)) << nb) + cb->bypass_bits(nb);
    }
    if (lasty > 3) {
      int nb = (lasty >> 1) - 1;
      lasty = ((2 + (lasty & 1)) << nb) + cb->bypass_bits(nb);
    }
    if (scan == 2) std::swap(lastx, lasty);

    const Scan& sbs = g_scans[log2 - 2][scan];
    const Scan& cs = g_scans[2][scan];
    int nsb = size >> 2;
    int last_sb = sbs.idx_of[(lasty >> 2) * nsb + (lastx >> 2)];
    int last_pos = cs.idx_of[(lasty & 3) * 4 + (lastx & 3)];

    uint8_t csbf[64] = {0};
    // coefficient output (dense n*n) appended to pool
    size_t pool_base = f.coeff_pool.size();
    f.coeff_pool.resize(pool_base + size * size, 0);
    int16_t* out = &f.coeff_pool[pool_base];

    bool sign_hiding = pps.sign_data_hiding && !cur_tq_bypass;
    bool prev_g1_zero = false;

    for (int i = last_sb; i >= 0; i--) {
      int xS = sbs.x[i], yS = sbs.y[i];
      bool infer_dc = false;
      if (i < last_sb && i > 0) {
        int right = xS + 1 < nsb ? csbf[yS * nsb + xS + 1] : 0;
        int below = yS + 1 < nsb ? csbf[(yS + 1) * nsb + xS] : 0;
        int inc = std::min(right + below, 1) + (cidx ? 2 : 0);
        int flag = cb->bin(ct.m[CTX_CSBF + inc]);
        csbf[yS * nsb + xS] = flag;
        infer_dc = true;
        if (!flag) continue;
      } else csbf[yS * nsb + xS] = 1;

      // per-subblock sig-ctx LUT: base pattern by scan position + constant
      // offset; DC of the whole TB (subblock 0, n==0) is the one exception
      const uint8_t* lut;
      int off, dc0 = -1;
      if (log2 == 2) {
        lut = g_map4[scan];
        off = cidx ? 27 : 0;
      } else {
        int right = xS + 1 < nsb ? csbf[yS * nsb + xS + 1] : 0;
        int below = yS + 1 < nsb ? csbf[(yS + 1) * nsb + xS] : 0;
        lut = g_sigbase[scan][right + 2 * below];
        if (cidx == 0)
          off = ((xS | yS) ? 3 : 0) + (log2 == 3 ? (scan == 0 ? 9 : 15) : 21);
        else
          off = 27 + (log2 == 3 ? 9 : 12);
        if (i == 0) dc0 = cidx ? 27 : 0;
      }
      int sig_pos[16], nsig = 0;
      int start = i == last_sb ? last_pos - 1 : 15;
      if (i == last_sb) sig_pos[nsig++] = last_pos;
      for (int n = start; n >= 0; n--) {
        if (n == 0 && infer_dc && nsig == 0) { sig_pos[nsig++] = 0; continue; }
        int inc = ts_ctx ? (cidx == 0 ? 42 : 43)
                         : ((n == 0 && dc0 >= 0) ? dc0 : lut[n] + off);
        if (cb->bin(ct.m[CTX_SIG + inc])) { sig_pos[nsig++] = n; infer_dc = false; }
      }
      if (!nsig) continue;
      int ctx_set = (i == 0 || cidx) ? 0 : 2;
      if (prev_g1_zero) ctx_set++;
      int g1ctx = 1;
      int g1[16] = {0}, first_g1 = -1;
      for (int k = 0; k < nsig && k < 8; k++) {
        int inc = ctx_set * 4 + std::min(3, g1ctx) + (cidx ? 16 : 0);
        g1[k] = cb->bin(ct.m[CTX_G1 + inc]);
        if (g1[k]) { g1ctx = 0; if (first_g1 < 0) first_g1 = k; }
        else if (g1ctx > 0) g1ctx++;
      }
      prev_g1_zero = g1ctx == 0;
      int g2v = 0;
      if (first_g1 >= 0) {
        int inc = cidx ? 4 + ctx_set : ctx_set;
        g2v = cb->bin(ct.m[CTX_G2 + inc]);
      }
      int last_sig_scan = sig_pos[0], first_sig_scan = sig_pos[nsig - 1];
      bool hidden = sign_hiding && (last_sig_scan - first_sig_scan > 3);
      int signs[16];
      // the hidden sign is always the last in k-order (sig_pos[nsig-1]);
      // all coded signs are contiguous -> batch into one bypass read
      int m = hidden ? nsig - 1 : nsig;
      uint32_t sv = m ? cb->bypass_bits(m) : 0;
      for (int k = 0; k < m; k++) signs[k] = (sv >> (m - 1 - k)) & 1;
      if (hidden) signs[nsig - 1] = 0;
      // persistent Rice adaptation (range ext): rice starts from
      // StatCoeff[sbType]/4 per subblock; StatCoeff adapts on the
      // subblock's FIRST remaining-coded level (slice.cc:3330-3376)
      int rice = persistent ? (ct.stat_coeff[sb_type] >> 2) : 0;
      bool first_rem = true;
      long sum_abs = 0;
      int vals[16];
      for (int k = 0; k < nsig; k++) {
        int base = 1 + (k < 8 ? g1[k] : 0) + (k == first_g1 ? g2v : 0);
        int threshold = k < 8 ? (k == first_g1 ? 3 : 2) : 1;
        int level = base;
        if (base == threshold) {
          int rem = decode_remaining(rice);
          level = base + rem;
          if (level > (3 << rice))
            rice = persistent ? rice + 1 : std::min(rice + 1, 4);
          if (persistent && first_rem) {
            int sc = ct.stat_coeff[sb_type];
            if (rem >= (3 << (sc >> 2))) ct.stat_coeff[sb_type] = sc + 1;
            else if (2 * rem < (1 << (sc >> 2)) && sc > 0)
              ct.stat_coeff[sb_type] = sc - 1;
          }
          first_rem = false;
        }
        vals[k] = level;
        sum_abs += level;
      }
      if (hidden && (sum_abs & 1)) {
        for (int k = 0; k < nsig; k++)
          if (sig_pos[k] == first_sig_scan) signs[k] = 1;
      }
      for (int k = 0; k < nsig; k++) {
        int n = sig_pos[k];
        int xC = (xS << 2) + cs.x[n], yC = (yS << 2) + cs.y[n];
        out[yC * size + xC] = (int16_t)(signs[k] ? -vals[k] : vals[k]);
      }
    }
    return true;
  }

  // ------------------- prediction units / motion -------------------
  void inter_pred_info(int x0, int y0, int log2, int part_mode, int depth);
  void prediction_unit(int xc, int yc, int x0, int y0, int w, int h, bool skip,
                       int pidx, int nparts, int depth, int part_mode);
  void derive_pu(const RawPU& r);
  int decode_merge_idx() {
    if (sh.max_merge <= 1) return 0;
    if (!cb->bin(ct.m[CTX_MERGEIDX])) return 0;
    int idx = 1;
    while (idx < sh.max_merge - 1 && cb->bypass()) idx++;
    return idx;
  }
  int decode_ref_idx(int num) {
    if (!cb->bin(ct.m[CTX_REFIDX])) return 0;
    if (num == 2 || !cb->bin(ct.m[CTX_REFIDX + 1])) return 1;
    int idx = 2;
    while (idx < num - 1 && cb->bypass()) idx++;
    return idx;
  }
  void decode_mvd(int* mvd) {
    int gt0[2], gt1[2] = {0, 0};
    for (int i = 0; i < 2; i++) gt0[i] = cb->bin(ct.m[CTX_MVD]);
    for (int i = 0; i < 2; i++) if (gt0[i]) gt1[i] = cb->bin(ct.m[CTX_MVD + 1]);
    for (int i = 0; i < 2; i++) {
      int v = 0;
      if (gt0[i]) {
        v = 1;
        if (gt1[i]) v = 2 + cb->eg_bypass(1);
        if (cb->bypass()) v = -v;
      }
      mvd[i] = v;
    }
  }
  // motion derivation (defined below)
  struct Cand { uint8_t pf[2]; int16_t mv[2][2]; int8_t ref[2];
    bool same(const Cand& o) const {
      return pf[0] == o.pf[0] && pf[1] == o.pf[1] &&
             mv[0][0] == o.mv[0][0] && mv[0][1] == o.mv[0][1] &&
             mv[1][0] == o.mv[1][0] && mv[1][1] == o.mv[1][1] &&
             ref[0] == o.ref[0] && ref[1] == o.ref[1];
    }
  };
  Cand nb_cand(int nx, int ny) {
    size_t g = G(nx >> 2, ny >> 2);
    Cand c;
    for (int l = 0; l < 2; l++) {
      c.pf[l] = f.pred_flag[g * 2 + l];
      c.mv[l][0] = f.mv[g * 4 + l * 2]; c.mv[l][1] = f.mv[g * 4 + l * 2 + 1];
      c.ref[l] = f.ref_idx[g * 2 + l];
    }
    return c;
  }
  bool temporal_mv(int x0, int y0, int w, int h, int X, int ref_idx, int16_t* out);
  bool col_mv(int xc, int yc, int X, int ref_idx, int16_t* out);
  int merge_candidates(int x0, int y0, int w, int h, int part_mode, int pidx,
                       Cand* out);
  void decode_merge(int xc, int yc, int x0, int y0, int w, int h, int pidx,
                    int part_mode, int merge_idx);
  void decode_amvp(int xc, int yc, int x0, int y0, int w, int h, int pidx,
                   int inter_dir, const int* ref_idx, int mvd[2][2],
                   const int* mvp_flag);
  void amvp_predictors(int xc, int yc, int x0, int y0, int w, int h,
                       int pidx, int X, int ref_idx, int16_t pred[2][2]);
  void store_pu(int x0, int y0, int w, int h, const uint8_t* pf,
                int16_t mv[2][2], const int8_t* ref);
  // wavefront replay: when >=0, store_pu writes f.pus[pu_out] instead of
  // push_back (slot order == decode order, matching the serial replay)
  int pu_out = -1;
};

}  // namespace

namespace {

static int16_t mv_wrap(int v) {
  v &= 0xFFFF;
  return (int16_t)(v >= 0x8000 ? v - 0x10000 : v);
}

static void scale_mv16(const int16_t* in, int tb, int td, int16_t* out) {
  td = clip3(-128, 127, td);
  tb = clip3(-128, 127, tb);
  int tx = td ? (16384 + (abs(td) >> 1)) / td : 0;
  int dsf = clip3(-4096, 4095, (tb * tx + 32) >> 6);
  for (int i = 0; i < 2; i++) {
    long v = (long)dsf * in[i];
    long a = (labs(v) + 127) >> 8;
    out[i] = (int16_t)clip3(-32768, 32767, (int)(v >= 0 ? a : -a));
  }
}

void SliceReader::inter_pred_info(int x0, int y0, int log2, int part_mode,
                                  int depth) {
  int s = 1 << log2, h = s >> 1, q = s >> 2;
  merge_2nx2n = false;
  struct R { int dx, dy, w, h; };
  R parts[4]; int np = 1;
  switch (part_mode) {
    case 0: parts[0] = {0,0,s,s}; np = 1; break;
    case 1: parts[0] = {0,0,s,h}; parts[1] = {0,h,s,h}; np = 2; break;
    case 2: parts[0] = {0,0,h,s}; parts[1] = {h,0,h,s}; np = 2; break;
    case 3: parts[0] = {0,0,h,h}; parts[1] = {h,0,h,h};
            parts[2] = {0,h,h,h}; parts[3] = {h,h,h,h}; np = 4; break;
    case 4: parts[0] = {0,0,s,q}; parts[1] = {0,q,s,s-q}; np = 2; break;
    case 5: parts[0] = {0,0,s,s-q}; parts[1] = {0,s-q,s,q}; np = 2; break;
    case 6: parts[0] = {0,0,q,s}; parts[1] = {q,0,s-q,s}; np = 2; break;
    case 7: parts[0] = {0,0,s-q,s}; parts[1] = {s-q,0,q,s}; np = 2; break;
  }
  for (int i = 0; i < np; i++)
    prediction_unit(x0, y0, x0 + parts[i].dx, y0 + parts[i].dy,
                    parts[i].w, parts[i].h, false, i, np, depth, part_mode);
}

void SliceReader::prediction_unit(int xc, int yc, int x0, int y0, int w, int h,
                                  bool skip, int pidx, int nparts, int depth,
                                  int part_mode) {
  int merge_idx = 0;
  bool merge = true;
  if (skip) {
    merge_idx = decode_merge_idx();
    if (pidx == 0 && nparts == 1) merge_2nx2n = true;
  } else {
    merge = cb->bin(ct.m[CTX_MERGEFLAG]);
    if (merge) {
      if (part_mode == 0 && pidx == 0) merge_2nx2n = true;
      merge_idx = decode_merge_idx();
    }
  }
  RawPU r{};
  r.xc = (int16_t)xc; r.yc = (int16_t)yc;
  r.x0 = (int16_t)x0; r.y0 = (int16_t)y0;
  r.w = (int16_t)w; r.h = (int16_t)h;
  r.slice_idx = (int16_t)slice_idx;
  r.pidx = (int8_t)pidx; r.part_mode = (int8_t)part_mode;
  if (merge) {
    r.merge = 1; r.merge_idx = (int8_t)merge_idx;
    f.raw_pus.push_back(r);
    return;
  }
  int inter_dir = 0;  // PRED_L0
  if (sh.type == 0) {
    if (w + h != 12) {
      if (cb->bin(ct.m[CTX_INTERDIR + depth])) inter_dir = 2;  // BI
    }
    if (inter_dir != 2)
      inter_dir = cb->bin(ct.m[CTX_INTERDIR + 4]) ? 1 : 0;
  }
  int mvd[2][2] = {{0,0},{0,0}};
  int ref_idx[2] = {0, 0}, mvp[2] = {0, 0};
  if (inter_dir != 1) {
    if (sh.nref[0] > 1) ref_idx[0] = decode_ref_idx(sh.nref[0]);
    decode_mvd(mvd[0]);
    mvp[0] = cb->bin(ct.m[CTX_MVP]);
  }
  if (inter_dir != 0) {
    if (sh.nref[1] > 1) ref_idx[1] = decode_ref_idx(sh.nref[1]);
    if (sh.mvd_l1_zero && inter_dir == 2) { mvd[1][0] = mvd[1][1] = 0; }
    else decode_mvd(mvd[1]);
    mvp[1] = cb->bin(ct.m[CTX_MVP]);
  }
  r.inter_dir = (int8_t)inter_dir;
  r.ref_idx[0] = (int8_t)ref_idx[0]; r.ref_idx[1] = (int8_t)ref_idx[1];
  r.mvp[0] = (int8_t)mvp[0]; r.mvp[1] = (int8_t)mvp[1];
  for (int l = 0; l < 2; l++)
    for (int i = 0; i < 2; i++) r.mvd[l][i] = (int16_t)mvd[l][i];
  f.raw_pus.push_back(r);
}

void SliceReader::derive_pu(const RawPU& r) {
  if (r.merge) {
    decode_merge(r.xc, r.yc, r.x0, r.y0, r.w, r.h, r.pidx, r.part_mode,
                 r.merge_idx);
    return;
  }
  int ref_idx[2] = {r.ref_idx[0], r.ref_idx[1]};
  int mvp[2] = {r.mvp[0], r.mvp[1]};
  int mvd[2][2] = {{r.mvd[0][0], r.mvd[0][1]}, {r.mvd[1][0], r.mvd[1][1]}};
  decode_amvp(r.xc, r.yc, r.x0, r.y0, r.w, r.h, r.pidx, r.inter_dir,
              ref_idx, mvd, mvp);
}

bool SliceReader::col_mv(int xc, int yc, int X, int ref_idx, int16_t* out) {
  if (!col) return false;
  int mx = xc >> 4, my = yc >> 4;
  if (mx >= col->mw || my >= col->mh) return false;
  size_t mi = (size_t)my * col->mw + mx;
  if (col->cintra[mi]) return false;
  int pf0 = col->cpf[mi * 2], pf1 = col->cpf[mi * 2 + 1];
  if (!pf0 && !pf1) return false;
  int l;
  if (!pf0) l = 1;
  else if (!pf1) l = 0;
  else {
    bool all_before = true;
    for (int ll = 0; ll < 2; ll++)
      for (int i = 0; i < sh.nref[ll]; i++)
        if (sh.ref_poc[ll][i] > f.poc) all_before = false;
    l = all_before ? X : (sh.col_from_l0 ? 0 : 1);
  }
  int16_t mv[2] = {col->cmv[mi * 4 + l * 2], col->cmv[mi * 4 + l * 2 + 1]};
  int col_ref_poc = col->cpoc[mi * 2 + l];
  bool col_lt = col->clt[mi * 2 + l];
  bool targ_lt = sh.ref_lt[X][ref_idx];
  if (col_lt != targ_lt) return false;
  if (targ_lt) { out[0] = mv[0]; out[1] = mv[1]; return true; }
  int col_diff = col->poc - col_ref_poc;
  int cur_diff = f.poc - sh.ref_poc[X][ref_idx];
  if (col_diff == cur_diff) { out[0] = mv[0]; out[1] = mv[1]; return true; }
  scale_mv16(mv, cur_diff, col_diff, out);
  return true;
}

bool SliceReader::temporal_mv(int x0, int y0, int w, int h, int X, int ref_idx,
                              int16_t* out) {
  if (!col) return false;
  int xbr = x0 + w, ybr = y0 + h;
  if ((y0 >> ctb_log2) == (ybr >> ctb_log2) && ybr < H && xbr < W)
    if (col_mv(xbr, ybr, X, ref_idx, out)) return true;
  return col_mv(x0 + (w >> 1), y0 + (h >> 1), X, ref_idx, out);
}

int SliceReader::merge_candidates(int x0, int y0, int w, int h, int part_mode,
                                  int pidx, Cand* out) {
  int plevel = pps.log2_pml;
  int n = 0;
  auto plevel_same = [&](int nx, int ny) {
    return (x0 >> plevel) == (nx >> plevel) && (y0 >> plevel) == (ny >> plevel);
  };
  auto get = [&](int nx, int ny, bool blocked, Cand& c) {
    if (blocked || plevel_same(nx, ny)) return false;
    if (!avail_pred(x0, y0, nx, ny)) return false;
    c = nb_cand(nx, ny);
    return true;
  };
  Cand a1, b1p, b0, a0, b2;
  bool ha1, hb1p, hb0, ha0, hb2;
  bool a1_blocked = pidx == 1 && (part_mode == 2 || part_mode == 6 || part_mode == 7);
  ha1 = get(x0 - 1, y0 + h - 1, a1_blocked, a1);
  if (ha1) out[n++] = a1;
  bool b1_blocked = pidx == 1 && (part_mode == 1 || part_mode == 4 || part_mode == 5);
  hb1p = get(x0 + w - 1, y0 - 1, b1_blocked, b1p);
  if (hb1p && !(ha1 && b1p.same(a1))) out[n++] = b1p;
  hb0 = get(x0 + w, y0 - 1, false, b0);
  if (hb0 && !(hb1p && b0.same(b1p))) out[n++] = b0;
  ha0 = get(x0 - 1, y0 + h, false, a0);
  if (ha0 && !(ha1 && a0.same(a1))) out[n++] = a0;
  if (n < 4) {
    hb2 = get(x0 - 1, y0 - 1, false, b2);
    if (hb2 && !(ha1 && b2.same(a1)) && !(hb1p && b2.same(b1p))) out[n++] = b2;
  }
  if (sh.temporal_mvp && n < sh.max_merge) {
    Cand tc{};
    tc.ref[0] = tc.ref[1] = -1;
    int nlists = sh.type == 0 ? 2 : 1;
    bool any = false;
    for (int X = 0; X < nlists; X++) {
      int16_t mv[2];
      if (temporal_mv(x0, y0, w, h, X, 0, mv)) {
        tc.pf[X] = 1; tc.mv[X][0] = mv[0]; tc.mv[X][1] = mv[1]; tc.ref[X] = 0;
        any = true;
      }
    }
    if (any) out[n++] = tc;
  }
  // combined bi-pred (B slices)
  if (sh.type == 0 && n >= 2 && n < sh.max_merge) {
    static const int L0I[12] = {0,1,0,2,1,2,0,3,1,3,2,3};
    static const int L1I[12] = {1,0,2,0,2,1,3,0,3,1,3,2};
    int orig_n = n;
    for (int k = 0; k < orig_n * (orig_n - 1) && n < sh.max_merge; k++) {
      int i0 = L0I[k], i1 = L1I[k];
      if (i0 >= orig_n || i1 >= orig_n) continue;
      const Cand& c0 = out[i0];
      const Cand& c1 = out[i1];
      if (!(c0.pf[0] && c1.pf[1])) continue;
      int p0 = sh.ref_poc[0][c0.ref[0]], p1 = sh.ref_poc[1][c1.ref[1]];
      if (p0 != p1 || c0.mv[0][0] != c1.mv[1][0] || c0.mv[0][1] != c1.mv[1][1]) {
        Cand c{};
        c.pf[0] = 1; c.pf[1] = 1;
        c.mv[0][0] = c0.mv[0][0]; c.mv[0][1] = c0.mv[0][1];
        c.mv[1][0] = c1.mv[1][0]; c.mv[1][1] = c1.mv[1][1];
        c.ref[0] = c0.ref[0]; c.ref[1] = c1.ref[1];
        out[n++] = c;
      }
    }
  }
  // zero candidates
  int n_ref = sh.type == 0 ? std::min(sh.nref[0], sh.nref[1]) : sh.nref[0];
  int zi = 0;
  while (n < sh.max_merge) {
    int r = zi < n_ref ? zi : 0;
    Cand c{};
    if (sh.type == 0) { c.pf[0] = c.pf[1] = 1; c.ref[0] = c.ref[1] = (int8_t)r; }
    else { c.pf[0] = 1; c.pf[1] = 0; c.ref[0] = (int8_t)r; c.ref[1] = -1; }
    out[n++] = c;
    zi++;
  }
  return n;
}

void SliceReader::decode_merge(int xc, int yc, int x0, int y0, int w, int h,
                               int pidx, int part_mode, int merge_idx) {
  int plevel = pps.log2_pml;
  int log2cb = f.log2_cb[G(xc >> 2, yc >> 2)];
  bool single = plevel > 2 && log2cb == 3;
  Cand cands[8];
  int nc;
  if (single) nc = merge_candidates(xc, yc, 8, 8, 0, 0, cands);
  else nc = merge_candidates(x0, y0, w, h, part_mode, pidx, cands);
  const Cand& c = cands[std::min(merge_idx, nc - 1)];
  uint8_t pf[2] = {c.pf[0], c.pf[1]};
  int16_t mv[2][2] = {{c.mv[0][0], c.mv[0][1]}, {c.mv[1][0], c.mv[1][1]}};
  int8_t ref[2] = {c.ref[0], c.ref[1]};
  if (w + h == 12 && pf[0] && pf[1]) { pf[1] = 0; ref[1] = -1; }
  store_pu(x0, y0, w, h, pf, mv, ref);
}

void SliceReader::amvp_predictors(int xc, int yc, int x0, int y0, int w,
                                  int h, int pidx, int X,
                                  int ref_idx, int16_t pred[2][2]) {
  int Y = 1 - X;
  int targ_poc = sh.ref_poc[X][ref_idx];
  bool targ_lt = sh.ref_lt[X][ref_idx];
  // neighbours inside the SAME coding block follow PU decode order, not
  // z-scan (6.4.2, image.cc:782-806); only NxN partIdx 1 reading the
  // partIdx-2 region is excluded
  int ncbs = 1 << f.log2_cb[G(xc >> 2, yc >> 2)];
  auto nb_ok = [&](int nx, int ny, int* g) {
    if (nx >= xc && nx < xc + ncbs && ny >= yc && ny < yc + ncbs) {
      if (w * 2 == ncbs && h * 2 == ncbs && pidx == 1 &&
          ny >= yc + h && nx < xc + w) return false;
      if (f.pred_mode[G(nx >> 2, ny >> 2)] != 0) return false;
    } else if (!avail_pred(x0, y0, nx, ny)) {
      return false;
    }
    g[0] = nx >> 2; g[1] = ny >> 2;
    return true;
  };
  auto try_direct = [&](const int* g, int16_t* mv) {
    size_t gi = G(g[0], g[1]);
    const int order[2] = {X, Y};
    for (int oi = 0; oi < 2; oi++) {
      int l = order[oi];
      if (f.pred_flag[gi * 2 + l]) {
        int r = f.ref_idx[gi * 2 + l];
        if (r >= 0 && r < sh.nref[l] &&
            sh.ref_poc[l][r] == targ_poc &&
            (sh.ref_lt[l][r] != 0) == targ_lt) {
          mv[0] = f.mv[gi * 4 + l * 2]; mv[1] = f.mv[gi * 4 + l * 2 + 1];
          return true;
        }
      }
    }
    return false;
  };
  auto try_scaled = [&](const int* g, int16_t* mv) {
    size_t gi = G(g[0], g[1]);
    const int order[2] = {X, Y};
    for (int oi = 0; oi < 2; oi++) {
      int l = order[oi];
      if (f.pred_flag[gi * 2 + l]) {
        int r = f.ref_idx[gi * 2 + l];
        if (r < 0 || r >= sh.nref[l]) continue;
        bool nb_lt = sh.ref_lt[l][r] != 0;
        if (nb_lt != targ_lt) continue;
        int16_t m[2] = {f.mv[gi * 4 + l * 2], f.mv[gi * 4 + l * 2 + 1]};
        if (targ_lt) { mv[0] = m[0]; mv[1] = m[1]; return true; }
        int tb = f.poc - targ_poc;
        int td = f.poc - sh.ref_poc[l][r];
        if (tb == td) { mv[0] = m[0]; mv[1] = m[1]; return true; }
        scale_mv16(m, tb, td, mv);
        return true;
      }
    }
    return false;
  };
  int a0[2], a1[2], b0[2], b1[2], b2[2];
  bool ha0 = nb_ok(x0 - 1, y0 + h, a0);
  bool ha1 = nb_ok(x0 - 1, y0 + h - 1, a1);
  bool is_scaled = ha0 || ha1;
  int16_t mvA[2]; bool hA = false;
  if (ha0 && try_direct(a0, mvA)) hA = true;
  if (!hA && ha1 && try_direct(a1, mvA)) hA = true;
  if (!hA && ha0 && try_scaled(a0, mvA)) hA = true;
  if (!hA && ha1 && try_scaled(a1, mvA)) hA = true;
  bool hb0 = nb_ok(x0 + w, y0 - 1, b0);
  bool hb1 = nb_ok(x0 + w - 1, y0 - 1, b1);
  bool hb2 = nb_ok(x0 - 1, y0 - 1, b2);
  int16_t mvB[2]; bool hB = false;
  if (hb0 && try_direct(b0, mvB)) hB = true;
  if (!hB && hb1 && try_direct(b1, mvB)) hB = true;
  if (!hB && hb2 && try_direct(b2, mvB)) hB = true;
  if (!is_scaled) {
    if (!hA && hB) { mvA[0] = mvB[0]; mvA[1] = mvB[1]; hA = true; }
    hB = false;
    if (hb0 && try_scaled(b0, mvB)) hB = true;
    if (!hB && hb1 && try_scaled(b1, mvB)) hB = true;
    if (!hB && hb2 && try_scaled(b2, mvB)) hB = true;
  }
  int ncand = 0;
  int16_t cands[2][2];
  if (hA) { cands[ncand][0] = mvA[0]; cands[ncand][1] = mvA[1]; ncand++; }
  if (hB && (!hA || mvB[0] != mvA[0] || mvB[1] != mvA[1])) {
    cands[ncand][0] = mvB[0]; cands[ncand][1] = mvB[1]; ncand++;
  }
  if (ncand < 2 && sh.temporal_mvp) {
    int16_t t[2];
    if (temporal_mv(x0, y0, w, h, X, ref_idx, t)) {
      cands[ncand][0] = t[0]; cands[ncand][1] = t[1]; ncand++;
    }
  }
  while (ncand < 2) { cands[ncand][0] = 0; cands[ncand][1] = 0; ncand++; }
  pred[0][0] = cands[0][0]; pred[0][1] = cands[0][1];
  pred[1][0] = cands[1][0]; pred[1][1] = cands[1][1];
}

void SliceReader::decode_amvp(int xc, int yc, int x0, int y0, int w, int h,
                              int pidx, int inter_dir,
                              const int* ref_idx, int mvd[2][2],
                              const int* mvp_flag) {
  uint8_t pf[2] = {0, 0};
  int16_t mv[2][2] = {{0,0},{0,0}};
  int8_t ref[2] = {-1, -1};
  for (int X = 0; X < 2; X++) {
    if ((X == 0 && inter_dir == 1) || (X == 1 && inter_dir == 0)) continue;
    pf[X] = 1; ref[X] = (int8_t)ref_idx[X];
    int16_t pred[2][2];
    amvp_predictors(xc, yc, x0, y0, w, h, pidx, X, ref_idx[X], pred);
    mv[X][0] = mv_wrap(pred[mvp_flag[X]][0] + mvd[X][0]);
    mv[X][1] = mv_wrap(pred[mvp_flag[X]][1] + mvd[X][1]);
  }
  store_pu(x0, y0, w, h, pf, mv, ref);
}

void SliceReader::store_pu(int x0, int y0, int w, int h, const uint8_t* pf,
                           int16_t mv[2][2], const int8_t* ref) {
  int gx = x0 >> 2, gy = y0 >> 2, gw4 = w >> 2, gh4 = h >> 2;
  int rp[2] = {0, 0}; int rframe[2] = {-1, -1}; uint8_t rlt[2] = {0, 0};
  for (int l = 0; l < 2; l++)
    if (pf[l]) {
      rp[l] = sh.ref_poc[l][ref[l]];
      rframe[l] = sh.ref_frame[l][ref[l]];
      rlt[l] = sh.ref_lt[l][ref[l]];
    }
  // row templates + per-row memcpy: a 64x64 PU writes 256 grid cells x
  // ~14 fields — the scattered per-cell stores were the bulk of the
  // serial derive_motion replay at 4K
  uint8_t tpf[32];
  int8_t tref[32];
  int16_t tmv[64];
  int32_t tpoc[32];
  uint8_t tlt[32];
  for (int x = 0; x < gw4; x++)
    for (int l = 0; l < 2; l++) {
      tpf[x * 2 + l] = pf[l];
      tref[x * 2 + l] = ref[l];
      tmv[x * 4 + l * 2] = mv[l][0];
      tmv[x * 4 + l * 2 + 1] = mv[l][1];
      tpoc[x * 2 + l] = rp[l];
      tlt[x * 2 + l] = rlt[l];
    }
  for (int y = 0; y < gh4; y++) {
    size_t g = G(gx, gy + y);
    memcpy(&f.pred_flag[g * 2], tpf, (size_t)gw4 * 2);
    memcpy(&f.ref_idx[g * 2], tref, (size_t)gw4 * 2);
    memcpy(&f.mv[g * 4], tmv, (size_t)gw4 * 8);
    memcpy(&f.refpoc[g * 2], tpoc, (size_t)gw4 * 8);
    memcpy(&f.ref_lt[g * 2], tlt, (size_t)gw4 * 2);
    f.pb_bound[g] |= 1;
  }
  uint8_t* pb = &f.pb_bound[G(gx, gy)];
  for (int x = 0; x < gw4; x++) pb[x] |= 2;
  PU pu{};
  pu.x = x0; pu.y = y0; pu.w = w; pu.h = h;
  pu.pf[0] = pf[0]; pu.pf[1] = pf[1];
  pu.mv[0][0] = mv[0][0]; pu.mv[0][1] = mv[0][1];
  pu.mv[1][0] = mv[1][0]; pu.mv[1][1] = mv[1][1];
  pu.ref[0] = ref[0]; pu.ref[1] = ref[1];
  pu.ref_poc[0] = rp[0]; pu.ref_poc[1] = rp[1];
  pu.ref_frame[0] = rframe[0]; pu.ref_frame[1] = rframe[1];
  pu.slice_idx = slice_idx;
  if (pu_out >= 0) f.pus[pu_out] = pu;
  else f.pus.push_back(pu);
}

static bool decode_slice_data(PicState& ps, Frame& f, SliceHeader& sh,
                              const uint8_t* data, size_t dlen, int sidx) {
  SliceReader sr(&ps, f, sh, data, dlen, sidx);
  return sr.run();
}

void Context::derive_motion(Frame& fr) {
  if (fr.raw_pus.empty()) return;
  int cur_slice = -1;
  std::unique_ptr<SliceReader> sr;
  for (const RawPU& r : fr.raw_pus) {
    if (r.slice_idx != cur_slice) {
      cur_slice = r.slice_idx;
      sr.reset(new SliceReader(nullptr, fr, fr.slices[cur_slice],
                               nullptr, 0, cur_slice));
    }
    sr->derive_pu(r);
  }
  fr.raw_pus.clear();
  fr.raw_pus.shrink_to_fit();
}

// Wavefront motion replay: merge/AMVP read only left/top/top-right
// neighbor motion (merge_candidates A1/B1/B0/A0/B2 above) plus the
// collocated frame's compressed grids, so CTB rows can derive in
// parallel with the same dependency shape the CABAC WPP pool exploits —
// row N's PU at column c needs row N-1 derived through column
// (x0+w)>>ctb_log2 (B0). A0 (y0+h, row below) is never z-order
// available, and availability never crosses tiles, so the wavefront
// unit is one (tile, CTB row) run of decode-order raw_pus. This is the
// round-5 answer to the serial decode-order replay chain the reference
// also walks inline (motion.cc:782-1019,1100-1276).
void Context::derive_motion_wavefront(Frame& fr, int nt) {
  size_t n = fr.raw_pus.size();
  if (!n) return;
  // small frames: parallel dispatch + wavefront waits cost more than
  // the serial walk (~3 ms at 1080p)
  if (nt <= 1 || n < 6000) { derive_motion(fr); return; }
  int ctb_log2 = fr.sps->log2_ctb;
  int wctbs = fr.nctbx;
  const PPS& pps = *fr.pps;
  struct Run { size_t a, b; int parent; };
  std::vector<Run> runs;
  {
    std::map<std::pair<int, int>, int> last;   // (tile,row) -> run idx
    int prow = -1, ptile = -1;
    for (size_t i = 0; i < n; i++) {
      const RawPU& r = fr.raw_pus[i];
      int row = r.yc >> ctb_log2;
      int rs = row * wctbs + (r.xc >> ctb_log2);
      int tile = pps.tile_id[rs];
      if (row != prow || tile != ptile) {
        Run R{i, i, -1};
        auto it = last.find({tile, row - 1});
        if (it != last.end()) R.parent = it->second;
        runs.push_back(R);
        last[{tile, row}] = (int)runs.size() - 1;
        prow = row; ptile = tile;
      }
      runs.back().b = i + 1;
    }
  }
  fr.pus.resize(n);
  std::unique_ptr<std::atomic<int>[]> prog(new std::atomic<int>[runs.size()]);
  for (size_t k = 0; k < runs.size(); k++) prog[k].store(-1);
  std::atomic<size_t> next{0};
  std::atomic<bool> oops{false};
  auto work = [&]() {
    std::unique_ptr<SliceReader> sr;
    for (;;) {
      size_t k = next.fetch_add(1);
      if (k >= runs.size()) break;
      const Run& R = runs[k];
      std::atomic<int>* par = R.parent >= 0 ? &prog[R.parent] : nullptr;
      int cur_slice = -1;
      for (size_t i = R.a; i < R.b && !oops.load(std::memory_order_relaxed);
           i++) {
        const RawPU& r = fr.raw_pus[i];
        if (r.slice_idx != cur_slice) {
          cur_slice = r.slice_idx;
          if (cur_slice < 0 || cur_slice >= (int)fr.slices.size()) {
            oops.store(true); break;
          }
          sr.reset(new SliceReader(nullptr, fr, fr.slices[cur_slice],
                                   nullptr, 0, cur_slice));
        }
        if (par) {
          int need = (r.x0 + r.w) >> ctb_log2;
          while (par->load(std::memory_order_acquire) < need)
            std::this_thread::yield();
        }
        // publish: all columns < current CTB column of this run are
        // fully derived (in-run decode order); release orders the
        // grid writes of earlier PUs before the column count
        prog[k].store((r.xc >> ctb_log2) - 1, std::memory_order_release);
        sr->pu_out = (int)i;
        sr->derive_pu(r);
      }
      prog[k].store(INT_MAX, std::memory_order_release);
    }
  };
  replay_pool.run(nt - 1, work);
  if (oops.load()) {                 // corrupt slice_idx: serial fallback
    fr.pus.clear();
    derive_motion(fr);
    return;
  }
  fr.raw_pus.clear();
  fr.raw_pus.shrink_to_fit();
}

bool Context::flush_jobs() {
  size_t begin = jobs_done, end = jobs.size();
  if (cur_job && end > begin && jobs[end - 1].get() == cur_job) end--;
  if (begin >= end) return true;
  int nt = num_threads;
  if (nt <= 0) {
    const char* e = getenv("FE_THREADS");
    nt = e ? atoi(e) : (int)std::thread::hardware_concurrency();
    if (nt <= 0) nt = 1;
  }
  if (g_trace) nt = 1;  // keep trace output in decode order
  nt = std::min<int>(nt, (int)(end - begin));
  auto run_job = [](PicJob& j, Frame* f, std::vector<SliceHeader>& slices) {
    PicState ps;
    for (auto& sd : j.slices) {
      if (!decode_slice_data(ps, *f, slices[sd.slice_idx],
                             sd.payload.data(), sd.payload.size(),
                             sd.slice_idx)) {
        j.failed = true;
        break;
      }
    }
    j.slices.clear();
    j.slices.shrink_to_fit();
  };
  auto prof_now = []() {
    return std::chrono::duration<double>(
        std::chrono::steady_clock::now().time_since_epoch()).count();
  };
  double t_pool0 = prof_now();
  double t_dm = 0, t_cm = 0;
  if (nt <= 1) {
    // serial: parse then replay per frame (replay order = decode order)
    for (size_t i = begin; i < end; i++) {
      run_job(*jobs[i], jobs[i]->f, jobs[i]->f->slices);
      if (jobs[i]->failed) { error = "slice data decode failed"; return false; }
      double a = prof_now();
      derive_motion(*jobs[i]->f);
      double b = prof_now();
      jobs[i]->f->compress_motion();
      t_dm += b - a;
      t_cm += prof_now() - b;
    }
  } else {
    // CABAC parse jobs fan out over the pool; the motion replay
    // (merge/AMVP/TMVP derivation + TMVP compression, which must run
    // in decode order — frame N's TMVP reads its refs' compressed
    // motion) runs CONCURRENTLY on a consumer thread that follows the
    // pool's per-job completion flags, instead of after the whole
    // batch: the serial replay chain hides under the parse wall.
    // Within each frame the replay itself runs as a CTB-row wavefront
    // (derive_motion_wavefront) — it was 40-84% of the FE wall.
    int replay_nt = std::min(nt, 4);
    if (const char* e = getenv("FE_REPLAY_THREADS")) replay_nt = atoi(e);
    if (replay_nt < 1) replay_nt = 1;
    std::atomic<size_t> next{begin};
    std::atomic<size_t> parsed{0};
    std::unique_ptr<std::atomic<int>[]> done(
        new std::atomic<int>[end - begin]);
    for (size_t i = 0; i < end - begin; i++) done[i].store(0);
    std::mutex m;
    std::condition_variable cv;
    auto worker = [&]() {
      for (;;) {
        size_t i = next.fetch_add(1);
        if (i >= end) break;
        run_job(*jobs[i], jobs[i]->f, jobs[i]->f->slices);
        done[i - begin].store(1, std::memory_order_release);
        parsed.fetch_add(1);
        { std::lock_guard<std::mutex> lk(m); }
        cv.notify_one();
      }
    };
    bool replay_failed = false;
    auto consumer = [&]() {
      for (size_t i = begin; i < end; i++) {
        if (!done[i - begin].load(std::memory_order_acquire)) {
          std::unique_lock<std::mutex> lk(m);
          cv.wait(lk, [&] {
            return done[i - begin].load(std::memory_order_acquire) != 0;
          });
        }
        if (jobs[i]->failed) { replay_failed = true; return; }
        double a = prof_now();
        // cores are saturated while CABAC jobs remain: the serial walk
        // overlaps with the parse wall for free. Once the pool drains
        // (the replay chain is the tail — it was 40-84% of the FE
        // wall), fan the frame out as a CTB-row wavefront.
        if (parsed.load(std::memory_order_relaxed) >= end - begin)
          derive_motion_wavefront(*jobs[i]->f, replay_nt);
        else
          derive_motion(*jobs[i]->f);
        double b = prof_now();
        jobs[i]->f->compress_motion();
        t_dm += b - a;
        t_cm += prof_now() - b;
      }
    };
    std::vector<std::thread> pool;
    for (int t = 0; t < nt; t++) pool.emplace_back(worker);
    consumer();
    for (auto& th : pool) th.join();
    for (size_t i = begin; i < end; i++)
      if (jobs[i]->failed) replay_failed = true;
    if (replay_failed) { error = "slice data decode failed"; return false; }
  }
  if (getenv("FE_PROF"))
    fprintf(stderr,
            "# FE_PROF frames=%zu threads=%d parse+replay=%.3fs "
            "derive_motion=%.3fs compress=%.3fs\n",
            end - begin, nt, prof_now() - t_pool0, t_dm, t_cm);
  jobs_done = end;
  return true;
}

}  // namespace

// ============================== C ABI =====================================
extern "C" {

// ====================== native plan packing ===============================
// fe_pack_setup / fe_pack_frame: fill the fused frame program's per-dtype
// blob buffers (frame_program.pack_frame + pack_blob layout) DIRECTLY from
// the C++ Frame state — the Python/numpy pack was the host pipeline's
// wall at 4K. The Python
// layout (blob_meta) is passed in as a key table; every writer below is a
// byte-exact mirror of its numpy counterpart (differential test:
// tests/test_native_pack.py compares whole blobs). Python keeps packing
// the keys C++ does not claim (weights, scaling matrices, intra classes).
enum PackKeyKind {
  PK_PM = 0, PK_CBF, PK_OFF, PK_TUCB, PK_EDGEALL, PK_QP, PK_PF, PK_MV,
  PK_POC, PK_SLOT, PK_ALLOW_V, PK_ALLOW_H, PK_PAIR_OK, PK_SAO_TYPE,
  PK_SAO_EO, PK_SAO_BAND, PK_SAO_OFF, PK_SIDX, PK_SH_DISABLE, PK_SH_BETA,
  PK_SH_TC, PK_SH_ACROSS, PK_SH_SAOL, PK_SH_SAOC, PK_RC, PK_RB, PK_RBI,
  PK_REI, PK_REV, PK_RK, PK_RQ, PK_RS
};

struct PackKeyDesc {
  int32_t kind, dt_slot;      // dt_slot: index into the buffer-ptr array
  int64_t off, sz;            // element offset in dtype buffer, per frame
  int32_t cidx, log2, K, E, Ssb, kinds;   // residual-bucket params
};

struct PackPlan {
  // cfg scalars (mirror of ProgramCfg fields pack_frame consumes)
  int W = 0, H = 0, log2ctb = 6, S1 = 2;
  int pack_bits = 1, qp_grid8 = 0, lane0 = 0, pu_grid8 = 0;
  int mv8 = 0, poc8 = 0, pcm_lfd = 0, skip_mc = 0, r_act = 1;
  int subw = 2, subh = 2;     // chroma plane subsampling (4:2:0 default)
  std::vector<PackKeyDesc> keys;
};

static void pack_bits_rows(const uint8_t* src, int gh, int gw, int stride,
                           uint8_t* dst) {
  // numpy packbits(bool, axis=1): MSB-first bytes per row
  int gwb = (gw + 7) >> 3;
  for (int y = 0; y < gh; y++) {
    const uint8_t* r = src + (size_t)y * stride;
    uint8_t* o = dst + (size_t)y * gwb;
    for (int xb = 0; xb < gwb; xb++) {
      uint8_t v = 0;
      int x0 = xb * 8, xe = x0 + 8 < gw ? x0 + 8 : gw;
      for (int x = x0; x < xe; x++) v |= (r[x] & 1) << (7 - (x - x0));
      o[xb] = v;
    }
  }
}

struct FEHandle {
  Context ctx;
  std::vector<uint8_t> nal_buf;
  std::vector<int> skip_buf;
  std::unique_ptr<PackPlan> pack_plan;   // fe_pack_setup state
};

FEHandle* fe_new() { trace_open(); init_scans(); return new FEHandle(); }
void fe_free(FEHandle* h) { delete h; }

// Push a whole Annex-B stream; returns number of frames decoded, or -1.
int fe_push_stream(FEHandle* h, const uint8_t* data, int64_t len) {
  // find start codes
  std::vector<int64_t> starts;
  for (int64_t i = 0; i + 2 < len; i++) {
    if (data[i] == 0 && data[i + 1] == 0 && data[i + 2] == 1) {
      starts.push_back(i + 3);
      i += 2;
    }
  }
  for (size_t k = 0; k < starts.size(); k++) {
    int64_t s = starts[k];
    int64_t e = (k + 1 < starts.size()) ? starts[k + 1] - 3 : len;
    while (e > s && k + 1 < starts.size() && data[e - 1] == 0) e--;
    if (e - s < 2) continue;
    unescape(data + s, (size_t)(e - s), h->nal_buf, h->skip_buf);
    if (!h->ctx.decode_nal(h->nal_buf.data(), h->nal_buf.size(), h->skip_buf))
      return -1;
  }
  h->ctx.finish_picture();
  if (!h->ctx.flush_jobs()) return -1;
  return (int)h->ctx.frames.size();
}

const char* fe_error(FEHandle* h) { return h->ctx.error.c_str(); }

// info[]: 0 W,1 H,2 poc,3 nal_type,4 output_flag,5 n_tus,6 n_pus,
//         7 coeff_pool_len,8 pcm_pool_len,9 n_slices,10 gw,11 gh,
//         12 nctbx,13 nctby,14 max_num_reorder,15 conf_l,16 conf_r,
//         17 conf_t,18 conf_b, 19 sps_id, 20 frame_id, 21 mw, 22 mh
int fe_frame_info(FEHandle* h, int idx, int32_t* info) {
  if (idx < 0 || idx >= (int)h->ctx.frames.size()) return -1;
  Frame& f = *h->ctx.frames[idx];
  info[0] = f.W; info[1] = f.H; info[2] = f.poc; info[3] = f.nal_type;
  info[4] = f.output_flag;
  info[5] = (int)f.tus.size(); info[6] = (int)f.pus.size();
  info[7] = (int)f.coeff_pool.size(); info[8] = (int)f.pcm_pool.size();
  info[9] = (int)f.slices.size();
  info[10] = f.gw; info[11] = f.gh; info[12] = f.nctbx; info[13] = f.nctby;
  info[14] = f.sps->max_num_reorder;
  info[15] = f.sps->conformance_window ? f.sps->conf_win[0] : 0;
  info[16] = f.sps->conformance_window ? f.sps->conf_win[1] : 0;
  info[17] = f.sps->conformance_window ? f.sps->conf_win[2] : 0;
  info[18] = f.sps->conformance_window ? f.sps->conf_win[3] : 0;
  info[19] = f.sps->sps_id; info[20] = f.frame_id;
  info[21] = f.mw; info[22] = f.mh;
  return 0;
}

// copy the 4x4 grids (each gw*gh entries, caller-allocated)
int fe_get_grids(FEHandle* h, int idx, uint8_t* pred_mode, uint8_t* skip,
                 uint8_t* intra_y, uint8_t* intra_c, uint8_t* ct_depth,
                 uint8_t* log2_cb, int8_t* qp_y, uint8_t* tq_bypass,
                 uint8_t* pcm, uint8_t* cbf_luma, uint8_t* tu_bound,
                 uint8_t* pb_bound, uint8_t* cb_bound,
                 int16_t* mv, int8_t* ref_idx, uint8_t* pred_flag,
                 int32_t* refpoc, uint8_t* ref_lt) {
  if (idx < 0 || idx >= (int)h->ctx.frames.size()) return -1;
  Frame& f = *h->ctx.frames[idx];
  size_t g = (size_t)f.gw * f.gh;
  memcpy(pred_mode, f.pred_mode.data(), g);
  memcpy(skip, f.skip_flag.data(), g);
  memcpy(intra_y, f.intra_y.data(), g);
  memcpy(intra_c, f.intra_c.data(), g);
  memcpy(ct_depth, f.ct_depth.data(), g);
  memcpy(log2_cb, f.log2_cb.data(), g);
  memcpy(qp_y, f.qp_y.data(), g);
  memcpy(tq_bypass, f.tq_bypass.data(), g);
  memcpy(pcm, f.pcm_flag.data(), g);
  memcpy(cbf_luma, f.cbf_luma.data(), g);
  memcpy(tu_bound, f.tu_bound.data(), g);
  memcpy(pb_bound, f.pb_bound.data(), g);
  memcpy(cb_bound, f.cb_bound.data(), g);
  memcpy(mv, f.mv.data(), g * 4 * sizeof(int16_t));
  memcpy(ref_idx, f.ref_idx.data(), g * 2);
  memcpy(pred_flag, f.pred_flag.data(), g * 2);
  memcpy(refpoc, f.refpoc.data(), g * 2 * sizeof(int32_t));
  memcpy(ref_lt, f.ref_lt.data(), g * 2);
  return 0;
}

int fe_get_ctb_grids(FEHandle* h, int idx, int32_t* slice_addr,
                     int32_t* slice_seg, uint8_t* sao_type, uint8_t* sao_eo,
                     uint8_t* sao_band, int16_t* sao_off) {
  if (idx < 0 || idx >= (int)h->ctx.frames.size()) return -1;
  Frame& f = *h->ctx.frames[idx];
  size_t nc = (size_t)f.nctbx * f.nctby;
  memcpy(slice_addr, f.slice_addr.data(), nc * 4);
  memcpy(slice_seg, f.ctb_slice_seg.data(), nc * 4);
  memcpy(sao_type, f.sao_type.data(), nc * 3);
  memcpy(sao_eo, f.sao_eo.data(), nc * 3);
  memcpy(sao_band, f.sao_band.data(), nc * 3);
  memcpy(sao_off, f.sao_off.data(), nc * 3 * 4 * sizeof(int16_t));
  return 0;
}

// tus: per TU 12 ints: cidx,x,y,log2,intra_mode,qp,tskip,tqbypass,
//      pred_mode,coeff_off,ccp_alpha,rdpcm
int fe_get_tus(FEHandle* h, int idx, int32_t* tus, int16_t* coeffs,
               int16_t* pcm) {
  if (idx < 0 || idx >= (int)h->ctx.frames.size()) return -1;
  Frame& f = *h->ctx.frames[idx];
  for (size_t i = 0; i < f.tus.size(); i++) {
    const TU& t = f.tus[i];
    int32_t* o = tus + i * 12;
    o[0] = t.cidx; o[1] = t.x; o[2] = t.y; o[3] = t.log2;
    o[4] = t.intra_mode; o[5] = t.qp; o[6] = t.transform_skip;
    o[7] = t.tq_bypass; o[8] = t.pred_mode; o[9] = t.coeff_off;
    o[10] = t.ccp_alpha; o[11] = t.rdpcm;
  }
  if (!f.coeff_pool.empty())
    memcpy(coeffs, f.coeff_pool.data(), f.coeff_pool.size() * sizeof(int16_t));
  if (!f.pcm_pool.empty())
    memcpy(pcm, f.pcm_pool.data(), f.pcm_pool.size() * sizeof(int16_t));
  return 0;
}

// Wavefront levels for the fused intra scan (mirror of
// libde265_tpu/intra_fused.assign_levels_meta, same DP in decode order):
// out[i] = level of TU i (0 for non-intra / PCM rows). The Python DP is
// the host pack bottleneck for I-frames; this runs in ~1 ms.
int fe_intra_levels(FEHandle* h, int idx, int32_t* out) {
  if (idx < 0 || idx >= (int)h->ctx.frames.size()) return -1;
  Frame& f = *h->ctx.frames[idx];
  const SPS& sps = *f.sps;
  // PER-AXIS chroma scale: 4:2:2 has subw=2, subh=1 — scaling y by subw
  // wrote past the grid (caught by the full-suite abort on rext vectors)
  int subw = sps.chroma_array_type ? sps.subw : 1;
  int subh = sps.chroma_array_type ? sps.subh : 1;
  int gh = f.gh, gw = f.gw;
  std::vector<int32_t> L(3 * gh * gw, 0);
  for (size_t i = 0; i < f.tus.size(); i++) {
    const TU& t = f.tus[i];
    out[i] = 0;
    if (t.cidx < 0 || t.pred_mode != 1) continue;
    int scx = t.cidx == 0 ? 1 : subw;
    int scy = t.cidx == 0 ? 1 : subh;
    int n = 1 << t.log2;
    int x0 = t.x * scx, y0 = t.y * scy;
    int spanx = n * scx, spany = n * scy;
    int32_t* g = L.data() + t.cidx * gh * gw;
    int gx0 = x0 >> 2, gy0 = y0 >> 2;
    int gsx = spanx >> 2; if (gsx < 1) gsx = 1;
    int gsy = spany >> 2; if (gsy < 1) gsy = 1;
    if (gx0 + gsx > gw) gsx = gw - gx0;
    if (gy0 + gsy > gh) gsy = gh - gy0;
    int dep = 0;
    int bx = (x0 - 1) >> 2;
    if (bx >= 0) {
      int y_end = (y0 + 2 * spany - 1) >> 2;
      if (y_end > gh - 1) y_end = gh - 1;
      for (int y = gy0; y <= y_end; y++)
        if (g[y * gw + bx] > dep) dep = g[y * gw + bx];
    }
    int by = (y0 - 1) >> 2;
    if (by >= 0) {
      int x_end = (x0 + 2 * spanx - 1) >> 2;
      if (x_end > gw - 1) x_end = gw - 1;
      for (int x = bx > 0 ? bx : 0; x <= x_end; x++)
        if (g[by * gw + x] > dep) dep = g[by * gw + x];
    }
    int lvl = dep + 1;
    for (int y = gy0; y < gy0 + gsy; y++)
      for (int x = gx0; x < gx0 + gsx; x++)
        g[y * gw + x] = lvl;
    out[i] = lvl;
  }
  return 0;
}

// pus: per PU 17 ints: x,y,w,h,pf0,pf1,mv00,mv01,mv10,mv11,ref0,ref1,
//      refpoc0,refpoc1,refframe0,refframe1,slice_idx
int fe_get_pus(FEHandle* h, int idx, int32_t* pus) {
  if (idx < 0 || idx >= (int)h->ctx.frames.size()) return -1;
  Frame& f = *h->ctx.frames[idx];
  for (size_t i = 0; i < f.pus.size(); i++) {
    const PU& p = f.pus[i];
    int32_t* o = pus + i * 17;
    o[0] = p.x; o[1] = p.y; o[2] = p.w; o[3] = p.h;
    o[4] = p.pf[0]; o[5] = p.pf[1];
    o[6] = p.mv[0][0]; o[7] = p.mv[0][1]; o[8] = p.mv[1][0]; o[9] = p.mv[1][1];
    o[10] = p.ref[0]; o[11] = p.ref[1];
    o[12] = p.ref_poc[0]; o[13] = p.ref_poc[1];
    o[14] = p.ref_frame[0]; o[15] = p.ref_frame[1];
    o[16] = p.slice_idx;
  }
  return 0;
}

// slice info: per slice 16 ints:
//  seg_addr, slice_addr_rs, type, qp, beta_off, tc_off, disable_deblock,
//  sao_luma, sao_chroma, lf_across, max_merge, nref0, nref1, has_pw,
//  cb_qp_off, cr_qp_off
int fe_get_slices(FEHandle* h, int idx, int32_t* out) {
  if (idx < 0 || idx >= (int)h->ctx.frames.size()) return -1;
  Frame& f = *h->ctx.frames[idx];
  for (size_t i = 0; i < f.slices.size(); i++) {
    const SliceHeader& s = f.slices[i];
    int32_t* o = out + i * 16;
    o[0] = s.seg_addr; o[1] = s.slice_addr_rs; o[2] = s.type; o[3] = s.qp;
    o[4] = s.beta_off; o[5] = s.tc_off; o[6] = s.disable_deblock;
    o[7] = s.sao_luma; o[8] = s.sao_chroma; o[9] = s.lf_across;
    o[10] = s.max_merge; o[11] = s.nref[0]; o[12] = s.nref[1];
    o[13] = s.has_pw ? 1 : 0; o[14] = s.cb_qp_off; o[15] = s.cr_qp_off;
  }
  return 0;
}

}  // extern "C"

namespace {

// per-frame derived state shared by several key writers
struct PackCtx {
  const PackPlan& pp;
  Frame& f;
  // slice-row mapping
  std::vector<int32_t> sidx_raw;   // (nctby*nctbx), unmapped = S
  int S;                            // number of real slices
  // resolved ref-slot table (S1,2,16) incl. the numpy unset->sel[0] rule
  std::vector<int32_t> rl;
  // lane-collapse swap mask per 4x4 cell (lane0 mode)
  // (computed on the fly from f.pred_flag)
  PackCtx(const PackPlan& p, Frame& fr, const int32_t* fids,
          const int32_t* slots, int nfids)
      : pp(p), f(fr) {
    S = (int)f.slices.size();
    sidx_raw.assign((size_t)f.nctby * f.nctbx, S);
    // seg2row: slice_segment_address -> header row; grid = ctb_slice_seg
    for (size_t i = 0; i < sidx_raw.size(); i++) {
      int seg = f.ctb_slice_seg[i];
      for (int s = 0; s < S; s++)
        if (f.slices[s].seg_addr == seg) { sidx_raw[i] = s; break; }
    }
    // rl_slot: mirror _pack_motion (frame_program.py:514-555)
    rl.assign((size_t)pp.S1 * 2 * 16, 0);
    std::vector<int> used_fids;
    std::vector<int> compact_fid;           // used_fids[i] = fid
    if (!pp.skip_mc) {
      std::vector<int32_t> rl_c((size_t)pp.S1 * 2 * 16, 0);
      for (int l = 0; l < 2; l++) {
        // unique (sh*16+ridx) in ascending key order, first occurrence
        std::vector<std::pair<int, int>> kv;    // key -> fid
        std::vector<char> seen((size_t)pp.S1 * 16, 0);
        for (const PU& pu : f.pus) {
          if (!pu.pf[l]) continue;
          int key = pu.slice_idx * 16 + pu.ref[l];
          if (key < 0 || key >= pp.S1 * 16 || seen[key]) continue;
          seen[key] = 1;
          kv.push_back({key, pu.ref_frame[l]});
        }
        std::sort(kv.begin(), kv.end());
        for (auto& e : kv) {
          int fid = e.second, ci = -1;
          for (size_t i = 0; i < used_fids.size(); i++)
            if (used_fids[i] == fid) { ci = (int)i; break; }
          if (ci < 0) { ci = (int)used_fids.size(); used_fids.push_back(fid); }
          rl_c[(size_t)(e.first / 16) * 32 + l * 16 + (e.first % 16)] = ci;
        }
      }
      // sel: compact id -> DPB slot (fid_slot map from python)
      std::vector<int32_t> sel(pp.r_act > 0 ? pp.r_act : 1, 0);
      for (size_t i = 0; i < used_fids.size(); i++) {
        int slot = 0;
        for (int j = 0; j < nfids; j++)
          if (fids[j] == used_fids[i]) { slot = slots[j]; break; }
        if ((int)i < (int)sel.size()) sel[i] = slot;
      }
      for (size_t i = 0; i < rl.size(); i++) {
        int c = rl_c[i];
        if (c < 0) c = 0;
        if (c > pp.r_act - 1) c = pp.r_act - 1;
        rl[i] = sel[c];
      }
    }
  }
  int sidx_clipped(int cy, int cx) const {
    int v = sidx_raw[(size_t)cy * f.nctbx + cx];
    return v < pp.S1 - 1 ? v : pp.S1 - 1;
  }
};

// slice-table entry with the slice_tables() sentinel + pack_frame padding
static int32_t sh_value(const PackCtx& c, int kind, int row) {
  const int S = c.S;
  if (row < S) {
    const SliceHeader& s = c.f.slices[row];
    switch (kind) {
      case PK_SH_DISABLE: return s.disable_deblock ? 1 : 0;
      case PK_SH_BETA: return s.beta_off;
      case PK_SH_TC: return s.tc_off;
      case PK_SH_ACROSS: return s.lf_across ? 1 : 0;
      case PK_SH_SAOL: return s.sao_luma ? 1 : 0;
      case PK_SH_SAOC: return s.sao_chroma ? 1 : 0;
    }
  } else if (row == S) {            // slice_tables sentinel row
    return (kind == PK_SH_DISABLE || kind == PK_SH_ACROSS) ? 1 : 0;
  }
  return kind == PK_SH_DISABLE ? 1 : 0;   // pack_frame pad rows
}

// deblock edge permission between CTB (cy,cx) and neighbour (ny,nx)
static bool ctb_pair_ok(const PackCtx& c, int cy, int cx, int ny, int nx,
                        bool sao) {
  const Frame& f = c.f;
  const PPS& pps = *f.pps;
  size_t ci = (size_t)cy * f.nctbx + cx, ni = (size_t)ny * f.nctbx + nx;
  bool tile_diff = pps.tile_id[(size_t)cy * f.nctbx + cx] !=
                   pps.tile_id[(size_t)ny * f.nctbx + nx];
  if (!pps.lf_across_tiles && tile_diff) return false;
  bool slice_diff = f.slice_addr[ci] != f.slice_addr[ni];
  if (!slice_diff) return true;
  int rc = c.sidx_raw[ci];
  bool a1 = sh_value(c, PK_SH_ACROSS, rc) != 0;
  if (!sao) return a1;
  int rn = c.sidx_raw[ni];
  bool a2 = sh_value(c, PK_SH_ACROSS, rn) != 0;
  return a1 && a2;
}

static int pack_one_key(const PackCtx& c, const PackKeyDesc& kd,
                        uint8_t* dst) {
  Frame& f = c.f;
  const PackPlan& pp = c.pp;
  const int gh = f.gh, gw = f.gw;
  const int sub = pp.pu_grid8 ? 2 : 1;     // motion-grid subsample
  const int mh = (gh + sub - 1) / sub, mw = (gw + sub - 1) / sub;
  const int s = pp.log2ctb - 2;
  switch (kd.kind) {
    case PK_PM: case PK_CBF: case PK_OFF: {
      std::vector<uint8_t> tmp((size_t)gh * gw);
      for (size_t i = 0; i < tmp.size(); i++) {
        if (kd.kind == PK_PM) tmp[i] = f.pred_mode[i] == 1;
        else if (kd.kind == PK_CBF) tmp[i] = f.cbf_luma[i] != 0;
        else {
          uint8_t v = f.tq_bypass[i];
          if (pp.pcm_lfd) v |= f.pcm_flag[i];
          tmp[i] = v != 0;
        }
      }
      pack_bits_rows(tmp.data(), gh, gw, gw, dst);
      return 0;
    }
    case PK_TUCB: case PK_EDGEALL: {
      int gwb = (gw + 7) >> 3;
      std::vector<uint8_t> tmp((size_t)gh * gw);
      for (int bit = 0; bit < 2; bit++) {
        for (size_t i = 0; i < tmp.size(); i++) {
          uint8_t v = f.tu_bound[i] | f.cb_bound[i];
          if (kd.kind == PK_EDGEALL) v |= f.pb_bound[i];
          tmp[i] = (v >> bit) & 1;
        }
        pack_bits_rows(tmp.data(), gh, gw, gw,
                       dst + (size_t)bit * gh * gwb);
      }
      return 0;
    }
    case PK_QP: {
      int8_t* o = (int8_t*)dst;
      int qs = pp.qp_grid8 ? 2 : 1;
      for (int y = 0; y < gh; y += qs)
        for (int x = 0; x < gw; x += qs)
          *o++ = f.qp_y[(size_t)y * gw + x];
      return 0;
    }
    case PK_PF: {
      uint8_t* o = dst;
      for (int y = 0; y < gh; y += sub)
        for (int x = 0; x < gw; x += sub) {
          size_t g = (size_t)y * gw + x;
          uint8_t p0 = f.pred_flag[g * 2], p1 = f.pred_flag[g * 2 + 1];
          if (pp.lane0) *o++ = p0 | p1;
          else { *o++ = p0; *o++ = p1; }
        }
      return 0;
    }
    case PK_MV: {
      for (int y = 0, oi = 0; y < gh; y += sub)
        for (int x = 0; x < gw; x += sub) {
          size_t g = (size_t)y * gw + x;
          int l0 = (pp.lane0 && !f.pred_flag[g * 2]) ? 1 : 0;
          int nl = pp.lane0 ? 1 : 2;
          for (int li = 0; li < nl; li++) {
            int l = pp.lane0 ? l0 : li;
            for (int i = 0; i < 2; i++) {
              int16_t v = f.mv[g * 4 + l * 2 + i];
              if (pp.mv8) ((int8_t*)dst)[oi++] = (int8_t)v;
              else ((int16_t*)dst)[oi++] = v;
            }
          }
        }
      return 0;
    }
    case PK_POC: {
      for (int y = 0, oi = 0; y < gh; y += sub)
        for (int x = 0; x < gw; x += sub) {
          size_t g = (size_t)y * gw + x;
          int l0 = (pp.lane0 && !f.pred_flag[g * 2]) ? 1 : 0;
          int nl = pp.lane0 ? 1 : 2;
          for (int li = 0; li < nl; li++) {
            int l = pp.lane0 ? l0 : li;
            int32_t d = f.refpoc[g * 2 + l] - f.poc;
            if (pp.poc8) ((int8_t*)dst)[oi++] = (int8_t)d;
            else ((int16_t*)dst)[oi++] = (int16_t)d;
          }
        }
      return 0;
    }
    case PK_SLOT: {
      int8_t* o = (int8_t*)dst;
      for (int y = 0; y < gh; y += sub)
        for (int x = 0; x < gw; x += sub) {
          size_t g = (size_t)y * gw + x;
          int row = c.sidx_clipped(y >> s, x >> s);
          int8_t sl[2];
          for (int l = 0; l < 2; l++) {
            int r = f.ref_idx[g * 2 + l];
            if (r < 0) r = 0;
            if (r > 15) r = 15;
            sl[l] = (int8_t)c.rl[(size_t)row * 32 + l * 16 + r];
          }
          if (pp.lane0)
            *o++ = f.pred_flag[g * 2] ? sl[0] : sl[1];
          else { *o++ = sl[0]; *o++ = sl[1]; }
        }
      return 0;
    }
    case PK_ALLOW_V: case PK_ALLOW_H: {
      bool vert = kd.kind == PK_ALLOW_V;
      for (int cy = 0; cy < f.nctby; cy++)
        for (int cx = 0; cx < f.nctbx; cx++) {
          bool ok = false;
          if (vert ? cx > 0 : cy > 0)
            ok = ctb_pair_ok(c, cy, cx, vert ? cy : cy - 1,
                             vert ? cx - 1 : cx, false);
          dst[(size_t)cy * f.nctbx + cx] = ok;
        }
      return 0;
    }
    case PK_PAIR_OK: {
      // dir 0 left, 1 right, 2 up, 3 down (device_plan.ctb_allow_masks)
      static const int dy[4] = {0, 0, -1, 1}, dx[4] = {-1, 1, 0, 0};
      for (int d = 0; d < 4; d++)
        for (int cy = 0; cy < f.nctby; cy++)
          for (int cx = 0; cx < f.nctbx; cx++) {
            int ny = cy + dy[d], nx = cx + dx[d];
            bool ok = ny >= 0 && nx >= 0 && ny < f.nctby && nx < f.nctbx
                && ctb_pair_ok(c, cy, cx, ny, nx, true);
            dst[((size_t)d * f.nctby + cy) * f.nctbx + cx] = ok;
          }
      return 0;
    }
    case PK_SAO_TYPE:
      memcpy(dst, f.sao_type.data(), f.sao_type.size());
      return 0;
    case PK_SAO_EO:
      memcpy(dst, f.sao_eo.data(), f.sao_eo.size());
      return 0;
    case PK_SAO_BAND:
      memcpy(dst, f.sao_band.data(), f.sao_band.size());
      return 0;
    case PK_SAO_OFF:
      memcpy(dst, f.sao_off.data(), f.sao_off.size() * sizeof(int16_t));
      return 0;
    case PK_SIDX: {
      int32_t* o = (int32_t*)dst;
      for (int cy = 0; cy < f.nctby; cy++)
        for (int cx = 0; cx < f.nctbx; cx++)
          *o++ = c.sidx_clipped(cy, cx);
      return 0;
    }
    case PK_SH_DISABLE: case PK_SH_BETA: case PK_SH_TC:
    case PK_SH_ACROSS: case PK_SH_SAOL: case PK_SH_SAOC: {
      int32_t* o = (int32_t*)dst;
      for (int r = 0; r < pp.S1; r++) o[r] = sh_value(c, kd.kind, r);
      return 0;
    }
    case PK_RC: case PK_RB: case PK_RBI: case PK_REI: case PK_REV:
    case PK_RK: case PK_RQ: case PK_RS: {
      const int n = 1 << kd.log2, nn = n * n;
      const int Wp = pp.W / (kd.cidx == 0 ? 1 : pp.subw);
      const int Hp = pp.H / (kd.cidx == 0 ? 1 : pp.subh);
      const int ncols = (Wp + n - 1) / n;
      const int nslots = ((Hp + n - 1) / n) * ncols;
      const int nsb = (n / 4) * (n / 4);
      // init padding
      if (kd.kind == PK_RC) memset(dst, 0, (size_t)kd.K * (nn / 2));
      else if (kd.kind == PK_RB) memset(dst, 0, (size_t)kd.Ssb * 8);
      else if (kd.kind == PK_RBI) {
        int32_t* o = (int32_t*)dst;
        for (int i = 0; i < kd.Ssb; i++) o[i] = kd.K * nsb + i;
      } else if (kd.kind == PK_REI) {
        int32_t* o = (int32_t*)dst;
        for (int i = 0; i < kd.E; i++) o[i] = kd.K * nn;
      } else if (kd.kind == PK_REV)
        memset(dst, 0, (size_t)kd.E * sizeof(int16_t));
      else if (kd.kind == PK_RK) memset(dst, 0, kd.K);
      else if (kd.kind == PK_RQ)
        memset(dst, 0, (size_t)kd.K * sizeof(int32_t));
      else if (kd.kind == PK_RS) {
        int32_t* o = (int32_t*)dst;
        for (int i = 0; i < kd.K; i++) o[i] = nslots;
      }
      int k = 0, ne = 0, nz = 0;
      for (const TU& t : f.tus) {
        if (t.cidx != kd.cidx || t.log2 != kd.log2) continue;
        if (t.pred_mode != 0 || t.coeff_off < 0) continue;
        if (k >= kd.K) return -2;
        const int16_t* cf = f.coeff_pool.data() + t.coeff_off;
        switch (kd.kind) {
          case PK_RC: {
            // 4-bit two's-complement nibble pairs (mirror of
            // pack_frame's uint8 body; escapes repair |v| outside
            // [-8,7])
            uint8_t* o = (uint8_t*)dst + (size_t)k * (nn / 2);
            for (int i = 0; i < nn; i += 2)
              o[i >> 1] = (uint8_t)((cf[i] & 15) |
                                    ((cf[i + 1] & 15) << 4));
            break;
          }
          case PK_RB: case PK_RBI: {
            // coded-sub-block rows in (k, sy, sx) order; both keys walk
            // the same nz sequence so their row counters agree. The nz
            // test uses the ORIGINAL level (nibble wrap can zero a 16).
            for (int sy = 0; sy < n / 4; sy++)
              for (int sx = 0; sx < n / 4; sx++) {
                bool any = false;
                int vals[16];
                for (int r = 0; r < 4; r++)
                  for (int cc = 0; cc < 4; cc++) {
                    int v = cf[(sy * 4 + r) * n + sx * 4 + cc];
                    vals[r * 4 + cc] = v;
                    any |= v != 0;
                  }
                if (!any) continue;
                if (nz >= kd.Ssb) return -2;
                if (kd.kind == PK_RB) {
                  uint8_t* o = (uint8_t*)dst + (size_t)nz * 8;
                  for (int j = 0; j < 8; j++)
                    o[j] = (uint8_t)((vals[2 * j] & 15) |
                                     ((vals[2 * j + 1] & 15) << 4));
                } else
                  ((int32_t*)dst)[nz] = k * nsb + sy * (n / 4) + sx;
                nz++;
              }
            break;
          }
          case PK_REI: case PK_REV: {
            for (int i = 0; i < nn; i++) {
              int v = cf[i];
              if (v >= -8 && v <= 7) continue;
              if (ne >= kd.E) return -2;
              if (kd.kind == PK_REI)
                ((int32_t*)dst)[ne] = k * nn + i;
              else
                ((int16_t*)dst)[ne] = (int16_t)v;
              ne++;
            }
            break;
          }
          case PK_RK:
            ((int8_t*)dst)[k] = t.tq_bypass ? 2 : t.transform_skip ? 1 : 0;
            break;
          case PK_RQ:
            ((int32_t*)dst)[k] = t.qp;
            break;
          case PK_RS:
            ((int32_t*)dst)[k] =
                (t.y >> kd.log2) * ncols + (t.x >> kd.log2);
            break;
        }
        k++;
      }
      (void)mh; (void)mw;
      return 0;
    }
  }
  return -3;
}

}  // namespace

extern "C" {

int fe_pack_setup(FEHandle* h, const int32_t* cfg, int ncfg,
                  const int64_t* keys, int nkeys) {
  if (ncfg < 13) return -1;
  PackPlan* pp = new PackPlan();
  pp->W = cfg[0]; pp->H = cfg[1]; pp->log2ctb = cfg[2]; pp->S1 = cfg[3];
  pp->pack_bits = cfg[4]; pp->qp_grid8 = cfg[5]; pp->lane0 = cfg[6];
  pp->pu_grid8 = cfg[7]; pp->mv8 = cfg[8]; pp->poc8 = cfg[9];
  pp->pcm_lfd = cfg[10]; pp->skip_mc = cfg[11]; pp->r_act = cfg[12];
  if (ncfg >= 15) { pp->subw = cfg[13]; pp->subh = cfg[14]; }
  for (int i = 0; i < nkeys; i++) {
    const int64_t* k = keys + (size_t)i * 10;
    PackKeyDesc kd;
    kd.kind = (int32_t)k[0]; kd.dt_slot = (int32_t)k[1];
    kd.off = k[2]; kd.sz = k[3];
    kd.cidx = (int32_t)k[4]; kd.log2 = (int32_t)k[5];
    kd.K = (int32_t)k[6]; kd.E = (int32_t)k[7];
    kd.Ssb = (int32_t)k[8]; kd.kinds = (int32_t)k[9];
    pp->keys.push_back(kd);
  }
  h->pack_plan.reset(pp);
  return 0;
}

// element sizes per dtype slot: 0='|i1' 1='|u1' 2='<i2' 3='<i4' 4='|b1'
static const int PK_ESIZE[5] = {1, 1, 2, 4, 1};

int fe_pack_frame(FEHandle* h, int idx, int batch_index,
                  const int32_t* fids, const int32_t* slots, int nfids,
                  uint8_t* buf_i1, uint8_t* buf_u1, uint8_t* buf_i2,
                  uint8_t* buf_i4, uint8_t* buf_b1) {
  if (!h->pack_plan) return -1;
  if (idx < 0 || idx >= (int)h->ctx.frames.size()) return -1;
  uint8_t* bufs[5] = {buf_i1, buf_u1, buf_i2, buf_i4, buf_b1};
  const PackPlan& pp = *h->pack_plan;
  PackCtx ctx(pp, *h->ctx.frames[idx], fids, slots, nfids);
  for (const PackKeyDesc& kd : pp.keys) {
    if (kd.dt_slot < 0 || kd.dt_slot > 4 || !bufs[kd.dt_slot]) return -4;
    uint8_t* dst = bufs[kd.dt_slot] +
        (kd.off + (int64_t)batch_index * kd.sz) * PK_ESIZE[kd.dt_slot];
    int r = pack_one_key(ctx, kd, dst);
    if (r) return r;
  }
  return 0;
}

// pred-weight table for slice si: luma_denom, chroma_denom then per list(2) x
// ref(16): lw, lo, cw0, co0, cw1, co1 -> 2 + 2*16*6 ints
int fe_get_pred_weights(FEHandle* h, int idx, int si, int32_t* out) {
  Frame& f = *h->ctx.frames[idx];
  const SliceHeader& s = f.slices[si];
  out[0] = s.pw.luma_denom; out[1] = s.pw.chroma_denom;
  int32_t* o = out + 2;
  for (int l = 0; l < 2; l++)
    for (int r = 0; r < 16; r++) {
      *o++ = s.pw.lw[l][r]; *o++ = s.pw.lo[l][r];
      *o++ = s.pw.cw[l][r][0]; *o++ = s.pw.co[l][r][0];
      *o++ = s.pw.cw[l][r][1]; *o++ = s.pw.co[l][r][1];
    }
  return 0;
}

}  // extern "C"
