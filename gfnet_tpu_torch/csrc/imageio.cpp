// Image decoding for the port's dataset path: JPEG (baseline, extended
// sequential and progressive Huffman, 8-bit, 1 or 3 components) and the
// row filters of PNG. Host C++ with a plain C interface, loaded by
// `gfnet_tpu_torch/data/imageio.py` with ctypes.
//
// The JPEG arithmetic is libjpeg's defaults, which PIL's libjpeg-turbo
// uses: the accurate integer IDCT ("islow", jidctint.c), "fancy"
// triangular chroma upsampling (jdsample.c: h2v1, h1v2, h2v2 with edge
// rows and columns replicated), fixed-point YCbCr -> RGB (jdcolor.c,
// 16 fractional bits), and the IDCT's range-limit table (jdmaster.c).
// Every step is integer arithmetic, so the pixels equal PIL's bit for bit.
//
// Refused, with the mode in the message: arithmetic coding, 12-bit
// samples, lossless and hierarchical frames, 2 or 4 components.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Error{msg}; }

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63,
    // overrun guard for corrupt runs (libjpeg's jpeg_natural_order extra entries)
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ------------------------------------------------------------- Huffman
struct Huffman {
  bool defined = false;
  uint16_t fast[1 << 9];   // (length << 8) | value for codes of <= 9 bits, else 0
  int32_t maxcode[18];     // largest code of each length, -1 if none
  int32_t valoff[17];      // index into vals of a length's first code, minus that code
  uint8_t vals[256];

  void build(const uint8_t* counts, const uint8_t* values, int nvals) {
    memset(fast, 0, sizeof(fast));
    memcpy(vals, values, nvals);
    int code = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
      valoff[len] = k - code;
      for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
        if (len <= 9) {
          int shift = 9 - len;
          for (int j = 0; j < (1 << shift); ++j)
            fast[(code << shift) | j] = (uint16_t)((len << 8) | values[k]);
        }
      }
      maxcode[len] = counts[len - 1] ? code - 1 : -1;
      if (code > (1 << len)) fail("bad Huffman table");
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
  }
};

// ------------------------------------------------------------ bit reader
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int cnt = 0;
  bool marker = false;  // stopped at a marker: zeros are fed from here on

  void fill() {
    while (cnt <= 56) {
      uint32_t b = 0;
      if (!marker && p < end) {
        b = *p;
        if (b == 0xFF) {
          uint32_t b2 = p + 1 < end ? p[1] : 0xD9;
          if (b2 == 0) {
            p += 2;
          } else {
            marker = true;
            b = 0;
          }
        } else {
          ++p;
        }
      }
      buf |= (uint64_t)b << (56 - cnt);
      cnt += 8;
    }
  }
  int bits(int n) {  // n in 1..16
    if (cnt < n) fill();
    int v = (int)(buf >> (64 - n));
    buf <<= n;
    cnt -= n;
    return v;
  }
  int bit() { return bits(1); }
  int decode(const Huffman& h) {
    if (cnt < 16) fill();
    int look = (int)(buf >> (64 - 9));
    uint16_t f = h.fast[look];
    if (f) {
      int len = f >> 8;
      buf <<= len;
      cnt -= len;
      return f & 0xFF;
    }
    int len = 10;
    int code = (int)(buf >> (64 - len));
    while (code > h.maxcode[len]) {
      ++len;
      if (len > 16) fail("corrupt Huffman code");
      code = (int)(buf >> (64 - len));
    }
    buf <<= len;
    cnt -= len;
    return h.vals[(h.valoff[len] + code) & 0xFF];
  }
  // Drop the bits left in the buffer and step over the RSTn marker.
  void restart() {
    buf = 0;
    cnt = 0;
    if (!marker) {
      while (p + 1 < end && !(p[0] == 0xFF && p[1] != 0 && p[1] != 0xFF)) ++p;
    }
    if (p + 1 < end && p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7) p += 2;
    marker = false;
  }
};

inline int extend(int v, int t) { return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v; }

// ------------------------------------------------------------- decoder
struct Component {
  int id, h, v, tq;
  int td = 0, ta = 0;
  int bw, bh;        // blocks stored (the MCU grid's, padded)
  int cw, ch;        // downsampled width and height (libjpeg's)
  int dc_pred = 0;
  std::vector<int16_t> coef;  // bw * bh blocks of 64, zigzag undone
  std::vector<uint8_t> plane; // (bh * 8) x (bw * 8) after the IDCT
};

struct Jpeg {
  const uint8_t* data = nullptr;
  size_t size = 0;
  size_t pos = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  std::vector<Component> comps;
  int width = 0, height = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool progressive = false, frame = false;
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int eobrun = 0;

  int u8() {
    if (pos >= size) fail("unexpected end of file");
    return data[pos++];
  }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }

  void read_sof(int marker) {
    int len = u16();
    size_t start = pos;
    int precision = u8();
    if (precision != 8)
      fail(std::to_string(precision) + "-bit samples (only 8-bit JPEG is decoded)");
    height = u16();
    width = u16();
    int n = u8();
    if (height == 0) fail("a height given by a DNL marker (not decoded)");
    if (width == 0) fail("zero width");
    if (n == 4) fail("4 components (CMYK/YCCK JPEG is not decoded)");
    if (n != 1 && n != 3) fail(std::to_string(n) + " components (only 1 or 3 are decoded)");
    comps.resize(n);
    for (auto& c : comps) {
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) fail("bad frame header");
      hmax = c.h > hmax ? c.h : hmax;
      vmax = c.v > vmax ? c.v : vmax;
    }
    pos = start + len - 2;
    progressive = marker == 0xC2;
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      if (hmax % c.h || vmax % c.v) fail("sampling factors that are not integral ratios");
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.cw = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
      c.ch = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    }
    frame = true;
  }

  void read_dht() {
    int len = u16();
    size_t end = pos + len - 2;
    while (pos < end) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("bad Huffman table id");
      uint8_t counts[16], values[256];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i] = (uint8_t)u8();
      if (total > 256) fail("bad Huffman table");
      for (int i = 0; i < total; ++i) values[i] = (uint8_t)u8();
      (tc == 0 ? dc[th] : ac[th]).build(counts, values, total);
    }
    pos = end;
  }

  void read_dqt() {
    int len = u16();
    size_t end = pos + len - 2;
    while (pos < end) {
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3) fail("bad quantization table id");
      for (int i = 0; i < 64; ++i) qt[tq][kNatural[i]] = (uint16_t)(pq ? u16() : u8());
      qt_defined[tq] = true;
    }
    pos = end;
  }

  void read_app(int marker) {
    int len = u16();
    size_t end = pos + len - 2;
    if (end > size) fail("unexpected end of file");
    const uint8_t* d = data + pos;
    int n = len - 2;
    if (marker == 0xE0 && n >= 5 && !memcmp(d, "JFIF\0", 5)) jfif = true;
    if (marker == 0xEE && n >= 12 && !memcmp(d, "Adobe", 5)) {
      adobe = true;
      adobe_transform = d[11];
    }
    pos = end;
  }

  void decode_block_baseline(BitReader& br, Component& c, int16_t* blk) {
    int t = br.decode(dc[c.td]);
    int diff = t ? extend(br.bits(t), t) : 0;
    c.dc_pred += diff;
    blk[0] = (int16_t)c.dc_pred;
    const Huffman& h = ac[c.ta];
    for (int k = 1; k < 64; ++k) {
      int rs = br.decode(h);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail("corrupt AC run");
        blk[kNatural[k]] = (int16_t)extend(br.bits(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void decode_dc_first(BitReader& br, Component& c, int16_t* blk, int al) {
    int t = br.decode(dc[c.td]);
    int diff = t ? extend(br.bits(t), t) : 0;
    c.dc_pred += diff;
    blk[0] = (int16_t)(c.dc_pred * (1 << al));
  }

  void decode_ac_first(BitReader& br, Component& c, int16_t* blk, int ss, int se, int al) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    const Huffman& h = ac[c.ta];
    for (int k = ss; k <= se; ++k) {
      int rs = br.decode(h);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail("corrupt AC run");
        blk[kNatural[k]] = (int16_t)(extend(br.bits(s), s) * (1 << al));
      } else {
        if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          --eobrun;
          break;
        }
      }
    }
  }

  void decode_ac_refine(BitReader& br, Component& c, int16_t* blk, int ss, int se, int al) {
    int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    const Huffman& h = ac[c.ta];
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = br.decode(h);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) fail("corrupt AC refinement");
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (br.bit() && (*coef & p1) == 0) *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
          } else {
            if (--r < 0) break;
          }
          ++k;
        } while (k <= se);
        if (s && k <= 63) blk[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0 && br.bit() && (*coef & p1) == 0)
          *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
      }
      --eobrun;
    }
  }

  void read_sos() {
    if (!frame) fail("scan before frame header");
    int len = u16();
    size_t start = pos;
    int ns = u8();
    if (ns < 1 || ns > 4) fail("bad scan header");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      int id = u8(), tdta = u8();
      Component* found = nullptr;
      for (auto& c : comps)
        if (c.id == id) found = &c;
      if (!found) fail("scan names an unknown component");
      found->td = tdta >> 4;
      found->ta = tdta & 15;
      if (found->td > 3 || found->ta > 3) fail("bad Huffman table id");
      sc.push_back(found);
    }
    int ss = u8(), se = u8(), ahal = u8();
    int ah = ahal >> 4, al = ahal & 15;
    pos = start + len - 2;
    if (progressive) {
      if (ss == 0 && se != 0) fail("bad progressive scan");
      if (ss > 0 && (se < ss || se > 63 || ns != 1)) fail("bad progressive scan");
    } else {
      ss = 0;
      se = 63;
      ah = al = 0;
    }
    for (auto* c : sc) {
      c->dc_pred = 0;
      if ((!progressive || (ss == 0 && ah == 0)) && !dc[c->td].defined) fail("scan uses an undefined DC table");
      if ((!progressive || ss > 0) && !ac[c->ta].defined) fail("scan uses an undefined AC table");
    }
    eobrun = 0;
    BitReader br{data + pos, data + size};

    auto block = [&](Component& c, int bx, int by) {
      int16_t* blk = c.coef.data() + ((size_t)by * c.bw + bx) * 64;
      if (!progressive) {
        decode_block_baseline(br, c, blk);
      } else if (ss == 0) {
        if (ah == 0)
          decode_dc_first(br, c, blk, al);
        else if (br.bit())
          blk[0] = (int16_t)(blk[0] | (1 << al));
      } else if (ah == 0) {
        decode_ac_first(br, c, blk, ss, se, al);
      } else {
        decode_ac_refine(br, c, blk, ss, se, al);
      }
    };
    auto do_restart = [&]() {
      br.restart();
      for (auto* c : sc) c->dc_pred = 0;
      eobrun = 0;
    };

    if (ns == 1) {  // non-interleaved: one block an MCU, the component's own grid
      Component& c = *sc[0];
      int nbx = (c.cw + 7) / 8, nby = (c.ch + 7) / 8;
      int todo = restart_interval;
      for (int by = 0; by < nby; ++by)
        for (int bx = 0; bx < nbx; ++bx) {
          if (restart_interval && todo == 0) {
            do_restart();
            todo = restart_interval;
          }
          block(c, bx, by);
          if (restart_interval) --todo;
        }
    } else {
      int todo = restart_interval;
      for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx) {
          if (restart_interval && todo == 0) {
            do_restart();
            todo = restart_interval;
          }
          for (auto* c : sc)
            for (int y = 0; y < c->v; ++y)
              for (int x = 0; x < c->h; ++x) block(*c, mx * c->h + x, my * c->v + y);
          if (restart_interval) --todo;
        }
    }
    // continue after the entropy-coded data: the next marker that is not RSTn
    const uint8_t* p = br.p;
    const uint8_t* end = data + size;
    while (p + 1 < end && !(p[0] == 0xFF && p[1] != 0 && p[1] != 0xFF && !(p[1] >= 0xD0 && p[1] <= 0xD7))) ++p;
    pos = (size_t)(p - data);
  }

  // Read the markers and decode every scan; with `header_only`, stop after
  // the frame header (the size and component count).
  void parse(bool header_only = false) {
    if (size < 4 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
    pos = 2;
    for (;;) {
      int b = u8();
      if (b != 0xFF) continue;  // garbage between markers, as libjpeg skips it
      int m = u8();
      while (m == 0xFF) m = u8();
      if (m == 0xD9) break;  // EOI
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
          if (frame) fail("a second frame header");
          read_sof(m);
          if (header_only) return;
          break;
        case 0xC3: fail("lossless JPEG (SOF3) is not decoded");
        case 0xC5: case 0xC6: case 0xC7: fail("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) + ") is not decoded");
        case 0xC9: case 0xCA: fail("arithmetic-coded JPEG (SOF" + std::to_string(m - 0xC0) + ") is not decoded");
        case 0xCB: fail("lossless arithmetic-coded JPEG (SOF11) is not decoded");
        case 0xCD: case 0xCE: case 0xCF: fail("hierarchical arithmetic-coded JPEG (SOF" + std::to_string(m - 0xC0) + ") is not decoded");
        case 0xCC: fail("arithmetic-coded JPEG (DAC marker) is not decoded");
        case 0xC4: read_dht(); break;
        case 0xDB: read_dqt(); break;
        case 0xDD:
          if (u16() != 4) fail("bad DRI marker");
          restart_interval = u16();
          break;
        case 0xDA:
          read_sos();
          break;
        case 0x01:
        case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5: case 0xD6: case 0xD7:
          break;
        default:
          if (m >= 0xE0 && m <= 0xEF) {
            read_app(m);
          } else {  // COM, DNL, DHP, EXP, JPGn: skip the segment
            int len = u16();
            pos += len - 2;
          }
      }
      if (pos >= size) break;  // a file cut before EOI keeps what it decoded
    }
    if (!frame) fail("no frame header");
  }

  // ---------------------------------------------------- islow IDCT
  static uint8_t range_limit(int x) {
    // jdmaster.c's post-IDCT table, indexed by x & 1023 around CENTERJSAMPLE
    int i = x & 1023;
    if (i < 128) return (uint8_t)(i + 128);
    if (i < 512) return 255;
    if (i < 896) return 0;
    return (uint8_t)(i - 896);
  }

  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;
    const int CB = 13, P1 = 2;
    int ws[64];
    for (int c = 0; c < 8; ++c) {
      const int16_t* ip = in + c;
      const uint16_t* qp = q + c;
      int* wp = ws + c;
      if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
        int dcval = (ip[0] * qp[0]) * (1 << P1);
        for (int r = 0; r < 8; ++r) wp[8 * r] = dcval;
        continue;
      }
      int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      z2 = ip[0] * qp[0];
      z3 = ip[32] * qp[32];
      int64_t tmp0 = (z2 + z3) * (1 << CB);
      int64_t tmp1 = (z2 - z3) * (1 << CB);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = ip[56] * qp[56];
      tmp1 = ip[40] * qp[40];
      tmp2 = ip[24] * qp[24];
      tmp3 = ip[8] * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = CB - P1;
      const int64_t rnd = (int64_t)1 << (sh - 1);
      wp[0] = (int)((tmp10 + tmp3 + rnd) >> sh);
      wp[56] = (int)((tmp10 - tmp3 + rnd) >> sh);
      wp[8] = (int)((tmp11 + tmp2 + rnd) >> sh);
      wp[48] = (int)((tmp11 - tmp2 + rnd) >> sh);
      wp[16] = (int)((tmp12 + tmp1 + rnd) >> sh);
      wp[40] = (int)((tmp12 - tmp1 + rnd) >> sh);
      wp[24] = (int)((tmp13 + tmp0 + rnd) >> sh);
      wp[32] = (int)((tmp13 - tmp0 + rnd) >> sh);
    }
    for (int r = 0; r < 8; ++r) {
      const int* wp = ws + 8 * r;
      uint8_t* op = out + (size_t)r * stride;
      if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
        uint8_t v = range_limit((int)(((int64_t)wp[0] + (1 << (P1 + 2))) >> (P1 + 3)));
        for (int c = 0; c < 8; ++c) op[c] = v;
        continue;
      }
      int64_t z2 = wp[2], z3 = wp[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << CB);
      int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << CB);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = wp[7];
      tmp1 = wp[5];
      tmp2 = wp[3];
      tmp3 = wp[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = CB + P1 + 3;
      const int64_t rnd = (int64_t)1 << (sh - 1);
      op[0] = range_limit((int)((tmp10 + tmp3 + rnd) >> sh));
      op[7] = range_limit((int)((tmp10 - tmp3 + rnd) >> sh));
      op[1] = range_limit((int)((tmp11 + tmp2 + rnd) >> sh));
      op[6] = range_limit((int)((tmp11 - tmp2 + rnd) >> sh));
      op[2] = range_limit((int)((tmp12 + tmp1 + rnd) >> sh));
      op[5] = range_limit((int)((tmp12 - tmp1 + rnd) >> sh));
      op[3] = range_limit((int)((tmp13 + tmp0 + rnd) >> sh));
      op[4] = range_limit((int)((tmp13 - tmp0 + rnd) >> sh));
    }
  }

  void idct_all() {
    for (auto& c : comps) {
      if (!qt_defined[c.tq]) fail("component uses an undefined quantization table");
      int stride = c.bw * 8;
      c.plane.assign((size_t)stride * c.bh * 8, 0);
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct_islow(c.coef.data() + ((size_t)by * c.bw + bx) * 64, qt[c.tq],
                     c.plane.data() + (size_t)by * 8 * stride + bx * 8, stride);
      std::vector<int16_t>().swap(c.coef);
    }
  }

  // ------------------------------------------------- upsampling
  // The component at full size (width x height), as libjpeg's upsampler
  // gives it: fancy h2v1 / h1v2 / h2v2 where those apply, else a box.
  std::vector<uint8_t> upsample(const Component& c) const {
    int rh = hmax / c.h, rv = vmax / c.v;
    int stride = c.bw * 8;
    const uint8_t* in = c.plane.data();
    std::vector<uint8_t> out((size_t)width * height);
    auto row = [&](int y) {  // rows outside [0, ch) replicate the edge rows
      y = y < 0 ? 0 : (y >= c.ch ? c.ch - 1 : y);
      return in + (size_t)y * stride;
    };
    if (rh == 1 && rv == 1) {
      for (int y = 0; y < height; ++y) memcpy(&out[(size_t)y * width], row(y), width);
      return out;
    }
    bool fancy_h = rh == 2 && c.cw > 2;
    if (rh == 2 && rv == 1 && fancy_h) {  // h2v1_fancy_upsample
      std::vector<uint8_t> line(2 * (size_t)c.cw);
      for (int y = 0; y < height; ++y) {
        const uint8_t* ip = row(y);
        uint8_t* op = line.data();
        int n = c.cw;
        op[0] = ip[0];
        op[1] = (uint8_t)((ip[0] * 3 + ip[1] + 2) >> 2);
        for (int x = 1; x < n - 1; ++x) {
          int v = ip[x] * 3;
          op[2 * x] = (uint8_t)((v + ip[x - 1] + 1) >> 2);
          op[2 * x + 1] = (uint8_t)((v + ip[x + 1] + 2) >> 2);
        }
        op[2 * n - 2] = (uint8_t)((ip[n - 1] * 3 + ip[n - 2] + 1) >> 2);
        op[2 * n - 1] = ip[n - 1];
        memcpy(&out[(size_t)y * width], line.data(), width);
      }
      return out;
    }
    if (rh == 1 && rv == 2) {  // h1v2_fancy_upsample
      for (int y = 0; y < height; ++y) {
        int iy = y >> 1;
        bool below = y & 1;
        const uint8_t* i0 = row(iy);
        const uint8_t* i1 = row(below ? iy + 1 : iy - 1);
        int bias = below ? 2 : 1;
        uint8_t* op = &out[(size_t)y * width];
        for (int x = 0; x < width; ++x) op[x] = (uint8_t)((i0[x] * 3 + i1[x] + bias) >> 2);
      }
      return out;
    }
    if (rh == 2 && rv == 2 && fancy_h) {  // h2v2_fancy_upsample
      std::vector<uint8_t> line(2 * (size_t)c.cw);
      int n = c.cw;
      for (int y = 0; y < height; ++y) {
        int iy = y >> 1;
        const uint8_t* i0 = row(iy);
        const uint8_t* i1 = row((y & 1) ? iy + 1 : iy - 1);
        uint8_t* op = line.data();
        int thiscol = i0[0] * 3 + i1[0];
        int nextcol = i0[1] * 3 + i1[1];
        op[0] = (uint8_t)((thiscol * 4 + 8) >> 4);
        op[1] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
        int lastcol = thiscol;
        thiscol = nextcol;
        for (int x = 1; x < n - 1; ++x) {
          nextcol = i0[x + 1] * 3 + i1[x + 1];
          op[2 * x] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
          op[2 * x + 1] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
          lastcol = thiscol;
          thiscol = nextcol;
        }
        op[2 * n - 2] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
        op[2 * n - 1] = (uint8_t)((thiscol * 4 + 7) >> 4);
        memcpy(&out[(size_t)y * width], line.data(), width);
      }
      return out;
    }
    // box (int_upsample): each sample repeated rh x rv times
    for (int y = 0; y < height; ++y) {
      const uint8_t* ip = in + (size_t)(y / rv) * stride;
      uint8_t* op = &out[(size_t)y * width];
      for (int x = 0; x < width; ++x) op[x] = ip[x / rh];
    }
    return out;
  }

  bool is_rgb() const {
    // jdapimin.c default_decompress_parms: JFIF implies YCbCr, then Adobe's
    // transform flag, then the component ids 'R', 'G', 'B'
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66;
  }

  void output(uint8_t* out) {
    idct_all();
    if (comps.size() == 1) {
      std::vector<uint8_t> g = upsample(comps[0]);
      memcpy(out, g.data(), g.size());
      return;
    }
    std::vector<uint8_t> p0 = upsample(comps[0]), p1 = upsample(comps[1]), p2 = upsample(comps[2]);
    size_t n = (size_t)width * height;
    if (is_rgb()) {
      for (size_t i = 0; i < n; ++i) {
        out[3 * i] = p0[i];
        out[3 * i + 1] = p1[i];
        out[3 * i + 2] = p2[i];
      }
      return;
    }
    // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert
    const int SB = 16;
    const int64_t HALF = (int64_t)1 << (SB - 1);
    auto fix = [](double x) { return (int64_t)(x * (1L << 16) + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + HALF) >> SB);
      cb_b[i] = (int)((fix(1.77200) * x + HALF) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + HALF;
    }
    auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    for (size_t i = 0; i < n; ++i) {
      int y = p0[i], cb = p1[i], cr = p2[i];
      out[3 * i] = clamp(y + cr_r[cr]);
      out[3 * i + 1] = clamp(y + (int)((cb_g[cb] + cr_g[cr]) >> SB));
      out[3 * i + 2] = clamp(y + cb_b[cb]);
    }
  }
};

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) snprintf(err, (size_t)errlen, "%s", msg.c_str());
}

}  // namespace

extern "C" {

// Width, height and component count (1 or 3) of a JPEG; 0 on success.
int gfnet_jpeg_info(const uint8_t* data, int64_t size, int* width, int* height, int* comps,
                    char* err, int errlen) {
  try {
    Jpeg j;
    j.data = data;
    j.size = (size_t)size;
    j.parse(true);
    *width = j.width;
    *height = j.height;
    *comps = (int)j.comps.size();
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return 1;
}

// Decode into `out`: height x width x comps bytes (gray, or RGB); 0 on success.
int gfnet_jpeg_decode(const uint8_t* data, int64_t size, uint8_t* out, int64_t out_size,
                      char* err, int errlen) {
  try {
    Jpeg j;
    j.data = data;
    j.size = (size_t)size;
    j.parse();
    if ((int64_t)j.width * j.height * (int64_t)j.comps.size() != out_size) fail("output buffer size");
    j.output(out);
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  }
  return 1;
}

// Undo PNG's row filters (None, Sub, Up, Average, Paeth): `raw` holds
// `height` rows of a filter byte and `row_bytes` bytes; `out` receives the
// rows without their filter bytes. `bpp`: bytes per pixel, at least 1.
int gfnet_png_unfilter(const uint8_t* raw, int64_t raw_size, int height, int64_t row_bytes,
                       int bpp, uint8_t* out, char* err, int errlen) {
  if (raw_size < (int64_t)height * (row_bytes + 1)) {
    set_error(err, errlen, "image data is shorter than the header says");
    return 1;
  }
  const uint8_t* prev = nullptr;
  for (int y = 0; y < height; ++y) {
    const uint8_t* in = raw + (int64_t)y * (row_bytes + 1);
    int f = in[0];
    ++in;
    uint8_t* o = out + (int64_t)y * row_bytes;
    switch (f) {
      case 0:
        memcpy(o, in, (size_t)row_bytes);
        break;
      case 1:
        for (int64_t x = 0; x < row_bytes; ++x) o[x] = (uint8_t)(in[x] + (x >= bpp ? o[x - bpp] : 0));
        break;
      case 2:
        for (int64_t x = 0; x < row_bytes; ++x) o[x] = (uint8_t)(in[x] + (prev ? prev[x] : 0));
        break;
      case 3:
        for (int64_t x = 0; x < row_bytes; ++x) {
          int a = x >= bpp ? o[x - bpp] : 0, b = prev ? prev[x] : 0;
          o[x] = (uint8_t)(in[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t x = 0; x < row_bytes; ++x) {
          int a = x >= bpp ? o[x - bpp] : 0, b = prev ? prev[x] : 0;
          int c = (x >= bpp && prev) ? prev[x - bpp] : 0;
          int p = a + b - c;
          int pa = p > a ? p - a : a - p, pb = p > b ? p - b : b - p, pc = p > c ? p - c : c - p;
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          o[x] = (uint8_t)(in[x] + pred);
        }
        break;
      default:
        set_error(err, errlen, "unknown PNG filter type " + std::to_string(f) + " in row " + std::to_string(y));
        return 1;
    }
    prev = o;
  }
  return 0;
}

}  // extern "C"
