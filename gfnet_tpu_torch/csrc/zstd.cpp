// Zstandard decompression (RFC 8878) and CRC-32C for the port's reader of
// Orbax checkpoints (`gfnet_tpu_torch/utils/orbax.py`). Host C++ with a
// plain C interface, loaded with ctypes.
//
// What a frame may hold: single-segment or windowed frames, raw, RLE and
// compressed blocks; literals raw, RLE or Huffman-coded in one or four
// streams (the table sent directly or FSE-compressed, or reused by a
// treeless block); sequences with literal-length, match-length and offset
// codes in predefined, RLE, FSE-compressed and repeat modes; the three
// repeat offsets; skippable frames, frames back to back, and the XXH64
// content checksum, verified when the frame carries it. A frame that needs
// a dictionary is refused.
//
// Every read is bounds-checked and every write stays inside the caller's
// buffer: a checkpoint is a file from elsewhere. A truncated, corrupt or
// oversized input returns an error with the byte offset where it was met.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>

namespace {

struct Error {
  std::string msg;
  size_t offset;
  bool capacity;  // the output did not fit: the caller may retry with more room
};

// ------------------------------------------------------------ CRC-32C
struct Crc32cTable {
  uint32_t t[8][256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      t[0][i] = c;
    }
    for (int s = 1; s < 8; ++s)
      for (int i = 0; i < 256; ++i) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xff];
  }
};

const Crc32cTable& crc_table() {
  static const Crc32cTable table;
  return table;
}

uint32_t crc32c(const uint8_t* p, size_t n, uint32_t crc) {
  const auto& t = crc_table().t;
  crc = ~crc;
  while (n >= 8) {  // slicing by 8
    uint32_t lo, hi;
    memcpy(&lo, p, 4);
    memcpy(&hi, p + 4, 4);
    lo ^= crc;
    crc = t[7][lo & 0xff] ^ t[6][(lo >> 8) & 0xff] ^ t[5][(lo >> 16) & 0xff] ^ t[4][lo >> 24] ^
          t[3][hi & 0xff] ^ t[2][(hi >> 8) & 0xff] ^ t[1][(hi >> 16) & 0xff] ^ t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ t[0][(crc ^ *p++) & 0xff];
  return ~crc;
}

// ------------------------------------------------------------ XXH64
const uint64_t P1 = 0x9E3779B185EBCA87ull, P2 = 0xC2B2AE3D27D4EB4Full, P3 = 0x165667B19E3779F9ull,
               P4 = 0x85EBCA77C2B2AE63ull, P5 = 0x27D4EB2F165667C5ull;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}
inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}
inline uint64_t xxround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xxmerge(uint64_t acc, uint64_t v) { return (acc ^ xxround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    while (end - p >= 32) {
      v1 = xxround(v1, rd64(p));
      v2 = xxround(v2, rd64(p + 8));
      v3 = xxround(v3, rd64(p + 16));
      v4 = xxround(v4, rd64(p + 24));
      p += 32;
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxmerge(h, v1);
    h = xxmerge(h, v2);
    h = xxmerge(h, v3);
    h = xxmerge(h, v4);
  } else {
    h = P5;
  }
  h += (uint64_t)n;
  while (end - p >= 8) {
    h ^= xxround(0, rd64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (end - p >= 4) {
    h ^= (uint64_t)rd32(p) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (uint64_t)(*p++) * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ------------------------------------------------------------ helpers
inline int highbit(uint32_t v) {  // index of the highest set bit, v > 0
  return 31 - __builtin_clz(v);
}

// Bits read from the end of a slice towards its start (RFC 8878 §4.1): the
// last byte holds a 1 above the last bit of the stream. Reads before the
// start of the slice give zeros; the callers check where the stream ended.
struct BackBits {
  const uint8_t* p = nullptr;
  size_t n = 0;
  int64_t off = 0;  // bit offset of the next read's top
  size_t at = 0;    // the slice's offset in the input, for errors

  void init(const uint8_t* src, size_t len, size_t where) {
    p = src;
    n = len;
    at = where;
    if (len == 0) throw Error{"empty bitstream", where, false};
    uint8_t last = src[len - 1];
    if (last == 0) throw Error{"bitstream without its end mark", where + len - 1, false};
    off = (int64_t)len * 8 - 8 + highbit(last);
  }
  // bits [pos, pos + nb) of the slice, little-endian; nb <= 56, pos >= 0
  inline uint64_t window(int64_t pos, int nb) const {
    size_t byte = (size_t)(pos >> 3);
    uint64_t v;
    if (byte + 8 <= n) {
      memcpy(&v, p + byte, 8);
    } else {
      v = 0;
      for (size_t i = 0; byte + i < n && i < 8; ++i) v |= (uint64_t)p[byte + i] << (8 * i);
    }
    v >>= (pos & 7);
    return nb == 64 ? v : v & ((1ull << nb) - 1);
  }
  inline uint64_t read(int nb) {
    if (nb == 0) return 0;
    off -= nb;
    if (off >= 0) return window(off, nb);
    int have = nb + (int)off;  // bits above the start
    if (have <= 0) return 0;
    return window(0, have) << (-off);
  }
};

// Bits read forward, least significant first (FSE table descriptions).
struct FwdBits {
  const uint8_t* p;
  size_t n;
  size_t bit = 0;
  size_t at;
  uint32_t read(int nb) {
    uint32_t v = 0;
    for (int i = 0; i < nb; ++i, ++bit) {
      size_t byte = bit >> 3;
      if (byte >= n) throw Error{"FSE table description runs past its section", at + n, false};
      v |= (uint32_t)((p[byte] >> (bit & 7)) & 1) << i;
    }
    return v;
  }
  size_t bytes_used() const { return (bit + 7) >> 3; }
};

// ------------------------------------------------------------ FSE
struct Fse {
  int log = 0;
  bool valid = false;
  uint8_t sym[512];
  uint8_t nbits[512];
  uint16_t base[512];

  void build(const int16_t* norm, int nsym, int acc_log, size_t at) {
    int size = 1 << acc_log;
    uint16_t next[256];
    int high = size;
    for (int s = 0; s < nsym; ++s)
      if (norm[s] == -1) {
        sym[--high] = (uint8_t)s;
        next[s] = 1;
      }
    int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
    for (int s = 0; s < nsym; ++s) {
      if (norm[s] <= 0) continue;
      next[s] = (uint16_t)norm[s];
      for (int i = 0; i < norm[s]; ++i) {
        sym[pos] = (uint8_t)s;
        do pos = (pos + step) & mask;
        while (pos >= high);
      }
    }
    if (pos != 0) throw Error{"FSE distribution does not fill its table", at, false};
    for (int i = 0; i < size; ++i) {
      uint16_t d = next[sym[i]]++;
      nbits[i] = (uint8_t)(acc_log - highbit(d));
      base[i] = (uint16_t)((d << nbits[i]) - size);
    }
    log = acc_log;
    valid = true;
  }
  void rle(uint8_t s) {
    log = 0;
    sym[0] = s;
    nbits[0] = 0;
    base[0] = 0;
    valid = true;
  }
  // the table description at src (forward bits) → bytes it took
  size_t read(const uint8_t* src, size_t len, int max_log, int max_sym, size_t at) {
    FwdBits in{src, len, 0, at};
    int acc_log = 5 + (int)in.read(4);
    if (acc_log > max_log) throw Error{"FSE accuracy log too large", at, false};
    int remaining = 1 << acc_log;
    int16_t norm[256];
    int s = 0;
    while (remaining > 0) {
      if (s > max_sym) throw Error{"FSE distribution has too many symbols", at + in.bytes_used(), false};
      int nb = highbit((uint32_t)remaining + 1) + 1;
      uint32_t val = in.read(nb);
      uint32_t lower = (1u << (nb - 1)) - 1;
      uint32_t threshold = (1u << nb) - 1 - ((uint32_t)remaining + 1);
      if ((val & lower) < threshold) {
        in.bit -= 1;
        val &= lower;
      } else if (val > lower) {
        val -= threshold;
      }
      int proba = (int)val - 1;
      remaining -= proba < 0 ? -proba : proba;
      norm[s++] = (int16_t)proba;
      if (proba == 0) {
        for (;;) {
          int rep = (int)in.read(2);
          for (int i = 0; i < rep; ++i) {
            if (s > max_sym) throw Error{"FSE zero run past the last symbol", at + in.bytes_used(), false};
            norm[s++] = 0;
          }
          if (rep != 3) break;
        }
      }
    }
    if (remaining != 0) throw Error{"FSE distribution overshoots its total", at + in.bytes_used(), false};
    build(norm, s, acc_log, at);
    return in.bytes_used();
  }
};

struct FseState {
  const Fse* t;
  uint32_t state;
  void init(const Fse& table, BackBits& bits) {
    t = &table;
    state = (uint32_t)bits.read(table.log);
  }
  inline uint8_t peek() const { return t->sym[state]; }
  inline void update(BackBits& bits) { state = t->base[state] + (uint32_t)bits.read(t->nbits[state]); }
};

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {0,  1,  2,  3,  4,  5,  6,   7,   8,   9,   10,   11,
                              12, 13, 14, 15, 16, 18, 20,  22,  24,  28,  32,   40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,  13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24,  25,  26,  27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41,  43,  47,  51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// ------------------------------------------------------------ Huffman
const int kHufMaxBits = 11;

struct Huffman {
  int max_bits = 0;
  bool valid = false;
  uint8_t sym[1 << kHufMaxBits];
  uint8_t nbits[1 << kHufMaxBits];

  // the tree description at src → bytes it took
  size_t read(const uint8_t* src, size_t len, size_t at) {
    if (len < 1) throw Error{"Huffman tree description missing", at, false};
    uint8_t weights[256];
    int nw = 0;
    size_t used;
    uint8_t header = src[0];
    if (header >= 128) {  // weights sent directly, 4 bits each
      nw = header - 127;
      used = 1 + (size_t)(nw + 1) / 2;
      if (used > len) throw Error{"Huffman weights run past the literals section", at, false};
      for (int i = 0; i < nw; ++i) {
        uint8_t b = src[1 + i / 2];
        weights[i] = (i % 2 == 0) ? b >> 4 : b & 15;
      }
    } else {  // FSE-compressed weights
      size_t csize = header;
      used = 1 + csize;
      if (used > len || csize == 0) throw Error{"Huffman weights run past the literals section", at, false};
      Fse fse;
      size_t tbl = fse.read(src + 1, csize, 6, 15, at + 1);
      if (tbl >= csize) throw Error{"Huffman weights stream missing", at + 1, false};
      BackBits bits;
      bits.init(src + 1 + tbl, csize - tbl, at + 1 + tbl);
      FseState s1, s2;
      s1.init(fse, bits);
      s2.init(fse, bits);
      auto push = [&](uint8_t w) {
        if (nw >= 255) throw Error{"too many Huffman weights", at, false};
        weights[nw++] = w;
      };
      for (;;) {
        push(s1.peek());
        s1.update(bits);
        if (bits.off < 0) {
          push(s2.peek());
          break;
        }
        push(s2.peek());
        s2.update(bits);
        if (bits.off < 0) {
          push(s1.peek());
          break;
        }
      }
    }
    uint32_t total = 0;
    for (int i = 0; i < nw; ++i) {
      if (weights[i] > kHufMaxBits) throw Error{"Huffman weight too large", at, false};
      if (weights[i]) total += 1u << (weights[i] - 1);
    }
    if (total == 0) throw Error{"Huffman weights all zero", at, false};
    int mb = highbit(total) + 1;
    if (mb > kHufMaxBits) throw Error{"Huffman code longer than 11 bits", at, false};
    uint32_t rest = (1u << mb) - total;
    if (rest & (rest - 1)) throw Error{"Huffman weights do not sum to a power of two", at, false};
    weights[nw++] = (uint8_t)(highbit(rest) + 1);
    build(weights, nw, mb, at);
    return used;
  }

  void build(const uint8_t* w, int nsym, int mb, size_t at) {
    int count[kHufMaxBits + 2] = {0};
    uint8_t bits[256];
    for (int i = 0; i < nsym; ++i) {
      bits[i] = w[i] ? (uint8_t)(mb + 1 - w[i]) : 0;
      count[bits[i]]++;
    }
    int idx[kHufMaxBits + 2];
    idx[mb] = 0;
    for (int i = mb; i >= 1; --i) {
      idx[i - 1] = idx[i] + count[i] * (1 << (mb - i));
      if (idx[i - 1] > (1 << mb)) throw Error{"Huffman table overflows", at, false};
      memset(nbits + idx[i], i, idx[i - 1] - idx[i]);
    }
    if (idx[0] != (1 << mb)) throw Error{"Huffman table not full", at, false};
    for (int i = 0; i < nsym; ++i) {
      if (!bits[i]) continue;
      int len = 1 << (mb - bits[i]);
      memset(sym + idx[bits[i]], i, len);
      idx[bits[i]] += len;
    }
    max_bits = mb;
    valid = true;
  }

  void decode_stream(const uint8_t* src, size_t len, uint8_t* out, size_t nout, size_t at) const {
    BackBits bits;
    bits.init(src, len, at);
    uint32_t mask = (1u << max_bits) - 1;
    uint32_t state = (uint32_t)bits.read(max_bits);
    for (size_t i = 0; i < nout; ++i) {
      out[i] = sym[state];
      int nb = nbits[state];
      state = ((state << nb) | (uint32_t)bits.read(nb)) & mask;
    }
    if (bits.off != -max_bits) throw Error{"Huffman stream length does not match its symbols", at, false};
  }
};

// ------------------------------------------------------------ decoder
const size_t kBlockMax = 128 * 1024;
const uint32_t kMagic = 0xFD2FB528u;

struct Decoder {
  const uint8_t* src;
  size_t n;
  uint8_t* dst;
  size_t cap;
  size_t out = 0;

  // per frame
  size_t frame_start = 0;  // output offset where the frame began
  uint32_t rep[3];
  Huffman huf;
  Fse ll, of, ml;
  uint8_t lit[kBlockMax];

  [[noreturn]] void corrupt(const char* what, size_t at) { throw Error{what, at, false}; }
  void need(size_t at, size_t k) {
    if (at > n || n - at < k) throw Error{"input ends early", n, false};
  }
  void room(size_t k, size_t at) {
    if (cap - out < k) throw Error{"output larger than the buffer", at, true};
  }

  size_t run() {
    size_t pos = 0;
    if (n == 0) corrupt("empty input", 0);
    while (pos < n) {
      need(pos, 4);
      uint32_t magic = rd32(src + pos);
      if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable frame
        need(pos + 4, 4);
        uint32_t sz = rd32(src + pos + 4);
        need(pos + 8, sz);
        pos += 8 + (size_t)sz;
        continue;
      }
      if (magic != kMagic) corrupt("not a zstd frame (bad magic number)", pos);
      pos = frame(pos + 4);
    }
    return out;
  }

  size_t frame(size_t pos) {
    need(pos, 1);
    uint8_t fhd = src[pos++];
    int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1, dict_flag = fhd & 3;
    if (fhd & 8) corrupt("reserved bit set in the frame header", pos - 1);
    uint64_t window = 0;
    if (!single) {
      need(pos, 1);
      uint8_t wd = src[pos++];
      int exp = wd >> 3, mant = wd & 7;
      if (exp > 31 - 10) corrupt("window too large", pos - 1);
      uint64_t wbase = 1ull << (10 + exp);
      window = wbase + (wbase / 8) * mant;
    }
    static const int kDictBytes[4] = {0, 1, 2, 4};
    need(pos, kDictBytes[dict_flag]);
    uint32_t dict = 0;
    for (int i = 0; i < kDictBytes[dict_flag]; ++i) dict |= (uint32_t)src[pos + i] << (8 * i);
    if (dict != 0) corrupt("frame needs a dictionary, which this decoder does not take", pos);
    pos += kDictBytes[dict_flag];
    static const int kFcsBytes[4] = {0, 2, 4, 8};
    int fcs_bytes = (fcs_flag == 0 && single) ? 1 : kFcsBytes[fcs_flag];
    need(pos, fcs_bytes);
    uint64_t fcs = 0;
    bool has_fcs = fcs_bytes > 0;
    for (int i = 0; i < fcs_bytes; ++i) fcs |= (uint64_t)src[pos + i] << (8 * i);
    if (fcs_bytes == 2) fcs += 256;
    pos += fcs_bytes;
    (void)window;  // the whole frame stays in `dst`: matches reach back to the frame's start
    if (has_fcs && fcs > cap - out) throw Error{"output larger than the buffer", pos, true};
    const size_t block_max = kBlockMax;

    frame_start = out;
    rep[0] = 1;
    rep[1] = 4;
    rep[2] = 8;
    huf.valid = ll.valid = of.valid = ml.valid = false;
    for (;;) {
      need(pos, 3);
      uint32_t bh = src[pos] | (src[pos + 1] << 8) | (src[pos + 2] << 16);
      size_t bpos = pos;
      pos += 3;
      int last = bh & 1, type = (bh >> 1) & 3;
      size_t bsize = bh >> 3;
      if (type == 3) corrupt("reserved block type", bpos);
      if (type == 1) {  // RLE
        need(pos, 1);
        if (bsize > block_max) corrupt("block larger than the window allows", bpos);
        room(bsize, bpos);
        memset(dst + out, src[pos], bsize);
        out += bsize;
        pos += 1;
      } else {
        if (bsize > block_max) corrupt("block larger than the window allows", bpos);
        need(pos, bsize);
        if (type == 0) {
          room(bsize, bpos);
          memcpy(dst + out, src + pos, bsize);
          out += bsize;
        } else {
          block(pos, bsize, block_max);
        }
        pos += bsize;
      }
      if (last) break;
    }
    if (has_fcs && out - frame_start != fcs) corrupt("frame content size does not match its blocks", pos);
    if (checksum) {
      need(pos, 4);
      uint32_t want = rd32(src + pos);
      uint32_t got = (uint32_t)xxh64(dst + frame_start, out - frame_start);
      if (want != got) corrupt("content checksum mismatch", pos);
      pos += 4;
    }
    return pos;
  }

  // literals section → count of literals in `lit`, and bytes used
  size_t literals(size_t pos, size_t end, size_t* nlit) {
    if (pos >= end) corrupt("block without a literals section", pos);
    uint8_t b0 = src[pos];
    int type = b0 & 3, sf = (b0 >> 2) & 3;
    if (type <= 1) {  // raw or RLE
      size_t regen, hsize;
      if ((sf & 1) == 0) {
        regen = b0 >> 3;
        hsize = 1;
      } else if (sf == 1) {
        if (end - pos < 2) corrupt("literals header runs past its block", pos);
        regen = (b0 >> 4) + ((size_t)src[pos + 1] << 4);
        hsize = 2;
      } else {
        if (end - pos < 3) corrupt("literals header runs past its block", pos);
        regen = (b0 >> 4) + ((size_t)src[pos + 1] << 4) + ((size_t)src[pos + 2] << 12);
        hsize = 3;
      }
      if (regen > kBlockMax) corrupt("literals larger than a block", pos);
      if (type == 0) {
        if (end - pos - hsize < regen) corrupt("raw literals run past their block", pos);
        memcpy(lit, src + pos + hsize, regen);
        *nlit = regen;
        return hsize + regen;
      }
      if (end - pos - hsize < 1) corrupt("RLE literals run past their block", pos);
      memset(lit, src[pos + hsize], regen);
      *nlit = regen;
      return hsize + 1;
    }
    // Huffman-coded: compressed (2) or treeless (3)
    size_t hsize = sf <= 1 ? 3 : (sf == 2 ? 4 : 5);
    int streams = sf == 0 ? 1 : 4;
    if (end - pos < hsize) corrupt("literals header runs past its block", pos);
    uint64_t h = 0;
    for (size_t i = 0; i < hsize; ++i) h |= (uint64_t)src[pos + i] << (8 * i);
    int nb = sf <= 1 ? 10 : (sf == 2 ? 14 : 18);
    size_t regen = (size_t)((h >> 4) & ((1ull << nb) - 1));
    size_t csize = (size_t)((h >> (4 + nb)) & ((1ull << nb) - 1));
    if (regen > kBlockMax) corrupt("literals larger than a block", pos);
    size_t p = pos + hsize;
    if (end - p < csize) corrupt("compressed literals run past their block", pos);
    size_t cend = p + csize;
    if (type == 2) {
      p += huf.read(src + p, cend - p, p);
    } else if (!huf.valid) {
      corrupt("treeless literals without an earlier Huffman table", pos);
    }
    if (streams == 1) {
      huf.decode_stream(src + p, cend - p, lit, regen, p);
    } else {
      if (cend - p < 6) corrupt("Huffman jump table runs past the literals", p);
      size_t s1 = src[p] | (src[p + 1] << 8), s2 = src[p + 2] | (src[p + 3] << 8),
             s3 = src[p + 4] | (src[p + 5] << 8);
      p += 6;
      if (s1 + s2 + s3 > cend - p) corrupt("Huffman streams larger than the literals", p);
      size_t s4 = cend - p - s1 - s2 - s3;
      size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) corrupt("too few literals for four streams", pos);
      size_t sizes[4] = {s1, s2, s3, s4};
      size_t o = 0;
      for (int i = 0; i < 4; ++i) {
        size_t cnt = i < 3 ? seg : regen - 3 * seg;
        huf.decode_stream(src + p, sizes[i], lit + o, cnt, p);
        p += sizes[i];
        o += cnt;
      }
    }
    *nlit = regen;
    return cend - pos;
  }

  size_t table(Fse& t, int mode, size_t pos, size_t end, const int16_t* def, int ndef, int def_log,
               int max_log, int max_sym, const char* name) {
    if (mode == 0) {
      t.build(def, ndef, def_log, pos);
      return 0;
    }
    if (mode == 1) {
      if (pos >= end) corrupt("RLE symbol runs past its block", pos);
      if (src[pos] > max_sym) corrupt("RLE symbol out of range", pos);
      t.rle(src[pos]);
      return 1;
    }
    if (mode == 2) return t.read(src + pos, end - pos, max_log, max_sym, pos);
    if (!t.valid) {
      std::string msg = std::string("repeat mode without an earlier ") + name + " table";
      throw Error{msg, pos, false};
    }
    return 0;
  }

  void block(size_t pos, size_t bsize, size_t block_max) {
    size_t end = pos + bsize;
    size_t nlit = 0;
    size_t block_out = out;
    pos += literals(pos, end, &nlit);
    if (pos >= end) corrupt("block without a sequences section", pos);
    size_t nseq;
    uint8_t b0 = src[pos];
    if (b0 < 128) {
      nseq = b0;
      pos += 1;
    } else if (b0 < 255) {
      if (end - pos < 2) corrupt("sequence count runs past its block", pos);
      nseq = ((size_t)(b0 - 128) << 8) + src[pos + 1];
      pos += 2;
    } else {
      if (end - pos < 3) corrupt("sequence count runs past its block", pos);
      nseq = src[pos + 1] + ((size_t)src[pos + 2] << 8) + 0x7F00;
      pos += 3;
    }
    if (nseq == 0) {
      if (pos != end) corrupt("bytes after a block without sequences", pos);
      room(nlit, pos);
      memcpy(dst + out, lit, nlit);
      out += nlit;
      return;
    }
    if (pos >= end) corrupt("compression modes missing", pos);
    uint8_t modes = src[pos++];
    if (modes & 3) corrupt("reserved bits set in the compression modes", pos - 1);
    pos += table(ll, modes >> 6, pos, end, kLLDefault, 36, 6, 9, 35, "literal-length");
    pos += table(of, (modes >> 4) & 3, pos, end, kOFDefault, 29, 5, 8, 31, "offset");
    pos += table(ml, (modes >> 2) & 3, pos, end, kMLDefault, 53, 6, 9, 52, "match-length");
    if (pos >= end) corrupt("sequences bitstream missing", pos);
    BackBits bits;
    bits.init(src + pos, end - pos, pos);
    FseState sl, so, sm;
    sl.init(ll, bits);
    so.init(of, bits);
    sm.init(ml, bits);
    size_t lp = 0;
    for (size_t i = 0; i < nseq; ++i) {
      uint8_t oc = so.peek(), mc = sm.peek(), lc = sl.peek();
      if (oc > 31) corrupt("offset code out of range", pos);
      uint32_t ofv = (uint32_t)((1ull << oc) + bits.read(oc));
      size_t mlen = kMLBase[mc] + (size_t)bits.read(kMLBits[mc]);
      size_t llen = kLLBase[lc] + (size_t)bits.read(kLLBits[lc]);
      size_t offset;
      if (ofv > 3) {
        offset = ofv - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = (uint32_t)offset;
      } else {
        uint32_t idx = ofv - 1 + (llen == 0 ? 1 : 0);
        if (idx == 0) {
          offset = rep[0];
        } else {
          offset = idx < 3 ? rep[idx] : rep[0] - 1;
          if (idx > 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = (uint32_t)offset;
        }
      }
      if (i + 1 < nseq) {
        sl.update(bits);
        sm.update(bits);
        so.update(bits);
      }
      if (bits.off < 0) corrupt("sequences bitstream ends early", pos);
      // execute
      if (llen > nlit - lp) corrupt("sequence takes more literals than the block has", pos);
      room(llen + mlen, pos);
      memcpy(dst + out, lit + lp, llen);
      out += llen;
      lp += llen;
      if (offset == 0 || offset > out - frame_start) corrupt("match offset before the frame's start", pos);
      uint8_t* d = dst + out;
      const uint8_t* s = d - offset;
      if (offset >= mlen) {
        memcpy(d, s, mlen);
      } else {
        for (size_t k = 0; k < mlen; ++k) d[k] = s[k];
      }
      out += mlen;
    }
    if (bits.off != 0) corrupt("sequences bitstream not fully used", pos);
    room(nlit - lp, pos);
    memcpy(dst + out, lit + lp, nlit - lp);
    out += nlit - lp;
    if (out - block_out > block_max) corrupt("block decodes larger than its maximum", pos);
  }
};

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) snprintf(err, (size_t)errlen, "%s", msg.c_str());
}

}  // namespace

extern "C" {

// Decompress every frame of src[0, n) into dst[0, cap). Returns the bytes
// written; -1 on a corrupt or unsupported input, -2 when the output does
// not fit in `cap` (the message says where; the caller may grow `cap`).
int64_t gfnet_zstd_decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap, char* err,
                              int errlen) {
  Decoder* d = nullptr;
  try {
    if (n < 0 || cap < 0) throw Error{"negative size", 0, false};
    d = new Decoder();
    d->src = src;
    d->n = (size_t)n;
    d->dst = dst;
    d->cap = (size_t)cap;
    int64_t r = (int64_t)d->run();
    delete d;
    return r;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg + " at byte " + std::to_string(e.offset));
    delete d;
    return e.capacity ? -2 : -1;
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
    delete d;
    return -1;
  }
}

// Sum of the frames' content sizes as their headers declare them; -1 when
// a frame leaves it out, -2 when the input is not a sequence of frames.
int64_t gfnet_zstd_content_size(const uint8_t* src, int64_t n) {
  size_t pos = 0, len = (size_t)n;
  uint64_t total = 0;
  while (pos < len) {
    if (len - pos < 5) return -2;
    uint32_t magic = rd32(src + pos);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (len - pos < 8) return -2;
      uint32_t sz = rd32(src + pos + 4);
      if (len - pos - 8 < sz) return -2;
      pos += 8 + (size_t)sz;
      continue;
    }
    if (magic != kMagic) return -2;
    uint8_t fhd = src[pos + 4];
    int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, dict_flag = fhd & 3;
    static const int kDictBytes[4] = {0, 1, 2, 4};
    static const int kFcsBytes[4] = {0, 2, 4, 8};
    size_t p = pos + 5 + (single ? 0 : 1) + kDictBytes[dict_flag];
    int fcs_bytes = (fcs_flag == 0 && single) ? 1 : kFcsBytes[fcs_flag];
    if (fcs_bytes == 0) return -1;  // unknown: the caller grows its buffer
    if (p + fcs_bytes > len) return -2;
    uint64_t fcs = 0;
    for (int i = 0; i < fcs_bytes; ++i) fcs |= (uint64_t)src[p + i] << (8 * i);
    if (fcs_bytes == 2) fcs += 256;
    total += fcs;
    if (total > (1ull << 62)) return -2;
    // walk the blocks to the frame's end
    p += fcs_bytes;
    for (;;) {
      if (p + 3 > len) return -2;
      uint32_t bh = src[p] | (src[p + 1] << 8) | (src[p + 2] << 16);
      p += 3;
      size_t bsize = (bh >> 1 & 3) == 1 ? 1 : bh >> 3;
      if (len - p < bsize) return -2;
      p += bsize;
      if (bh & 1) break;
    }
    if (fhd & 4) p += 4;
    if (p > len) return -2;
    pos = p;
  }
  return (int64_t)total;
}

uint32_t gfnet_crc32c(const uint8_t* p, int64_t n, uint32_t crc) { return crc32c(p, (size_t)n, crc); }

}  // extern "C"
