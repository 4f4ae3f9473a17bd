// A Zstandard frame decoder (RFC 8878) and CRC32C, for reading the JAX
// package's Orbax checkpoints: OCDBT manifests and B-tree nodes are zstd
// frames with a CRC32C trailer, and zarr v2 chunks are zstd frames.
//
// Decodes any sequence of zstd and skippable frames: raw, RLE and
// compressed blocks; raw, RLE, Huffman and treeless literals with one or
// four streams and direct or FSE-compressed Huffman weights; predefined,
// RLE, FSE-compressed and repeat sequence tables; the three repeat
// offsets; matches that overlap their own output; the optional XXH64
// content checksum.  Dictionaries are refused.  Every malformed input
// raises an error that names the byte offset where it was found.
//
// Plain C interface, loaded with ctypes (which releases the GIL during the
// call):
//   gct_zstd_decompress(src, n, dst, cap, err, err_cap, err_off)
//       decodes into dst; returns the decoded size, or -1 with a message
//       in err and the offset in *err_off.
//   gct_zstd_decompress_alloc(src, n, &out, err, err_cap, err_off)
//       decodes into a buffer it allocates (free with gct_free).
//   gct_crc32c(data, n) -> CRC32C (Castagnoli) of the bytes.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__
#error "zstd_decode.cpp assumes a little-endian host"
#endif

namespace {

struct DecodeError {
  const char* msg;
  size_t offset;
};

[[noreturn]] void fail(const char* msg, size_t offset) {
  throw DecodeError{msg, offset};
}

inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline int high_bit(uint64_t v) { return 63 - __builtin_clzll(v); }

// ---------------------------------------------------------------------------
// bit readers
// ---------------------------------------------------------------------------

// A forward bit stream, least significant bit first (FSE table headers).
struct ForwardBits {
  const uint8_t* src;
  size_t n;       // bytes available
  size_t off;     // offset of src in the input, for errors
  uint64_t pos = 0;  // bits consumed

  uint32_t read(int k) {
    if (k == 0) return 0;
    if (pos + k > 8 * n) fail("FSE table header runs past its block", off + n);
    uint32_t v = 0;
    for (int i = 0; i < k; i++) {
      uint64_t b = pos + i;
      v |= uint32_t((src[b >> 3] >> (b & 7)) & 1) << i;
    }
    pos += k;
    return v;
  }
  size_t bytes() const { return (pos + 7) >> 3; }
};

// A backward bit stream (Huffman and FSE payloads): read from the last
// byte towards the first, most significant bits first, after the end
// marker (the highest set bit of the last byte).  Reading below the first
// byte yields zeros and leaves pos negative, which the callers test.
struct BackBits {
  const uint8_t* src;
  size_t n;
  int64_t pos;  // bits left to read

  BackBits(const uint8_t* s, size_t len, size_t off) : src(s), n(len) {
    if (len == 0) fail("empty bit stream", off);
    uint8_t last = s[len - 1];
    if (last == 0) fail("bit stream without its end marker", off + len - 1);
    pos = int64_t(8 * (len - 1)) + high_bit(last);
  }

  // bits [lo, lo + k), k <= 56; bits below 0 read as zero
  uint64_t bits_at(int64_t lo, int k) const {
    if (lo < 0) {
      int kk = k + int(lo);
      if (kk <= 0) return 0;
      return bits_at(0, kk) << (-lo);
    }
    size_t byte = size_t(lo) >> 3;
    int sh = int(lo & 7);
    uint64_t w = 0;
    if (byte + 8 <= n) {
      w = load64(src + byte);
    } else {
      std::memcpy(&w, src + byte, n - byte);
    }
    return (w >> sh) & ((uint64_t(1) << k) - 1);
  }
  uint64_t peek(int k) const { return bits_at(pos - k, k); }
  void skip(int k) { pos -= k; }
  uint64_t read(int k) {
    if (k == 0) return 0;
    pos -= k;
    return bits_at(pos, k);
  }
};

// ---------------------------------------------------------------------------
// FSE
// ---------------------------------------------------------------------------

constexpr int kMaxFseLog = 9;

struct FseTable {
  int log = -1;  // -1: no table yet
  uint8_t sym[1 << kMaxFseLog];
  uint8_t nbits[1 << kMaxFseLog];
  uint16_t base[1 << kMaxFseLog];
};

void build_fse(FseTable& t, const int16_t* norm, int nsym, int log,
               size_t off) {
  const int size = 1 << log;
  uint16_t next[256];
  int high = size - 1;
  for (int s = 0; s < nsym; s++) {
    if (norm[s] == -1) {
      t.sym[high--] = uint8_t(s);
      next[s] = 1;
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3;
  const int mask = size - 1;
  int p = 0;
  for (int s = 0; s < nsym; s++) {
    if (norm[s] <= 0) continue;
    next[s] = uint16_t(norm[s]);
    for (int i = 0; i < norm[s]; i++) {
      t.sym[p] = uint8_t(s);
      do {
        p = (p + step) & mask;
      } while (p > high);
    }
  }
  if (p != 0) fail("FSE distribution does not fill its table", off);
  for (int i = 0; i < size; i++) {
    uint16_t d = next[t.sym[i]]++;
    int nb = log - high_bit(d);
    t.nbits[i] = uint8_t(nb);
    t.base[i] = uint16_t((d << nb) - size);
  }
  t.log = log;
}

void build_rle(FseTable& t, uint8_t s) {
  t.sym[0] = s;
  t.nbits[0] = 0;
  t.base[0] = 0;
  t.log = 0;
}

// Reads an FSE table description at src; returns the bytes it took.
size_t read_fse_table(FseTable& t, const uint8_t* src, size_t n, size_t off,
                      int max_log, int max_sym) {
  ForwardBits in{src, n, off};
  int log = int(in.read(4)) + 5;
  if (log > max_log) fail("FSE accuracy log too large", off);
  int16_t norm[256];
  int remaining = 1 << log;
  int s = 0;
  while (remaining > 0) {
    if (s >= max_sym) fail("FSE table has too many symbols", off);
    int bits = high_bit(uint64_t(remaining) + 1) + 1;
    uint32_t val = in.read(bits);
    uint32_t lower_mask = (uint32_t(1) << (bits - 1)) - 1;
    uint32_t threshold = (uint32_t(1) << bits) - 1 - uint32_t(remaining + 1);
    if ((val & lower_mask) < threshold) {
      in.pos -= 1;
      val &= lower_mask;
    } else if (val > lower_mask) {
      val -= threshold;
    }
    int prob = int(val) - 1;
    remaining -= prob < 0 ? -prob : prob;
    norm[s++] = int16_t(prob);
    if (prob == 0) {
      uint32_t rep = in.read(2);
      for (;;) {
        for (uint32_t i = 0; i < rep; i++) {
          if (s >= max_sym) fail("FSE table has too many symbols", off);
          norm[s++] = 0;
        }
        if (rep != 3) break;
        rep = in.read(2);
      }
    }
  }
  if (remaining != 0) fail("FSE probabilities overflow the table", off);
  build_fse(t, norm, s, log, off);
  return in.bytes();
}

// ---------------------------------------------------------------------------
// Huffman
// ---------------------------------------------------------------------------

constexpr int kMaxHufBits = 11;

struct HufTable {
  int max_bits = 0;  // 0: no table yet
  uint8_t sym[1 << kMaxHufBits];
  uint8_t nbits[1 << kMaxHufBits];
};

// Reads a Huffman tree description; returns the bytes it took.
size_t read_huf_table(HufTable& t, const uint8_t* src, size_t n, size_t off) {
  if (n < 1) fail("truncated Huffman tree description", off);
  uint8_t w[256];
  int nw = 0;
  size_t used;
  uint8_t header = src[0];
  if (header >= 128) {
    nw = header - 127;
    size_t bytes = (size_t(nw) + 1) / 2;
    if (1 + bytes > n) fail("truncated Huffman weights", off);
    for (int i = 0; i < nw; i++) {
      uint8_t b = src[1 + i / 2];
      w[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
    used = 1 + bytes;
  } else {
    size_t csize = header;
    if (csize == 0 || 1 + csize > n) fail("truncated Huffman weights", off);
    FseTable ft;
    size_t h = read_fse_table(ft, src + 1, csize, off + 1, 6, 12);
    if (h >= csize) fail("Huffman weights without a payload", off + 1);
    BackBits br(src + 1 + h, csize - h, off + 1 + h);
    uint32_t s1 = uint32_t(br.read(ft.log)), s2 = uint32_t(br.read(ft.log));
    if (br.pos < 0) fail("Huffman weight stream too short", off + 1 + h);
    for (;;) {
      if (nw >= 255) fail("too many Huffman weights", off + 1 + h);
      w[nw++] = ft.sym[s1];
      s1 = ft.base[s1] + uint32_t(br.read(ft.nbits[s1]));
      if (br.pos < 0) {
        if (nw >= 255) fail("too many Huffman weights", off + 1 + h);
        w[nw++] = ft.sym[s2];
        break;
      }
      if (nw >= 255) fail("too many Huffman weights", off + 1 + h);
      w[nw++] = ft.sym[s2];
      s2 = ft.base[s2] + uint32_t(br.read(ft.nbits[s2]));
      if (br.pos < 0) {
        if (nw >= 255) fail("too many Huffman weights", off + 1 + h);
        w[nw++] = ft.sym[s1];
        break;
      }
    }
    used = 1 + csize;
  }
  uint64_t total = 0;
  for (int i = 0; i < nw; i++) {
    if (w[i] > kMaxHufBits) fail("Huffman weight too large", off);
    if (w[i]) total += uint64_t(1) << (w[i] - 1);
  }
  if (total == 0) fail("Huffman weights are all zero", off);
  int max_bits = high_bit(total) + 1;
  if (max_bits > kMaxHufBits) fail("Huffman code too long", off);
  uint64_t rest = (uint64_t(1) << max_bits) - total;
  if (rest & (rest - 1)) fail("Huffman weights do not complete a tree", off);
  w[nw++] = uint8_t(high_bit(rest) + 1);
  // codes of the lowest weight (longest) first, each weight's symbols in
  // order: table position p holds the symbol whose code prefixes p
  int p = 0;
  for (int wt = 1; wt <= max_bits; wt++) {
    int len = 1 << (wt - 1);
    for (int s = 0; s < nw; s++) {
      if (w[s] != wt) continue;
      std::memset(t.sym + p, s, len);
      std::memset(t.nbits + p, max_bits + 1 - wt, len);
      p += len;
    }
  }
  t.max_bits = max_bits;
  return used;
}

void huf_stream(const HufTable& t, const uint8_t* src, size_t n, size_t off,
                uint8_t* out, size_t count) {
  BackBits br(src, n, off);
  const int mb = t.max_bits;
  const uint32_t mask = (uint32_t(1) << mb) - 1;
  size_t i = 0;
  // four symbols (at most 44 bits) from one 56-bit window while the
  // window lies inside the stream
  while (count - i >= 4 && br.pos >= 56) {
    int64_t lo = br.pos - 56;
    uint64_t w = load64(src + (lo >> 3)) >> (lo & 7);
    int avail = 56;
    for (int k = 0; k < 4; k++) {
      uint32_t v = uint32_t(w >> (avail - mb)) & mask;
      out[i++] = t.sym[v];
      avail -= t.nbits[v];
    }
    br.pos -= 56 - avail;
  }
  for (; i < count; i++) {
    uint32_t v = uint32_t(br.peek(mb));
    out[i] = t.sym[v];
    br.skip(t.nbits[v]);
  }
  if (br.pos != 0) fail("Huffman stream not consumed exactly", off);
}

// ---------------------------------------------------------------------------
// sequences
// ---------------------------------------------------------------------------

const uint32_t kLLBase[36] = {
    0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
    12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10,  11,  12,  13,   14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24,  25,  26,  27,   28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41,  43,  47,  51,   59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1};

// ---------------------------------------------------------------------------
// output
// ---------------------------------------------------------------------------

struct Out {
  uint8_t* base;
  size_t cap;
  size_t pos = 0;
  std::vector<uint8_t>* grow;  // null: a fixed buffer

  void ensure(size_t k, size_t off) {
    if (pos + k <= cap) return;
    if (!grow) fail("output larger than the buffer given", off);
    size_t want = cap ? cap : 1024;
    while (want < pos + k) want *= 2;
    grow->resize(want);
    base = grow->data();
    cap = want;
  }
};

// ---------------------------------------------------------------------------
// frames
// ---------------------------------------------------------------------------

constexpr size_t kMaxBlock = 128 * 1024;

struct FrameState {
  HufTable huf;
  FseTable ll, of, ml;
  uint64_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> lits;
  FrameState() { lits.reserve(kMaxBlock); }  // data() is never null
};

// The literals section at src; fills st.lits, returns the bytes it took.
size_t read_literals(FrameState& st, const uint8_t* src, size_t n,
                     size_t off, size_t* nlit) {
  if (n < 1) fail("truncated literals header", off);
  int type = src[0] & 3;
  int fmt = (src[0] >> 2) & 3;
  if (type <= 1) {  // raw or RLE
    size_t regen, hs;
    if ((fmt & 1) == 0) {
      regen = src[0] >> 3;
      hs = 1;
    } else if (fmt == 1) {
      if (n < 2) fail("truncated literals header", off);
      regen = (src[0] >> 4) + (size_t(src[1]) << 4);
      hs = 2;
    } else {
      if (n < 3) fail("truncated literals header", off);
      regen = (src[0] >> 4) + (size_t(src[1]) << 4) + (size_t(src[2]) << 12);
      hs = 3;
    }
    if (regen > kMaxBlock) fail("literals larger than a block", off);
    st.lits.resize(regen);
    *nlit = regen;
    if (type == 0) {
      if (hs + regen > n) fail("truncated raw literals", off + hs);
      std::memcpy(st.lits.data(), src + hs, regen);
      return hs + regen;
    }
    if (hs + 1 > n) fail("truncated RLE literals", off + hs);
    std::memset(st.lits.data(), src[hs], regen);
    return hs + 1;
  }
  // Huffman (2) or treeless (3)
  size_t hs, bits;
  int streams = fmt == 0 ? 1 : 4;
  if (fmt <= 1) {
    hs = 3;
    bits = 10;
  } else if (fmt == 2) {
    hs = 4;
    bits = 14;
  } else {
    hs = 5;
    bits = 18;
  }
  if (n < hs) fail("truncated literals header", off);
  uint64_t h = 0;
  for (size_t i = 0; i < hs; i++) h |= uint64_t(src[i]) << (8 * i);
  size_t mask = (size_t(1) << bits) - 1;
  size_t regen = (h >> 4) & mask;
  size_t csize = (h >> (4 + bits)) & mask;
  if (regen > kMaxBlock) fail("literals larger than a block", off);
  if (hs + csize > n) fail("truncated compressed literals", off + hs);
  const uint8_t* p = src + hs;
  size_t pn = csize, poff = off + hs;
  if (type == 2) {
    size_t used = read_huf_table(st.huf, p, pn, poff);
    p += used;
    pn -= used;
    poff += used;
  } else if (st.huf.max_bits == 0) {
    fail("treeless literals without an earlier Huffman table", off);
  }
  st.lits.resize(regen);
  *nlit = regen;
  if (streams == 1) {
    huf_stream(st.huf, p, pn, poff, st.lits.data(), regen);
  } else {
    if (pn < 6) fail("truncated literals jump table", poff);
    size_t s1 = p[0] | (size_t(p[1]) << 8);
    size_t s2 = p[2] | (size_t(p[3]) << 8);
    size_t s3 = p[4] | (size_t(p[5]) << 8);
    if (6 + s1 + s2 + s3 > pn) fail("literals jump table overflows", poff);
    size_t s4 = pn - 6 - s1 - s2 - s3;
    size_t seg = (regen + 3) / 4;
    if (3 * seg > regen) fail("too few literals for four streams", off);
    const uint8_t* q = p + 6;
    size_t qoff = poff + 6;
    uint8_t* o = st.lits.data();
    huf_stream(st.huf, q, s1, qoff, o, seg);
    huf_stream(st.huf, q + s1, s2, qoff + s1, o + seg, seg);
    huf_stream(st.huf, q + s1 + s2, s3, qoff + s1 + s2, o + 2 * seg, seg);
    huf_stream(st.huf, q + s1 + s2 + s3, s4, qoff + s1 + s2 + s3,
               o + 3 * seg, regen - 3 * seg);
  }
  return hs + csize;
}

size_t read_seq_table(FseTable& t, int mode, const int16_t* def, int ndef,
                      int def_log, int max_log, int max_sym,
                      const uint8_t* src, size_t n, size_t off) {
  switch (mode) {
    case 0:
      build_fse(t, def, ndef, def_log, off);
      return 0;
    case 1:
      if (n < 1) fail("truncated RLE sequence table", off);
      if (src[0] >= max_sym) fail("RLE sequence symbol out of range", off);
      build_rle(t, src[0]);
      return 1;
    case 2:
      return read_fse_table(t, src, n, off, max_log, max_sym);
    default:
      if (t.log < 0) fail("repeat sequence table without an earlier one", off);
      return 0;
  }
}

void copy_match(Out& out, uint64_t offset, size_t len) {
  uint8_t* d = out.base + out.pos;
  const uint8_t* s = d - offset;
  if (offset >= len) {
    std::memcpy(d, s, len);
  } else {
    for (size_t i = 0; i < len; i++) d[i] = s[i];
  }
  out.pos += len;
}

void compressed_block(FrameState& st, const uint8_t* src, size_t n,
                      size_t off, Out& out, size_t frame_start) {
  size_t nlit = 0;
  size_t p = read_literals(st, src, n, off, &nlit);
  if (p >= n) fail("truncated sequences section", off + p);
  uint32_t nseq = src[p];
  if (nseq < 128) {
    p += 1;
  } else if (nseq < 255) {
    if (p + 2 > n) fail("truncated sequence count", off + p);
    nseq = ((nseq - 128) << 8) + src[p + 1];
    p += 2;
  } else {
    if (p + 3 > n) fail("truncated sequence count", off + p);
    nseq = src[p + 1] + (uint32_t(src[p + 2]) << 8) + 0x7F00;
    p += 3;
  }
  const uint8_t* lits = st.lits.data();
  if (nseq == 0) {
    if (p != n) fail("bytes after an empty sequences section", off + p);
    out.ensure(nlit, off);
    std::memcpy(out.base + out.pos, lits, nlit);
    out.pos += nlit;
    return;
  }
  if (p >= n) fail("truncated sequence modes", off + p);
  uint8_t modes = src[p++];
  if (modes & 3) fail("reserved sequence mode bits set", off + p - 1);
  p += read_seq_table(st.ll, modes >> 6, kLLDefault, 36, 6, 9, 36, src + p,
                      n - p, off + p);
  p += read_seq_table(st.of, (modes >> 4) & 3, kOFDefault, 29, 5, 8, 32,
                      src + p, n - p, off + p);
  p += read_seq_table(st.ml, (modes >> 2) & 3, kMLDefault, 53, 6, 9, 53,
                      src + p, n - p, off + p);
  if (p >= n) fail("sequences without a bit stream", off + p);
  BackBits br(src + p, n - p, off + p);
  const size_t boff = off + p;
  uint32_t sl = uint32_t(br.read(st.ll.log));
  uint32_t so = uint32_t(br.read(st.of.log));
  uint32_t sm = uint32_t(br.read(st.ml.log));
  size_t lp = 0;
  for (uint32_t i = 0; i < nseq; i++) {
    uint8_t ofc = st.of.sym[so], llc = st.ll.sym[sl], mlc = st.ml.sym[sm];
    if (ofc > 31) fail("offset code out of range", boff);
    uint64_t ov = (uint64_t(1) << ofc) + br.read(ofc);
    size_t ml = kMLBase[mlc] + size_t(br.read(kMLBits[mlc]));
    size_t ll = kLLBase[llc] + size_t(br.read(kLLBits[llc]));
    if (i + 1 < nseq) {
      sl = st.ll.base[sl] + uint32_t(br.read(st.ll.nbits[sl]));
      sm = st.ml.base[sm] + uint32_t(br.read(st.ml.nbits[sm]));
      so = st.of.base[so] + uint32_t(br.read(st.of.nbits[so]));
    }
    if (br.pos < 0) fail("sequence bit stream too short", boff);
    uint64_t offset;
    if (ov > 3) {
      offset = ov - 3;
      st.rep[2] = st.rep[1];
      st.rep[1] = st.rep[0];
      st.rep[0] = offset;
    } else {
      int idx = int(ov) - 1 + (ll == 0 ? 1 : 0);
      if (idx == 0) {
        offset = st.rep[0];
      } else {
        offset = idx == 3 ? st.rep[0] - 1 : st.rep[idx];
        if (idx > 1) st.rep[2] = st.rep[1];
        st.rep[1] = st.rep[0];
        st.rep[0] = offset;
      }
    }
    if (lp + ll > nlit) fail("sequence takes more literals than decoded",
                             boff);
    out.ensure(ll + ml, boff);
    std::memcpy(out.base + out.pos, lits + lp, ll);
    out.pos += ll;
    lp += ll;
    if (offset == 0 || offset > out.pos - frame_start)
      fail("match offset before the start of the frame", boff);
    copy_match(out, offset, ml);
  }
  if (br.pos != 0) fail("sequence bit stream not consumed exactly", boff);
  size_t rest = nlit - lp;
  out.ensure(rest, boff);
  std::memcpy(out.base + out.pos, lits + lp, rest);
  out.pos += rest;
}

// XXH64 with seed 0
constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL,
                   P3 = 0x165667B19E3779F9ULL, P4 = 0x85EBCA77C2B2AE63ULL,
                   P5 = 0x27D4EB2F165667C5ULL;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) {
  acc += in * P2;
  return rotl(acc, 31) * P1;
}
inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  acc ^= xround(0, v);
  return acc * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t len) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xround(v1, load64(p));
      v2 = xround(v2, load64(p + 8));
      v3 = xround(v3, load64(p + 16));
      v4 = xround(v4, load64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(h, v1);
    h = xmerge(h, v2);
    h = xmerge(h, v3);
    h = xmerge(h, v4);
  } else {
    h = P5;
  }
  h += uint64_t(len);
  while (p + 8 <= end) {
    h ^= xround(0, load64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= uint64_t(load32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= uint64_t(*p) * P5;
    h = rotl(h, 11) * P1;
    p++;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// One zstd frame at src[0..n) (magic included); returns its length.
size_t decode_frame(const uint8_t* src, size_t n, size_t off, Out& out) {
  if (n < 5) fail("truncated frame header", off);
  uint8_t fhd = src[4];
  int fcs_flag = fhd >> 6;
  bool single = (fhd >> 5) & 1;
  bool checksum = (fhd >> 2) & 1;
  int did_flag = fhd & 3;
  if (fhd & 8) fail("reserved frame header bit set", off + 4);
  size_t p = 5;
  if (!single) {
    if (p >= n) fail("truncated frame header", off + p);
    p++;  // the window descriptor: the whole frame is held in memory
  }
  static const int did_size[4] = {0, 1, 2, 4};
  int ds = did_size[did_flag];
  if (p + ds > n) fail("truncated frame header", off + p);
  uint32_t did = 0;
  for (int i = 0; i < ds; i++) did |= uint32_t(src[p + i]) << (8 * i);
  if (did != 0) fail("frames with a dictionary are not supported", off + p);
  p += ds;
  static const int fcs_size[4] = {0, 2, 4, 8};
  int fs = fcs_flag == 0 && single ? 1 : fcs_size[fcs_flag];
  bool has_fcs = fs > 0;
  uint64_t fcs = 0;
  if (p + fs > n) fail("truncated frame header", off + p);
  for (int i = 0; i < fs; i++) fcs |= uint64_t(src[p + i]) << (8 * i);
  if (fs == 2) fcs += 256;
  p += fs;

  FrameState st;
  const size_t frame_start = out.pos;
  // size a growing buffer from the header, but never beyond what this
  // input could decode to at the deepest ratio (a 4-byte RLE block per
  // 128 KiB): a corrupt header must not allocate gigabytes
  if (has_fcs && out.grow && fcs / kMaxBlock < n) out.ensure(fcs, off);
  for (;;) {
    if (p + 3 > n) fail("truncated block header", off + p);
    uint32_t bh = src[p] | (uint32_t(src[p + 1]) << 8) |
                  (uint32_t(src[p + 2]) << 16);
    size_t hoff = off + p;
    p += 3;
    bool last = bh & 1;
    int type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    if (size > kMaxBlock) fail("block larger than 128 KiB", hoff);
    const size_t block_start = out.pos;
    if (type == 0) {
      if (p + size > n) fail("truncated raw block", off + p);
      out.ensure(size, hoff);
      std::memcpy(out.base + out.pos, src + p, size);
      out.pos += size;
      p += size;
    } else if (type == 1) {
      if (p + 1 > n) fail("truncated RLE block", off + p);
      out.ensure(size, hoff);
      std::memset(out.base + out.pos, src[p], size);
      out.pos += size;
      p += 1;
    } else if (type == 2) {
      if (p + size > n) fail("truncated compressed block", off + p);
      compressed_block(st, src + p, size, off + p, out, frame_start);
      if (out.pos - block_start > kMaxBlock)
        fail("block decodes to more than 128 KiB", hoff);
      p += size;
    } else {
      fail("reserved block type", hoff);
    }
    if (last) break;
  }
  size_t produced = out.pos - frame_start;
  if (has_fcs && produced != fcs)
    fail("frame content size differs from its header", off);
  if (checksum) {
    if (p + 4 > n) fail("truncated content checksum", off + p);
    uint32_t want = load32(src + p);
    uint32_t got = uint32_t(xxh64(out.base + frame_start, produced));
    if (want != got) fail("content checksum mismatch", off + p);
    p += 4;
  }
  return p;
}

void decode_all(const uint8_t* src, size_t n, Out& out) {
  if (n == 0) fail("no zstd frame in an empty input", 0);
  size_t p = 0;
  while (p < n) {
    if (n - p < 4) fail("truncated frame magic", p);
    uint32_t magic = load32(src + p);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (n - p < 8) fail("truncated skippable frame", p);
      uint64_t len = load32(src + p + 4);
      if (len > n - p - 8) fail("truncated skippable frame", p);
      p += 8 + len;
    } else if (magic == 0xFD2FB528u) {
      p += decode_frame(src + p, n - p, p, out);
    } else {
      fail("bad zstd frame magic", p);
    }
  }
}

void report(const DecodeError& e, char* err, size_t err_cap,
            int64_t* err_off) {
  if (err && err_cap) {
    std::strncpy(err, e.msg, err_cap - 1);
    err[err_cap - 1] = 0;
  }
  if (err_off) *err_off = int64_t(e.offset);
}

// CRC32C, slicing by 8
uint32_t crc_table[8][256];
bool crc_ready = [] {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
    crc_table[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; i++)
    for (int t = 1; t < 8; t++)
      crc_table[t][i] = (crc_table[t - 1][i] >> 8) ^
                        crc_table[0][crc_table[t - 1][i] & 0xFF];
  return true;
}();

}  // namespace

extern "C" {

int64_t gct_zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst,
                            size_t cap, char* err, size_t err_cap,
                            int64_t* err_off) {
  Out out{dst, cap, 0, nullptr};
  try {
    decode_all(src, n, out);
  } catch (const DecodeError& e) {
    report(e, err, err_cap, err_off);
    return -1;
  } catch (const std::bad_alloc&) {
    report(DecodeError{"out of memory", 0}, err, err_cap, err_off);
    return -1;
  }
  return int64_t(out.pos);
}

int64_t gct_zstd_decompress_alloc(const uint8_t* src, size_t n,
                                  uint8_t** result, char* err, size_t err_cap,
                                  int64_t* err_off) {
  *result = nullptr;
  std::vector<uint8_t> buf(4096);
  Out out{buf.data(), buf.size(), 0, &buf};
  try {
    decode_all(src, n, out);
  } catch (const DecodeError& e) {
    report(e, err, err_cap, err_off);
    return -1;
  } catch (const std::bad_alloc&) {
    report(DecodeError{"out of memory", 0}, err, err_cap, err_off);
    return -1;
  }
  uint8_t* mem = static_cast<uint8_t*>(std::malloc(out.pos ? out.pos : 1));
  if (!mem) {
    report(DecodeError{"out of memory", 0}, err, err_cap, err_off);
    return -1;
  }
  if (out.pos) std::memcpy(mem, buf.data(), out.pos);
  *result = mem;
  return int64_t(out.pos);
}

void gct_free(void* p) { std::free(p); }

uint32_t gct_crc32c(const uint8_t* p, size_t n) {
  uint32_t c = 0xFFFFFFFFu;
  while (n >= 8) {
    uint64_t w = load64(p) ^ c;
    c = crc_table[7][w & 0xFF] ^ crc_table[6][(w >> 8) & 0xFF] ^
        crc_table[5][(w >> 16) & 0xFF] ^ crc_table[4][(w >> 24) & 0xFF] ^
        crc_table[3][(w >> 32) & 0xFF] ^ crc_table[2][(w >> 40) & 0xFF] ^
        crc_table[1][(w >> 48) & 0xFF] ^ crc_table[0][w >> 56];
    p += 8;
    n -= 8;
  }
  while (n--) c = crc_table[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

}  // extern "C"
