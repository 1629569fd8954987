// Native runtime for the BIC1 bitstream: tile-record packing (encoder tail)
// and the full windowed-codec decoder.  The device does the search/analysis
// (models/compress.py); this code is the serial bit-twiddling the reference
// left unfinished (its decoders are dead code) — Golomb-Rice with the
// reference's adaptive k (GolombCoder.cpp:29-33), exact enumerative
// (combinatorial number system) ranks with on-the-fly bignum binomials, MED
// inversion, and candidate-index geometry shared with
// models/codec.window_candidates.
//
// Exposed via ctypes (binary_image_compression_tpu/native.py); all formats
// byte-identical with the Python reference implementation (tests).

#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <vector>

namespace {

// ------------------------------ bignum (fixed u64 limbs) ------------------
// Enumerative ranks for a W x W tile need at most log2 C(W^2, W^2/2) bits;
// with W <= 64 (validated at every entry point) that is < 4096 bits = 64
// limbs.  A fixed inline array kills the vector allocations that dominated
// the round-1 encoder tail; 64-bit limbs halve the mul/div chain length.

struct Big {
  static constexpr int CAP = 66;  // C(4096, 2048) < 2^4090 -> 64 limbs
  uint64_t d[CAP];
  int len = 0;  // limbs in use; 0 == zero
  void trim() { while (len && d[len - 1] == 0) --len; }
  bool is_zero() const { return len == 0; }
  int bit_length() const {
    if (!len) return 0;
    return (len - 1) * 64 + (64 - __builtin_clzll(d[len - 1]));
  }
  void set_u64(uint64_t v) { len = v ? 1 : 0; d[0] = v; }
  void mul_small(uint64_t m) {
    unsigned __int128 carry = 0;
    for (int i = 0; i < len; ++i) {
      unsigned __int128 p = (unsigned __int128)d[i] * m + carry;
      d[i] = (uint64_t)p;
      carry = p >> 64;
    }
    if (carry && len < CAP) d[len++] = (uint64_t)carry;
  }
  void div_small(uint64_t m) {  // exact or floor division
    unsigned __int128 rem = 0;
    for (int i = len - 1; i >= 0; --i) {
      unsigned __int128 cur = (rem << 64) | d[i];
      d[i] = (uint64_t)(cur / m);
      rem = cur % m;
    }
    trim();
  }
  void add(const Big& o) {
    int n = o.len > len ? o.len : len;
    uint64_t carry = 0;
    for (int i = 0; i < n; ++i) {
      unsigned __int128 s = (unsigned __int128)(i < len ? d[i] : 0)
                            + (i < o.len ? o.d[i] : 0) + carry;
      d[i] = (uint64_t)s;
      carry = (uint64_t)(s >> 64);
    }
    len = n;
    if (carry && len < CAP) d[len++] = carry;
  }
  // this -= o (requires this >= o)
  void sub(const Big& o) {
    uint64_t borrow = 0;
    for (int i = 0; i < len; ++i) {
      uint64_t oi = i < o.len ? o.d[i] : 0;
      uint64_t di = d[i];
      uint64_t r = di - oi - borrow;
      borrow = (di < oi + borrow) || (oi + borrow < oi) ? 1 : 0;
      d[i] = r;
    }
    trim();
  }
  bool ge(const Big& o) const {  // this >= o
    if (len != o.len) return len > o.len;
    for (int i = len - 1; i >= 0; --i)
      if (d[i] != o.d[i]) return d[i] > o.d[i];
    return true;
  }
};

static Big binom(int n, int k) {  // C(n, k)
  Big c;
  c.set_u64(1);
  if (k < 0 || k > n) { c.len = 0; return c; }
  if (k > n - k) k = n - k;
  for (int i = 0; i < k; ++i) {
    c.mul_small((uint64_t)(n - i));
    c.div_small((uint64_t)(i + 1));
  }
  return c;
}

// ------------------------------ bit writer / reader -----------------------

struct Writer {
  uint8_t* buf;
  long cap;
  long bitpos = 0;
  bool overflow = false;
  Writer(uint8_t* b, long c) : buf(b), cap(c) {}
  inline void put_bit(int v) {
    long byte = bitpos >> 3;
    if (byte >= cap) { overflow = true; return; }
    if (v) buf[byte] |= (uint8_t)(0x80u >> (bitpos & 7));
    bitpos++;
  }
  void put_bits(uint64_t v, int n) {
    for (int i = n - 1; i >= 0; --i) put_bit((v >> i) & 1);
  }
  void put_big(const Big& v, int nbits) {  // MSB-first, fixed width
    for (int i = nbits - 1; i >= 0; --i) {
      int limb = i >> 6, off = i & 63;
      int bit = (limb < v.len) ? (int)((v.d[limb] >> off) & 1) : 0;
      put_bit(bit);
    }
  }
  void put_unary_zeros(long n) { for (long i = 0; i < n; ++i) put_bit(0); }
};

struct Reader {
  const uint8_t* buf;
  long nbits;
  long bitpos = 0;
  bool error = false;
  Reader(const uint8_t* b, long nbytes) : buf(b), nbits(nbytes * 8) {}
  inline int get_bit() {
    if (bitpos >= nbits) { error = true; return 0; }
    int v = (buf[bitpos >> 3] >> (7 - (bitpos & 7))) & 1;
    bitpos++;
    return v;
  }
  uint64_t get_bits(int n) {
    uint64_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | get_bit();
    return v;
  }
  Big get_big(int nbits_) {
    Big v;
    v.len = (nbits_ + 63) / 64;
    if (v.len > Big::CAP) { error = true; v.len = 0; return v; }
    for (int i = 0; i < v.len; ++i) v.d[i] = 0;
    for (int i = nbits_ - 1; i >= 0; --i) {
      int bit = get_bit();
      if (bit) v.d[i >> 6] |= (1ULL << (i & 63));
    }
    v.trim();
    return v;
  }
  long get_unary_zeros() {
    long n = 0;
    while (!error && get_bit() == 0) n++;
    return n;
  }
};

// -------------------- adaptive Golomb (GolombCoder.cpp semantics) ---------

struct Golomb {
  uint32_t acc = 0, samples = 0, k = 1;
  void update(uint32_t u) {
    samples += 1;
    acc += u;
    uint32_t kk = 0;
    while (kk < 32 && (uint32_t)(samples << kk) < acc) kk++;
    k = kk < 32 ? kk : 31;
  }
  void encode(Writer& w, uint32_t u) {
    w.put_bits(u & ((k >= 32) ? 0xFFFFFFFFu : ((1u << k) - 1u)), (int)k);
    w.put_unary_zeros(u >> k);
    w.put_bit(1);
    update(u);
  }
  uint32_t decode(Reader& r) {
    uint32_t low = (uint32_t)r.get_bits((int)k);
    uint32_t high = (uint32_t)r.get_unary_zeros();
    uint32_t u = (high << k) | low;
    update(u);
    return u;
  }
};

// -------------------- enumerative rank / unrank ---------------------------

static int enum_nbits(int n, int w) {
  if (w == 0 || w == n) return 0;
  Big c = binom(n, w);
  if (c.is_zero()) return 0;
  // nbits = bit_length(c - 1)
  Big one; one.set_u64(1);
  c.sub(one);
  return c.bit_length();
}

// per-M lookup of enum_nbits(M, w) for w in [0, M]; one binom sweep per call
static std::vector<int> enum_nbits_table(int M) {
  std::vector<int> enb(M + 1);
  Big c; c.set_u64(1);  // C(M, 0)
  for (int w = 0; w <= M; ++w) {
    if (w == 0 || w == M) {
      enb[w] = 0;
    } else {
      Big cm = c;  // C(M, w)
      Big one; one.set_u64(1);
      cm.sub(one);
      enb[w] = cm.bit_length();
    }
    if (w < M) {  // C(M, w+1) = C(M, w) * (M - w) / (w + 1)
      c.mul_small((uint64_t)(M - w));
      c.div_small((uint64_t)(w + 1));
    }
  }
  return enb;
}

// ---- Pascal-triangle binomial cache (M <= 256) ----------------------------
// The incremental rank/unrank transitions need a bignum mul+div per bit;
// with the triangle of C(a, r) precomputed (pure adds to build, ~1.3 MB for
// M=256) each step becomes a 4-limb add/sub — 3-4x faster encoder tail.
// C(255, 127) < 2^252, so 4 u64 limbs always suffice at M <= 256.

struct SmallBig {
  uint64_t d[4];
  uint8_t len;
};

struct BinomTable {
  int n;
  std::vector<SmallBig> v;  // triangular: C(a, r) at a*(a+1)/2 + r, r <= a
  const SmallBig& at(int a, int r) const {
    return v[(size_t)a * (a + 1) / 2 + r];
  }
};

static const BinomTable* binom_table(int M) {
  if (M < 1 || M > 256) return nullptr;
  static std::mutex mu;  // decode/pack run concurrently from Python threads
  static std::map<int, std::unique_ptr<BinomTable>> cache;
  std::lock_guard<std::mutex> lk(mu);
  auto& slot = cache[M];
  if (!slot) {
    auto t = std::make_unique<BinomTable>();
    t->n = M;
    t->v.resize((size_t)M * (M + 1) / 2);
    for (int a = 0; a < M; ++a) {
      for (int r = 0; r <= a; ++r) {
        SmallBig& c = t->v[(size_t)a * (a + 1) / 2 + r];
        if (r == 0 || r == a) {
          c.d[0] = 1; c.d[1] = c.d[2] = c.d[3] = 0; c.len = 1;
        } else {  // Pascal: C(a, r) = C(a-1, r-1) + C(a-1, r)
          const SmallBig& x = t->at(a - 1, r - 1);
          const SmallBig& y = t->at(a - 1, r);
          unsigned __int128 carry = 0;
          int len = 0;
          for (int i = 0; i < 4; ++i) {
            unsigned __int128 s = carry;
            s += (i < x.len) ? x.d[i] : 0;
            s += (i < y.len) ? y.d[i] : 0;
            c.d[i] = (uint64_t)s;
            carry = s >> 64;
            if (c.d[i]) len = i + 1;
          }
          c.len = (uint8_t)len;
        }
      }
    }
    slot = std::move(t);
  }
  return slot.get();
}

// rank/unrank with the table: add/sub-only inner loop
static Big enum_rank_tab(const uint8_t* bits, int n, int w,
                         const BinomTable* T) {
  Big rank;
  int rem = w;
  for (int q = 0; q < n && rem > 0; ++q) {
    int a = n - 1 - q;
    if (bits[q]) {
      rem -= 1;
    } else if (rem - 1 <= a) {  // else C(a, rem-1) == 0
      const SmallBig& c = T->at(a, rem - 1);
      // rank += c (4-limb add)
      unsigned __int128 carry = 0;
      int nlim = rank.len > c.len ? rank.len : c.len;
      for (int i = 0; i < nlim; ++i) {
        unsigned __int128 s = carry;
        s += (i < rank.len) ? rank.d[i] : 0;
        s += (i < c.len) ? c.d[i] : 0;
        rank.d[i] = (uint64_t)s;
        carry = s >> 64;
      }
      rank.len = nlim;
      if (carry && rank.len < Big::CAP) rank.d[rank.len++] = (uint64_t)carry;
    }
  }
  return rank;
}

static void enum_unrank_tab(Big rank, int n, int w, uint8_t* bits,
                            const BinomTable* T) {
  std::memset(bits, 0, n);
  int rem = w;
  for (int q = 0; q < n && rem > 0; ++q) {
    int a = n - 1 - q;
    bool take_one = true;
    if (rem - 1 <= a) {
      const SmallBig& c = T->at(a, rem - 1);
      // rank >= c ?
      bool ge;
      if (rank.len != c.len) {
        ge = rank.len > c.len;
      } else {
        ge = true;
        for (int i = rank.len - 1; i >= 0; --i)
          if (rank.d[i] != c.d[i]) { ge = rank.d[i] > c.d[i]; break; }
      }
      if (ge) {  // bit 0: rank -= c
        uint64_t borrow = 0;
        for (int i = 0; i < rank.len; ++i) {
          uint64_t ci = i < c.len ? c.d[i] : 0;
          uint64_t di = rank.d[i];
          uint64_t r = di - ci - borrow;
          borrow = (di < ci + borrow) || (ci + borrow < ci) ? 1 : 0;
          rank.d[i] = r;
        }
        rank.trim();
        take_one = false;
      }
    }
    if (take_one) {
      bits[q] = 1;
      rem -= 1;
    }
  }
}

// rank of 0/1 vector bits[n] with weight w; single pass maintaining
// c = C(n-1-q, rem-1)
static Big enum_rank(const uint8_t* bits, int n, int w) {
  Big rank;  // 0
  if (w == 0) return rank;
  int rem = w;
  Big c = binom(n - 1, rem - 1);
  for (int q = 0; q < n && rem > 0; ++q) {
    int a = n - 1 - q;  // current c == C(a, rem-1)
    if (bits[q]) {
      // advance with rem-1: C(a-1, rem-2) = C(a, rem-1) * (rem-1) / a
      rem -= 1;
      if (rem == 0) break;
      if (a > 0) { c.mul_small((uint32_t)(rem)); c.div_small((uint32_t)a); }
      // note: after rem -= 1, new target is C(a-1, rem-1) = C(a,rem)*?:
      // C(a-1, rem-1) = C(a, rem) ... we maintained c = C(a, rem) before
      // decrement (since old rem-1 == new rem). transition:
      // C(a-1, new_rem-1) = C(a, new_rem) * new_rem / a  -- done above
    } else {
      rank.add(c);
      // C(a-1, rem-1) = C(a, rem-1) * (a - (rem-1)) / a
      if (a > 0) {
        c.mul_small((uint32_t)(a - (rem - 1)));
        c.div_small((uint32_t)a);
      }
    }
  }
  return rank;
}

static void enum_unrank(Big rank, int n, int w, uint8_t* bits) {
  std::memset(bits, 0, n);
  if (w == 0) return;
  int rem = w;
  Big c = binom(n - 1, rem - 1);
  for (int q = 0; q < n && rem > 0; ++q) {
    int a = n - 1 - q;  // invariant: c == C(a, rem-1); c >= 1 while the
                        // remaining ones fit (rem <= a+1), which holds for
                        // every valid rank
    if (!c.is_zero() && rank.ge(c)) {
      rank.sub(c);  // bit 0
      if (a > 0) {
        c.mul_small((uint32_t)(a - (rem - 1)));
        c.div_small((uint32_t)a);
      }
    } else {
      bits[q] = 1;
      rem -= 1;
      if (rem == 0) break;
      if (a > 0) { c.mul_small((uint32_t)rem); c.div_small((uint32_t)a); }
    }
  }
}

// -------------------- MED (invertible origin) ------------------------------

static void unmed(uint8_t* t, int W) {  // in-place inverse: prefix-xor x then y
  for (int i = 0; i < W; ++i)
    for (int j = 1; j < W; ++j) t[i * W + j] ^= t[i * W + j - 1];
  for (int j = 0; j < W; ++j)
    for (int i = 1; i < W; ++i) t[i * W + j] ^= t[(i - 1) * W + j];
}

// -------------------- candidate geometry (window_candidates) --------------

struct Geom {
  long n1, c1, n2, c2;  // grid sizes (rows, cols)
  int i0, j0, mini, minj, maxj, mini2, maxj2, yhi;
};

static Geom geom(int i0, int j0, int W, int R, int rows, int cols) {
  Geom g{};
  g.i0 = i0; g.j0 = j0;
  g.mini = i0 - R > 0 ? i0 - R : 0;
  g.minj = j0 - R > 0 ? j0 - R : 0;
  g.maxj = (j0 + R) < (cols - W) ? (j0 + R) : (cols - W);
  g.mini2 = i0 - W > 0 ? i0 - W : 0;
  g.maxj2 = j0 - W;
  g.yhi = i0 - W;
  if (j0 >= W) {
    g.n1 = g.i0 - g.mini2 + 1;
    g.c1 = g.maxj2 - g.minj + 1;
    if (g.c1 < 0) g.c1 = 0;
  } else { g.n1 = 0; g.c1 = 0; }
  if (g.yhi >= g.mini && g.maxj >= g.minj) {
    g.n2 = g.yhi - g.mini + 1;
    g.c2 = g.maxj - g.minj + 1;
  } else { g.n2 = 0; g.c2 = 0; }
  return g;
}

static long geom_count(const Geom& g) { return g.n1 * g.c1 + g.n2 * g.c2; }

static void geom_at(const Geom& g, long rank, int* y, int* x) {
  long s1 = g.n1 * g.c1;
  if (g.c1 > 0 && rank < s1) {
    *y = g.i0 - (int)(rank / g.c1);
    *x = g.maxj2 - (int)(rank % g.c1);
  } else if (g.c2 > 0) {
    rank -= s1;
    *y = g.yhi - (int)(rank / g.c2);
    *x = g.maxj - (int)(rank % g.c2);
  } else {  // corrupt stream: match record with an empty window
    *y = 0;
    *x = 0;
  }
}

static int idx_len_for(long n) {
  if (n <= 0) return 0;
  long v = n - 1;
  int b = 0;
  while (v) { b++; v >>= 1; }
  return b < 1 ? 1 : b;
}

}  // namespace

extern "C" {

// Pack encoder tile records after device analysis.  residuals: [T][M] 0/1
// bytes.  Returns total byte length, or -1 on overflow.
long bic_pack_tiles(const uint8_t* header, long header_len, long n_tiles,
                    int M, const int32_t* mode, const uint8_t* inv,
                    const int64_t* rank, const int32_t* idx_len,
                    const int32_t* weight, const uint8_t* residuals,
                    uint8_t* out, long out_cap) {
  std::memset(out, 0, out_cap);
  std::memcpy(out, header, header_len);
  Writer w(out, out_cap);
  w.bitpos = header_len * 8;
  Golomb gm, gn;
  std::vector<int> enb = enum_nbits_table(M);
  const BinomTable* bt = binom_table(M);
  for (long t = 0; t < n_tiles; ++t) {
    int m = mode[t];
    uint32_t wt = (uint32_t)weight[t];
    if (m < 2) {
      w.put_bit(1);
      w.put_bit(m & 1);
      w.put_bit(inv[t] ? 1 : 0);
      w.put_bits((uint64_t)rank[t], idx_len[t]);
      gm.encode(w, wt);
    } else {
      w.put_bit(0);
      w.put_bit(m & 1);
      gn.encode(w, wt);
    }
    Big r = bt ? enum_rank_tab(residuals + t * M, M, (int)wt, bt)
               : enum_rank(residuals + t * M, M, (int)wt);
    w.put_big(r, enb[wt <= (uint32_t)M ? wt : M]);
    if (w.overflow) return -1;
  }
  return (w.bitpos + 7) / 8;
}

// Fused mode decision + tile-record packing: the full encoder tail after
// device analysis in ONE native call (replaces the round-1 Python
// _decide_modes loop + np_unpack + bic_pack_tiles).  Inputs are exactly the
// per-tile arrays models/compress.encode_analyze returns:
//   weights4  [T*4] int32  residual weights for modes (m/np, m/p, n/np, n/p)
//   has_cands [T]   u8     any causal candidate in the window
//   idx_len   [T]   i32    ceil(log2 n_candidates)
//   inv       [T]   u8     complement flag of the best candidate (codec 8)
//   rank      [T]   i64    scan-order rank of the best candidate
//   residual4 [T*4*nw] u32 packed residual bits per mode (MSB-first lanes)
// Decision arithmetic is identical to models/codec._encode_windowed: true
// record-header bit counts + adaptive-Golomb cost + enumerative bits, first
// minimum wins.  Returns total byte length, or -1 on overflow/bad args.
long bic_decide_pack(const uint8_t* header, long header_len, long n_tiles,
                     int M, int codec_id, const int32_t* weights4,
                     const uint8_t* has_cands, const int32_t* idx_len,
                     const uint8_t* inv, const int64_t* rank,
                     const uint32_t* residual4, int nwords,
                     uint8_t* out, long out_cap, int32_t* mode_out) {
  if (M < 1 || M > 64 * 64 || nwords < (M + 31) / 32) return -1;
  const bool use_pred = codec_id == 7 || codec_id == 8;
  const bool invert = codec_id == 8;
  const long mcost = 1 + (use_pred ? 1 : 0) + (invert ? 1 : 0);
  const long ncost = 1 + (use_pred ? 1 : 0);
  const long BIG = 1L << 28;
  std::memset(out, 0, out_cap);
  std::memcpy(out, header, header_len);
  Writer w(out, out_cap);
  w.bitpos = header_len * 8;
  Golomb gm, gn;
  std::vector<int> enb = enum_nbits_table(M);
  const BinomTable* bt = binom_table(M);
  std::vector<uint8_t> bits(M);
  auto gk = [](const Golomb& g, long u) {
    return (long)g.k + (u >> g.k) + 1; };
  for (long t = 0; t < n_tiles; ++t) {
    const int32_t* w4 = weights4 + t * 4;
    for (int m = 0; m < 4; ++m)
      if (w4[m] < 0 || w4[m] > M) return -1;
    bool hc = has_cands[t] != 0;
    long il = idx_len[t];
    long costs[4] = {
        hc ? mcost + il + gk(gm, w4[0]) + enb[w4[0]] : BIG,
        (hc && use_pred) ? mcost + il + gk(gm, w4[1]) + enb[w4[1]] : BIG,
        ncost + gk(gn, w4[2]) + enb[w4[2]],
        use_pred ? ncost + gk(gn, w4[3]) + enb[w4[3]] : BIG};
    int mode = 0;
    for (int m = 1; m < 4; ++m)
      if (costs[m] < costs[mode]) mode = m;
    if (mode_out) mode_out[t] = mode;
    uint32_t wt = (uint32_t)w4[mode];
    if (mode < 2) {
      w.put_bit(1);
      if (use_pred) w.put_bit(mode & 1);
      if (invert) w.put_bit(inv[t] ? 1 : 0);
      w.put_bits((uint64_t)rank[t], (int)il);
      gm.encode(w, wt);
    } else {
      w.put_bit(0);
      if (use_pred) w.put_bit(mode & 1);
      gn.encode(w, wt);
    }
    // unpack the chosen mode's packed residual row (MSB-first uint32 lanes)
    const uint32_t* row = residual4 + (t * 4 + mode) * nwords;
    for (int j = 0; j < M; ++j)
      bits[j] = (uint8_t)((row[j >> 5] >> (31 - (j & 31))) & 1);
    Big r = bt ? enum_rank_tab(bits.data(), M, (int)wt, bt)
               : enum_rank(bits.data(), M, (int)wt);
    w.put_big(r, enb[wt]);
    if (w.overflow) return -1;
  }
  return (w.bitpos + 7) / 8;
}

// Full decoder for windowed codecs (4/6/7/8), both modes.  out_img must be
// rows*cols bytes.  Returns 0 on success.
int bic_decode_windowed(const uint8_t* blob, long blob_len,
                        uint8_t* out_img) {
  if (blob_len < 28) return -1;
  // header: magic(4) crc(4) codec(1) flags(1) W(2) rows(4) cols(4) T(4) R(4)
  int codec = blob[8];
  int flags = blob[9];
  int W = 0;  std::memcpy(&W, blob + 10, 2);
  uint32_t rows, cols, T, R;
  std::memcpy(&rows, blob + 12, 4);
  std::memcpy(&cols, blob + 16, 4);
  std::memcpy(&T, blob + 20, 4);
  std::memcpy(&R, blob + 24, 4);
  // untrusted header: W=0 divides by zero below, W>64 overflows M and the
  // packed-row fast paths; oversized dims would size multi-GB buffers
  // (geometry in 64-bit — cols+W-1 overflows uint32 at cols=0xffffffff)
  if (W < 1 || W > 64) return -4;
  if (rows == 0 || cols == 0 ||
      (uint64_t)rows * (uint64_t)cols > (1ULL << 30)) return -4;
  bool strict = flags & 1;
  bool invert = codec == 8;
  bool use_pred = codec == 7 || codec == 8;
  long ny = ((long)rows + W - 1) / W, nx = ((long)cols + W - 1) / W;
  int M = W * W;
  long gw = (long)nx * W, gh = (long)ny * W;
  std::vector<uint8_t> work(gh * gw, 0), outg(gh * gw, 0);
  uint8_t* ref = strict ? work.data() : outg.data();
  Reader r(blob, blob_len);
  r.bitpos = 28 * 8;
  Golomb gm, gn;
  std::vector<int> enb = enum_nbits_table(M);
  const BinomTable* bt = binom_table(M);
  std::vector<uint8_t> res(M), P(M);
  for (int ti = 0; ti < ny; ++ti) {
    for (int tj = 0; tj < nx; ++tj) {
      int i0 = ti * W, j0 = tj * W;
      int match = r.get_bit();
      int pred = use_pred ? r.get_bit() : 0;
      int inv = 0;
      long rank = 0;
      Geom g = geom(i0, j0, W, (int)R, (int)rows, (int)cols);
      if (match) {
        if (invert) inv = r.get_bit();
        long nc = geom_count(g);
        if (nc == 0) return -3;  // corrupt: match with no candidates
        int il = idx_len_for(nc);
        rank = (long)r.get_bits(il);
        if (rank >= nc) rank = nc - 1;  // corrupt index: clamp
      }
      uint32_t wt = match ? gm.decode(r) : gn.decode(r);
      if (wt > (uint32_t)M) return -2;  // corrupt weight
      int nb = enb[wt];
      Big rk = r.get_big(nb);
      if (bt) enum_unrank_tab(rk, M, (int)wt, res.data(), bt);
      else enum_unrank(rk, M, (int)wt, res.data());
      if (r.error) return -2;
      // reconstruct P
      std::memcpy(P.data(), res.data(), M);
      if (pred) unmed(P.data(), W);
      if (match) {
        int y, x;
        geom_at(g, rank, &y, &x);
        for (int a = 0; a < W; ++a)
          for (int b = 0; b < W; ++b)
            P[a * W + b] ^= ref[(long)(y + a) * gw + (x + b)];
        if (inv)
          for (int i = 0; i < M; ++i) P[i] ^= 1;
      }
      for (int a = 0; a < W; ++a)
        std::memcpy(&outg[(long)(i0 + a) * gw + j0], &P[a * W], W);
      if (strict)
        for (int a = 0; a < W; ++a)
          std::memcpy(&work[(long)(i0 + a) * gw + j0], &res[a * W], W);
    }
  }
  for (uint32_t i = 0; i < rows; ++i)
    std::memcpy(out_img + (long)i * cols, &outg[(long)i * gw], cols);
  return 0;
}

// ------------------- codec 10 run-length stage (EG / MELCODE) -------------
// Adaptive exponential-Golomb runs for the MED+RLE codec: the per-run hot
// loop of models/codec._EGStream (the reference's intended MELCODE,
// eg.cpp:4-37, with the LUT clamped to 31 — DEVIATIONS.md 2).  The payload
// is byte-aligned after the BIC1 header, so these operate on a fresh
// bitstream.  Encoder takes precomputed zero-run lengths (numpy extracts
// them vectorized); decoder emits the flat 0/1 residual plane.

static const int EGLUT[32] = {0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                              4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13,
                              14, 15};

struct EGState {
  int lut_index = 0, g = 1;
  long block = 1;  // eg.h ctor state
  void inc() {
    if (lut_index < 31) lut_index++;
    g = EGLUT[lut_index];
    block = 1L << g;
  }
  void dec() {
    if (lut_index > 0) lut_index--;
    g = EGLUT[lut_index];
    block = 1L << g;
  }
};

long bic_eg_encode_runs(const int64_t* runs, long n_runs, uint8_t* out,
                        long cap) {
  std::memset(out, 0, cap);
  Writer w(out, cap);
  EGState eg;
  for (long i = 0; i < n_runs; ++i) {
    long len = runs[i];
    if (len < 0) return -1;
    while (len >= eg.block) {
      len -= eg.block;
      w.put_bit(1);
      eg.inc();
    }
    w.put_bit(0);
    w.put_bits((uint64_t)len, eg.g);
    eg.dec();
    if (w.overflow) return -1;
  }
  return (w.bitpos + 7) / 8;
}

// decode zero-runs until n_pixels consumed; flat_out[n_pixels] gets the 0/1
// residual plane.  Returns 0, or -2 on truncated/corrupt stream.
int bic_eg_decode_runs(const uint8_t* payload, long payload_len,
                       long n_pixels, uint8_t* flat_out) {
  std::memset(flat_out, 0, n_pixels);
  Reader r(payload, payload_len);
  EGState eg;
  long pos = 0;
  while (pos < n_pixels) {
    long len = 0;
    while (r.get_bit()) {
      len += eg.block;
      eg.inc();
      if (len > n_pixels - pos) { len = n_pixels - pos; goto place; }
      if (r.error) return -2;
    }
    len += (long)r.get_bits(eg.g);
    eg.dec();
  place:
    pos += len;
    if (pos < n_pixels) {
      flat_out[pos] = 1;
      pos += 1;
    }
    if (r.error && pos < n_pixels) return -2;
  }
  return 0;
}

// standalone helpers for tests
int bic_enum_nbits(int n, int w) { return enum_nbits(n, w); }

long bic_enum_roundtrip(const uint8_t* bits, int n, int w, uint8_t* out) {
  Big r = enum_rank(bits, n, w);
  enum_unrank(r, n, w, out);
  return r.bit_length();
}

}  // extern "C"

// ===========================================================================
// codec 12: context-adaptive binary arithmetic coding (JBIG-class)
// ===========================================================================
// LZMA-style carry-counting range coder + per-context adaptive 16-bit
// probabilities.  Context = 10 causal neighbors (3 from row-2, 5 from
// row-1, 2 to the left), the classic JBIG template; out-of-image reads 0.
// This goes beyond the reference (whose best tool is MED + Golomb
// estimates) — typically 2-4x smaller on document images.

namespace {

struct RC {
  uint8_t* out;
  long cap, n = 0;
  uint64_t low = 0;
  uint32_t range = 0xFFFFFFFFu;
  uint8_t cache = 0;
  int64_t cache_size = 1;
  bool overflow = false;
  RC(uint8_t* o, long c) : out(o), cap(c) {}
  void emit(uint8_t b) {
    if (n >= cap) { overflow = true; return; }
    out[n++] = b;
  }
  void shift_low() {
    if ((uint32_t)low < 0xFF000000u || (low >> 32) != 0) {
      uint8_t carry = (uint8_t)(low >> 32);
      do { emit((uint8_t)(cache + carry)); cache = 0xFF; }
      while (--cache_size);
      cache = (uint8_t)(low >> 24);
    }
    cache_size++;
    low = (uint32_t)((uint32_t)low << 8);  // 32-bit truncating shift
  }
  void encode_bit(uint32_t p1, int bit) {  // p1 = P(bit==1) in [1, 0xFFFF]
    uint32_t bound = (range >> 16) * p1;
    if (bit) range = bound;
    else { low += bound; range -= bound; }
    while (range < (1u << 24)) { shift_low(); range <<= 8; }
  }
  long finish() {
    for (int i = 0; i < 5; ++i) shift_low();
    return n;
  }
};

struct RD {
  const uint8_t* in;
  long nbytes, pos = 0;
  uint32_t range = 0xFFFFFFFFu, code = 0;
  RD(const uint8_t* i, long nb) : in(i), nbytes(nb) {
    pos = 1;  // encoder's first byte is the initial zero cache
    for (int k = 0; k < 4; ++k) code = (code << 8) | get();
  }
  uint8_t get() { return pos < nbytes ? in[pos++] : 0; }
  int decode_bit(uint32_t p1) {
    uint32_t bound = (range >> 16) * p1;
    int bit;
    if (code < bound) { bit = 1; range = bound; }
    else { bit = 0; code -= bound; range -= bound; }
    while (range < (1u << 24)) { range <<= 8; code = (code << 8) | get(); }
    return bit;
  }
};

static inline uint32_t ctx_at(const uint8_t* img, int rows, int cols,
                              int r, int c) {
  auto px = [&](int rr, int cc) -> uint32_t {
    if (rr < 0 || cc < 0 || cc >= cols) return 0;
    return img[(long)rr * cols + cc];
  };
  return (px(r - 2, c - 1) << 9) | (px(r - 2, c) << 8)
       | (px(r - 2, c + 1) << 7) | (px(r - 1, c - 2) << 6)
       | (px(r - 1, c - 1) << 5) | (px(r - 1, c) << 4)
       | (px(r - 1, c + 1) << 3) | (px(r - 1, c + 2) << 2)
       | (px(r, c - 2) << 1) | px(r, c - 1);
}

static inline void model_update(uint16_t& p, int bit) {
  if (bit) p = (uint16_t)(p + ((0xFFFFu - p) >> 5));
  else p = (uint16_t)(p - (p >> 5));
  if (p < 32) p = 32;
  if (p > 0xFFDF) p = 0xFFDF;
}

}  // namespace

extern "C" {

// Encode a 0/1 image with 10-bit-context adaptive arithmetic coding.
// Returns byte length, or -1 on overflow.
long bic_cabic_encode(const uint8_t* img, int rows, int cols,
                      uint8_t* out, long cap) {
  std::vector<uint16_t> prob(1 << 10, 0x8000);
  RC rc(out, cap);
  for (int r = 0; r < rows; ++r)
    for (int c = 0; c < cols; ++c) {
      uint32_t ctx = ctx_at(img, rows, cols, r, c);
      rc.encode_bit(prob[ctx], img[(long)r * cols + c]);
      model_update(prob[ctx], img[(long)r * cols + c]);
      if (rc.overflow) return -1;
    }
  return rc.finish();
}

int bic_cabic_decode(const uint8_t* blob, long blob_len, int rows, int cols,
                     uint8_t* out_img) {
  std::vector<uint16_t> prob(1 << 10, 0x8000);
  RD rd(blob, blob_len);
  for (int r = 0; r < rows; ++r)
    for (int c = 0; c < cols; ++c) {
      uint32_t ctx = ctx_at(out_img, rows, cols, r, c);
      int bit = rd.decode_bit(prob[ctx]);
      model_update(prob[ctx], bit);
      out_img[(long)r * cols + c] = (uint8_t)bit;
    }
  return 0;
}

}  // extern "C"

// ===========================================================================
// full windowed encoder (codecs 4/6/7/8, strict + causal modes)
// ===========================================================================
// The complete encoder in native code: packed-uint64 XOR/popcount candidate
// search with the reference's early-exit semantics, MED prediction, 4-way
// mode decision against the two adaptive Golomb contexts, and tile-record
// packing.  Byte-identical to models/codec._encode_windowed (tests).

namespace {

struct PackedGrid {
  // row-major bit rows, 64-bit words, MSB-first within word
  std::vector<uint64_t> words;
  long gw64;  // words per row
  long gh, gw;
  void init(long h, long wpx) {
    gh = h; gw = wpx;
    gw64 = (wpx + 63) / 64;
    words.assign(h * gw64, 0);
  }
  void set_row_bits(long r, const uint8_t* bits, long n) {
    uint64_t* row = &words[r * gw64];
    for (long j = 0; j < gw64; ++j) row[j] = 0;
    for (long j = 0; j < n; ++j)
      if (bits[j]) row[j >> 6] |= (0x8000000000000000ULL >> (j & 63));
  }
  // extract W<=64 bits of row r starting at column c, left-aligned
  inline uint64_t get_bits(long r, long c, int W) const {
    const uint64_t* row = &words[r * gw64];
    long w0 = c >> 6;
    int off = (int)(c & 63);
    uint64_t v = row[w0] << off;
    if (off && w0 + 1 < gw64) v |= row[w0 + 1] >> (64 - off);
    uint64_t mask = (W == 64) ? ~0ULL : (~0ULL << (64 - W));
    return v & mask;
  }
};

static void med_tile(const uint8_t* p, uint8_t* r, int W) {
  for (int i = 0; i < W; ++i)
    for (int j = 0; j < W; ++j) {
      uint8_t up = i ? p[(i - 1) * W + j] : 0;
      uint8_t left = j ? p[i * W + j - 1] : 0;
      uint8_t ul = (i && j) ? p[(i - 1) * W + j - 1] : 0;
      r[i * W + j] = p[i * W + j] ^ up ^ left ^ ul;
    }
}

}  // namespace

extern "C" {

long bic_encode_windowed(const uint8_t* img, const uint8_t* header,
                         long header_len, int codec_id, int strict, int W,
                         uint32_t rows, uint32_t cols, uint32_t T, uint32_t R,
                         uint8_t* out, long out_cap) {
  // prow[64] below holds one packed tile row per W; W outside [1, 64]
  // would smash the stack (W > 64) or divide by zero (W = 0)
  if (W < 1 || W > 64 || rows == 0 || cols == 0) return -1;
  const int ny = (rows + W - 1) / W, nx = (cols + W - 1) / W;
  const int M = W * W;
  const long gh = (long)ny * W, gw = (long)nx * W;
  const bool invert = codec_id == 8;
  const bool use_pred = codec_id == 7 || codec_id == 8;

  // byte grids: orig + (strict) work
  std::vector<uint8_t> orig(gh * gw, 0);
  for (uint32_t r = 0; r < rows; ++r)
    for (uint32_t c = 0; c < cols; ++c)
      orig[(long)r * gw + c] = img[(long)r * cols + c];
  std::vector<uint8_t> workb = orig;
  std::vector<uint8_t>& refb = strict ? workb : orig;

  PackedGrid pg;
  pg.init(gh, gw);
  {
    std::vector<uint8_t> rowbits(gw);
    for (long r = 0; r < gh; ++r)
      pg.set_row_bits(r, &refb[r * gw], gw);
  }

  std::memset(out, 0, out_cap);
  std::memcpy(out, header, header_len);
  Writer wtr(out, out_cap);
  wtr.bitpos = header_len * 8;
  Golomb gm, gn;
  std::vector<int> enb = enum_nbits_table(M);
  const BinomTable* bt = binom_table(M);
  std::vector<uint8_t> P(M), P2(M), Pm(M), P3(M), dP3(M), dP(M);

  for (int ti = 0; ti < ny; ++ti) {
    for (int tj = 0; tj < nx; ++tj) {
      const int i0 = ti * W, j0 = tj * W;
      for (int a = 0; a < W; ++a)
        std::memcpy(&P[a * W], &refb[(long)(i0 + a) * gw + j0], W);
      // packed tile rows for fast dist
      uint64_t prow[64];
      for (int a = 0; a < W; ++a) prow[a] = pg.get_bits(i0 + a, j0, W);

      Geom g = geom(i0, j0, W, (int)R, (int)rows, (int)cols);
      long ncands = geom_count(g);
      long best = -1, rank = 0;
      int bestd = M + 1;
      bool bestinv = false;
      // serial scan with early exit (reference semantics, defined inv)
      for (long rk = 0; rk < ncands; ++rk) {
        int y, x;
        geom_at(g, rk, &y, &x);
        int d = 0;
        for (int a = 0; a < W; ++a)
          d += __builtin_popcountll(prow[a] ^ pg.get_bits(y + a, x, W));
        bool inv = false;
        if (invert && (M - d) < d) { inv = true; d = M - d; }
        if (d < bestd) {
          best = rk; bestd = d; bestinv = inv;
          if (bestd <= (int)T) break;
        }
      }
      int il = idx_len_for(ncands);

      // candidate residuals + weights
      long w_m_np = -1, w_m_p = -1;
      if (best >= 0) {
        int y, x;
        geom_at(g, best, &y, &x);
        for (int a = 0; a < W; ++a)
          for (int b = 0; b < W; ++b) {
            uint8_t pv = P[a * W + b];
            if (bestinv) pv ^= 1;
            P3[a * W + b] = pv ^ refb[(long)(y + a) * gw + (x + b)];
          }
        w_m_np = 0;
        for (int i = 0; i < M; ++i) w_m_np += P3[i];
        if (use_pred) {
          med_tile(P3.data(), dP3.data(), W);
          w_m_p = 0;
          for (int i = 0; i < M; ++i) w_m_p += dP3[i];
        }
      }
      long w_n_np = 0;
      for (int i = 0; i < M; ++i) w_n_np += P[i];
      long w_n_p = -1;
      if (use_pred) {
        med_tile(P.data(), dP.data(), W);
        w_n_p = 0;
        for (int i = 0; i < M; ++i) w_n_p += dP[i];
      }

      // 4-way decision, same arithmetic as models/codec._encode_windowed:
      // header bits actually written = match + pred? + inv?
      const long BIG = 1L << 40;
      long mcost = 1 + (use_pred ? 1 : 0) + (invert ? 1 : 0);
      long ncost = use_pred ? 2 : 1;
      auto gk = [](const Golomb& gg, long u) {
        return (long)gg.k + (u >> gg.k) + 1; };
      long costs[4] = {
          best >= 0 ? mcost + il + gk(gm, w_m_np) + enb[w_m_np] : BIG,
          (best >= 0 && use_pred)
              ? mcost + il + gk(gm, w_m_p) + enb[w_m_p] : BIG,
          ncost + gk(gn, w_n_np) + enb[w_n_np],
          use_pred ? ncost + gk(gn, w_n_p) + enb[w_n_p] : BIG};
      int mode = 0;
      for (int m = 1; m < 4; ++m)
        if (costs[m] < costs[mode]) mode = m;

      const uint8_t* res = mode == 0 ? P3.data()
                        : mode == 1 ? dP3.data()
                        : mode == 2 ? P.data() : dP.data();
      long wt = mode == 0 ? w_m_np : mode == 1 ? w_m_p
              : mode == 2 ? w_n_np : w_n_p;
      if (mode < 2) {
        wtr.put_bit(1);
        if (use_pred) wtr.put_bit(mode & 1);
        if (invert) wtr.put_bit(bestinv ? 1 : 0);
        wtr.put_bits((uint64_t)best, il);
        gm.encode(wtr, (uint32_t)wt);
      } else {
        wtr.put_bit(0);
        if (use_pred) wtr.put_bit(mode & 1);
        gn.encode(wtr, (uint32_t)wt);
      }
      Big rb = bt ? enum_rank_tab(res, M, (int)wt, bt)
                  : enum_rank(res, M, (int)wt);
      wtr.put_big(rb, enb[wt]);
      if (wtr.overflow) return -1;

      if (strict) {
        for (int a = 0; a < W; ++a) {
          std::memcpy(&workb[(long)(i0 + a) * gw + j0], &res[a * W], W);
          pg.set_row_bits(i0 + a, &workb[(long)(i0 + a) * gw], gw);
        }
      }
    }
  }
  return (wtr.bitpos + 7) / 8;
}

}  // extern "C"

// ===========================================================================
// codec 13: stripe-parallel context-adaptive binary arithmetic coding (SCAB)
// ===========================================================================
// The codec-12 idea re-engineered for parallel hardware: the image splits
// into horizontal stripes that are coded as fully INDEPENDENT arithmetic
// streams (template reads above the stripe top return 0, each stripe's
// model starts fresh), so encode and decode parallelize across host cores
// and the per-pixel context ids can be computed on device for the whole
// page at once (models/compress.scab_ctx_map) — the encoder then does only
// the serial range-coder update per pixel.
//
// Two refinements over codec 12 recover (and beat) the model-reset cost:
//  * incremental context maintenance — 3 shift-registers per row instead of
//    10 bounds-checked loads per pixel (~4x faster inner loop);
//  * count-ramped adaptation — fresh contexts move with shift 2..4 before
//    settling at 5, so each stripe's model warms in tens of pixels.
//
// Payload (after the BIC1 header): u8 tmpl (10/12), u8 ramp, u16 n_stripes,
// u32 stripe_rows, u32 len[n_stripes], then the concatenated streams.

#include <atomic>
#include <thread>

namespace scab {

static inline int ramp_shift(uint32_t n) {
  return n < 2 ? 2 : n < 4 ? 3 : n < 8 ? 4 : 5;
}

// one uint32 table entry per context: p in the low 16 bits, the ramp
// count in bits 16.. — a single load/store per pixel (the separate count
// array cost ~40% of the encode loop)
struct Model {
  std::vector<uint32_t> t;
  bool ramp;
  explicit Model(int bits, bool ramp_) : t(1u << bits, 0x8000),
                                         ramp(ramp_) {}
  static constexpr uint8_t RAMP[9] = {2, 2, 3, 3, 4, 4, 4, 4, 5};
  // returns P(bit==1) BEFORE adapting the entry toward bit
  inline uint32_t code(uint32_t ctx, int bit) {
    uint32_t e = t[ctx];
    uint32_t q = e & 0xFFFFu, n = e >> 16;
    uint32_t p1 = q;
    int sh = 5;
    if (ramp) {
      sh = RAMP[n];
      n += (n < 8);
    }
    if (bit) q += (0xFFFFu - q) >> sh;
    else     q -= q >> sh;
    if (q < 32) q = 32; else if (q > 0xFFDF) q = 0xFFDF;
    t[ctx] = q | (n << 16);
    return p1;
  }
};
constexpr uint8_t Model::RAMP[9];

// Incremental context scan over one stripe.  Registers per row:
//   a: row-2 window, b: row-1 window, cur: already-coded row-0 bits.
// tmpl 10 (the codec-12 JBIG template, ctx_at above):
//   ctx = a3<<7 | b5<<2 | cur2   (a3 = px2[c-1..c+1], b5 = px1[c-2..c+2],
//                                 cur2 = px0[c-2..c-1], MSB = leftmost)
// tmpl 12 adds px1[c+3] and px0[c-3]:
//   ctx = a3<<9 | b6<<3 | cur3   (b6 = px1[c-2..c+3], cur3 = px0[c-3..c-1])
template <int TMPL, class F>
static void scan_stripe(const uint8_t* img, int rows, int cols,
                        int top, int bot, F&& per_pixel) {
  // zero-padded copies of the two context rows kill every per-pixel bounds
  // check in the register advance (the lookahead reads run to c+4)
  std::vector<uint8_t> r2e((size_t)cols + 8, 0), r1e((size_t)cols + 8, 0);
  for (int r = top; r < bot; ++r) {
    if (r - top >= 2)
      std::memcpy(r2e.data(), img + (long)(r - 2) * cols, (size_t)cols);
    else
      std::memset(r2e.data(), 0, (size_t)cols);
    if (r - top >= 1)
      std::memcpy(r1e.data(), img + (long)(r - 1) * cols, (size_t)cols);
    else
      std::memset(r1e.data(), 0, (size_t)cols);
    const uint8_t* p2 = r2e.data();
    const uint8_t* p1 = r1e.data();
    uint32_t a = ((uint32_t)p2[0] << 1) | p2[1];               // px2[-1..1]
    uint32_t b, cur = 0;
    if (TMPL == 10)
      b = ((uint32_t)p1[0] << 2) | ((uint32_t)p1[1] << 1) | p1[2];
    else
      b = ((uint32_t)p1[0] << 3) | ((uint32_t)p1[1] << 2)
        | ((uint32_t)p1[2] << 1) | p1[3];
    for (int c = 0; c < cols; ++c) {
      uint32_t ctx;
      if (TMPL == 10) ctx = (a << 7) | (b << 2) | cur;
      else            ctx = (a << 9) | (b << 3) | cur;
      int bit = per_pixel((long)r * cols + c, ctx);
      a = ((a << 1) | p2[c + 2]) & 7u;
      if (TMPL == 10) {
        b = ((b << 1) | p1[c + 3]) & 31u;
        cur = ((cur << 1) | (uint32_t)bit) & 3u;
      } else {
        b = ((b << 1) | p1[c + 4]) & 63u;
        cur = ((cur << 1) | (uint32_t)bit) & 7u;
      }
    }
  }
}

struct StripeJob {
  long out_len = -1;
  std::vector<uint8_t> buf;
};

// encode one stripe; ctx_pre (nullable) supplies device-computed contexts
template <int TMPL>
static void encode_stripe(const uint8_t* img, int rows, int cols,
                          int top, int bot, bool ramp,
                          const uint16_t* ctx_pre, StripeJob& job) {
  long pixels = (long)(bot - top) * cols;
  // worst case: a clamped model mispredicting every bit costs ~11 bits per
  // pixel transiently; size like the codec-12 entry (8 bits/pixel + slack)
  // so overflow is a genuine error, not an undersized buffer
  job.buf.resize((size_t)(pixels + 4096));
  RC rc(job.buf.data(), (long)job.buf.size());
  Model m(TMPL, ramp);
  if (ctx_pre) {
    const uint8_t* px = img + (long)top * cols;
    const uint16_t* cx = ctx_pre + (long)top * cols;
    for (long i = 0; i < pixels; ++i)
      rc.encode_bit(m.code(cx[i], px[i]), px[i]);
  } else {
    scan_stripe<TMPL>(img, rows, cols, top, bot,
                      [&](long idx, uint32_t ctx) -> int {
                        int bit = img[idx];
                        rc.encode_bit(m.code(ctx, bit), bit);
                        return bit;
                      });
  }
  job.out_len = rc.overflow ? -1 : rc.finish();
}

template <int TMPL>
static void decode_stripe(const uint8_t* stream, long slen,
                          uint8_t* img, int rows, int cols,
                          int top, int bot, bool ramp) {
  RD rd(stream, slen);
  Model m(TMPL, ramp);
  scan_stripe<TMPL>(img, rows, cols, top, bot,
                    [&](long idx, uint32_t ctx) -> int {
                      uint32_t e = m.t[ctx];
                      int bit = rd.decode_bit(e & 0xFFFFu);
                      m.code(ctx, bit);
                      img[idx] = (uint8_t)bit;
                      return bit;
                    });
}

// --- payload mode 2: static-table interleaved rANS (device-assembled) ----
// Twin of ops/ransdevice.py + models/codec._decode_scab_rans: the encoder
// is the device jit (semi-adaptive per-context table + N interleaved rANS
// lanes, 32-bit state / 16-bit renorm / 12-bit freqs); this is the serial
// host decoder, parallel across stripes.

static const uint16_t RANS_LOGIT64[64] = {
    1, 2, 2, 3, 4, 5, 6, 8, 10, 13, 17, 22, 29, 37, 48, 61,
    78, 101, 129, 164, 209, 266, 337, 424, 531, 659, 812, 990,
    1193, 1419, 1663, 1918, 2178, 2433, 2677, 2903, 3106, 3284,
    3437, 3565, 3672, 3759, 3830, 3887, 3932, 3967, 3995, 4018,
    4035, 4048, 4059, 4067, 4074, 4079, 4083, 4086, 4088, 4090,
    4091, 4092, 4093, 4094, 4094, 4095};

template <int TMPL>
static void decode_stripe_rans(const uint8_t* blob, long slen,
                               const uint16_t* table, int n_lanes,
                               uint8_t* img, int rows, int cols,
                               int top, int bot) {
  std::vector<uint32_t> x((size_t)n_lanes);
  std::memcpy(x.data(), blob, 4L * n_lanes);
  const uint8_t* st = blob + 4L * n_lanes;
  long nbytes = slen - 4L * n_lanes;
  long pos = 0, t = 0;
  scan_stripe<TMPL>(img, rows, cols, top, bot,
                    [&](long idx, uint32_t ctx) -> int {
                      uint32_t& xs = x[(size_t)(t % n_lanes)];
                      uint32_t p1 = table[ctx], f0 = 4096u - p1;
                      uint32_t slot = xs & 4095u;
                      int bit = slot >= f0;
                      uint32_t f = bit ? p1 : f0, b = bit ? f0 : 0;
                      xs = f * (xs >> 12) + slot - b;
                      if (xs < (1u << 16)) {  // exactly one 16-bit pull
                        uint32_t w = 0;
                        if (pos + 2 <= nbytes)  // corrupt tail -> CRC fails
                          w = ((uint32_t)st[pos] << 8) | st[pos + 1];
                        pos += 2;
                        xs = (xs << 16) | w;
                      }
                      img[idx] = (uint8_t)bit;
                      ++t;
                      return bit;
                    });
}

template <class Fn>
static void run_stripes(int n_stripes, Fn&& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int nt = (int)std::min<unsigned>(hw ? hw : 1, (unsigned)n_stripes);
  if (nt <= 1) {
    for (int s = 0; s < n_stripes; ++s) fn(s);
    return;
  }
  std::atomic<int> next(0);
  std::vector<std::thread> ts;
  for (int t = 0; t < nt; ++t)
    ts.emplace_back([&] {
      for (int s = next.fetch_add(1); s < n_stripes; s = next.fetch_add(1))
        fn(s);
    });
  for (auto& t : ts) t.join();
}

}  // namespace scab

extern "C" {

// Encode a 0/1 image as a codec-13 payload (no BIC1 header).  tmpl in
// {10, 12}; n_stripes >= 1 (clamped to rows); ramp 0/1; ctx_pre nullable
// uint16[rows*cols] precomputed contexts (must match the incremental scan
// — the device path, tested).  Returns payload length or -1.
long bic_scab_encode(const uint8_t* img, int rows, int cols, int tmpl,
                     int n_stripes, int ramp, const uint16_t* ctx_pre,
                     uint8_t* out, long cap) {
  if (tmpl != 10 && tmpl != 12) return -1;
  if (n_stripes < 1) n_stripes = 1;
  if (n_stripes > rows) n_stripes = rows;
  int stripe_rows = (rows + n_stripes - 1) / n_stripes;
  n_stripes = (rows + stripe_rows - 1) / stripe_rows;
  std::vector<scab::StripeJob> jobs(n_stripes);
  scab::run_stripes(n_stripes, [&](int s) {
    int top = s * stripe_rows;
    int bot = std::min(rows, top + stripe_rows);
    if (tmpl == 10)
      scab::encode_stripe<10>(img, rows, cols, top, bot, ramp != 0,
                              ctx_pre, jobs[s]);
    else
      scab::encode_stripe<12>(img, rows, cols, top, bot, ramp != 0,
                              ctx_pre, jobs[s]);
  });
  long need = 8 + 4L * n_stripes;
  for (auto& j : jobs) {
    if (j.out_len < 0) return -1;
    need += j.out_len;
  }
  if (need > cap) return -1;
  uint8_t* w = out;
  *w++ = (uint8_t)tmpl;
  *w++ = (uint8_t)(ramp != 0);
  *w++ = (uint8_t)(n_stripes & 0xFF);
  *w++ = (uint8_t)(n_stripes >> 8);
  std::memcpy(w, &stripe_rows, 4); w += 4;
  for (auto& j : jobs) {
    uint32_t ln = (uint32_t)j.out_len;
    std::memcpy(w, &ln, 4); w += 4;
  }
  for (auto& j : jobs) {
    std::memcpy(w, j.buf.data(), (size_t)j.out_len);
    w += j.out_len;
  }
  return need;
}

int bic_scab_decode(const uint8_t* payload, long len, int rows, int cols,
                    uint8_t* out_img) {
  if (len < 8) return -1;
  int tmpl = payload[0];
  int ramp = payload[1];
  int n_stripes = payload[2] | (payload[3] << 8);
  int32_t stripe_rows;
  std::memcpy(&stripe_rows, payload + 4, 4);
  if ((tmpl != 10 && tmpl != 12) || n_stripes < 1 || stripe_rows < 1)
    return -1;
  if ((long)8 + 4L * n_stripes > len) return -1;
  if ((long)(n_stripes - 1) * stripe_rows >= rows ||
      (long)n_stripes * stripe_rows < rows)
    return -1;
  std::vector<uint32_t> lens(n_stripes);
  std::memcpy(lens.data(), payload + 8, 4L * n_stripes);
  std::vector<long> offs(n_stripes);
  long off = 8 + 4L * n_stripes;
  for (int s = 0; s < n_stripes; ++s) {
    offs[s] = off;
    off += lens[s];
    if (off > len) return -1;
  }
  scab::run_stripes(n_stripes, [&](int s) {
    int top = s * stripe_rows;
    int bot = std::min(rows, top + stripe_rows);
    if (tmpl == 10)
      scab::decode_stripe<10>(payload + offs[s], lens[s], out_img,
                              rows, cols, top, bot, ramp != 0);
    else
      scab::decode_stripe<12>(payload + offs[s], lens[s], out_img,
                              rows, cols, top, bot, ramp != 0);
  });
  return 0;
}

// Decode the mode-2 (static-table interleaved rANS) codec-13 payload.
// Layout: see models/compress._encode_scab_device.  Returns 0 / -1.
int bic_scab_rans_decode(const uint8_t* payload, long len, int rows,
                         int cols, uint8_t* out_img) {
  if (len < 16) return -1;
  int tmpl = payload[0], mode = payload[1];
  int n_stripes = payload[2] | (payload[3] << 8);
  int32_t stripe_rows;
  std::memcpy(&stripe_rows, payload + 4, 4);
  int n_lanes = payload[8], q_def = payload[9];
  int n_tr = payload[10] | (payload[11] << 8);
  int bm_mode = payload[12], rice_k = payload[13];
  int bm_len = payload[14] | (payload[15] << 8);
  if ((tmpl != 10 && tmpl != 12) || mode != 2 || n_stripes < 1 ||
      stripe_rows < 1 || n_lanes < 1 || q_def > 63 || n_tr > 4096 ||
      bm_mode > 1 || rice_k > 12)
    return -1;
  if ((long)(n_stripes - 1) * stripe_rows >= rows ||
      (long)n_stripes * stripe_rows < rows)
    return -1;
  long off = 16;
  if (len < off + bm_len) return -1;
  const uint8_t* bm = payload + off;
  // transmitted context ids: raw bitmap or Rice-coded gaps
  std::vector<int> ids;
  ids.reserve((size_t)n_tr);
  if (bm_mode == 0) {
    if (bm_len != 512) return -1;
    for (int c = 0; c < 4096; ++c)
      if ((bm[c >> 3] >> (7 - (c & 7))) & 1) ids.push_back(c);
  } else {
    long bp = 0, bmax = (long)bm_len * 8;
    int prev = -1;
    for (int i = 0; i < n_tr; ++i) {
      uint32_t low = 0;
      for (int k = 0; k < rice_k; ++k, ++bp) {
        if (bp >= bmax) return -1;
        low = (low << 1) | ((bm[bp >> 3] >> (7 - (bp & 7))) & 1);
      }
      uint32_t high = 0;
      while (true) {
        if (bp >= bmax) return -1;
        int b = (bm[bp >> 3] >> (7 - (bp & 7))) & 1;
        ++bp;
        if (b) break;
        ++high;
      }
      prev = prev + 1 + (int)((high << rice_k) | low);
      if (prev >= 4096) return -1;
      ids.push_back(prev);
    }
  }
  if ((int)ids.size() != n_tr) return -1;
  off += bm_len;
  long code_bytes = ((long)n_tr * 6 + 7) / 8;
  if (len < off + code_bytes) return -1;
  const uint8_t* cb = payload + off;
  std::vector<uint16_t> table(4096, scab::RANS_LOGIT64[q_def]);
  long bitpos = 0;
  for (int c : ids) {
    uint32_t q = 0;
    for (int k = 0; k < 6; ++k, ++bitpos)
      q = (q << 1) | ((cb[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
    table[c] = scab::RANS_LOGIT64[q];
  }
  off += code_bytes;
  if (len < off + 4L * n_stripes) return -1;
  std::vector<uint32_t> lens(n_stripes);
  std::memcpy(lens.data(), payload + off, 4L * n_stripes);
  off += 4L * n_stripes;
  std::vector<long> offs(n_stripes);
  for (int s = 0; s < n_stripes; ++s) {
    offs[s] = off;
    off += lens[s];
    if (lens[s] < 4L * n_lanes || off > len) return -1;
  }
  scab::run_stripes(n_stripes, [&](int s) {
    int top = s * stripe_rows;
    int bot = std::min(rows, top + stripe_rows);
    if (tmpl == 10)
      scab::decode_stripe_rans<10>(payload + offs[s], lens[s],
                                   table.data(), n_lanes, out_img,
                                   rows, cols, top, bot);
    else
      scab::decode_stripe_rans<12>(payload + offs[s], lens[s],
                                   table.data(), n_lanes, out_img,
                                   rows, cols, top, bot);
  });
  return 0;
}

}  // extern "C"
