// Batched SHA-256 / SHA-512 over fixed-width rows, and the OT-MtA host
// extension's hot loops (PRG expansion, packed bit transpose, in-place
// xor).
//
// The port's own copy of mpcium_tpu/native/batch_hash.cpp: the same
// entry points, the same threading and the same bytes. The engines' host
// hash points hash B independent fixed-width rows per round; Python's
// per-row hashlib loop costs ~1-2 us of interpreter overhead per row, and
// this C++ path does the whole batch in one call (threaded across rows).
// Implementations follow FIPS 180-4 directly.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libbatchhash.so batch_hash.cpp
// -lpthread (mpcium_tpu_torch.native builds it at its first call, into
// build/mpcium_tpu_torch/).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- SHA-256

inline uint32_t rotr32(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

const uint32_t K256[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

void sha256_blocks(uint32_t h[8], const uint8_t* data, size_t n_blocks) {
  for (size_t b = 0; b < n_blocks; ++b) {
    uint32_t w[64];
    for (int i = 0; i < 16; ++i)
      w[i] = (uint32_t(data[b * 64 + 4 * i]) << 24) |
             (uint32_t(data[b * 64 + 4 * i + 1]) << 16) |
             (uint32_t(data[b * 64 + 4 * i + 2]) << 8) |
             uint32_t(data[b * 64 + 4 * i + 3]);
    for (int i = 16; i < 64; ++i) {
      uint32_t s0 = rotr32(w[i - 15], 7) ^ rotr32(w[i - 15], 18) ^ (w[i - 15] >> 3);
      uint32_t s1 = rotr32(w[i - 2], 17) ^ rotr32(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], bb = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
             g = h[6], hh = h[7];
    for (int i = 0; i < 64; ++i) {
      uint32_t S1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + S1 + ch + K256[i] + w[i];
      uint32_t S0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
      uint32_t mj = (a & bb) ^ (a & c) ^ (bb & c);
      uint32_t t2 = S0 + mj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = bb; bb = a; a = t1 + t2;
    }
    h[0] += a; h[1] += bb; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }
}

void sha256_one(const uint8_t* msg, size_t len, uint8_t out[32]) {
  uint32_t h[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                   0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  size_t full = len / 64;
  sha256_blocks(h, msg, full);
  uint8_t tail[128] = {0};
  size_t rem = len - full * 64;
  std::memcpy(tail, msg + full * 64, rem);
  tail[rem] = 0x80;
  size_t tail_blocks = (rem + 9 <= 64) ? 1 : 2;
  uint64_t bits = uint64_t(len) * 8;
  for (int i = 0; i < 8; ++i)
    tail[tail_blocks * 64 - 1 - i] = uint8_t(bits >> (8 * i));
  sha256_blocks(h, tail, tail_blocks);
  for (int i = 0; i < 8; ++i) {
    out[4 * i] = uint8_t(h[i] >> 24);
    out[4 * i + 1] = uint8_t(h[i] >> 16);
    out[4 * i + 2] = uint8_t(h[i] >> 8);
    out[4 * i + 3] = uint8_t(h[i]);
  }
}

// ---------------------------------------------------------------- SHA-512

inline uint64_t rotr64(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

const uint64_t K512[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL,
    0xe9b5dba58189dbbcULL, 0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL,
    0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL, 0xd807aa98a3030242ULL,
    0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL,
    0xc19bf174cf692694ULL, 0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL,
    0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL, 0x2de92c6f592b0275ULL,
    0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL,
    0xbf597fc7beef0ee4ULL, 0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL,
    0x06ca6351e003826fULL, 0x142929670a0e6e70ULL, 0x27b70a8546d22ffcULL,
    0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL,
    0x92722c851482353bULL, 0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL,
    0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL, 0xd192e819d6ef5218ULL,
    0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL,
    0x34b0bcb5e19b48a8ULL, 0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL,
    0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL, 0x748f82ee5defb2fcULL,
    0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL,
    0xc67178f2e372532bULL, 0xca273eceea26619cULL, 0xd186b8c721c0c207ULL,
    0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL, 0x06f067aa72176fbaULL,
    0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL,
    0x431d67c49c100d4cULL, 0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL,
    0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL};

void sha512_blocks(uint64_t h[8], const uint8_t* data, size_t n_blocks) {
  for (size_t b = 0; b < n_blocks; ++b) {
    uint64_t w[80];
    for (int i = 0; i < 16; ++i) {
      uint64_t v = 0;
      for (int j = 0; j < 8; ++j) v = (v << 8) | data[b * 128 + 8 * i + j];
      w[i] = v;
    }
    for (int i = 16; i < 80; ++i) {
      uint64_t s0 = rotr64(w[i - 15], 1) ^ rotr64(w[i - 15], 8) ^ (w[i - 15] >> 7);
      uint64_t s1 = rotr64(w[i - 2], 19) ^ rotr64(w[i - 2], 61) ^ (w[i - 2] >> 6);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint64_t a = h[0], bb = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
             g = h[6], hh = h[7];
    for (int i = 0; i < 80; ++i) {
      uint64_t S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
      uint64_t ch = (e & f) ^ (~e & g);
      uint64_t t1 = hh + S1 + ch + K512[i] + w[i];
      uint64_t S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
      uint64_t mj = (a & bb) ^ (a & c) ^ (bb & c);
      uint64_t t2 = S0 + mj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = bb; bb = a; a = t1 + t2;
    }
    h[0] += a; h[1] += bb; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }
}

void sha512_one(const uint8_t* msg, size_t len, uint8_t out[64]) {
  uint64_t h[8] = {0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL,
                   0x3c6ef372fe94f82bULL, 0xa54ff53a5f1d36f1ULL,
                   0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
                   0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};
  size_t full = len / 128;
  sha512_blocks(h, msg, full);
  uint8_t tail[256] = {0};
  size_t rem = len - full * 128;
  std::memcpy(tail, msg + full * 128, rem);
  tail[rem] = 0x80;
  size_t tail_blocks = (rem + 17 <= 128) ? 1 : 2;
  uint64_t bits = uint64_t(len) * 8;  // < 2^64; high 64 bits stay zero
  for (int i = 0; i < 8; ++i)
    tail[tail_blocks * 128 - 1 - i] = uint8_t(bits >> (8 * i));
  sha512_blocks(h, tail, tail_blocks);
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j)
      out[8 * i + j] = uint8_t(h[i] >> (56 - 8 * j));
}

// Thread count: MPCIUM_NATIVE_THREADS pins it (1 = deterministic
// single-thread mode, checked per call so tests can flip it);
// otherwise hardware_concurrency. Every parallelized loop writes
// disjoint output ranges, so results are bit-identical at any count.
unsigned resolve_threads() {
  const char* env = std::getenv("MPCIUM_NATIVE_THREADS");
  if (env && *env) {
    long v = std::strtol(env, nullptr, 10);
    if (v >= 1) return unsigned(v);
  }
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : n;
}

template <typename F>
void parallel_rows(size_t rows, F fn) {
  unsigned n_threads = resolve_threads();
  if (n_threads == 1 || rows < 256) {
    // single-thread pin, or below the point where spawn costs more
    // than it saves
    for (size_t i = 0; i < rows; ++i) fn(i);
    return;
  }
  std::vector<std::thread> ts;
  size_t per = (rows + n_threads - 1) / n_threads;
  for (unsigned t = 0; t < n_threads; ++t) {
    size_t lo = t * per, hi = std::min(rows, lo + per);
    if (lo >= hi) break;
    ts.emplace_back([=]() {
      for (size_t i = lo; i < hi; ++i) fn(i);
    });
  }
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// rows: B rows of row_len bytes, prefixed per-call with `prefix`
// (prefix_len bytes, shared across rows). out: B × 32 (or 64) bytes.
void batch_sha256(const uint8_t* prefix, size_t prefix_len,
                  const uint8_t* rows, size_t row_len, size_t n_rows,
                  uint8_t* out) {
  parallel_rows(n_rows, [=](size_t i) {
    std::vector<uint8_t> buf(prefix_len + row_len);
    std::memcpy(buf.data(), prefix, prefix_len);
    std::memcpy(buf.data() + prefix_len, rows + i * row_len, row_len);
    sha256_one(buf.data(), buf.size(), out + i * 32);
  });
}

void batch_sha512(const uint8_t* prefix, size_t prefix_len,
                  const uint8_t* rows, size_t row_len, size_t n_rows,
                  uint8_t* out) {
  parallel_rows(n_rows, [=](size_t i) {
    std::vector<uint8_t> buf(prefix_len + row_len);
    std::memcpy(buf.data(), prefix, prefix_len);
    std::memcpy(buf.data() + prefix_len, rows + i * row_len, row_len);
    sha512_one(buf.data(), buf.size(), out + i * 64);
  });
}

// Packed bit-matrix transpose (the OT-MtA host hot path). `packed` is
// the (kappa, m/8) extension matrix with numpy little-bitorder packing:
// bit j of row r is (packed[r][j>>3]>>(j&7))&1. Row j of `out` is the
// kappa column bits re-packed LE into kappa/8 bytes -- the per-OT
// "t row" whose prefixed hash makes the pad. The python equivalent
// materializes the unpacked (kappa, m) byte matrix plus a
// cache-hostile strided transpose copy (~130 MB per leg at m = 2^20);
// this walks the packed matrix directly and writes m*kappa/8 bytes
// once. Row hashing (with per-payload-set prefixes) rides
// batch_sha256, so a multi-set extension pays the transpose exactly
// once however many pad domains it derives.
// Fused PRG expansion (the OT-MtA host hot path next to the
// transpose). Each 32-byte seed row j expands to n_blocks SHA-256
// blocks: out[j][b] = sha256(prefix || seed_j || le16(j) ||
// le32(blk_off + b)). Identical stream to mta_ot._prg's numpy
// fallback, which materializes the full (n_seeds * n_blocks, 38)
// message matrix before hashing; this builds each 38-byte message in
// a thread-local stack buffer. blk_off lets a chunked pipeline expand
// a block sub-range that concatenates bit-exactly with its
// neighbours.
void prg_expand(const uint8_t* prefix, size_t prefix_len,
                const uint8_t* seeds, size_t n_seeds, size_t n_blocks,
                size_t blk_off, uint8_t* out) {
  parallel_rows(n_seeds * n_blocks, [=](size_t i) {
    const size_t j = i / n_blocks;
    const uint32_t blk = uint32_t(blk_off + i % n_blocks);
    std::vector<uint8_t> buf(prefix_len + 38);
    std::memcpy(buf.data(), prefix, prefix_len);
    std::memcpy(buf.data() + prefix_len, seeds + j * 32, 32);
    buf[prefix_len + 32] = uint8_t(j);
    buf[prefix_len + 33] = uint8_t(j >> 8);
    for (int k = 0; k < 4; ++k)
      buf[prefix_len + 34 + k] = uint8_t(blk >> (8 * k));
    sha256_one(buf.data(), buf.size(), out + i * 32);
  });
}

// In-place dst ^= src over n bytes, threaded in 64 KiB stripes. The
// OT-MtA masking legs (y0/y1 ^= pad, t0^t1, pad ^= payload) otherwise
// materialize a fresh ~M x 32 numpy temporary per xor.
void xor_rows(uint8_t* dst, const uint8_t* src, size_t n) {
  const size_t stripe = size_t(1) << 16;
  const size_t n_stripes = (n + stripe - 1) / stripe;
  parallel_rows(n_stripes, [=](size_t i) {
    const size_t lo = i * stripe;
    const size_t hi = lo + stripe < n ? lo + stripe : n;
    for (size_t k = lo; k < hi; ++k) dst[k] ^= src[k];
  });
}

// dst[r] ^= row for every one of n_rows rows (the U ^= r_packed
// broadcast leg).
void xor_bcast_row(uint8_t* dst, const uint8_t* row, size_t n_rows,
                   size_t row_len) {
  parallel_rows(n_rows, [=](size_t r) {
    uint8_t* d = dst + r * row_len;
    for (size_t k = 0; k < row_len; ++k) d[k] ^= row[k];
  });
}

// The thread count every threaded entry resolves right now (the
// MPCIUM_NATIVE_THREADS pin, else hardware_concurrency), for reports.
unsigned native_threads() { return resolve_threads(); }

void ot_transpose(const uint8_t* packed, size_t kappa, size_t m,
                  uint8_t* out) {
  const size_t kb = kappa / 8;
  const size_t mb = (m + 7) / 8;
  parallel_rows(m, [=](size_t j) {
    uint8_t* trow = out + j * kb;
    const size_t jb = j >> 3;
    const int js = int(j & 7);
    for (size_t t = 0; t < kb; ++t) {
      uint8_t byte = 0;
      const uint8_t* col = packed + (8 * t) * mb + jb;
      for (int s = 0; s < 8; ++s)
        byte |= uint8_t((col[size_t(s) * mb] >> js) & 1) << s;
      trow[t] = byte;
    }
  });
}

}  // extern "C"
