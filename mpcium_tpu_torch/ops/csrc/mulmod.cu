// Batched a·b mod m and whole exponentiations for the GG18 Paillier /
// ring-Pedersen widths (sm_90a).
//
// Replaces the TPU kernel mpcium_tpu/ops/pallas_mulmod.py:_mulmod_kernel
// (launched by pl.pallas_call in _mulmod_call) and the exponent loops
// that the JAX package runs around it (mpcium_tpu/ops/modmul.py
// _k_powmod, _k_powmod_digits, _k_powmod_fb: one kernel call per step).
// Same function: for normalized 7-bit little-endian int32 limbs of row
// width n, the canonical limbs of a·b mod m (or x^e mod m), zero-padded
// to n. The JAX kernel is exact for a·b < R^occ·m (R = 2^7, occ = limbs
// of m), operands above m included; this kernel is exact for every pair
// of normalized n-limb operands, a superset of that domain.
//
// What bounds it on an H100: 32-bit integer multiply-add throughput, not
// bytes (a 4096-bit row moves ~7 KB per exponentiation step against ~33k
// word products), with few rows to hide latency (the signing path gives
// it 1,024 rows for 132 SMs, ~8 an SM). The design keeps every row busy
// on its own warp and takes the serial work out of the step:
//
// - One warp per row, the row in registers. m has k words; each lane
//   holds W = ceil(k/32) consecutive 32-bit words (lane L: words
//   L·W .. L·W+W-1) of the accumulator and of each operand, so a row is
//   s = 32·W words (W = 1, 2, 4 for 1024-, 2048- and 4096-bit moduli).
//   WARPS rows share a block; a step has no __syncthreads and writes no
//   partial product to shared memory.
// - Montgomery multiplication in radix 2^32 (CIOS, R = 2^(32s)), every
//   modulus being odd (Paillier N, N², p, q, p², q², ring-Pedersen Ñ).
//   Iteration i broadcasts word a_i (a shuffle from the lane that holds
//   it, or a shared-memory broadcast for a staged operand), each lane
//   runs its W-word multiply-add chain for a_i·b, lane 0 forms
//   q_i = t_0·m' (m' = -m^-1 mod 2^32), broadcast by a shuffle, each lane
//   runs its chain for q_i·m, and the row shifts down one word by a
//   shuffle. A lane's carry out of its top word stays pending (carry-save,
//   at most 2 after the shift) and joins the next lane's bottom word at
//   the following shift, so no carry crosses the warp inside the loop.
// - After the last iteration the pending carries are resolved by a
//   warp-parallel carry: each lane adds the carry of the lane below, then
//   generate (carry out) and propagate (all ones) bits gathered with
//   __ballot_sync give every lane its carry in by one 32-bit addition
//   (carry lookahead). The conditional subtraction of m uses the same
//   lookahead for its borrow. Each step ends canonical, in [0, m).
//
// Entry and exit stay exact for every normalized row: a row of n limbs
// spans kw = ceil(7n/32) >= k words (133 against 128 at n=608), staged
// in shared memory and streamed into the CIOS loop word by word (kw
// iterations, so every bit counts) against a host constant C < m:
// mont_kw(a, C) = a·C·2^(-32kw) mod m. The host passes, per modulus,
// consts = (m, 2^(64kw) mod m, 2^(32(kw+s)) mod m), each s words, and m'.
//
// Two kernels:
// - mulmod_kernel: p = mont_kw(a, 2^(64kw)) = a·2^(32kw), then
//   mont_kw(b, p) = a·b mod m; unpack.
// - powmod_kernel: a whole exponentiation in one launch, the row in
//   registers from the first step to the last. Three modes:
//     MODE_ROW    per-row 4-bit window digits (rows, nwin), variable base;
//     MODE_SHARED one digit array for every row (digit stride 0);
//     MODE_COMB   fixed-base comb: the row's 8-bit digit d_i picks the
//                 canonical entry base^(2^(8i)·d_i) of a word table
//                 (nwin, 256, k) in device memory, one multiply a window.
//   ROW and SHARED enter with x·R = mont_kw(x, 2^(32(kw+s))) (the step
//   that reduces x, so an unreduced base is exact), build the 16-entry
//   window table x^j·R in shared memory (16·s words a row, each lane's
//   own words interleaved so the reads are conflict-free), run 4
//   squarings and, for a non-zero digit, one multiply per window below
//   the top non-zero one, and leave Montgomery form by one multiply by 1.
//   COMB multiplies canonical entries: each of its nz-1 multiplies leaves
//   a factor R^-1, removed at the end by one multiply by R^nz mod m (a
//   host table rpow of R^j mod m, s words a row). The next non-zero
//   window's entry is loaded into registers (16-byte loads a lane at
//   4096 bits) before the current multiply, so its latency hides behind
//   the multiply. Digits are least significant first; e = 0 gives 1.
// Measured on the H100 (PERF.md): the hot loops issue 6 to 8 SASS
// instructions per 64-bit multiply-add (the carry adds, moves and
// shuffles around each product; scripts/torch_k0_ab.py --sass), which
// leaves K0 at about a third of its multiply-add bound. Later work: the
// reduction half q·m on tensor cores (int8 wgmma against m's Toeplitz
// matrix, the rows of a block in lockstep) and a dedicated squaring.
//
// C entry points (ctypes): each returns cudaGetLastError() after the
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

#define KMAX 136      // words of the widest row (n <= 608 limbs)
#define WMAX 5        // words a lane holds: k <= 32·WMAX
#define STAGE 160     // staged words a row: max(kw, s) <= 32·WMAX
#define WARPS 4       // rows (one warp each) per block
#define LIMB_BITS 7
#define MODE_ROW 0
#define MODE_SHARED 1
#define MODE_COMB 2
#define COMB_ROWS 256  // entries per comb window (8-bit digits)
#define FULL 0xffffffffu

// The modulus as one lane holds it: its W words of m, and m'.
template <int W>
struct Mod {
  uint32_t m[W];
  uint32_t mp;
};

// One CIOS iteration, (t, c) <- (t + ai·b + q·m) / 2^32 over the warp.
// c is the lane's pending carry into the next lane's bottom word.
template <int W>
__device__ __forceinline__ void mont_iter(uint32_t ai, const uint32_t (&b)[W],
                                          const Mod<W> &md, uint32_t (&t)[W],
                                          uint32_t &c, int lane) {
  uint32_t cy = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const uint64_t p = (uint64_t)ai * b[j] + t[j] + cy;
    t[j] = (uint32_t)p;
    cy = (uint32_t)(p >> 32);
  }
  // t_0 is exact: nothing is pending below lane 0
  const uint32_t q = __shfl_sync(FULL, t[0] * md.mp, 0);
  uint32_t cq = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const uint64_t p = (uint64_t)q * md.m[j] + t[j] + cq;
    t[j] = (uint32_t)p;
    cq = (uint32_t)(p >> 32);
  }
  // shift down one word: lane 0's bottom word is now 0 and drops out
  uint32_t up = __shfl_down_sync(FULL, t[0], 1);
  if (lane == 31) up = 0;
  const uint64_t s = (uint64_t)c + cy + cq + up;
#pragma unroll
  for (int j = 0; j + 1 < W; ++j) t[j] = t[j + 1];
  t[W - 1] = (uint32_t)s;
  c = (uint32_t)(s >> 32);
}

// Carry lookahead over the warp: the carry into each lane from generate
// bits g and propagate bits p (one per lane), and the carry out of lane
// 31. Lane L's carry is the carry into bit L of (g|p) + g.
__device__ __forceinline__ uint32_t lookahead(bool g, bool p, uint32_t &out) {
  const uint32_t G = __ballot_sync(FULL, g), P = __ballot_sync(FULL, p);
  const uint64_t S = (uint64_t)(G | P) + G;
  out = (uint32_t)(S >> 32);
  return (uint32_t)S ^ (G | P) ^ G;
}

// The end of a Montgomery product: resolve the pending carries (the
// value is then below 2m) and subtract m once if the value reaches it.
template <int W>
__device__ __forceinline__ void mont_finish(uint32_t (&t)[W], uint32_t c,
                                            const Mod<W> &md, int lane) {
  uint32_t cin = __shfl_up_sync(FULL, c, 1);
  if (lane == 0) cin = 0;
  uint32_t top = __shfl_sync(FULL, c, 31);  // the words above s
  uint64_t s = cin;
  bool ones = true;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    s += t[j];
    t[j] = (uint32_t)s;
    s >>= 32;
    ones &= t[j] == FULL;
  }
  uint32_t cout;
  uint32_t k = (lookahead(s != 0, ones, cout) >> lane) & 1;
  top += cout;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const uint64_t v = (uint64_t)t[j] + k;
    t[j] = (uint32_t)v;
    k = (uint32_t)(v >> 32);
  }
  // d = t - m, borrows by the same lookahead
  uint32_t d[W], br = 0;
  bool zero = true;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const uint64_t v = (uint64_t)t[j] - md.m[j] - br;
    d[j] = (uint32_t)v;
    br = (uint32_t)(v >> 63);
    zero &= d[j] == 0;
  }
  uint32_t bout;
  br = (lookahead(br != 0, zero, bout) >> lane) & 1;
  if (top || !bout) {  // value >= m (warp-uniform)
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const uint64_t v = (uint64_t)d[j] - br;
      t[j] = (uint32_t)v;
      br = (uint32_t)(v >> 63);
    }
  }
}

// out = a·b·R^-1 mod m, a and b canonical rows in registers; out may be
// a or b.
template <int W>
__device__ __forceinline__ void mont_mul(const uint32_t (&a)[W], const uint32_t (&b)[W],
                                         const Mod<W> &md, uint32_t (&out)[W], int lane) {
  uint32_t t[W], c = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) t[j] = 0;
  for (int l = 0; l < 32; ++l) {
#pragma unroll
    for (int w = 0; w < W; ++w) mont_iter<W>(__shfl_sync(FULL, a[w], l), b, md, t, c, lane);
  }
  mont_finish<W>(t, c, md, lane);
#pragma unroll
  for (int j = 0; j < W; ++j) out[j] = t[j];
}

// out = a·b·2^(-32·na) mod m for a staged row a of na words (any value
// below 2^(32·na)) and b < m in registers; out may be b.
template <int W>
__device__ __forceinline__ void mont_stream(const uint32_t *a, int na, const uint32_t (&b)[W],
                                            const Mod<W> &md, uint32_t (&out)[W], int lane) {
  uint32_t t[W], c = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) t[j] = 0;
  for (int i = 0; i < na; ++i) mont_iter<W>(a[i], b, md, t, c, lane);
  mont_finish<W>(t, c, md, lane);
#pragma unroll
  for (int j = 0; j < W; ++j) out[j] = t[j];
}

// A lane's W words of a k-word row in device memory (zero from word k):
// one 16- or 8-byte load when the row fills the warp.
template <int W>
__device__ __forceinline__ void load_words(const uint32_t *src, int k, uint32_t (&r)[W], int lane) {
  if constexpr (W % 4 == 0) {
    if (k == 32 * W) {
#pragma unroll
      for (int j = 0; j < W; j += 4) {
        const uint4 v = reinterpret_cast<const uint4 *>(src + lane * W + j)[0];
        r[j] = v.x, r[j + 1] = v.y, r[j + 2] = v.z, r[j + 3] = v.w;
      }
      return;
    }
  }
  if constexpr (W % 2 == 0) {
    if (k == 32 * W) {
#pragma unroll
      for (int j = 0; j < W; j += 2) {
        const uint2 v = reinterpret_cast<const uint2 *>(src + lane * W + j)[0];
        r[j] = v.x, r[j + 1] = v.y;
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < W; ++j) r[j] = lane * W + j < k ? src[lane * W + j] : 0;
}

// 7-bit limbs of one row (n of them) -> kw 32-bit words, by the warp.
__device__ void repack(const int *row, int n, int kw, uint32_t *Wd, int lane) {
  for (int w = lane; w < kw; w += 32) {
    uint64_t v = 0;
    const int bit0 = 32 * w;
    const int l0 = bit0 / LIMB_BITS;
    int l1 = (bit0 + 31) / LIMB_BITS;
    if (l1 > n - 1) l1 = n - 1;
    for (int l = l0; l <= l1; ++l) {
      const int sh = LIMB_BITS * l - bit0;
      const uint64_t lv = (uint32_t)row[l];
      v |= sh >= 0 ? lv << sh : lv >> (-sh);
    }
    Wd[w] = (uint32_t)v;
  }
}

// A canonical row in registers -> n 7-bit limbs, through the warp's
// staging buffer.
template <int W>
__device__ void unpack(const uint32_t (&r)[W], uint32_t *sh, int *orow, int n, int lane) {
  constexpr int S = 32 * W;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < W; ++j) sh[lane * W + j] = r[j];
  __syncwarp();
  for (int l = lane; l < n; l += 32) {
    const int bit = LIMB_BITS * l;
    const int w = bit >> 5, s = bit & 31;
    uint64_t v = 0;
    if (w < S) v = sh[w];
    if (w + 1 < S) v |= (uint64_t)sh[w + 1] << 32;
    orow[l] = (int)((v >> s) & ((1u << LIMB_BITS) - 1));
  }
}

template <int W>
__global__ void __launch_bounds__(32 * WARPS)
mulmod_kernel(const int *__restrict__ a, const int *__restrict__ b, int *__restrict__ out,
              const uint32_t *__restrict__ consts, uint32_t mp, int rows, int n, int kw) {
  constexpr int S = 32 * W;
  __shared__ uint32_t SA[WARPS][STAGE], SB[WARPS][STAGE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row = (size_t)blockIdx.x * WARPS + warp;
  if (row >= (size_t)rows) return;
  Mod<W> md;
  load_words<W>(consts, S, md.m, lane);
  md.mp = mp;
  uint32_t p[W];
  load_words<W>(consts + S, S, p, lane);  // 2^(64kw) mod m
  repack(a + row * n, n, kw, SA[warp], lane);
  repack(b + row * n, n, kw, SB[warp], lane);
  __syncwarp();
  mont_stream<W>(SA[warp], kw, p, md, p, lane);  // a·2^(32kw) mod m
  mont_stream<W>(SB[warp], kw, p, md, p, lane);  // a·b mod m
  unpack<W>(p, SA[warp], out + row * n, n, lane);
}

__device__ __forceinline__ int next_digit(const int *d, int i, int top, int dmask) {
  do ++i;
  while (i <= top && !(d[i] & dmask));
  return i;
}

template <int W>
__global__ void __launch_bounds__(32 * WARPS)
powmod_kernel(const int *__restrict__ x, const int *__restrict__ digits, int dstride, int nwin,
              const uint32_t *__restrict__ table, const uint32_t *__restrict__ rpow,
              int *__restrict__ out, const uint32_t *__restrict__ consts, uint32_t mp, int rows,
              int n, int k, int kw, int mode) {
  constexpr int S = 32 * W;
  __shared__ uint32_t T[WARPS][16][S];  // x^j·R mod m: lane l's word w at [j][32w + l]
  __shared__ uint32_t SX[WARPS][STAGE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row = (size_t)blockIdx.x * WARPS + warp;
  if (row >= (size_t)rows) return;
  const int *d = digits + row * dstride;
  const int dmask = mode == MODE_COMB ? COMB_ROWS - 1 : 15;
  // the top non-zero window and the count of non-zero windows
  int top = -1, nz = 0;
  for (int i = lane; i < nwin; i += 32)
    if (d[i] & dmask) top = i, ++nz;
  top = __reduce_max_sync(FULL, top);
  nz = __reduce_add_sync(FULL, nz);

  Mod<W> md;
  load_words<W>(consts, S, md.m, lane);
  md.mp = mp;
  uint32_t acc[W];
#pragma unroll
  for (int j = 0; j < W; ++j) acc[j] = lane == 0 && j == 0;  // e = 0: 1
  if (top >= 0 && mode == MODE_COMB) {
    auto entry = [&](int i) { return table + ((size_t)i * COMB_ROWS + (d[i] & dmask)) * k; };
    const int first = next_digit(d, -1, top, dmask);
    load_words<W>(entry(first), k, acc, lane);
    int j = next_digit(d, first, top, dmask);
    uint32_t nxt[W];
    if (j <= top) load_words<W>(entry(j), k, nxt, lane);
    while (j <= top) {
      uint32_t cur[W];
#pragma unroll
      for (int w = 0; w < W; ++w) cur[w] = nxt[w];
      const int j2 = next_digit(d, j, top, dmask);
      if (j2 <= top) load_words<W>(entry(j2), k, nxt, lane);  // in flight during the multiply
      mont_mul<W>(acc, cur, md, acc, lane);
      j = j2;
    }
    if (nz > 1) {  // acc = product·R^-(nz-1): one multiply by R^nz
      uint32_t rp[W];
      load_words<W>(rpow + (size_t)nz * S, S, rp, lane);
      mont_mul<W>(acc, rp, md, acc, lane);
    }
  } else if (top >= 0) {
    uint32_t(*Tw)[S] = T[warp];
    uint32_t x1[W];
    load_words<W>(consts + 2 * S, S, x1, lane);  // 2^(32(kw+s)) mod m
    repack(x + row * n, n, kw, SX[warp], lane);
    __syncwarp();
    mont_stream<W>(SX[warp], kw, x1, md, x1, lane);  // x·R mod m
#pragma unroll
    for (int w = 0; w < W; ++w) Tw[1][32 * w + lane] = acc[w] = x1[w];
    for (int e = 2; e < 16; ++e) {
      mont_mul<W>(acc, x1, md, acc, lane);
#pragma unroll
      for (int w = 0; w < W; ++w) Tw[e][32 * w + lane] = acc[w];
    }
    const int dt = d[top] & dmask;
#pragma unroll
    for (int w = 0; w < W; ++w) acc[w] = Tw[dt][32 * w + lane];
    for (int i = top - 1; i >= 0; --i) {
      const int di = d[i] & dmask;  // loaded ahead of the squarings
      for (int q = 0; q < 4; ++q) mont_mul<W>(acc, acc, md, acc, lane);
      if (di) {
        uint32_t f[W];
#pragma unroll
        for (int w = 0; w < W; ++w) f[w] = Tw[di][32 * w + lane];
        mont_mul<W>(acc, f, md, acc, lane);
      }
    }
    uint32_t one[W];
#pragma unroll
    for (int w = 0; w < W; ++w) one[w] = lane == 0 && w == 0;
    mont_mul<W>(acc, one, md, acc, lane);  // out of Montgomery form
  }
  unpack<W>(acc, SX[warp], out + row * n, n, lane);
}

static int bad_width(int n, int k) {
  const int kw = (LIMB_BITS * n + 31) / 32;
  return k < 1 || kw < k || kw > KMAX || k > 32 * WMAX;
}

static inline int blocks(int rows) { return (rows + WARPS - 1) / WARPS; }

// consts: (3, s) words, s = 32·ceil(k/32): m, 2^(64kw) mod m,
// 2^(32(kw+s)) mod m; mp = -m^-1 mod 2^32 (m odd).
extern "C" int mpcium_mulmod(const int *a, const int *b, int *out, const unsigned *consts,
                             unsigned mp, int rows, int n, int k, void *stream) {
  if (bad_width(n, k) || rows < 1) return (int)cudaErrorInvalidValue;
  const int kw = (LIMB_BITS * n + 31) / 32;
  const cudaStream_t st = (cudaStream_t)stream;
  const uint32_t *cw = (const uint32_t *)consts;
  switch ((k + 31) / 32) {
#define MULMOD_CASE(W) \
  case W: mulmod_kernel<W><<<blocks(rows), 32 * WARPS, 0, st>>>(a, b, out, cw, mp, rows, n, kw); break;
    MULMOD_CASE(1) MULMOD_CASE(2) MULMOD_CASE(3) MULMOD_CASE(4) MULMOD_CASE(5)
#undef MULMOD_CASE
  }
  return (int)cudaGetLastError();
}

// x: (rows, n) limbs (ROW, SHARED) or NULL (COMB); digits: int32, row
// stride dstride (0 for SHARED), nwin per row, least significant first;
// table: (nwin, 256, k) canonical words (COMB) or NULL; rpow: (>= nwin+1,
// s) words of R^j mod m (COMB) or NULL; consts and mp as for mulmod.
extern "C" int mpcium_powmod(const int *x, const int *digits, const unsigned *table,
                             const unsigned *rpow, int *out, const unsigned *consts,
                             unsigned mp, int rows, int n, int k, int nwin, int dstride,
                             int mode, void *stream) {
  if (bad_width(n, k) || rows < 1 || nwin < 0 || dstride < 0 || !digits ||
      mode < MODE_ROW || mode > MODE_COMB ||
      (mode == MODE_COMB) != (table != nullptr) ||
      (mode == MODE_COMB) != (rpow != nullptr) ||
      (mode == MODE_COMB) == (x != nullptr))
    return (int)cudaErrorInvalidValue;
  const int kw = (LIMB_BITS * n + 31) / 32;
  const cudaStream_t st = (cudaStream_t)stream;
  const uint32_t *cw = (const uint32_t *)consts;
  const uint32_t *tw = (const uint32_t *)table, *rw = (const uint32_t *)rpow;
  switch ((k + 31) / 32) {
#define POWMOD_CASE(W)                                                                     \
  case W:                                                                                  \
    powmod_kernel<W><<<blocks(rows), 32 * WARPS, 0, st>>>(x, digits, dstride, nwin, tw, rw, \
                                                          out, cw, mp, rows, n, k, kw,      \
                                                          mode);                            \
    break;
    POWMOD_CASE(1) POWMOD_CASE(2) POWMOD_CASE(3) POWMOD_CASE(4) POWMOD_CASE(5)
#undef POWMOD_CASE
  }
  return (int)cudaGetLastError();
}
