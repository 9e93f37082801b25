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
// What bounds it on an H100: integer multiply throughput, not bytes. A
// 4096-bit row moves 3·608·4 bytes but needs ~41k 32x32->64 word
// products (the a·b product, the q1·mu and q3·m Barrett legs); at B=1024
// that is ~7.5 MB against ~85 M multiplies. The design therefore drops
// the 7-bit form for the arithmetic: each block repacks its row into
// 32-bit words in shared memory (64 words at 2048 bits, 128 at 4096),
// which takes ~21x fewer multiplies than 7-bit limbs at 4096 bits, and
// runs Barrett reduction in radix 2^32 (HAC 14.42) with mu and m as word
// arrays the host prepares once per modulus.
//
// Widths: m has k words; a row of n limbs spans kw = ceil(7n/32) >= k
// words. The host passes mu = floor(2^(64·kw) / m) (2kw-k+1 words). A
// product whose operands both fit in k words (every reduced operand)
// runs Barrett at width k with mu's top k+1 words, which are exactly
// floor(2^(64k) / m); one with any bit at or above word k runs it at
// width kw with the whole of mu. Either way x = a·b < 2^(64·width), so
// the quotient estimate is at most 2 short and two conditional
// subtractions finish the reduction.
//
// Layout: one block of 128 threads per row. mulmod_words is one modular
// multiply of word rows already in shared memory: column sums formed in
// parallel (a thread per column, 64-bit multiply-adds into a 72-bit
// accumulator); carries, the Barrett subtraction and the final
// conditional subtractions resolved by one thread.
//
// Two kernels over it:
// - mulmod_kernel: repack a and b, one mulmod_words, unpack.
// - powmod_kernel: a whole exponentiation in one launch. The row stays in
//   words in shared memory from the first step to the last, so the 7-bit
//   repack, the unpack and the HBM round trip happen once per
//   exponentiation, not once per step. Three modes:
//     MODE_ROW    per-row 4-bit window digits (rows, nwin), variable base;
//     MODE_SHARED one digit array for every row (digit stride 0);
//     MODE_COMB   fixed-base comb: the row's 8-bit digit d_i picks the
//                 canonical entry base^(2^(8i)·d_i) of a word table
//                 (nwin, 256, k) in device memory, one multiply a window.
//   ROW and SHARED build the 16-entry window table x^j mod m in shared
//   memory (its first entry reduces x, so an unreduced base is exact),
//   then run 4 squarings and, for a non-zero digit, one multiply per
//   window below the top non-zero one. Digits are least significant
//   first. Every step yields the canonical residue, so the result does
//   not depend on the window schedule. e = 0 gives 1.
// Warpgroup MMA, TMA loads, register-resident rows and a parallel carry
// are later work.
//
// C entry points (ctypes): each returns cudaGetLastError() after the
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

#define KMAX 136      // words of the widest row (n <= 608 limbs)
#define LMAX 160      // words of mu and of the quotient: 2kw-k+1 <= LMAX
#define THREADS 128
#define LIMB_BITS 7
#define MODE_ROW 0
#define MODE_SHARED 1
#define MODE_COMB 2
#define COMB_ROWS 256  // entries per comb window (8-bit digits)

// The modulus, mu and the scratch of one modular multiply (shared memory).
struct Barrett {
  uint32_t M[KMAX], MU[LMAX];
  uint32_t X[2 * KMAX], Q3[LMAX], R[KMAX + 1];
  uint64_t lo[2 * LMAX];
  uint32_t hi[2 * LMAX];
};

__device__ __forceinline__ void mac(uint64_t &lo, uint32_t &hi, uint32_t a,
                                    uint32_t b) {
  uint64_t p = (uint64_t)a * b;
  lo += p;
  hi += (lo < p);
}

// Column sums of x (nx words) times y (ny words), columns [0, ncols).
__device__ void columns(const uint32_t *x, int nx, const uint32_t *y, int ny,
                        int ncols, uint64_t *lo, uint32_t *hi) {
  for (int c = threadIdx.x; c < ncols; c += blockDim.x) {
    uint64_t l = 0;
    uint32_t h = 0;
    int i0 = c - (ny - 1) > 0 ? c - (ny - 1) : 0;
    int i1 = c < nx - 1 ? c : nx - 1;
    for (int i = i0; i <= i1; ++i) mac(l, h, x[i], y[c - i]);
    lo[c] = l;
    hi[c] = h;
  }
}

// Carry the column sums into words; writes words [skip, skip+nout) of
// the result to out[0, nout). One thread.
__device__ void resolve(const uint64_t *lo, const uint32_t *hi, int ncols,
                        uint32_t *out, int skip, int nout) {
  if (threadIdx.x != 0) return;
  uint64_t aLo = 0, aHi = 0;  // 128-bit running carry
  for (int c = 0; c < skip + nout; ++c) {
    if (c < ncols) {
      uint64_t t = aLo + lo[c];
      aHi += (uint64_t)hi[c] + (t < aLo);
      aLo = t;
    }
    if (c >= skip) out[c - skip] = (uint32_t)aLo;
    aLo = (aLo >> 32) | (aHi << 32);
    aHi >>= 32;
  }
}

__device__ void load_consts(Barrett &s, const uint32_t *m, const uint32_t *mu,
                            int k, int kw) {
  for (int w = threadIdx.x; w < k; w += blockDim.x) s.M[w] = m[w];
  for (int w = threadIdx.x; w < 2 * kw - k + 1; w += blockDim.x) s.MU[w] = mu[w];
}

// 7-bit limbs of one row (n of them) -> kw 32-bit words.
__device__ void repack(const int *row, int n, int kw, uint32_t *W) {
  for (int w = threadIdx.x; w < kw; w += blockDim.x) {
    uint64_t v = 0;
    int bit0 = 32 * w;
    int l0 = bit0 / LIMB_BITS;
    int l1 = (bit0 + 31) / LIMB_BITS;
    if (l1 > n - 1) l1 = n - 1;
    for (int l = l0; l <= l1; ++l) {
      int sh = LIMB_BITS * l - bit0;
      uint64_t lv = (uint32_t)row[l];
      v |= sh >= 0 ? lv << sh : lv >> (-sh);
    }
    W[w] = (uint32_t)v;
  }
}

// Canonical words (k of them) -> n 7-bit limbs, zero above the modulus.
__device__ void unpack(const uint32_t *R, int k, int *orow, int n) {
  for (int l = threadIdx.x; l < n; l += blockDim.x) {
    int bit = LIMB_BITS * l;
    int w = bit >> 5, s = bit & 31;
    uint64_t v = 0;
    if (w < k) v = R[w];
    if (w + 1 < k) v |= (uint64_t)R[w + 1] << 32;
    orow[l] = (int)((v >> s) & ((1u << LIMB_BITS) - 1));
  }
}

// out = a·b mod m for rows a, b of kw words in shared memory, every bit
// of them counted; out gets the canonical residue as kw words (zero from
// word k) and may alias a or b. Enter after a __syncthreads() that
// follows the last write of a and b; returns after one.
__device__ void mulmod_words(const uint32_t *A, const uint32_t *Bw,
                             uint32_t *out, Barrett &s, int k, int kw) {
  // vote: any bit at or above word k?
  int wide = 0;
  for (int w = k + threadIdx.x; w < kw; w += blockDim.x)
    if (A[w] | Bw[w]) wide = 1;
  wide = __syncthreads_or(wide);
  const int kk = wide ? kw : k;    // Barrett width of this product
  const int nq = 2 * kk - k + 1;   // words of q1, of its mu and of q3
  const uint32_t *muk = s.MU + 2 * (kw - kk);  // floor(2^(64kk) / m)

  // x = a·b (2kk words)
  columns(A, kk, Bw, kk, 2 * kk - 1, s.lo, s.hi);
  __syncthreads();
  resolve(s.lo, s.hi, 2 * kk - 1, s.X, 0, 2 * kk);
  __syncthreads();

  // q3 = floor(floor(x / b^(k-1)) · mu / b^nq), nq words
  columns(s.X + (k - 1), nq, muk, nq, 2 * nq - 1, s.lo, s.hi);
  __syncthreads();
  resolve(s.lo, s.hi, 2 * nq - 1, s.Q3, nq, nq);
  __syncthreads();

  // r2 = q3·m mod b^(k+1)
  columns(s.Q3, nq, s.M, k, k + 1, s.lo, s.hi);
  __syncthreads();
  resolve(s.lo, s.hi, k + 1, s.R, 0, k + 1);
  __syncthreads();

  if (threadIdx.x == 0) {
    uint32_t *R = s.R, *T = s.Q3;
    // r = (x - r2) mod b^(k+1), in [0, 3m)
    uint64_t borrow = 0;
    for (int i = 0; i <= k; ++i) {
      uint64_t d = (uint64_t)s.X[i] - R[i] - borrow;
      R[i] = (uint32_t)d;
      borrow = d >> 63;
    }
    // at most two subtractions of m leave r in [0, m)
    for (int it = 0; it < 2; ++it) {
      uint64_t br2 = 0;
      for (int i = 0; i <= k; ++i) {
        uint64_t mi = i < k ? s.M[i] : 0;
        uint64_t d = (uint64_t)R[i] - mi - br2;
        T[i] = (uint32_t)d;
        br2 = d >> 63;
      }
      if (br2) break;
      for (int i = 0; i <= k; ++i) R[i] = T[i];
    }
  }
  __syncthreads();
  for (int w = threadIdx.x; w < kw; w += blockDim.x) out[w] = w < k ? s.R[w] : 0;
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
mulmod_kernel(const int *__restrict__ a, const int *__restrict__ b,
              int *__restrict__ out, const uint32_t *__restrict__ m,
              const uint32_t *__restrict__ mu, int n, int k, int kw) {
  __shared__ uint32_t A[KMAX], Bw[KMAX];
  __shared__ Barrett s;

  const size_t row = blockIdx.x;
  repack(a + row * n, n, kw, A);
  repack(b + row * n, n, kw, Bw);
  load_consts(s, m, mu, k, kw);
  __syncthreads();
  mulmod_words(A, Bw, A, s, k, kw);
  unpack(A, k, out + row * n, n);
}

__global__ void __launch_bounds__(THREADS)
powmod_kernel(const int *__restrict__ x, const int *__restrict__ digits,
              int dstride, int nwin, const uint32_t *__restrict__ table,
              int *__restrict__ out, const uint32_t *__restrict__ m,
              const uint32_t *__restrict__ mu, int n, int k, int kw,
              int mode) {
  __shared__ uint32_t T[16][KMAX];  // window table x^j mod m
  __shared__ uint32_t ACC[KMAX];
  __shared__ Barrett s;
  __shared__ int top_s;

  const size_t row = blockIdx.x;
  const int *d = digits + row * dstride;
  const int dmask = mode == MODE_COMB ? COMB_ROWS - 1 : 15;
  if (threadIdx.x == 0) top_s = -1;
  load_consts(s, m, mu, k, kw);
  for (int w = threadIdx.x; w < kw; w += blockDim.x) ACC[w] = w == 0;
  __syncthreads();
  // the top non-zero window; none: e = 0 and ACC stays 1
  for (int i = threadIdx.x; i < nwin; i += blockDim.x)
    if (d[i] & dmask) atomicMax(&top_s, i);
  __syncthreads();
  const int top = top_s;

  if (mode == MODE_COMB) {
    bool one = true;  // ACC still holds 1
    for (int i = 0; i <= top; ++i) {
      const int di = d[i] & dmask;
      if (!di) continue;  // entry d = 0 is 1
      const uint32_t *e = table + ((size_t)i * COMB_ROWS + di) * k;
      uint32_t *dst = one ? ACC : T[0];
      for (int w = threadIdx.x; w < kw; w += blockDim.x) dst[w] = w < k ? e[w] : 0;
      __syncthreads();
      if (!one) mulmod_words(ACC, T[0], ACC, s, k, kw);
      one = false;
    }
  } else if (top >= 0) {
    repack(x + row * n, n, kw, T[1]);
    for (int w = threadIdx.x; w < kw; w += blockDim.x) T[0][w] = w == 0;
    __syncthreads();
    mulmod_words(T[1], T[0], T[1], s, k, kw);  // x mod m
    for (int j = 2; j < 16; ++j) mulmod_words(T[j - 1], T[1], T[j], s, k, kw);
    const int dt = d[top] & dmask;
    for (int w = threadIdx.x; w < kw; w += blockDim.x) ACC[w] = T[dt][w];
    __syncthreads();
    for (int i = top - 1; i >= 0; --i) {
      for (int sq = 0; sq < 4; ++sq) mulmod_words(ACC, ACC, ACC, s, k, kw);
      const int di = d[i] & dmask;
      if (di) mulmod_words(ACC, T[di], ACC, s, k, kw);
    }
  }
  unpack(ACC, k, out + row * n, n);
}

static int bad_width(int n, int k) {
  const int kw = (LIMB_BITS * n + 31) / 32;
  return k < 1 || kw < k || kw > KMAX || 2 * kw - k + 1 > LMAX;
}

extern "C" int mpcium_mulmod(const int *a, const int *b, int *out,
                             const unsigned *m, const unsigned *mu, int rows,
                             int n, int k, void *stream) {
  if (bad_width(n, k) || rows < 1) return (int)cudaErrorInvalidValue;
  const int kw = (LIMB_BITS * n + 31) / 32;
  mulmod_kernel<<<rows, THREADS, 0, (cudaStream_t)stream>>>(
      a, b, out, (const uint32_t *)m, (const uint32_t *)mu, n, k, kw);
  return (int)cudaGetLastError();
}

// x: (rows, n) limbs (ROW, SHARED) or NULL (COMB); digits: int32, row
// stride dstride (0 for SHARED), nwin per row, least significant first;
// table: (nwin, 256, k) canonical words (COMB) or NULL.
extern "C" int mpcium_powmod(const int *x, const int *digits,
                             const unsigned *table, int *out,
                             const unsigned *m, const unsigned *mu, int rows,
                             int n, int k, int nwin, int dstride, int mode,
                             void *stream) {
  if (bad_width(n, k) || rows < 1 || nwin < 0 || dstride < 0 || !digits ||
      mode < MODE_ROW || mode > MODE_COMB ||
      (mode == MODE_COMB) != (table != nullptr) ||
      (mode == MODE_COMB) == (x != nullptr))
    return (int)cudaErrorInvalidValue;
  const int kw = (LIMB_BITS * n + 31) / 32;
  powmod_kernel<<<rows, THREADS, 0, (cudaStream_t)stream>>>(
      x, digits, dstride, nwin, (const uint32_t *)table, out,
      (const uint32_t *)m, (const uint32_t *)mu, n, k, kw, mode);
  return (int)cudaGetLastError();
}
