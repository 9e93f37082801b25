// Batched a·b mod m for the GG18 Paillier / ring-Pedersen widths (sm_90a).
//
// Replaces the TPU kernel mpcium_tpu/ops/pallas_mulmod.py:_mulmod_kernel
// (launched by pl.pallas_call in _mulmod_call). Same function: for
// normalized 7-bit little-endian int32 limbs a, b of row width n, the
// canonical limbs of a·b mod m, zero-padded to n. The JAX kernel is exact
// for a·b < R^occ·m (R = 2^7, occ = limbs of m), operands above m
// included; this kernel is exact for every pair of normalized n-limb
// operands, a superset of that domain.
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
// row whose operands both fit in k words (every reduced operand) runs
// Barrett at width k with mu's top k+1 words, which are exactly
// floor(2^(64k) / m); a row with any bit at or above word k runs it at
// width kw with the whole of mu. Either way x = a·b < 2^(64·width), so
// the quotient estimate is at most 2 short and two conditional
// subtractions finish the reduction.
//
// Layout: one block of 128 threads per row. Column sums of each product
// are formed in parallel (a thread per column, 64-bit multiply-adds into
// a 72-bit accumulator); carries, the Barrett subtraction and the final
// conditional subtractions are resolved by one thread. Warpgroup MMA,
// TMA loads and in-kernel exponent loops (a whole powmod per launch) are
// later work.
//
// C entry point (ctypes): returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#define KMAX 136      // words of the widest row (n <= 608 limbs)
#define LMAX 160      // words of mu and of the quotient: 2kw-k+1 <= LMAX
#define THREADS 128
#define LIMB_BITS 7

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

__global__ void __launch_bounds__(THREADS)
mulmod_kernel(const int *__restrict__ a, const int *__restrict__ b,
              int *__restrict__ out, const uint32_t *__restrict__ m,
              const uint32_t *__restrict__ mu, int n, int k, int kw) {
  __shared__ uint32_t A[KMAX], Bw[KMAX], M[KMAX], MU[LMAX];
  __shared__ uint32_t X[2 * KMAX];
  __shared__ uint32_t Q3[LMAX], R[KMAX + 1];
  __shared__ uint64_t lo[2 * LMAX];
  __shared__ uint32_t hi[2 * LMAX];

  const size_t row = blockIdx.x;
  const int *ar = a + row * n;
  const int *br = b + row * n;

  // repack 7-bit limbs into 32-bit words; note any bit at or above word k
  int wide = 0;
  for (int w = threadIdx.x; w < kw; w += blockDim.x) {
    uint64_t va = 0, vb = 0;
    int bit0 = 32 * w;
    int l0 = bit0 / LIMB_BITS;
    int l1 = (bit0 + 31) / LIMB_BITS;
    if (l1 > n - 1) l1 = n - 1;
    for (int l = l0; l <= l1; ++l) {
      int sh = LIMB_BITS * l - bit0;
      uint64_t la = (uint32_t)ar[l], lb = (uint32_t)br[l];
      if (sh >= 0) {
        va |= la << sh;
        vb |= lb << sh;
      } else {
        va |= la >> (-sh);
        vb |= lb >> (-sh);
      }
    }
    A[w] = (uint32_t)va;
    Bw[w] = (uint32_t)vb;
    if (w >= k && (A[w] | Bw[w])) wide = 1;
  }
  for (int w = threadIdx.x; w < k; w += blockDim.x) M[w] = m[w];
  for (int w = threadIdx.x; w < 2 * kw - k + 1; w += blockDim.x) MU[w] = mu[w];
  wide = __syncthreads_or(wide);
  const int kk = wide ? kw : k;    // Barrett width of this row
  const int nq = 2 * kk - k + 1;   // words of q1, of its mu and of q3
  const uint32_t *muk = MU + 2 * (kw - kk);  // floor(2^(64kk) / m)

  // x = a·b (2kk words)
  columns(A, kk, Bw, kk, 2 * kk - 1, lo, hi);
  __syncthreads();
  resolve(lo, hi, 2 * kk - 1, X, 0, 2 * kk);
  __syncthreads();

  // q3 = floor(floor(x / b^(k-1)) · mu / b^nq), nq words
  columns(X + (k - 1), nq, muk, nq, 2 * nq - 1, lo, hi);
  __syncthreads();
  resolve(lo, hi, 2 * nq - 1, Q3, nq, nq);
  __syncthreads();

  // r2 = q3·m mod b^(k+1)
  columns(Q3, nq, M, k, k + 1, lo, hi);
  __syncthreads();
  resolve(lo, hi, k + 1, R, 0, k + 1);
  __syncthreads();

  if (threadIdx.x == 0) {
    // r = (x - r2) mod b^(k+1), in [0, 3m)
    uint64_t borrow = 0;
    for (int i = 0; i <= k; ++i) {
      uint64_t d = (uint64_t)X[i] - R[i] - borrow;
      R[i] = (uint32_t)d;
      borrow = d >> 63;
    }
    // at most two subtractions of m leave r in [0, m)
    for (int it = 0; it < 2; ++it) {
      uint64_t br2 = 0;
      for (int i = 0; i <= k; ++i) {
        uint64_t mi = i < k ? M[i] : 0;
        uint64_t d = (uint64_t)R[i] - mi - br2;
        Q3[i] = (uint32_t)d;
        br2 = d >> 63;
      }
      if (br2) break;
      for (int i = 0; i <= k; ++i) R[i] = Q3[i];
    }
  }
  __syncthreads();

  // unpack to 7-bit limbs, zero above the modulus width
  int *orow = out + row * n;
  for (int l = threadIdx.x; l < n; l += blockDim.x) {
    int bit = LIMB_BITS * l;
    int w = bit >> 5, s = bit & 31;
    uint64_t v = 0;
    if (w < k) v = R[w];
    if (w + 1 < k) v |= (uint64_t)R[w + 1] << 32;
    orow[l] = (int)((v >> s) & ((1u << LIMB_BITS) - 1));
  }
}

extern "C" int mpcium_mulmod(const int *a, const int *b, int *out,
                             const unsigned *m, const unsigned *mu, int rows,
                             int n, int k, void *stream) {
  const int kw = (LIMB_BITS * n + 31) / 32;
  if (k < 1 || kw < k || kw > KMAX || 2 * kw - k + 1 > LMAX || rows < 1)
    return (int)cudaErrorInvalidValue;
  mulmod_kernel<<<rows, THREADS, 0, (cudaStream_t)stream>>>(
      a, b, out, (const uint32_t *)m, (const uint32_t *)mu, n, k, kw);
  return (int)cudaGetLastError();
}
