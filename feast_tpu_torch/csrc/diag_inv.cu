// The diagonal-block inverses of the blocked LU for Hopper (sm_90a): every
// 64 x 64 diagonal tile of both triangles of every diagonal block of a
// batch of LU factors inverted in one launch, read straight from the
// factor through its strides.
//
// Replaces no TPU kernel.  The JAX package inverts the diagonal blocks by
// a row-by-row substitution inside a compiled fori_loop
// (feast_tpu/ops/lu.py::lu_diag_inv); issued eagerly on the card that
// substitution is a handful of launches a row, tens of thousands a factor.
// Here the 64 x 64 tiles are inverted in one launch, and ops/diag_inv.py
// joins them into the b x b block inverses by log2(b / 64) levels of
// batched products (the blocked triangular inverse of LAPACK's xTRTRI).
//
// Output (ops/diag_inv.py::tiles_plain, its plain version): for each
// matrix and diagonal block j of width b, two (b, b) blocks, Lw for the
// unit lower triangle L and Uw for the upper triangle U of the block,
// taken with an identity extension past n (rows and columns >= n are the
// identity's):
//   * a diagonal 64-tile of Lw (Uw) is the inverse of that tile of L (U);
//   * a tile below the diagonal of Lw (above it, of Uw) holds the
//     triangle's entries negated: the doubling's products take -C there;
//   * every other tile is zero.
// A zero diagonal entry of U (|d|^2 == 0) is replaced by
// eps * max(sqrt(max |U|^2 over the block's upper triangle), sqrt(tiny)),
// the identity extension's ones counted, as the plain substitution does
// (ops/lu.py::_upper_solve_small); divisions by the diagonal go by
// Smith's algorithm (cx.cdiv), so a large |d|^2 does not overflow.
//
// Bound.  Operations: a 64-tile's inverse is 64^3 / 6 complex
// multiply-adds, 8 fp32 operations each: 1.8 GFLOP for the 16 x 20
// blocks of 512 of the dense cell (5,120 tiles), 27 us at the fp32 rate.
// Bytes: the factor's blocks read once and both outputs written once,
// 2.0 GB there, 0.6 ms at 3.35 TB/s: the kernel is bound by bytes, most of
// them the off-diagonal tiles it copies for the doubling.  (The whole
// inverse needs 2 * 4/3 b^3 fp32 operations a block, xTRTRI's count, 0.115
// TFLOP there, 1.7 ms at the fp32 rate; the doubling's dense products do
// twice their share of it.)
//
// Design.  One block of 64 threads a 64 x 64 tile of one triangle of one
// diagonal block of one matrix; the grid covers (matrix, block, tile row,
// tile column) x 2 triangles.  An off-diagonal tile is copied (negated) or
// zeroed, a row a pass, each thread a column: coalesced 8-byte accesses.
// A diagonal tile is staged in shared memory (32 KB of complex64), and
// thread c computes column c of the inverse by substitution, the column
// in registers (the loops are unrolled), every thread reading the same
// tile entry at once (a broadcast, no bank conflict); its row i is then
// stored across the threads, coalesced.  The zero-pivot floor needs the
// whole block's upper triangle: a diagonal U tile that holds a zero pivot
// reduces it itself, and only then, so the common case reads nothing more.

#include <cuda_runtime.h>

namespace {

constexpr int T = 64;   // tile width, the block's thread count

__device__ __forceinline__ float abs2(float2 v) {
  // no contraction into an FMA: the same rounding as re * re + im * im on
  // the host, so the same entries count as zero
  return __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
}

// a / d by Smith's algorithm, the branches of cx.cdiv
__device__ __forceinline__ float2 smith_div(float2 a, float2 d) {
  const float c = d.x, e = d.y;
  if (fabsf(c) >= fabsf(e)) {
    const float r = e / (c == 0.0f ? 1.0f : c);
    const float den = c + e * r;
    return make_float2((a.x + a.y * r) / den, (a.y - a.x * r) / den);
  }
  const float r = c / (e == 0.0f ? 1.0f : e);
  const float den = c * r + e;
  return make_float2((a.x * r + a.y) / den, (a.y * r - a.x) / den);
}

// eps * max(sqrt(max |U|^2 over the upper triangle of the rows x rows
// block at `blk`), sqrt(FLT_MIN)), a block identity-extended to b when
// rows < b; every thread of the block calls it and gets the value.
__device__ float pivot_floor(const float2* __restrict__ blk, long long lda, int rows,
                             int b) {
  __shared__ float part[T / 32];
  float m = rows < b ? 1.0f : 0.0f;
  for (int r = 0; r < rows; ++r)
    for (int c = r + threadIdx.x; c < rows; c += T)
      m = fmaxf(m, abs2(blk[(long long)r * lda + c]));
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  m = part[0];
  for (int w = 1; w < T / 32; ++w) m = fmaxf(m, part[w]);
  return __fmul_rn(1.1920928955078125e-07f, fmaxf(sqrtf(m), 1.0842021724855044e-19f));
}

__global__ void __launch_bounds__(T)
diag_inv_tiles(const float2* __restrict__ LU, long long bstride, long long lda, int n,
               int b, int nb, float2* __restrict__ Linv, float2* __restrict__ Uinv) {
  __shared__ float2 tile[T][T];
  __shared__ int zero_pivot;
  const int tb = b / T;
  long long id = blockIdx.x;
  const int tj = (int)(id % tb);
  id /= tb;
  const int ti = (int)(id % tb);
  id /= tb;
  const int j = (int)(id % nb);
  const long long g = id / nb;
  const bool upper = blockIdx.y != 0;
  const int c = threadIdx.x;
  const int r0 = j * b + ti * T, c0 = j * b + tj * T;   // the tile's corner in LU
  const float2* in = LU + g * bstride + (long long)r0 * lda + c0;
  float2* out = (upper ? Uinv : Linv) + ((g * nb + j) * b + ti * T) * (long long)b + tj * T;

  if (ti != tj) {
    // an off-diagonal tile: the triangle's entries negated, or zeros
    const bool keep = upper ? ti < tj : ti > tj;
    const bool col = c0 + c < n;
#pragma unroll 8
    for (int r = 0; r < T; ++r) {
      float2 v = make_float2(0.0f, 0.0f);
      if (keep && col && r0 + r < n) {
        v = in[(long long)r * lda + c];
        v = make_float2(-v.x, -v.y);
      }
      out[(long long)r * b + c] = v;
    }
    return;
  }

  // a diagonal tile (r0 == c0), identity-extended past n
  if (c == 0) zero_pivot = 0;
#pragma unroll 8
  for (int r = 0; r < T; ++r)
    tile[r][c] = (r0 + r < n && r0 + c < n) ? in[(long long)r * lda + c]
                                            : make_float2(r == c ? 1.0f : 0.0f, 0.0f);
  __syncthreads();

  float2 x[T];   // column c of the inverse
  if (!upper) {
    // unit lower: x_i = e_c(i) - sum_{k < i} L_ik x_k, top down
#pragma unroll
    for (int i = 0; i < T; ++i) {
      float re0 = i == c ? 1.0f : 0.0f, im0 = 0.0f, re1 = 0.0f, im1 = 0.0f;
#pragma unroll
      for (int k = 0; k < i; k += 2) {
        const float2 l = tile[i][k];
        re0 -= l.x * x[k].x - l.y * x[k].y;
        im0 -= l.x * x[k].y + l.y * x[k].x;
        if (k + 1 < i) {
          const float2 m = tile[i][k + 1];
          re1 -= m.x * x[k + 1].x - m.y * x[k + 1].y;
          im1 -= m.x * x[k + 1].y + m.y * x[k + 1].x;
        }
      }
      x[i] = make_float2(re0 + re1, im0 + im1);
    }
  } else {
    if (!(abs2(tile[c][c]) > 0.0f)) zero_pivot = 1;
    __syncthreads();
    float floor_ = 0.0f;
    if (zero_pivot) {
      const int rows = min(b, n - j * b);
      floor_ = pivot_floor(LU + g * bstride + (long long)(j * b) * lda + j * b, lda,
                           rows, b);
    }
    // upper: x_i = (e_c(i) - sum_{k > i} U_ik x_k) / U_ii, bottom up
#pragma unroll
    for (int i = T - 1; i >= 0; --i) {
      float re0 = i == c ? 1.0f : 0.0f, im0 = 0.0f, re1 = 0.0f, im1 = 0.0f;
#pragma unroll
      for (int k = i + 1; k < T; k += 2) {
        const float2 u = tile[i][k];
        re0 -= u.x * x[k].x - u.y * x[k].y;
        im0 -= u.x * x[k].y + u.y * x[k].x;
        if (k + 1 < T) {
          const float2 v = tile[i][k + 1];
          re1 -= v.x * x[k + 1].x - v.y * x[k + 1].y;
          im1 -= v.x * x[k + 1].y + v.y * x[k + 1].x;
        }
      }
      float2 d = tile[i][i];
      if (!(abs2(d) > 0.0f)) d = make_float2(floor_, 0.0f);
      x[i] = smith_div(make_float2(re0 + re1, im0 + im1), d);
    }
  }
#pragma unroll
  for (int i = 0; i < T; ++i) out[(long long)i * b + c] = x[i];
}

}  // namespace

// LU: (batch, n, n) complex64, unit column stride, rows lda and matrices
// bstride entries apart; Linv, Uinv: (batch, nb, b, b) complex64,
// contiguous, nb = ceil(n / b); b a multiple of 64.
extern "C" int feast_diag_inv_c64(const void* LU, long long bstride, long long lda, int n,
                                  int b, int batch, void* Linv, void* Uinv, void* stream) {
  if (b < T || b % T != 0 || n < 1 || batch < 1 || lda < n)
    return (int)cudaErrorInvalidValue;
  const int nb = (n + b - 1) / b, tb = b / T;
  const long long blocks = (long long)batch * nb * tb * tb;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  diag_inv_tiles<<<dim3((unsigned)blocks, 2), T, 0, (cudaStream_t)stream>>>(
      (const float2*)LU, bstride, lda, n, b, nb, (float2*)Linv, (float2*)Uinv);
  return (int)cudaGetLastError();
}
