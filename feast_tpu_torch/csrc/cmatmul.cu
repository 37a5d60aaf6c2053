// Complex64 matrix product C = A B with fp32 accumulation, for Hopper
// (sm_90a): interleaved complex in and out, an optional leading batch, any
// M, N, K.
//
// Replaces the TPU kernel feast_tpu/ops/pallas_kernels.py::
// _cmatmul_pallas_padded (launched by cmatmul_pallas, pallas_kernels.py:85).
// That kernel works on separate real and imaginary planes padded to tiles of
// 128-256 and forms three real products per tile (Karatsuba) on the matrix
// unit at Precision.HIGHEST, i.e. with fp32 accuracy.  Here the planes are
// split while a tile is loaded into shared memory, the ragged edges are
// bounds-checked in the kernel (no padding), and each complex multiply-add
// is the direct four-product form
//
//     Cr += Ar Br - Ai Bi,    Ci += Ar Bi + Ai Br
//
// in fp32 FMAs.  TF32 tensor-core math keeps about three digits and would
// not be a port of an fp32-accurate product, so no wgmma here.  The plain
// PyTorch version (cx._cmatmul_planes) forms the same four real products.
//
// Design.  The classic shared-memory tiled GEMM with register blocking: a
// block of 256 threads owns a 64 x 64 tile of C and walks K in steps of 16;
// each step stages a 64 x 16 tile of A (stored transposed, so that a
// thread's four rows are one 16-byte read) and a 16 x 64 tile of B as four
// fp32 planes in shared memory; each thread keeps a 4 x 4 complex micro-tile
// (32 accumulators) in registers and does 64 FMAs per four 16-byte shared
// loads.  Row strides and batch strides are passed in, so slices of a
// larger matrix and operands shared across the batch (stride 0) need no
// copy.
//
// Bound.  A complex product needs three real ones (the Karatsuba form of
// the TPU body), so the function needs 6 M N K fp32 operations against
// 8 (M K + K N + M N) bytes: by operations at the card's 67 TFLOP/s outside
// the tensor cores for every shape the dense path produces (K >= 48).  This
// kernel executes the four-product form, 8 M N K operations.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16;
constexpr int NT = 256;
constexpr int PAD = 4;  // keeps 16-byte alignment, spreads the transposed stores

__global__ void __launch_bounds__(NT)
cmatmul_kernel(const float2* __restrict__ A, const float2* __restrict__ B,
               float2* __restrict__ C, int M, int N, int K,
               long long lda, long long ldb, long long ldc,
               long long a_bstride, long long b_bstride, long long c_bstride) {
  __shared__ __align__(16) float As_re[BK][BM + PAD];
  __shared__ __align__(16) float As_im[BK][BM + PAD];
  __shared__ __align__(16) float Bs_re[BK][BN];
  __shared__ __align__(16) float Bs_im[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  A += blockIdx.z * a_bstride;
  B += blockIdx.z * b_bstride;
  C += blockIdx.z * c_bstride;

  float cr[4][4], ci[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) cr[i][j] = ci[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int l = 0; l < (BM * BK) / NT; ++l) {
      const int idx = tid + l * NT;
      const int row = idx / BK, kk = idx % BK;
      float2 v = make_float2(0.f, 0.f);
      if (m0 + row < M && k0 + kk < K) v = A[(long long)(m0 + row) * lda + k0 + kk];
      As_re[kk][row] = v.x;
      As_im[kk][row] = v.y;
    }
#pragma unroll
    for (int l = 0; l < (BK * BN) / NT; ++l) {
      const int idx = tid + l * NT;
      const int kk = idx / BN, col = idx % BN;
      float2 v = make_float2(0.f, 0.f);
      if (k0 + kk < K && n0 + col < N) v = B[(long long)(k0 + kk) * ldb + n0 + col];
      Bs_re[kk][col] = v.x;
      Bs_im[kk][col] = v.y;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 ar4 = *reinterpret_cast<const float4*>(&As_re[kk][ty * 4]);
      const float4 ai4 = *reinterpret_cast<const float4*>(&As_im[kk][ty * 4]);
      const float4 br4 = *reinterpret_cast<const float4*>(&Bs_re[kk][tx * 4]);
      const float4 bi4 = *reinterpret_cast<const float4*>(&Bs_im[kk][tx * 4]);
      const float ar[4] = {ar4.x, ar4.y, ar4.z, ar4.w};
      const float ai[4] = {ai4.x, ai4.y, ai4.z, ai4.w};
      const float br[4] = {br4.x, br4.y, br4.z, br4.w};
      const float bi[4] = {bi4.x, bi4.y, bi4.z, bi4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          cr[i][j] += ar[i] * br[j];
          cr[i][j] -= ai[i] * bi[j];
          ci[i][j] += ar[i] * bi[j];
          ci[i][j] += ai[i] * br[j];
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < N) C[(long long)row * ldc + col] = make_float2(cr[i][j], ci[i][j]);
    }
  }
}

}  // namespace

// A: (batch or 1, M, K), B: (batch or 1, K, N), C: (batch, M, N), complex64
// with unit column stride.  Row strides (lda, ldb, ldc) and batch strides are
// in complex elements; a batch stride of 0 shares the operand.
extern "C" int feast_cmatmul_c64(const void* A, const void* B, void* C, int M,
                                 int N, int K, int batch, long long lda,
                                 long long ldb, long long ldc,
                                 long long a_bstride, long long b_bstride,
                                 long long c_bstride, void* stream) {
  if (M < 1 || N < 1 || K < 0 || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const long long gy = (N + BN - 1) / BN;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)gy, (unsigned)batch);
  cmatmul_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float2*)A, (const float2*)B, (float2*)C, M, N, K, lda, ldb, ldc,
      a_bstride, b_bstride, c_bstride);
  return (int)cudaGetLastError();
}
