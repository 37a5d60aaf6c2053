// DIA (diagonal-storage) sparse matrix times a block of vectors, complex64,
// for Hopper (sm_90a):
//
//     Y[b, i, j] = sum_k data[b, k, i] * X[b, i + offsets[k], j]
//
// with an out-of-range column index i + offsets[k] contributing zero.
//
// Replaces the TPU kernel feast_tpu/ops/pallas_kernels.py::
// _dia_matvec_pallas_padded (launched by dia_matvec_pallas,
// pallas_kernels.py:156).  That kernel copies one (bn + span, m) halo window
// of X into fast memory per row block, after zero-padding n to the block,
// pre-shifting X by the smallest offset and padding the columns to 128
// lanes.  None of that plumbing is carried over: the kernel below computes
// the whole product on the unpadded operands and bounds-checks the column
// index itself.
//
// Design.  One thread per output element (row i, column j), the diagonals
// looped inside in the order of `offsets` with fp32 accumulation (the order
// of the plain version).  A row's m complex values are contiguous, so at
// m = 8 a warp reads and writes four whole 64-byte rows per access, and the
// eight threads of a row read the same data[k, i] (one broadcast load).
// Neighbouring rows reuse the same rows of X through L1/L2: the widest
// span on the 1000 x 1000 grid pencil is 2002 rows x 64 B = 128 KB, far
// inside the 50 MB L2, so X comes from device memory once.  The batch (the
// contour-node axis: the shifted data differs per node) is the grid's y
// dimension; a batch stride of 0 shares data or X across the batch.
//
// Bound.  Bytes: data (ndiag n), X and Y (n m each), 8 bytes per value,
// against 8 ndiag n m flops: 0.20 GB and 0.58 GFLOP per node at ndiag = 9,
// n = 1e6, m = 8, so device memory bounds it (0.060 ms at 3.35 TB/s).

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
dia_spmm_kernel(const float2* __restrict__ data, const int* __restrict__ offsets,
                const float2* __restrict__ X, float2* __restrict__ Y,
                int ndiag, int n, int ncols, int m,
                long long data_bstride, long long x_bstride) {
  const long long total = (long long)n * m;
  const long long t = (long long)blockIdx.x * NT + threadIdx.x;
  if (t >= total) return;
  const int i = (int)(t / m);
  const int j = (int)(t - (long long)i * m);
  const float2* d = data + blockIdx.y * data_bstride + i;
  const float2* x = X + blockIdx.y * x_bstride + j;
  float yr = 0.f, yi = 0.f;
  for (int k = 0; k < ndiag; ++k) {
    const long long c = (long long)i + __ldg(offsets + k);
    if (c < 0 || c >= ncols) continue;
    const float2 a = __ldg(d + (long long)k * n);
    const float2 v = __ldg(x + c * m);
    yr += a.x * v.x - a.y * v.y;
    yi += a.x * v.y + a.y * v.x;
  }
  Y[blockIdx.y * total + t] = make_float2(yr, yi);
}

}  // namespace

// data: (batch or 1, ndiag, n); X: (batch or 1, ncols, m); Y: (batch, n, m);
// all complex64, contiguous inside one batch entry.  Batch strides are in
// complex elements; 0 shares the operand across the batch.
extern "C" int feast_dia_spmm_c64(const void* data, const void* offsets,
                                  const void* X, void* Y, int ndiag, int n,
                                  int ncols, int m, int batch,
                                  long long data_bstride, long long x_bstride,
                                  void* stream) {
  if (ndiag < 0 || n < 1 || ncols < 1 || m < 1 || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)n * m + NT - 1) / NT;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, (unsigned)batch);
  dia_spmm_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float2*)data, (const int*)offsets, (const float2*)X, (float2*)Y,
      ndiag, n, ncols, m, data_bstride, x_bstride);
  return (int)cudaGetLastError();
}
