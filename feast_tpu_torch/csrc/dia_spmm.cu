// DIA (diagonal-storage) sparse matrix times a block of vectors, complex64,
// for Hopper (sm_90a):
//
//     Y[b, i, j] = sum_k data[b, k, i] * X[b, i + offsets[k], j]
//
// with an out-of-range column index i + offsets[k] contributing zero, the
// diagonals summed in the order of `offsets` in fp32.
//
// Replaces the TPU kernel feast_tpu/ops/pallas_kernels.py::
// _dia_matvec_pallas_padded (launched by dia_matvec_pallas,
// pallas_kernels.py:156).  That kernel copies one (bn + span, m) halo window
// of X per row block into fast memory, over the whole band: on the
// 1000 x 1000 grid pencil the span is 2002 rows, so the window is mostly
// rows no diagonal of the block reads.
//
// Bound.  Bytes: data (ndiag n), X and Y (n m each), 8 bytes per value,
// against 8 ndiag n m flops.  At the sparse path's level-0 shape (9
// diagonals, n = 1e6, m = 8, 8 nodes) that is 1.6 GB and 0.478 ms at
// 3.35 TB/s; at level 1 (21 diagonals, n = 167,000) 0.40 GB, 0.118 ms.
//
// Design.  Each thread owns one row i and two columns (j, j+1): 16-byte
// loads of X where m is even and X is 16-byte aligned (else two 8-byte
// loads), the diagonal loop unrolled by 12 so that a thread has its loads
// in flight together, 32-bit row and column indices, and Y written by
// 16-byte (or 8-byte) streaming stores (__stcs).  The offsets come from a
// device array through the read-only path (one broadcast load a warp).  A
// block takes 256 (row, column pair) items; the batch (the contour-node
// axis: the shifted data differ per node) is the grid's y dimension, and a
// batch stride of 0 shares data or X across the batch.
//
// Why not halo windows in shared memory.  A variant that brought one X
// window per run of nearby diagonals ({-N-1, -N, -N+1}, {-1, 0, 1},
// {N-1, N, N+1} on the grid) and the data tile into a 2-3 stage ring with
// 1-D TMA bulk copies and mbarriers, on a persistent grid, was built and
// timed beside this kernel: 0.906 against 0.766 ms at level 0 and 0.384
// against 0.254 ms at level 1 (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
// This kernel already reads X from device memory about once: the rows a
// run's diagonals share are L1 hits inside a block, and the rows of the
// other runs come from L2, where the neighbouring blocks in flight left
// them.  The windows save only L2-to-SM traffic, which was not the pace;
// their own cost was: each tile's copies, header, mbarrier wait and block
// barrier are served by fewer warps than the 64 a SM keeps here with their
// loads in flight.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int NT = 256;

template <bool VEC>
__device__ __forceinline__ void load_pair(const float2* p, bool two, float2& x0, float2& x1) {
  if (VEC) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x0 = make_float2(v.x, v.y);
    x1 = make_float2(v.z, v.w);
  } else {
    x0 = __ldg(p);
    x1 = two ? __ldg(p + 1) : make_float2(0.f, 0.f);
  }
}

// CPR: column pairs a row, (m + 1) / 2, as a constant for m <= 16 (0: runtime)
template <int CPR, bool VEC>
__global__ void __launch_bounds__(NT)
dia_spmm_kernel(const float2* __restrict__ data, const int* __restrict__ offsets,
                const float2* __restrict__ X, float2* __restrict__ Y,
                int ndiag, int n, int ncols, int m,
                long long data_bstride, long long x_bstride) {
  const int cpr = CPR ? CPR : (m + 1) >> 1;
  const long long w = (long long)blockIdx.x * NT + threadIdx.x;
  if (w >= (long long)n * cpr) return;
  const int i = (int)(w / cpr);
  const int j = 2 * (int)(w - (long long)i * cpr);
  const bool two = j + 1 < m;
  const float2* xb = X + blockIdx.y * x_bstride + j;
  const float2* db = data + blockIdx.y * data_bstride + i;
  float r0 = 0.f, i0 = 0.f, r1 = 0.f, i1 = 0.f;
#pragma unroll 12
  for (int k = 0; k < ndiag; ++k) {
    const int col = i + __ldg(offsets + k);
    if ((unsigned)col >= (unsigned)ncols) continue;
    float2 x0, x1;
    load_pair<VEC>(xb + (long long)col * m, two, x0, x1);
    const float2 d = __ldg(db + (long long)k * n);
    r0 += d.x * x0.x - d.y * x0.y;
    i0 += d.x * x0.y + d.y * x0.x;
    r1 += d.x * x1.x - d.y * x1.y;
    i1 += d.x * x1.y + d.y * x1.x;
  }
  float2* y = Y + ((long long)blockIdx.y * n + i) * m + j;
  if (VEC) {
    __stcs(reinterpret_cast<float4*>(y), make_float4(r0, i0, r1, i1));
  } else {
    __stcs(y, make_float2(r0, i0));
    if (two) __stcs(y + 1, make_float2(r1, i1));
  }
}

template <bool VEC>
void* pick(int cpr) {
  switch (cpr) {
    case 1: return (void*)dia_spmm_kernel<1, VEC>;
    case 2: return (void*)dia_spmm_kernel<2, VEC>;
    case 4: return (void*)dia_spmm_kernel<4, VEC>;
    case 8: return (void*)dia_spmm_kernel<8, VEC>;
    default: return (void*)dia_spmm_kernel<0, VEC>;
  }
}

}  // namespace

// data: (batch or 1, ndiag, n); offsets: device array of ndiag ints;
// X: (batch or 1, ncols, m); Y: (batch, n, m); all complex64, contiguous
// inside one batch entry.  Batch strides are in complex elements; 0 shares
// the operand across the batch.
extern "C" int feast_dia_spmm_c64(const void* data, const void* offsets,
                                  const void* X, void* Y, int ndiag, int n,
                                  int ncols, int m, int batch,
                                  long long data_bstride, long long x_bstride,
                                  void* stream) {
  if (ndiag < 0 || n < 1 || ncols < 1 || m < 1 || batch < 1 || batch > 65535 ||
      (long long)n * m > 0x7fffffffLL || (long long)ncols * m > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int cpr = (m + 1) / 2;
  const long long blocks = ((long long)n * cpr + NT - 1) / NT;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // 16-byte pairs: m even and X, Y on 16-byte boundaries (then every row is)
  const bool vec = m % 2 == 0 && ((uintptr_t)X & 15) == 0 && ((uintptr_t)Y & 15) == 0;
  void* fn = vec ? pick<true>(cpr) : pick<false>(cpr);
  void* args[] = {&data, &offsets, &X, &Y, &ndiag, &n, &ncols, &m, &data_bstride, &x_bstride};
  const cudaError_t err = cudaLaunchKernel(fn, dim3((unsigned)blocks, (unsigned)batch),
                                           dim3(NT), args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
