// Panel LU of complex64 column slabs for Hopper (sm_90a).
//
// Replaces the TPU kernel feast_tpu/ops/pallas_lu.py::_panel_kernel
// (launched by panel_slab_pallas, pallas_lu.py:208).  One launch factors a
// batch of (n, b) column slabs in place, pivot rows j0..j0+b-1, with the
// semantics of feast_tpu/ops/lu.py::_panel_lu_slab:
//   * per column k (global row g = j0 + k): argmax of |.|^2 over rows >= g,
//     lowest index winning ties (lax.argmax), swap of rows g and p, the swap
//     composed into perm;
//   * an exact zero pivot replaced by tiny = FLT_EPSILON * max(sqrt(max
//     |slab|^2), 1e-30), the max taken over the whole slab before the first
//     column; the reciprocal by Smith's algorithm (pallas_lu.py:104-118);
//   * multipliers on rows > g and the rank-1 update of columns > k;
//   * afterwards X = inverse of the unit-lower diagonal block L11.
//
// Design.  The TPU kernel keeps the whole slab in VMEM; here the slab
// (4096 x 128 complex64 = 4 MiB at the headline shape) is far larger than
// a block's 227 KB of shared memory, so it stays in global memory, where it
// is L2-resident (50 MB L2).  One 1024-thread block per slab, the batch
// (the contour nodes) on the grid.  Rows < j0 are read once, for tiny's
// slab max, and never written; only rows >= j0 are updated.  The
// pivot row of each step is staged in shared memory; each warp updates one
// row at a time with lanes on consecutive columns (coalesced).  The L11
// inverse is built in dynamic shared memory (b*b*8 = 128 KB at b = 128).
// Compiled with --fmad=false: every product and sum is rounded on its own,
// in the order of the plain PyTorch version, so both pick the same pivots.
//
// Bound.  The rank-1 work of a whole n = 4096 factor is about
// n^2 b / 4 = 5.4e8 complex multiply-adds (2.1e9 real FMA, 4.3e9 flop):
// ~0.07 ms at the card's 67 TFLOP/s fp32 rate if spread over all SMs.
// This kernel runs one block per node (16 SMs at the headline shape) and a
// block-wide barrier per column, so it is latency- and L2-bound far above
// that: a multi-block (cluster or cooperative) design is later work.

#include <cuda_runtime.h>
#include <cfloat>
#include <climits>

namespace {

constexpr int NT = 1024;
constexpr int NW = NT / 32;
constexpr int MAXB = 128;

__global__ void __launch_bounds__(NT)
panel_lu_kernel(float2* __restrict__ A, long long bstride, long long lda,
                int n, int b, int j0, int* __restrict__ perm_out,
                float2* __restrict__ invl_out) {
  extern __shared__ float2 xs[];  // b*b: the L11 inverse under construction
  __shared__ float2 urow[MAXB];
  __shared__ float red_m[NW];
  __shared__ int red_i[NW];
  __shared__ int s_piv;
  __shared__ float s_max;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float2* S = A + blockIdx.x * bstride;
  int* perm = perm_out + (long long)blockIdx.x * n;

  for (int i = tid; i < n; i += NT) perm[i] = i;

  // zero-pivot substitute from the whole slab, before the first column
  float m = 0.f;
  for (long long e = tid; e < (long long)n * b; e += NT) {
    const float2 v = S[(e / b) * lda + (e % b)];
    m = fmaxf(m, v.x * v.x + v.y * v.y);
  }
  for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) red_m[warp] = m;
  __syncthreads();
  if (tid == 0) {
    float mm = red_m[0];
    for (int w = 1; w < NW; ++w) mm = fmaxf(mm, red_m[w]);
    s_max = mm;
  }
  __syncthreads();
  const float tiny = FLT_EPSILON * fmaxf(sqrtf(s_max), 1e-30f);

  for (int k = 0; k < b; ++k) {
    const int g = j0 + k;
    // ---- pivot: argmax |.|^2 over rows >= g, lowest index on ties ----
    float best = -1.f;
    int bidx = INT_MAX;
    for (int i = g + tid; i < n; i += NT) {
      const float2 v = S[i * lda + k];
      const float a2 = v.x * v.x + v.y * v.y;
      if (a2 > best) { best = a2; bidx = i; }
    }
    for (int o = 16; o; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx, o);
      if (ob > best || (ob == best && oi < bidx)) { best = ob; bidx = oi; }
    }
    if (lane == 0) { red_m[warp] = best; red_i[warp] = bidx; }
    __syncthreads();
    if (tid == 0) {
      float bb = red_m[0];
      int bi = red_i[0];
      for (int w = 1; w < NW; ++w)
        if (red_m[w] > bb || (red_m[w] == bb && red_i[w] < bi)) { bb = red_m[w]; bi = red_i[w]; }
      s_piv = bi;
    }
    __syncthreads();
    const int p = s_piv;

    // ---- swap rows g <-> p; stage the new pivot row ----
    if (tid < b) {
      const float2 vg = S[g * lda + tid], vp = S[p * lda + tid];
      S[g * lda + tid] = vp;
      S[p * lda + tid] = vg;
      urow[tid] = vp;
    }
    if (tid == 0) { const int t = perm[g]; perm[g] = perm[p]; perm[p] = t; }
    __syncthreads();

    // ---- guarded pivot, Smith's reciprocal ----
    float pr = urow[k].x, pi = urow[k].y;
    const bool nz = (pr != 0.f) || (pi != 0.f);
    pr = nz ? pr : tiny;
    pi = nz ? pi : 0.f;
    const bool big = fabsf(pr) >= fabsf(pi);
    const float r1 = pi / (pr == 0.f ? 1.f : pr);
    const float den1 = pr + pi * r1;
    const float r2 = pr / (pi == 0.f ? 1.f : pi);
    const float den2 = pr * r2 + pi;
    const float inv_r = big ? 1.f / den1 : r2 / den2;
    const float inv_i = big ? -r1 / den1 : -1.f / den2;

    // ---- multipliers + rank-1 update, one warp per row ----
    for (int i = g + 1 + warp; i < n; i += NW) {
      float2* row = S + i * lda;
      const float2 c = row[k];
      const float mr = c.x * inv_r - c.y * inv_i;
      const float mi = c.x * inv_i + c.y * inv_r;
      for (int cc = k + 1 + lane; cc < b; cc += 32) {
        const float2 u = urow[cc];
        float2 s = row[cc];
        s.x = s.x - (mr * u.x - mi * u.y);
        s.y = s.y - (mr * u.y + mi * u.x);
        row[cc] = s;
      }
      __syncwarp();
      if (lane == 0) row[k] = make_float2(mr, mi);
    }
    __syncthreads();
  }

  // ---- X = L11^{-1}: column-oriented forward substitution ----
  for (int e = tid; e < b * b; e += NT)
    xs[e] = make_float2((e / b) == (e % b) ? 1.f : 0.f, 0.f);
  __syncthreads();
  for (int l = 0; l + 1 < b; ++l) {
    const int nr = b - l - 1, ncol = l + 1;  // X[l, c] == 0 for c > l
    for (int e = tid; e < nr * ncol; e += NT) {
      const int r = l + 1 + e / ncol, c = e % ncol;
      const float2 L = S[(long long)(j0 + r) * lda + l];
      const float2 xl = xs[l * b + c];
      float2 x = xs[r * b + c];
      x.x = x.x - (L.x * xl.x - L.y * xl.y);
      x.y = x.y - (L.x * xl.y + L.y * xl.x);
      xs[r * b + c] = x;
    }
    __syncthreads();
  }
  float2* X = invl_out + (long long)blockIdx.x * b * b;
  for (int e = tid; e < b * b; e += NT) X[e] = xs[e];
}

}  // namespace

extern "C" int feast_panel_lu_c64(void* A, long long bstride, long long lda,
                                  int n, int b, int j0, int batch, void* perm,
                                  void* invl, void* stream) {
  if (b < 1 || b > MAXB || j0 < 0 || j0 + b > n || batch < 1)
    return (int)cudaErrorInvalidValue;
  const int smem = b * b * (int)sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      panel_lu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  panel_lu_kernel<<<batch, NT, smem, (cudaStream_t)stream>>>(
      (float2*)A, bstride, lda, n, b, j0, (int*)perm, (float2*)invl);
  return (int)cudaGetLastError();
}
