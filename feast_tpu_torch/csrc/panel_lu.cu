// Panel LU of complex64 column slabs for Hopper (sm_90a): one thread-block
// cluster per slab.
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
// Bound.  At the dense path's shape (16 slabs of 4096 x 128) the work is
// about n b^2 / 2 complex multiply-adds per slab: by operations at the
// card's 67 TFLOP/s fp32 rate for j0 <= 2048, by the bytes of the slab
// (all n rows read once, rows >= j0 written) above; either way tens of
// microseconds.  What sets the pace is latency: 128 dependent pivot steps,
// each a reduction over all active rows followed by a row swap.
//
// Design.  Each slab gets a cluster of C blocks, C the largest size up to 8
// whose clusters hold the whole batch in one wave
// (cudaOccupancyMaxActiveClusters decides: an H100 holds 15 clusters of 8
// or 7 and 17 of 6, so the batch of 16 runs on 96 SMs, not on 16).  Block r
// of a cluster owns the contiguous rows [j0 + r R, j0 + (r+1) R) of the
// active rows.  The b columns are factored
// as sub-panels of w columns (w = 32 where it fits; less for tall slabs):
//   1. each block copies its rows of the sub-panel into shared memory
//      (row stride w + 1: conflict-free 8-byte accesses down a column);
//   2. per column: every block publishes, in shared memory double-buffered
//      by column parity, its local argmax, that row of the sub-panel and
//      (its owner) row g; one cluster barrier; every block reads the C
//      candidates and rows and row g through distributed shared memory in
//      one round, reduces the candidates (lowest index on ties), and the
//      owners write the swapped rows g and p into their tiles; each thread
//      then updates one of its block's rows in shared memory and takes that
//      row's entry of the next column for the next argmax.  No block reads
//      another's tile, so one cluster barrier per column is enough: a block
//      reuses a buffer only after the next barrier, which no block passes
//      before it has read this column's copies;
//   3. the sub-panel goes back to the slab; the sub-panel's row swaps are
//      applied to the slab's other columns (laswp); every block computes
//      the w pivot rows of the columns to the right in sequence (U12) and
//      applies the w rank-1 terms to its own rows, one at a time in column
//      order.
// One cluster barrier per column, two more per sub-panel; the trailing
// columns pass through L2 once per sub-panel, not once per column.
// Zero-pivot tiny: a cluster-wide max before the first column.  The L11
// inverse: block r forward-substitutes columns [r b/C, (r+1) b/C) of X with
// L11 packed in shared memory.  Where even w = 4 does not fit (very tall
// slabs on few blocks), the sub-panel stays in the slab (global memory).
//
// Bit-exactness.  Every element sees the rank-1 terms of the right-looking
// plain version in the same order (column order), each product and sum
// rounded on its own (built with --fmad=false), so the kernel is bit for
// bit equal to ops/panel_lu.py::panel_factor_plain: same pivots, slab and
// invL11.  ops/panel_lu.py::launch_plan mirrors the launch plan below.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cfloat>
#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;
constexpr int NW = NT / 32;
constexpr int MAXB = 128;
constexpr int MAXW = 32;
constexpr int MAXC = 8;
constexpr int SMEM_CAP = 232448;      // 227 KB: the most a block may use
constexpr int STATIC_RESERVE = 8192;  // upper bound of the kernel's static shared memory

struct Cand {
  float v;
  int i;
};

struct Plan {
  int C, w, rows_per, in_smem, smem;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// dynamic shared bytes: sub-panel tile (rows_per x (w+1)), U block (w x b),
// L block (w x w); then, reused, the X columns (b x ceil(b/C)) and the
// packed strictly-lower L11 (b (b-1) / 2)
int plan_smem(int n, int b, int j0, int C, int w, int in_smem) {
  const int rows_per = cdiv(n - j0, C);
  const long long p1 = (in_smem ? (long long)rows_per * (w + 1) : 0) + w * b + w * w;
  const long long p2 = (long long)b * cdiv(b, C) + b * (b - 1) / 2;
  return (int)((p1 > p2 ? p1 : p2) * 8);
}

Plan plan_for(int n, int b, int j0, int C) {
  const int rows_per = cdiv(n - j0, C);
  const int ws[4] = {32, 16, 8, 4};
  for (int i = 0; i < 4; ++i) {
    const int w = ws[i] < b ? ws[i] : b;
    const int smem = plan_smem(n, b, j0, C, w, 1);
    if (smem <= SMEM_CAP - STATIC_RESERVE) return {C, w, rows_per, 1, smem};
  }
  const int w = MAXW < b ? MAXW : b;
  return {C, w, rows_per, 0, plan_smem(n, b, j0, C, w, 0)};
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

// block-wide argmax into *cand (lowest index on ties)
__device__ void publish_candidate(float v, int i, Cand* cand, float* red_v, int* red_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_argmax(v, i);
  if (lane == 0) { red_v[warp] = v; red_i[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    v = lane < NW ? red_v[lane] : -2.f;
    i = lane < NW ? red_i[lane] : INT_MAX;
    warp_argmax(v, i);
    if (lane == 0) { cand->v = v; cand->i = i; }
  }
}

// x -= l * u, each product and sum rounded on its own (as the plain version)
__device__ __forceinline__ float2 sub_prod(float2 x, float2 l, float2 u) {
  x.x = x.x - (l.x * u.x - l.y * u.y);
  x.y = x.y - (l.x * u.y + l.y * u.x);
  return x;
}

__global__ void __launch_bounds__(NT, 1)
panel_lu_cluster(float2* __restrict__ A, long long bstride, long long lda, int n,
                 int b, int j0, int C, int w, int rows_per, int in_smem,
                 int* __restrict__ perm_out, float2* __restrict__ invl_out) {
  extern __shared__ float2 dyn[];
  // published for the cluster, double-buffered by column parity: this
  // block's pivot candidate, its candidate row and (its owner's) row g
  __shared__ Cand cand[2];
  __shared__ float2 pub[2][MAXW], pubg[2][MAXW];
  __shared__ float2 stage[MAXC + 1][MAXW];  // the cluster's candidate rows, then row g
  __shared__ float smax;                    // this block's share of the slab max
  __shared__ float red_v[NW];
  __shared__ int red_i[NW];
  __shared__ int piv[MAXB];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const long long node = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float2* S = A + node * bstride;
  const int lo = min(n, j0 + rank * rows_per), hi = min(n, lo + rows_per);

  // ---- zero-pivot substitute: max |.|^2 over the whole slab, cluster-wide ----
  {
    const int share = cdiv(n, C);
    const int r0 = min(n, rank * share), r1 = min(n, r0 + share);
    float m = 0.f;
    for (int r = r0 + warp; r < r1; r += NW)
      for (int c = lane; c < b; c += 32) {
        const float2 v = S[(long long)r * lda + c];
        m = fmaxf(m, v.x * v.x + v.y * v.y);
      }
    for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) red_v[warp] = m;
    __syncthreads();
    if (tid == 0) {
      float mm = red_v[0];
      for (int q = 1; q < NW; ++q) mm = fmaxf(mm, red_v[q]);
      smax = mm;
    }
  }
  cluster.sync();
  float tot = 0.f;
  for (int q = 0; q < C; ++q) tot = fmaxf(tot, *cluster.map_shared_rank(&smax, q));
  const float tiny = FLT_EPSILON * fmaxf(sqrtf(tot), 1e-30f);

  float2* tile = dyn;
  const int ldt = w + 1;
  float2* Ublk = dyn + (in_smem ? (long long)rows_per * ldt : 0);
  float2* Lblk = Ublk + w * b;

  for (int s = 0; s < b; s += w) {
    const int we = min(w, b - s);
    // this block's row r of the sub-panel
    auto mine = [&](int r) -> float2* {
      return in_smem ? tile + (long long)(r - lo) * ldt : S + (long long)r * lda + s;
    };
    // block-wide argmax (bv, bi) of column t + 1 into cand[par]; its row,
    // and row g + 1 where this block owns it, into pub[par], pubg[par]
    auto publish = [&](float bv, int bi, int t, int par) {
      publish_candidate(bv, bi, &cand[par], red_v, red_i);
      __syncthreads();
      const int gn = j0 + s + t + 1, win = cand[par].i;
      if (tid < we) {
        if (win != INT_MAX) pub[par][tid] = mine(win)[tid];
        if (gn >= lo && gn < hi) pubg[par][tid] = mine(gn)[tid];
      }
    };

    if (in_smem) {
      for (int e = tid; e < (hi - lo) * we; e += NT) {
        const int r = e / we, t = e % we;
        tile[r * ldt + t] = S[(long long)(lo + r) * lda + s + t];
      }
      __syncthreads();
    }
    {
      float bv = -1.f;
      int bi = INT_MAX;
      for (int r = max(lo, j0 + s) + tid; r < hi; r += NT) {
        const float2 v = mine(r)[0];
        const float a2 = v.x * v.x + v.y * v.y;
        if (a2 > bv) { bv = a2; bi = r; }
      }
      publish(bv, bi, -1, s & 1);
    }

    for (int t = 0; t < we; ++t) {
      const int k = s + t, g = j0 + k, par = k & 1;
      // One cluster barrier per column: every block has published column
      // k's candidate and rows.  A block overwrites buffer `par` again only
      // after the next barrier, which no block passes before it is done
      // reading this column's buffers.
      cluster.sync();
      float v = -2.f;
      int p = INT_MAX;
      if (lane < C) {
        const Cand c = *cluster.map_shared_rank(&cand[par], lane);
        v = c.v;
        p = c.i;
      }
      warp_argmax(v, p);  // every warp: the pivot row p
      if (tid < (C + 1) * MAXW) {
        const int q = tid / MAXW, col = tid % MAXW;
        if (col < we) {
          const int src = q < C ? q : (g - j0) / rows_per;
          stage[q][col] = cluster.map_shared_rank(q < C ? pub[par] : pubg[par], src)[col];
        }
      }
      __syncthreads();
      const float2* rowp = stage[(p - j0) / rows_per];  // the winner's published row p
      const float2* rowg = stage[C];
      if (tid == 0) piv[k] = p;
      if (tid < we) {
        if (g >= lo && g < hi) mine(g)[tid] = rowp[tid];
        if (p != g && p >= lo && p < hi) mine(p)[tid] = rowg[tid];
      }
      __syncthreads();

      // guarded pivot, Smith's reciprocal
      float pr = rowp[t].x, pi = rowp[t].y;
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

      // multipliers and rank-1 update, one row per thread; the row's entry
      // of the next column feeds the next argmax
      float bv = -1.f;
      int bi = INT_MAX;
      for (int r = max(lo, g + 1) + tid; r < hi; r += NT) {
        float2* row = mine(r);
        const float2 c = row[t];
        const float2 m = make_float2(c.x * inv_r - c.y * inv_i, c.x * inv_i + c.y * inv_r);
        for (int cc = t + 1; cc < we; ++cc) row[cc] = sub_prod(row[cc], m, rowp[cc]);
        row[t] = m;
        if (t + 1 < we) {
          const float2 x = row[t + 1];
          const float a2 = x.x * x.x + x.y * x.y;
          if (a2 > bv) { bv = a2; bi = r; }
        }
      }
      if (t + 1 < we) publish(bv, bi, t, par ^ 1);
    }

    // the sub-panel back to the slab; its swaps on the other columns
    if (in_smem) {
      for (int e = tid; e < (hi - lo) * we; e += NT) {
        const int r = e / we, t = e % we;
        S[(long long)(lo + r) * lda + s + t] = tile[r * ldt + t];
      }
    }
    for (int q = rank * NT + tid; q < b - we; q += C * NT) {
      const int c = q < s ? q : q + we;
      for (int t = 0; t < we; ++t) {
        const long long g = j0 + s + t, p = piv[s + t];
        if (p != g) {
          const float2 x = S[g * lda + c];
          S[g * lda + c] = S[p * lda + c];
          S[p * lda + c] = x;
        }
      }
    }
    cluster.sync();  // the slab is consistent in global memory

    const int s2 = s + we, nr = b - s2;
    if (nr > 0) {
      for (int e = tid; e < we * nr; e += NT)
        Ublk[e] = S[(long long)(j0 + s + e / nr) * lda + s2 + e % nr];
      for (int e = tid; e < we * we; e += NT)
        Lblk[e] = S[(long long)(j0 + s + e / we) * lda + s + e % we];
      cluster.sync();  // every block has the pivot rows before their owners overwrite them
      // U12: pivot row t takes the terms of columns t' < t, in order
      for (int c = tid; c < nr; c += NT)
        for (int t = 1; t < we; ++t) {
          float2 x = Ublk[t * nr + c];
          for (int u = 0; u < t; ++u) x = sub_prod(x, Lblk[t * we + u], Ublk[u * nr + c]);
          Ublk[t * nr + c] = x;
        }
      __syncthreads();
      for (int e = tid; e < we * nr; e += NT) {
        const int r = j0 + s + e / nr;
        if (r >= lo && r < hi) S[(long long)r * lda + s2 + e % nr] = Ublk[e];
      }
      // this block's rows below the pivot rows: the w rank-1 terms in column order
      const int r0 = max(lo, j0 + s2);
      for (int e = tid; e < (hi - r0) * nr; e += NT) {
        const int r = r0 + e / nr, c = e % nr;
        const float2* m = mine(r);
        float2* y = S + (long long)r * lda + s2 + c;
        float2 x = *y;
        for (int t = 0; t < we; ++t) x = sub_prod(x, m[t], Ublk[t * nr + c]);
        *y = x;
      }
    }
    __syncthreads();
  }
  cluster.sync();  // the whole slab is final (L11 for the inverse)

  // perm: the swaps g_k <-> p_k composed in order, traced backwards from
  // each position (rows < j0 keep theirs); block r writes its own rows,
  // block 0 also the rows above j0
  {
    int* perm = perm_out + node * n;
    for (int i = (rank == 0 ? 0 : lo) + tid; i < hi; i += NT) {
      int x = i;
      if (i >= j0)
        for (int k = b - 1; k >= 0; --k) {
          const int g = j0 + k, p = piv[k];
          x = x == g ? p : (x == p ? g : x);
        }
      perm[i] = x;
    }
  }

  // ---- X = L11^{-1}: this block's columns, column-oriented forward substitution ----
  const int cpr = cdiv(b, C);
  const int c0 = min(b, rank * cpr), nc = min(b, c0 + cpr) - c0;
  float2* X = dyn;            // b x nc
  float2* Lp = dyn + b * cpr;  // strictly lower L11, packed by columns
  auto off = [&](int l) { return l * (b - 1) - l * (l - 1) / 2; };
  for (int e = tid; e < b * nc; e += NT)
    X[e] = make_float2(e / nc == c0 + e % nc ? 1.f : 0.f, 0.f);
  for (int e = tid; e < b * b; e += NT) {
    const int r = e / b, l = e % b;
    if (r > l) Lp[off(l) + r - l - 1] = S[(long long)(j0 + r) * lda + l];
  }
  __syncthreads();
  for (int l = 0; l + 1 < b; ++l) {
    const int nrow = b - l - 1, ncl = min(nc, l + 1 - c0);  // X[l, c] == 0 for c > l
    if (ncl > 0)
      for (int e = tid; e < nrow * ncl; e += NT) {
        const int r = l + 1 + e / ncl, c = e % ncl;
        X[r * nc + c] = sub_prod(X[r * nc + c], Lp[off(l) + r - l - 1], X[l * nc + c]);
      }
    __syncthreads();
  }
  float2* Xo = invl_out + node * b * b;
  for (int e = tid; e < b * nc; e += NT) Xo[(e / nc) * b + c0 + e % nc] = X[e];
  cluster.sync();  // no block leaves while the cluster may still read its shared memory
}

// The launch plan: the largest cluster size C <= 8 whose clusters hold the
// whole batch in one wave, else C = 1.  With all_fits, fits[C - 1] receives
// the clusters of every C = 1..8 that fit on the card at once
// (cudaOccupancyMaxActiveClusters); else the search stops at the chosen C.
cudaError_t choose_plan(int n, int b, int j0, int batch, Plan* out, int* fits,
                        bool all_fits) {
  Plan chosen = plan_for(n, b, j0, 1);
  bool found = false;
  for (int C = MAXC; C >= 1 && (all_fits || !found); --C) {
    const Plan p = plan_for(n, b, j0, C);
    cudaError_t err = cudaFuncSetAttribute(
        panel_lu_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = p.smem;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = C;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int fit = 0;
    err = cudaOccupancyMaxActiveClusters(&fit, panel_lu_cluster, &cfg);
    if (err != cudaSuccess) return err;
    fits[C - 1] = fit;
    if (!found && (C == 1 || fit >= batch)) {
      chosen = p;
      found = true;
    }
  }
  *out = chosen;
  return cudaSuccess;
}

bool bad_args(int n, int b, int j0, int batch) {
  return b < 1 || b > MAXB || j0 < 0 || j0 + b > n || batch < 1;
}

}  // namespace

// out: C, w, rows per block, sub-panel in shared memory (0/1), dynamic shared
// bytes, then the clusters of C = 1, ..., 8 that fit at once.
extern "C" int feast_panel_lu_plan(int n, int b, int j0, int batch, int* out) {
  if (bad_args(n, b, j0, batch)) return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err = choose_plan(n, b, j0, batch, &p, out + 5, true);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.C;
  out[1] = p.w;
  out[2] = p.rows_per;
  out[3] = p.in_smem;
  out[4] = p.smem;
  return 0;
}

extern "C" int feast_panel_lu_c64(void* A, long long bstride, long long lda,
                                  int n, int b, int j0, int batch, void* perm,
                                  void* invl, void* stream) {
  if (bad_args(n, b, j0, batch)) return (int)cudaErrorInvalidValue;
  Plan p;
  int fits[MAXC];
  cudaError_t err = choose_plan(n, b, j0, batch, &p, fits, false);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(panel_lu_cluster,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(batch * p.C));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, panel_lu_cluster, (float2*)A, bstride, lda, n, b, j0,
                           p.C, p.w, p.rows_per, p.in_smem, (int*)perm, (float2*)invl);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
