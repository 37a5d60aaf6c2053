// Whole complex Schur decomposition A = Z T Z^H of small complex64 matrices
// (2 <= n <= 128) in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel feast_tpu/ops/pallas_eig.py::_schur_kernel
// (launched by schur_pallas, pallas_eig.py:431), with its formulas:
//   * Householder reduction to Hessenberg form (pallas_eig.py:70-115);
//   * single-shift QR sweeps on the active window 0..k: Wilkinson shift with
//     the principal csqrt (:163-199), an exceptional shift d + 0.75|g| every
//     10 stalled sweeps, Givens rotations c = |a|/r, s = phase(a) conj(b)/r
//     (:221-251), deflation of |H[i+1,i]| <= eps (|H_ii| + |H_i+1,i+1|) with
//     the eps ||H||_F fallback (:128-147), at most max_sweeps_per_eig * n
//     sweeps; the result forced upper triangular;
//   * with want_y, the eigenvectors Y of T (unit upper triangular, the smln
//     floor on T_jj - lam_i) and X = Y^{-1} (:313-390).
//
// Bound.  The arithmetic is O(n^3) over the sweeps (about 1e7 flop at
// n = 48), microseconds at the card's fp32 rate; the data are a few KB.
// The kernel is bound by its chain of dependent steps: one Givens rotation
// after another, a few thousand per decomposition.  The design makes each
// step as short as the card allows.
//
// Design: one warp per matrix, no block barrier.  The batch is on the grid,
// up to 4 matrices (warps) a block while their shared memory fits (the
// FEAST paths launch a batch of 1 at n = m0 = 48 and n = 8).  Lane t owns
// columns t, t+32, t+64, t+96 in the row phases and the same rows in the
// column phases; __syncwarp() orders the shared-memory updates between
// dependent steps.  T lives in shared memory with an odd row stride
// (n | 1: a column read by 32 lanes hits 32 banks); Z too while both fit
// in 200 KB (n <= 113), else in the global output, column-major until the
// end (a lane owns rows of Z, so a warp's accesses are then coalesced).
//   * Householder: the norms are warp shuffles, v sits in shared memory,
//     the left update is column-owned, the right update (T and Z) row-owned.
//   * Deflation: each lane tests its subdiagonals, zeroes the negligible
//     ones, and __ballot_sync + __clz give the bottom of the active window.
//   * Shift: every lane computes the Wilkinson shift from the same four
//     entries (a broadcast read), so the warp has it without a shuffle.
//   * Sweep, forward and backward fused at a lag of two: step i applies
//     row rotation i to rows i, i+1 at columns >= i and column rotation
//     i-2 to columns i-2, i-1 of T at rows <= i (left of i and below the
//     subdiagonal T holds only the rounding residues of eliminated
//     entries).  Column rotation j touches columns j, j+1 and row rotation
//     i touches columns >= i, so for j <= i-2 they touch disjoint entries
//     and commute: the fused sweep is exactly the two-pass sweep with the
//     same restrictions (tests/test_torch_hopper_designs.py holds the two
//     float32 mirrors equal), and the two updates of one step never write
//     the same entry.  The last two column rotations run after the loop.
//     The restrictions also let a step skip the lane's column groups
//     wholly left of i and row groups wholly below it: G + 1 group updates
//     a step instead of 2 G.
//   * A lane's columns of rows i and i+1 stay in registers from step to
//     step (row i+2 is read a step ahead: no rotation of the sweep has
//     touched it at columns > i yet), so the chain from one rotation to the
//     next runs in registers: every lane forms rotation i+1 from its own
//     column of the owner's group (no divergence), the owner's (c, s) is
//     broadcast with __shfl_sync, and T's column rotation fills the latency
//     of that chain.
//   * Z's column rotations feed nothing back into the sweep, so they leave
//     the step: the sweep keeps its rotations in shared memory and each
//     lane then applies them to its rows of Z in one pass, the rotated
//     column carried in a register.
//   * Every square root and quotient (rotation, shift, deflation test,
//     Householder, Y) comes from the hardware estimate and one residual
//     correction: IEEE sqrtf and '/' carry slow-path branches, and the
//     group count G = ceil(n/32) is a template constant with lanes past n
//     working on a per-warp sink row instead of branching around it.  A
//     branch that can split the warp costs a convergence barrier, and a
//     single warp waits through every one on its critical path.
//   * Y and X: column-owned back-substitutions, up to 4 columns a lane, in
//     shared memory where Z and T were when Z fits there (Y then X), else
//     in the global outputs.
//   * Scale: the warp first scales A by the power of two that brings its
//     largest entry into [1, 2), and T by the inverse at the end (exact, as
//     a power of two).  The Schur steps are homogeneous in A, so this
//     changes none of their results in the normal range, and it keeps the
//     squared norms that the estimates below take in the normal range for
//     entries of any magnitude (1e-20 in SI units, say), where their
//     FLT_MIN floors would otherwise bias the rotations.  Y's smln floor
//     eps max(||T||_F, 1) is taken on the scaled T, so it is the same as
//     the plain version's where ||A||_F >= 1 and relative to ||T||_F below
//     (the plain version's absolute eps would floor every eigenvalue gap
//     of a matrix of norm 1e-20).

#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr int MAXN = 128;
constexpr int MAXW = 4;                 // matrices (warps) a block
constexpr int SMEM_BUDGET = 200 * 1024;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float abs2(float2 v) { return v.x * v.x + v.y * v.y; }

template <int V>
struct Int { static constexpr int value = V; };

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// 2^e for -126 <= e <= 127
__device__ __forceinline__ float pow2(int e) { return __int_as_float((127 + e) << 23); }

// Square root and quotient from the hardware estimates (MUFU) and one
// residual correction: within an ulp of the IEEE results for operands in
// the normal range (sqrt_nr raises x to FLT_MIN, rcp.approx overflows for
// divisors below about 2.9e-39; the scaling of A keeps the kernel's
// operands above both), the errors of either sign, and no slow-path branch
// (a single warp waits through every branch of sqrtf and '/', which are
// IEEE-exact and call a slow path for rare operands)
__device__ __forceinline__ float rcp_est(float x) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ float sqrt_nr(float x) {  // x >= 0
  const float xs = fmaxf(x, FLT_MIN);                 // no 0 * inf at x = 0
  const float y = rsqrtf(xs), r = xs * y;
  const float v = fmaf(fmaf(-r, r, xs), 0.5f * y, r);
  return x > 0.f ? v : 0.f;                           // a select, not a branch
}
__device__ __forceinline__ float div_nr(float a, float b) {
  const float r = rcp_est(b), q = a * r;
  return fmaf(fmaf(-b, q, a), r, q);
}

// rotation G = [[c, s], [-conj(s), c]] with G [a; b] = [r; 0]:
// c = |a| / r, s = phase(a) conj(b) / r.  Every estimate is formed on a
// safe operand first and the special cases (a = 0: phase 1; b = 0: c = 1,
// s = 0) are selects after it, not branches
__device__ __forceinline__ void givens(float2 a, float2 b, float& c, float2& s) {
  const float na2 = abs2(a), nb2 = abs2(b);
  const bool bz = nb2 == 0.f, az = na2 == 0.f;
  const float rr = fmaxf(sqrt_nr(na2 + nb2), FLT_MIN);
  const float absa = sqrt_nr(na2), absa_s = fmaxf(absa, FLT_MIN);
  const float pr0 = div_nr(a.x, absa_s), pi0 = div_nr(a.y, absa_s);
  const float pr = az ? 1.f : pr0, pi = az ? 0.f : pi0;
  const float c0 = div_nr(absa, rr);
  const float sr = div_nr(pr * b.x + pi * b.y, rr), si = div_nr(pi * b.x - pr * b.y, rr);
  c = bz ? 1.f : c0;
  s = make_float2(bz ? 0.f : sr, bz ? 0.f : si);
}

__device__ __forceinline__ float2 rot_top(float c, float2 s, float2 u, float2 w) {
  return make_float2(c * u.x + s.x * w.x - s.y * w.y, c * u.y + s.x * w.y + s.y * w.x);
}
__device__ __forceinline__ float2 rot_bot(float c, float2 s, float2 u, float2 w) {
  return make_float2(w.x * c - (s.x * u.x + s.y * u.y), w.y * c - (s.x * u.y - s.y * u.x));
}

// columns (j, j+1) of one row, holding u, w: M[:, j] = c u + conj(s) w,
// M[:, j+1] = c w - s u
__device__ __forceinline__ void col_rot(float2* at, float c, float2 s, float2 u, float2 w) {
  at[0] = make_float2(c * u.x + s.x * w.x + s.y * w.y, c * u.y + s.x * w.y - s.y * w.x);
  at[1] = make_float2(c * w.x - (s.x * u.x - s.y * u.y), c * w.y - (s.x * u.y + s.y * u.x));
}
__device__ __forceinline__ void col_rot(float2* row, int j, float c, float2 s) {
  col_rot(row + j, c, s, row[j], row[j + 1]);
}

// Y: eigenvectors of upper-triangular T (column-owned back-substitution,
// y_t = 1, the smln floor eps max(||T||_F, 1) on T_jj - lam_t); X = Y^{-1},
// column-owned too.  Y and X have row strides ldy, ldx; X may take T's
// place (T is read only while Y is formed)
template <int G>
__device__ __forceinline__ void ys_and_xs(const float2* T, float2* Y, int ldy, float2* X,
                                          int ldx, int n, int ldt, int lane) {
  const float eps = FLT_EPSILON;
  float tn = 0.f;
  for (int e = lane; e < n * n; e += 32) {
    const int r = e / n, c = e - r * n;
    Y[r * ldy + c] = make_float2(r == c ? 1.f : 0.f, 0.f);
    tn += abs2(T[r * ldt + c]);
  }
  const float smln = eps * fmaxf(sqrt_nr(warp_sum(tn)), 1.f);
  __syncwarp();
#pragma unroll
  for (int q = 0; q < G; ++q) {  // column t of Y: (T - lam_t I) y = 0, y_t = 1
    const int t = lane + 32 * q;
    if (t >= n) continue;
    const float2 lam = T[t * ldt + t];
    for (int j = t - 1; j >= 0; --j) {
      float nr = 0.f, ni = 0.f;
#pragma unroll 4
      for (int l = j + 1; l <= t; ++l) {
        const float2 tj = T[j * ldt + l], yl = Y[l * ldy + t];
        nr += tj.x * yl.x - tj.y * yl.y;
        ni += tj.x * yl.y + tj.y * yl.x;
      }
      float dr = T[j * ldt + j].x - lam.x, di = T[j * ldt + j].y - lam.y;
      const bool tiny = sqrt_nr(dr * dr + di * di) < smln;
      dr = tiny ? smln : dr;
      di = tiny ? 0.f : di;
      const float d2 = dr * dr + di * di;
      Y[j * ldy + t] = make_float2(-div_nr(nr * dr + ni * di, d2), -div_nr(ni * dr - nr * di, d2));
    }
  }
  __syncwarp();
  for (int e = lane; e < n * n; e += 32) {
    const int r = e / n, c = e - r * n;
    X[r * ldx + c] = make_float2(r == c ? 1.f : 0.f, 0.f);
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < G; ++q) {  // column t of X: row j = e_j - Y[j, j+1:] X[j+1:, :]
    const int t = lane + 32 * q;
    if (t >= n) continue;
    for (int j = t - 1; j >= 0; --j) {
      float nr = 0.f, ni = 0.f;
#pragma unroll 4
      for (int l = j + 1; l <= t; ++l) {
        const float2 yj = Y[j * ldy + l], xl = X[l * ldx + t];
        nr += yj.x * xl.x - yj.y * xl.y;
        ni += yj.x * xl.y + yj.y * xl.x;
      }
      X[j * ldx + t] = make_float2(-nr, -ni);
    }
  }
  __syncwarp();
}

// G = ceil(n / 32) groups of 32 columns (rows) a lane walks: a compile-time
// count, and lanes past n act on a per-warp sink row instead of skipping,
// so the warp's code stays straight-line (no convergence barriers)
template <int G, bool ZG>
__global__ void __launch_bounds__(32 * MAXW)
schur_kernel(const float2* __restrict__ Ain, float2* __restrict__ Tout,
             float2* __restrict__ Zout, float2* __restrict__ Yout,
             float2* __restrict__ Xout, int* __restrict__ stats,
             int n, int batch, int maxit, int want_y) {
  constexpr bool z_in_smem = !ZG;
  extern __shared__ float2 sm[];
  __shared__ float2 vsh[MAXW][MAXN];
  __shared__ float2 sinks[MAXW][MAXN + 2];
  __shared__ float4 rots[MAXW][MAXN];     // (c, s) of the sweep's rotations
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int mat = blockIdx.x * (blockDim.x >> 5) + wid;
  if (mat >= batch) return;  // the whole warp: nothing below waits for it

  const long long off = (long long)mat * n * n;
  const int ldt = n | 1;
  const int per = n * ldt;
  float2* sink = sinks[wid];
  float2* T = sm + (long long)wid * per * (z_in_smem ? 2 : 1);
  // Z(r, c) at Z[r zr + c zc]: row-major with T's stride in shared memory;
  // in the global output (n >= 114) column-major while it is formed, so the
  // row-owned accesses of a warp are coalesced, and transposed at the end
  float2* Z = z_in_smem ? T + per : Zout + off;
  const int zr = ZG ? 1 : ldt, zc = ZG ? n : 1;
  // a lane's row r of Z, or for r >= n what stands in for it: the sink in
  // shared memory; in global memory row r - 32 (n >= 114, so it is a row
  // the same lane owns in its previous group, and the lane computes and
  // stores the same values for it twice)
  auto zrow = [&](int r) -> float2* {
    return r < n ? Z + r * zr : (z_in_smem ? sink : Z + (r - 32) * zr);
  };
  float2* v = vsh[wid];
  float4* rot = rots[wid];
  const float eps = FLT_EPSILON;

  // the power of two 2^-e that brings the largest |re|, |im| into [1, 2)
  // (e clamped to [-126, 126]: a subnormal largest entry is raised to at
  // least 2^-23, an infinite one stays so)
  float amax = 0.f;
  for (int e = lane; e < n * n; e += 32) {
    const float2 x = Ain[off + e];
    amax = fmaxf(amax, fmaxf(fabsf(x.x), fabsf(x.y)));
  }
  const int e2 = min(max(((__float_as_int(warp_max(amax)) >> 23) & 0xff) - 127, -126), 126);
  const float down = pow2(-e2), up = pow2(e2);
  for (int e = lane; e < n * n; e += 32) {
    const int r = e / n, c = e - r * n;
    const float2 x = Ain[off + e];
    T[r * ldt + c] = make_float2(x.x * down, x.y * down);
    Z[r * zr + c * zc] = make_float2(r == c ? 1.f : 0.f, 0.f);
  }
  __syncwarp();

  // ---------------- Householder reduction to Hessenberg form -------------
  for (int k = 0; k + 2 < n; ++k) {
    float s1 = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int r = lane + 32 * g;
      const bool ok = r > k && r < n;
      const float2 x = T[(ok ? r : k) * ldt + k];
      s1 += ok ? abs2(x) : 0.f;
    }
    const float normx = sqrt_nr(warp_sum(s1));
    const float2 al = T[(k + 1) * ldt + k];
    const float amag = sqrt_nr(abs2(al)), amag_s = fmaxf(amag, FLT_MIN);
    const bool az = amag > 0.f;
    const float phr0 = div_nr(al.x, amag_s), phi0 = div_nr(al.y, amag_s);
    const float phr = az ? phr0 : 1.f, phi = az ? phi0 : 0.f;
    float s2 = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int r = lane + 32 * g;
      const bool ok = r > k && r < n;
      float2 x = T[(ok ? r : k) * ldt + k];
      if (r == k + 1) { x.x += phr * normx; x.y += phi * normx; }
      *(ok ? v + r : sink) = x;
      s2 += ok ? abs2(x) : 0.f;
    }
    const float vn2 = warp_sum(s2);
    const float beta0 = div_nr(2.f, fmaxf(vn2, FLT_MIN));
    const float beta = vn2 > 0.f ? beta0 : 0.f;
    __syncwarp();
    // left, column-owned: w = v^H T[:, c], T[:, c] -= beta v w (columns
    // left of k are zero below row k); lanes past n work on column n-1 and
    // write to the sink; the next row is read before the row is stored
    float2 w[G];
    int cc[G];
    bool cok[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int c = lane + 32 * g;
      cok[g] = c >= k && c < n;
      cc[g] = c < n ? c : n - 1;
      w[g] = make_float2(0.f, 0.f);
    }
#pragma unroll 4
    for (int i = k + 1; i < n; ++i) {
      const float2 vi = v[i];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float2 h = T[i * ldt + cc[g]];
        w[g].x += vi.x * h.x + vi.y * h.y;
        w[g].y += vi.x * h.y - vi.y * h.x;
      }
    }
    {
      float2 hn[G];
#pragma unroll
      for (int g = 0; g < G; ++g) hn[g] = T[(k + 1) * ldt + cc[g]];
      for (int i = k + 1; i < n; ++i) {
        const float2 vi = v[i];
        float2 h[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          h[g] = hn[g];
          hn[g] = T[min(i + 1, n - 1) * ldt + cc[g]];
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          h[g].x -= beta * (vi.x * w[g].x - vi.y * w[g].y);
          h[g].y -= beta * (vi.x * w[g].y + vi.y * w[g].x);
          *(cok[g] ? T + i * ldt + cc[g] : sink + g) = h[g];
        }
      }
    }
    __syncwarp();
    // right, row-owned: u = T[r, :] v, T[r, :] -= beta u v^H; Z likewise
    float2 u[G], q[G];
    float2* rt[G];
    float2* rz[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int r = lane + 32 * g;
      rt[g] = r < n ? T + r * ldt : sink;
      rz[g] = zrow(r);
      u[g] = q[g] = make_float2(0.f, 0.f);
    }
#pragma unroll 4
    for (int j = k + 1; j < n; ++j) {
      const float2 vj = v[j];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float2 h = rt[g][j], zz = rz[g][j * zc];
        u[g].x += h.x * vj.x - h.y * vj.y;
        u[g].y += h.x * vj.y + h.y * vj.x;
        q[g].x += zz.x * vj.x - zz.y * vj.y;
        q[g].y += zz.x * vj.y + zz.y * vj.x;
      }
    }
    {
      float2 hn[G], zn[G];
#pragma unroll
      for (int g = 0; g < G; ++g) { hn[g] = rt[g][k + 1]; zn[g] = rz[g][(k + 1) * zc]; }
      for (int j = k + 1; j < n; ++j) {
        const float2 vj = v[j];
        const int jn = min(j + 1, n - 1);
        float2 h[G], zz[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          h[g] = hn[g]; zz[g] = zn[g];
          hn[g] = rt[g][jn]; zn[g] = rz[g][jn * zc];
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          h[g].x -= beta * (u[g].x * vj.x + u[g].y * vj.y);
          h[g].y -= beta * (u[g].y * vj.x - u[g].x * vj.y);
          zz[g].x -= beta * (q[g].x * vj.x + q[g].y * vj.y);
          zz[g].y -= beta * (q[g].y * vj.x - q[g].x * vj.y);
          rt[g][j] = h[g];
          rz[g][j * zc] = zz[g];
        }
      }
    }
    __syncwarp();
  }

  // ---------------- shifted QR iteration with deflation -------------------
  float fro = 0.f;
  for (int e = lane; e < n * n; e += 32) {
    const int r = e / n;
    fro += abs2(T[r * ldt + e - r * n]);
  }
  const float fnorm = sqrt_nr(warp_sum(fro));
  const float tolfb = eps * (fnorm > 0.f ? fnorm : 1.f);

  // zero negligible subdiagonals; returns the bottom of the active window
  auto deflate = [&]() -> int {
    int kk = 0;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int i = lane + 32 * g;
      const bool ok = i + 1 < n;
      const int ic = ok ? i : 0;
      const float2 sub = T[(ic + 1) * ldt + ic];
      float tol = eps * (sqrt_nr(abs2(T[ic * ldt + ic])) + sqrt_nr(abs2(T[(ic + 1) * ldt + ic + 1])));
      tol = tol > 0.f ? tol : tolfb;
      const bool live = ok && !(sqrt_nr(abs2(sub)) <= tol);
      *(ok && !live ? T + (ic + 1) * ldt + ic : sink) = make_float2(0.f, 0.f);
      const unsigned mask = __ballot_sync(FULL, live);
      if (mask) kk = 32 * g + 32 - __clz(mask);
    }
    __syncwarp();
    return kk;
  };

  int k = deflate();
  int it = 0, stag = 0, work = 0;
  while (k > 0 && it < maxit) {
    // Wilkinson shift of the trailing active 2x2 (every lane alike)
    const float2 a = T[(k - 1) * ldt + k - 1], bb = T[(k - 1) * ldt + k];
    const float2 g = T[k * ldt + k - 1], d = T[k * ldt + k];
    const float der = (a.x - d.x) * 0.5f, dei = (a.y - d.y) * 0.5f;
    const float bgr = bb.x * g.x - bb.y * g.y, bgi = bb.x * g.y + bb.y * g.x;
    const float t2r = der * der - dei * dei + bgr;
    const float t2i = 2.f * der * dei + bgi;
    const float mag = sqrt_nr(t2r * t2r + t2i * t2i);
    const float tre = sqrt_nr(fmaxf((mag + t2r) * 0.5f, 0.f));
    const float tim_ = sqrt_nr(fmaxf((mag - t2r) * 0.5f, 0.f));
    const float tim = t2i < 0.f ? -tim_ : tim_;
    const float d1r = der + tre, d1i = dei + tim, d2r = der - tre, d2i = dei - tim;
    const float n1 = d1r * d1r + d1i * d1i, n2 = d2r * d2r + d2i * d2i;
    const bool pick1 = n1 >= n2;
    const float dnr = pick1 ? d1r : d2r, dni = pick1 ? d1i : d2i;
    const float dn2 = pick1 ? n1 : n2;
    const bool small = dn2 <= 0.f;
    const float dn2s = small ? 1.f : dn2;
    const float qr0 = div_nr(bgr * dnr + bgi * dni, dn2s);
    const float qi0 = div_nr(bgi * dnr - bgr * dni, dn2s);
    const float qr = small ? 0.f : qr0, qi = small ? 0.f : qi0;
    float sig_r = d.x - qr, sig_i = d.y - qi;
    if (stag > 0 && stag % 10 == 0) {  // exceptional shift
      sig_r = d.x + 0.75f * sqrt_nr(g.x * g.x + g.y * g.y);
      sig_i = d.y;
    }
    __syncwarp();  // every lane has read the 2x2 before the shift lands
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int c = lane + 32 * q;
      const bool ok = c <= k && c < n;
      float2* p = ok ? T + c * ldt + c : sink;
      const float2 t = *p;
      *p = make_float2(t.x - sig_r, t.y - sig_i);
    }
    __syncwarp();

    // The lane's columns of rows i and i+1 ride in registers (cur, nxt)
    // from step to step: row rotation i reads and writes only them, and
    // row i+2 (untouched in this sweep at columns > i) is read at the top
    // of the step, before any store.  Shared memory receives every rotated
    // entry for the column rotations, which read it a step or more later.
    float2 cur[G], nxt[G];
    int cc[G];
    float2* rt[G];
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int c = lane + 32 * q;
      cc[q] = c < n ? c : n - 1;
      cur[q] = T[cc[q]];
      nxt[q] = T[ldt + cc[q]];
      rt[q] = c < n ? T + c * ldt : sink;
    }
    float c0, c1 = 1.f, c2 = 1.f;          // rotations i, i-1, i-2
    float2 s0, s1 = make_float2(0.f, 0.f), s2 = s1;
    givens(T[0], T[ldt], c0, s0);          // rotation 0, every lane alike
    rot[0] = make_float4(c0, s0.x, s0.y, 0.f);
    // step i; P = i / 32 as a compile-time constant (the steps run in
    // segments of 32): the column groups q < P lie wholly left of i and are
    // done for the sweep, the row groups q > P lie wholly below i, and
    // neither costs an instruction or a branch
    auto step = [&](auto p_const, int i) {
      constexpr int P = decltype(p_const)::value;
      // row i+2 of the lane's columns, for rotation i+1 and the next step
      const int i2 = min(i + 2, n - 1);
      float2 n2[G];
#pragma unroll
      for (int q = P; q < G; ++q) n2[q] = T[i2 * ldt + cc[q]];
      // row rotation i on rows i, i+1 at the lane's columns >= i
#pragma unroll
      for (int q = P; q < G; ++q) {
        const int c = lane + 32 * q;
        const float2 top = rot_top(c0, s0, cur[q], nxt[q]);
        const float2 bot = rot_bot(c0, s0, cur[q], nxt[q]);
        const bool ok = c >= i && c < n;
        *(ok ? T + i * ldt + c : sink + 2 * q) = top;
        *(ok ? T + (i + 1) * ldt + c : sink + 2 * q + 1) = bot;
        cur[q] = bot;
        nxt[q] = n2[q];
      }
      // rotation i+1 from (rotated T[i+1, i+1], T[i+2, i+1]): every lane
      // forms one from its own column of that group, the owner's is used
      const int gn = (i + 1) >> 5;
      float2 an = cur[0], bn = nxt[0];
#pragma unroll
      for (int q = 1; q < G; ++q)
        if (gn == q) { an = cur[q]; bn = nxt[q]; }
      float cn;
      float2 sn;
      givens(an, bn, cn, sn);
      // column rotation i-2 of T on the lane's rows <= i (below, columns
      // i-2 and i-1 hold only rounding residues), every load issued before
      // the first store
      if (i >= 2) {
        float2 tu[G], tw[G];
#pragma unroll
        for (int q = 0; q <= P; ++q) { tu[q] = rt[q][i - 2]; tw[q] = rt[q][i - 1]; }
#pragma unroll
        for (int q = 0; q <= P; ++q)
          col_rot(lane + 32 * q <= i ? rt[q] + i - 2 : sink + 2 * G, c2, s2, tu[q], tw[q]);
      }
      const int src = (i + 1) & 31;
      cn = __shfl_sync(FULL, cn, src);
      sn.x = __shfl_sync(FULL, sn.x, src);
      sn.y = __shfl_sync(FULL, sn.y, src);
      rot[i + 1] = make_float4(cn, sn.x, sn.y, 0.f);  // every lane the same value
      c2 = c1; s2 = s1; c1 = c0; s1 = s0; c0 = cn; s0 = sn;
      __syncwarp();
    };
    // unrolled by 8, so that a step's work off the rotation chain (T's
    // column rotation, the next row's loads) overlaps the chains of the
    // steps after it
#pragma unroll 8
    for (int i = 0; i < min(k, 32); ++i) step(Int<0>{}, i);
    if (G > 1) {
#pragma unroll 8
      for (int i = 32; i < min(k, 64); ++i) step(Int<(G > 1)>{}, i);
    }
    if (G > 2) {
#pragma unroll 8
      for (int i = 64; i < min(k, 96); ++i) step(Int<2 * (G > 2)>{}, i);
    }
    if (G > 3) {
#pragma unroll 8
      for (int i = 96; i < k; ++i) step(Int<3 * (G > 3)>{}, i);
    }
    // the last two column rotations of T (k-2 on rows <= k, k-1 on rows
    // <= k+1), then the shift back; a lane owns row r in both and so the
    // diagonal entry (r, r)
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const int r = lane + 32 * q;
      if (k >= 2) col_rot(r <= k ? rt[q] : sink, k - 2, c2, s2);
      col_rot(r <= k + 1 ? rt[q] : sink, k - 1, c1, s1);
      float2* p = r <= k && r < n ? rt[q] + r : sink;
      const float2 t = *p;
      *p = make_float2(t.x + sig_r, t.y + sig_i);
    }
    // Z's column rotations feed nothing back into the sweep: each lane
    // applies the sweep's k rotations to its rows of Z in one pass, the
    // rotated column j+1 carried in a register, the groups interleaved and
    // the next column read before the store
    {
      float2* zp[G];
      float2 carry[G], wn[G];
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const int r = lane + 32 * q;
        zp[q] = zrow(r);
        carry[q] = zp[q][0];
        wn[q] = zp[q][zc];
      }
#pragma unroll 2
      for (int j = 0; j < k; ++j) {
        const float4 cs = rot[j];
        const int jn = min(j + 2, n - 1);
        float2 w[G];
#pragma unroll
        for (int q = 0; q < G; ++q) { w[q] = wn[q]; wn[q] = zp[q][jn * zc]; }
#pragma unroll
        for (int q = 0; q < G; ++q) {
          const float2 u = carry[q];
          zp[q][j * zc] = make_float2(cs.x * u.x + cs.y * w[q].x + cs.z * w[q].y,
                                 cs.x * u.y + cs.y * w[q].y - cs.z * w[q].x);
          carry[q] = make_float2(cs.x * w[q].x - (cs.y * u.x - cs.z * u.y),
                                 cs.x * w[q].y - (cs.y * u.y + cs.z * u.x));
        }
      }
#pragma unroll
      for (int q = 0; q < G; ++q) zp[q][k * zc] = carry[q];
    }
    __syncwarp();
    const int k_new = deflate();
    stag = k_new < k ? 0 : stag + 1;
    work += k;
    k = k_new;
    ++it;
  }
  for (int e = lane; e < n * n; e += 32) {
    const int r = e / n, c = e - r * n;
    const float2 h = r > c ? make_float2(0.f, 0.f) : T[r * ldt + c];
    T[r * ldt + c] = h;
    Tout[off + e] = make_float2(h.x * up, h.y * up);
    if (z_in_smem) {
      Zout[off + e] = Z[r * zr + c];
    } else if (r < c) {  // column-major to row-major, in place
      const float2 t = Z[e];
      Z[e] = Z[c * n + r];
      Z[c * n + r] = t;
    }
  }
  if (lane == 0) { stats[2 * mat] = it; stats[2 * mat + 1] = work; }
  __syncwarp();
  if (want_y) {
    if (z_in_smem) {  // Y where Z was, X where T was, then out
      ys_and_xs<G>(T, Z, ldt, T, ldt, n, ldt, lane);
      for (int e = lane; e < n * n; e += 32) {
        const int r = e / n, c = e - r * n;
        Yout[off + e] = Z[r * ldt + c];
        Xout[off + e] = T[r * ldt + c];
      }
    } else {
      ys_and_xs<G>(T, Yout + off, n, Xout + off, n, n, ldt, lane);
    }
  }
}


const void* kernel_for(int n, bool z_global) {
  switch ((n + 31) / 32) {
    case 1: return (const void*)schur_kernel<1, false>;
    case 2: return (const void*)schur_kernel<2, false>;
    case 3: return (const void*)schur_kernel<3, false>;
    default:
      return z_global ? (const void*)schur_kernel<4, true> : (const void*)schur_kernel<4, false>;
  }
}

}  // namespace

// A: (batch, n, n); T, Z and, with want_y, Y, X: the same; stats: (batch, 2)
// int32 of (sweeps, sum of active-window sizes).  T with the odd row stride
// n | 1 in shared memory, Z beside it while both fit in 200 KB, and as many
// matrices (one warp each, at most 4) a block as fit.
extern "C" int feast_schur_c64(const void* A, void* T, void* Z, void* Y,
                               void* X, void* stats, int n, int batch,
                               int max_sweeps_per_eig, int want_y,
                               void* stream) {
  if (n < 2 || n > MAXN || batch < 1) return (int)cudaErrorInvalidValue;
  const int tbytes = n * (n | 1) * (int)sizeof(float2);
  const int zs = 2 * tbytes <= SMEM_BUDGET;
  const int per = zs ? 2 * tbytes : tbytes;
  int w = SMEM_BUDGET / per;
  w = w < MAXW ? w : MAXW;
  w = w < batch ? w : batch;
  const int smem = w * per;
  const void* fn = kernel_for(n, !zs);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int maxit = max_sweeps_per_eig * n;
  void* args[] = {&A, &T, &Z, &Y, &X, &stats, &n, &batch, &maxit, &want_y};
  err = cudaLaunchKernel(fn, dim3((batch + w - 1) / w), dim3(32 * w), args, (size_t)smem,
                         (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
