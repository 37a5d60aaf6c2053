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
// Design.  One block of 128 threads per matrix, the batch on the grid (the
// FEAST main path launches a batch of 1 at n = m0 = 48).  Thread t owns
// column t in the column phases and row t in the row phases, so most of the
// sequential algorithm needs no barrier: in the forward pass of a sweep the
// owner of column i computes rotation i from its own column and one barrier
// publishes it; the backward (column) rotations are applied by each row's
// owner to its own row of T and Z with no barrier at all, and the Y and X
// back-substitutions are column-owned.  T lives in shared memory with a
// padded row stride (n+1, against bank conflicts); Z also lives there when
// both fit in 200 KB (n <= 112), else in the global output buffer.  Sums
// are warp shuffles.  The TPU kernel's lane masks and masked-sum
// extractions become plain indexing.
//
// Bound.  The arithmetic is O(n^3) over the sweeps (about 1e7 flop at
// n = 48), microseconds at the card's fp32 rate; the data are a few KB.
// The kernel is bound by its chain of dependent steps (one barrier per
// Givens rotation, a few thousand per decomposition), not by bytes or flops.

#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr int NT = 128;
constexpr int NW = NT / 32;
constexpr int MAXN = 128;
constexpr int SMEM_BUDGET = 200 * 1024;

__device__ __forceinline__ float abs2(float2 v) { return v.x * v.x + v.y * v.y; }

// Sum over the block; every thread returns the same value.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // earlier readers of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = red[0];
  for (int w = 1; w < NW; ++w) s += red[w];
  return s;
}

__global__ void __launch_bounds__(NT)
schur_kernel(const float2* __restrict__ Ain, float2* __restrict__ Tout,
             float2* __restrict__ Zout, float2* __restrict__ Yout,
             float2* __restrict__ Xout, int* __restrict__ stats, int n,
             int maxit, int want_y, int z_in_smem) {
  extern __shared__ float2 sm[];
  __shared__ float red[NW];
  __shared__ float2 v[MAXN];
  __shared__ float cs_c[MAXN];
  __shared__ float2 cs_s[MAXN];
  __shared__ int s_k;

  const int t = threadIdx.x;
  const long long off = (long long)blockIdx.x * n * n;
  const int ldt = n + 1;
  float2* T = sm;
  float2* Z = z_in_smem ? sm + n * ldt : Zout + off;
  const int ldz = z_in_smem ? ldt : n;
  const float eps = FLT_EPSILON;

  for (int e = t; e < n * n; e += NT) {
    const int r = e / n, c = e % n;
    T[r * ldt + c] = Ain[off + e];
    Z[r * ldz + c] = make_float2(r == c ? 1.f : 0.f, 0.f);
  }
  __syncthreads();

  // ---------------- Householder reduction to Hessenberg form -------------
  for (int k = 0; k + 2 < n; ++k) {
    float2 x = make_float2(0.f, 0.f);
    if (t < n && t >= k + 1) x = T[t * ldt + k];
    const float normx = sqrtf(block_sum(abs2(x), red));
    const float2 al = T[(k + 1) * ldt + k];
    const float amag = sqrtf(abs2(al));
    const bool az = amag > 0.f;
    const float phr = az ? al.x / amag : 1.f, phi = az ? al.y / amag : 0.f;
    float2 vt = x;
    if (t == k + 1) { vt.x = x.x + phr * normx; vt.y = x.y + phi * normx; }
    const float vn2 = block_sum(abs2(vt), red);
    const float beta = vn2 > 0.f ? 2.f / vn2 : 0.f;
    if (t < n) v[t] = vt;
    __syncthreads();
    if (t < n) {  // left: w = v^H T (column t), T -= beta v w
      float wr = 0.f, wi = 0.f;
      for (int i = k + 1; i < n; ++i) {
        const float2 vi = v[i], h = T[i * ldt + t];
        wr += vi.x * h.x + vi.y * h.y;
        wi += vi.x * h.y - vi.y * h.x;
      }
      for (int i = k + 1; i < n; ++i) {
        const float2 vi = v[i];
        float2 h = T[i * ldt + t];
        h.x -= beta * (vi.x * wr - vi.y * wi);
        h.y -= beta * (vi.x * wi + vi.y * wr);
        T[i * ldt + t] = h;
      }
    }
    __syncthreads();
    if (t < n) {  // right: u = T v (row t), T -= beta u v^H; Z likewise
      float ur = 0.f, ui = 0.f, qr = 0.f, qi = 0.f;
      for (int j = k + 1; j < n; ++j) {
        const float2 vj = v[j], h = T[t * ldt + j], zz = Z[t * ldz + j];
        ur += h.x * vj.x - h.y * vj.y;
        ui += h.x * vj.y + h.y * vj.x;
        qr += zz.x * vj.x - zz.y * vj.y;
        qi += zz.x * vj.y + zz.y * vj.x;
      }
      for (int j = k + 1; j < n; ++j) {
        const float2 vj = v[j];
        float2 h = T[t * ldt + j], zz = Z[t * ldz + j];
        h.x -= beta * (ur * vj.x + ui * vj.y);
        h.y -= beta * (ui * vj.x - ur * vj.y);
        zz.x -= beta * (qr * vj.x + qi * vj.y);
        zz.y -= beta * (qi * vj.x - qr * vj.y);
        T[t * ldt + j] = h;
        Z[t * ldz + j] = zz;
      }
    }
    __syncthreads();
  }

  // ---------------- shifted QR iteration with deflation -------------------
  float fro = 0.f;
  for (int e = t; e < n * n; e += NT) fro += abs2(T[(e / n) * ldt + e % n]);
  const float fnorm = sqrtf(block_sum(fro, red));
  const float tolfb = eps * (fnorm > 0.f ? fnorm : 1.f);

  // zero negligible subdiagonals; returns the bottom of the active window
  auto deflate = [&]() -> int {
    if (t == 0) s_k = 0;
    __syncthreads();
    if (t + 1 < n) {
      const float2 sub = T[(t + 1) * ldt + t];
      float tol = eps * (sqrtf(abs2(T[t * ldt + t])) +
                         sqrtf(abs2(T[(t + 1) * ldt + t + 1])));
      tol = tol > 0.f ? tol : tolfb;
      if (sqrtf(abs2(sub)) <= tol) T[(t + 1) * ldt + t] = make_float2(0.f, 0.f);
      else atomicMax(&s_k, t + 1);
    }
    __syncthreads();
    return s_k;
  };

  int k = deflate();
  int it = 0, stag = 0, work = 0;
  while (k > 0 && it < maxit) {
    // Wilkinson shift of the trailing active 2x2 (every thread alike)
    const float2 a = T[(k - 1) * ldt + k - 1], bb = T[(k - 1) * ldt + k];
    const float2 g = T[k * ldt + k - 1], d = T[k * ldt + k];
    const float der = (a.x - d.x) * 0.5f, dei = (a.y - d.y) * 0.5f;
    const float bgr = bb.x * g.x - bb.y * g.y, bgi = bb.x * g.y + bb.y * g.x;
    const float t2r = der * der - dei * dei + bgr;
    const float t2i = 2.f * der * dei + bgi;
    const float mag = sqrtf(t2r * t2r + t2i * t2i);
    const float tre = sqrtf(fmaxf((mag + t2r) * 0.5f, 0.f));
    const float tim_ = sqrtf(fmaxf((mag - t2r) * 0.5f, 0.f));
    const float tim = t2i < 0.f ? -tim_ : tim_;
    const float d1r = der + tre, d1i = dei + tim, d2r = der - tre, d2i = dei - tim;
    const float n1 = d1r * d1r + d1i * d1i, n2 = d2r * d2r + d2i * d2i;
    const bool pick1 = n1 >= n2;
    const float dnr = pick1 ? d1r : d2r, dni = pick1 ? d1i : d2i;
    const float dn2 = pick1 ? n1 : n2;
    const bool small = dn2 <= 0.f;
    const float dn2s = small ? 1.f : dn2;
    const float qr = small ? 0.f : (bgr * dnr + bgi * dni) / dn2s;
    const float qi = small ? 0.f : (bgi * dnr - bgr * dni) / dn2s;
    float sig_r = d.x - qr, sig_i = d.y - qi;
    if (stag > 0 && stag % 10 == 0) {  // exceptional shift
      sig_r = d.x + 0.75f * sqrtf(g.x * g.x + g.y * g.y);
      sig_i = d.y;
    }
    __syncthreads();  // everyone has read the 2x2 before the shift lands

    // forward pass: row rotations; thread t owns column t
    if (t <= k) { T[t * ldt + t].x -= sig_r; T[t * ldt + t].y -= sig_i; }
    for (int i = 0; i < k; ++i) {
      if (t == i) {
        const float2 ai = T[i * ldt + i], bi = T[(i + 1) * ldt + i];
        const float na2 = abs2(ai), nb2 = abs2(bi);
        const float r2 = na2 + nb2;
        const bool bz = nb2 == 0.f;
        const float rr = sqrtf(r2 > 0.f ? r2 : 1.f);
        const float absa = sqrtf(na2);
        const bool aznz = na2 > 0.f;
        const float pr = aznz ? ai.x / absa : 1.f, pi = aznz ? ai.y / absa : 0.f;
        cs_c[i] = bz ? 1.f : absa / rr;
        cs_s[i] = make_float2(bz ? 0.f : (pr * bi.x + pi * bi.y) / rr,
                              bz ? 0.f : (pi * bi.x - pr * bi.y) / rr);
      }
      __syncthreads();
      if (t < n) {
        const float c = cs_c[i];
        const float2 s = cs_s[i];
        const float2 ri = T[i * ldt + t], rn = T[(i + 1) * ldt + t];
        T[i * ldt + t] = make_float2(c * ri.x + s.x * rn.x - s.y * rn.y,
                                     c * ri.y + s.x * rn.y + s.y * rn.x);
        T[(i + 1) * ldt + t] = make_float2(rn.x * c - (s.x * ri.x + s.y * ri.y),
                                           rn.y * c - (s.x * ri.y - s.y * ri.x));
      }
    }
    __syncthreads();
    // backward pass: column rotations of T and Z; thread t owns row t
    if (t < n) {
      float2 ct = T[t * ldt], cz = Z[t * ldz];
      for (int i = 0; i < k; ++i) {
        const float c = cs_c[i];
        const float2 s = cs_s[i];
        const float2 nt = T[t * ldt + i + 1], nz = Z[t * ldz + i + 1];
        T[t * ldt + i] = make_float2(c * ct.x + s.x * nt.x + s.y * nt.y,
                                     c * ct.y + s.x * nt.y - s.y * nt.x);
        Z[t * ldz + i] = make_float2(c * cz.x + s.x * nz.x + s.y * nz.y,
                                     c * cz.y + s.x * nz.y - s.y * nz.x);
        ct = make_float2(c * nt.x - (s.x * ct.x - s.y * ct.y),
                         c * nt.y - (s.x * ct.y + s.y * ct.x));
        cz = make_float2(c * nz.x - (s.x * cz.x - s.y * cz.y),
                         c * nz.y - (s.x * cz.y + s.y * cz.x));
      }
      T[t * ldt + k] = ct;
      Z[t * ldz + k] = cz;
      if (t <= k) { T[t * ldt + t].x += sig_r; T[t * ldt + t].y += sig_i; }
    }
    const int k_new = deflate();
    stag = k_new < k ? 0 : stag + 1;
    work += k;
    k = k_new;
    ++it;
  }
  for (int e = t; e < n * n; e += NT) {
    const int r = e / n, c = e % n;
    const float2 h = r > c ? make_float2(0.f, 0.f) : T[r * ldt + c];
    T[r * ldt + c] = h;
    Tout[off + e] = h;
    if (z_in_smem) Zout[off + e] = Z[r * ldz + c];
  }
  if (t == 0) { stats[2 * blockIdx.x] = it; stats[2 * blockIdx.x + 1] = work; }
  __syncthreads();
  if (!want_y) return;

  // ---------------- Y: eigenvectors of T; X = Y^{-1} ----------------------
  float2* Y = Yout + off;
  float2* X = Xout + off;
  for (int e = t; e < n * n; e += NT) {
    const float one = (e / n) == (e % n) ? 1.f : 0.f;
    Y[e] = make_float2(one, 0.f);
    X[e] = make_float2(one, 0.f);
  }
  float tn = 0.f;
  for (int e = t; e < n * n; e += NT) tn += abs2(T[(e / n) * ldt + e % n]);
  const float smln = eps * fmaxf(sqrtf(block_sum(tn, red)), 1.f);
  if (t < n) {  // column t of Y: (T - lam_t I) y = 0, y_t = 1
    const float2 lam = T[t * ldt + t];
    for (int j = t - 1; j >= 0; --j) {
      float nr = 0.f, ni = 0.f;
      for (int l = j + 1; l <= t; ++l) {
        const float2 tj = T[j * ldt + l], yl = Y[l * n + t];
        nr += tj.x * yl.x - tj.y * yl.y;
        ni += tj.x * yl.y + tj.y * yl.x;
      }
      float dr = T[j * ldt + j].x - lam.x, di = T[j * ldt + j].y - lam.y;
      if (sqrtf(dr * dr + di * di) < smln) { dr = smln; di = 0.f; }
      const float d2 = dr * dr + di * di;
      Y[j * n + t] = make_float2(-(nr * dr + ni * di) / d2, -(ni * dr - nr * di) / d2);
    }
  }
  __syncthreads();
  if (t < n) {  // column t of X: row j = e_j - Y[j, j+1:] X[j+1:, :]
    for (int j = t - 1; j >= 0; --j) {
      float nr = 0.f, ni = 0.f;
      for (int l = j + 1; l <= t; ++l) {
        const float2 yj = Y[j * n + l], xl = X[l * n + t];
        nr += yj.x * xl.x - yj.y * xl.y;
        ni += yj.x * xl.y + yj.y * xl.x;
      }
      X[j * n + t] = make_float2(-nr, -ni);
    }
  }
}

}  // namespace

extern "C" int feast_schur_c64(const void* A, void* T, void* Z, void* Y,
                               void* X, void* stats, int n, int batch,
                               int max_sweeps_per_eig, int want_y,
                               void* stream) {
  if (n < 2 || n > MAXN || batch < 1) return (int)cudaErrorInvalidValue;
  const int tbytes = n * (n + 1) * (int)sizeof(float2);
  const int z_in_smem = 2 * tbytes <= SMEM_BUDGET;
  const int smem = z_in_smem ? 2 * tbytes : tbytes;
  cudaError_t err = cudaFuncSetAttribute(
      schur_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  schur_kernel<<<batch, NT, smem, (cudaStream_t)stream>>>(
      (const float2*)A, (float2*)T, (float2*)Z, (float2*)Y, (float2*)X,
      (int*)stats, n, max_sweeps_per_eig * n, want_y, z_in_smem);
  return (int)cudaGetLastError();
}
