// Complex64 matrix product C = A B at fp32 accuracy on Hopper's tensor
// cores (sm_90a): interleaved complex in and out, an optional leading
// batch, any M, N, K.
//
// Replaces the TPU kernel feast_tpu/ops/pallas_kernels.py::
// _cmatmul_pallas_padded (launched by cmatmul_pallas, pallas_kernels.py:85).
// That kernel forms three real products per tile (Karatsuba) on the matrix
// unit at Precision.HIGHEST, which builds fp32 accuracy out of several
// passes of a lower-precision unit.  This one does the same on the TF32
// tensor cores ("3xTF32"): each fp32 operand x is split into
// big = tf32_rna(x) and small = tf32_rna(x - big), and each real product is
// small*big + big*small + big*big, accumulated in fp32 (small*small lies
// below fp32 rounding).  The complex product is Karatsuba, as in the TPU
// body and in the plain version cx._cmatmul_planes:
//
//     t1 = Ar Br,  t2 = Ai Bi,  t3 = (Ar + Ai)(Br + Bi),
//     Cr = t1 - t2,  Ci = t3 - t1 - t2,
//
// so nine TF32 MMAs per 8-deep k-step and tile, against twelve for four
// products.
//
// Design.  A block of 256 threads (two warpgroups) owns a 128 x 64 tile of
// C; each warpgroup 64 rows, computed by wgmma.mma_async m64n64k8 tf32 with
// A from registers and B from shared memory, into three fp32 accumulators
// (t1, t2, t3: 96 registers a thread).  K is walked in steps of 16: the raw
// complex64 tiles of A and B go through a ring of three shared-memory slots
// by cp.async (8-byte copies, so any base alignment and row stride works;
// zeros past the edges), two steps ahead of the tensor cores, and each step
// the threads convert one raw tile, two barriers per step: A into the fp32
// planes Ar, Ai, Ar + Ai (each warp splits its own rows' fragments into big
// and small in registers, since no other warp reads them), B into the six
// tf32 planes big and small of Br, Bi, Br + Bi, K-major in the core-matrix
// layout the wgmma descriptors name (wgmma's tf32 form reads B K-major
// only, and B arrives N-major: the conversion transposes it).  Each
// product's six MMAs of a step sum into a fresh register tile that is
// added to its accumulator with one fp32 add, so the large sums take K / 16
// roundings (3 K / 8 if the MMAs summed into them directly: twice the fp32
// error at K = 4096); two such tiles alternate, so one product runs while
// the previous is added.  The epilogue forms Cr, Ci and stores interleaved
// complex with bounds checks, as streaming stores (16 bytes where aligned).  Row strides and batch strides are passed
// in, so slices of a larger matrix and operands shared across the batch
// (stride 0) need no copy.
//
// Bound.  At fp32 accuracy the least time is the smaller of 6 M N K flop at
// the 67 TFLOP/s fp32 rate and 3 x 6 M N K at the 495 TFLOP/s TF32
// tensor-core rate (3xTF32 Karatsuba), against 8 (M K + K N + M N) bytes
// at 3.35 TB/s: by operations on the tensor cores for every shape the
// dense path produces (1.173 ms at 16 x 3968 x 128 x 3968).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BM = 128, BN = 64, BK = 16;
constexpr int NT = 256;                 // two warpgroups, 64 rows of C each
constexpr int LDA_S = BK + 4;           // A plane row stride (floats)
constexpr int A_PLANE = BM * LDA_S;     // floats
constexpr int B_PLANE = BN * BK;        // floats, K-major core matrices
constexpr int STAGE = 3 * A_PLANE + 6 * B_PLANE;  // floats
constexpr int RAW = BM * BK + BK * BN;  // float2: one raw A and B tile
constexpr int NRAW = 3;                 // raw tiles in flight
constexpr int SMEM_BYTES = STAGE * 4 + NRAW * RAW * 8;
constexpr int A_PER_T = BM * BK / NT, B_PER_T = BK * BN / NT;

// 8-byte asynchronous copy global -> shared; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// B planes: an N x K tile of tf32 as 8 x 4 core matrices (8 rows of 16
// bytes), the K-adjacent ones 128 bytes apart (LBO), the N-adjacent ones
// 32 BK bytes apart (SBO): wgmma's K-major layout without swizzle
__device__ __forceinline__ int b_off(int kk, int col) {
  return (col >> 3) * (8 * BK) + (kk >> 2) * 32 + (col & 7) * 4 + (kk & 3);
}

__device__ __forceinline__ uint64_t b_desc(const float* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((32 * BK) >> 4) << 32);
}

// d (+)= a b for a 64 x 64 x 8 tf32 tile: a from registers (this warp's 16
// rows, the m16n8k8 fragment layout), b through its descriptor
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a, uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// keep the compiler from moving register uses across the asynchronous MMAs
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__global__ void __launch_bounds__(NT, 1)
cmatmul_tf32x3(const float2* __restrict__ A, const float2* __restrict__ B,
               float2* __restrict__ C, int M, int N, int K, long long lda,
               long long ldb, long long ldc, long long a_bstride,
               long long b_bstride, long long c_bstride) {
  extern __shared__ __align__(128) float sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int row0 = (warp >> 2) * 64 + (warp & 3) * 16 + g;  // this thread's first row
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  A += blockIdx.z * a_bstride;
  B += blockIdx.z * b_bstride;
  C += blockIdx.z * c_bstride;

  float acc[3][32];
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int q = 0; q < 32; ++q) acc[p][q] = 0.f;

  float* aplanes = sm;                                  // Ar, Ai, Ar + Ai (fp32)
  float* bplanes = sm + 3 * A_PLANE;                    // (Br, Bi, Br + Bi) x (big, small)
  float2* raw = reinterpret_cast<float2*>(sm + STAGE);  // NRAW raw tiles
  // raw complex64 tile kt (A: BM x BK, B: BK x BN) into slot kt % NRAW
  auto fetch = [&](int kt) {
    float2* ra = raw + (kt % NRAW) * RAW;
    float2* rb = ra + BM * BK;
    const int k0 = kt * BK;
#pragma unroll
    for (int l = 0; l < A_PER_T; ++l) {
      const int idx = tid + l * NT, row = idx / BK, kk = idx % BK;
      const bool ok = m0 + row < M && k0 + kk < K;
      cp_async8(ra + idx, ok ? A + (long long)(m0 + row) * lda + k0 + kk : A, ok ? 8 : 0);
    }
#pragma unroll
    for (int l = 0; l < B_PER_T; ++l) {
      const int idx = tid + l * NT, kk = idx / BN, col = idx % BN;
      const bool ok = k0 + kk < K && n0 + col < N;
      cp_async8(rb + idx, ok ? B + (long long)(k0 + kk) * ldb + n0 + col : B, ok ? 8 : 0);
    }
  };
  // raw tile kt into the A planes (fp32) and the split B planes (tf32)
  auto convert = [&](int kt) {
    const float2* ra = raw + (kt % NRAW) * RAW;
    const float2* rb = ra + BM * BK;
#pragma unroll
    for (int l = 0; l < A_PER_T; ++l) {
      const int idx = tid + l * NT, o = (idx / BK) * LDA_S + idx % BK;
      const float2 v = ra[idx];
      aplanes[o] = v.x;
      aplanes[A_PLANE + o] = v.y;
      aplanes[2 * A_PLANE + o] = v.x + v.y;
    }
#pragma unroll
    for (int l = 0; l < B_PER_T; ++l) {
      const int idx = tid + l * NT, o = b_off(idx / BN, idx % BN);
      const float2 v = rb[idx];
      const float x[3] = {v.x, v.y, v.x + v.y};
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        uint32_t big, small;
        split(x[p], big, small);
        bplanes[(2 * p) * B_PLANE + o] = __uint_as_float(big);
        bplanes[(2 * p + 1) * B_PLANE + o] = __uint_as_float(small);
      }
    }
    // the planes are read by the tensor cores through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  const int nk = (K + BK - 1) / BK;
  if (nk > 0) fetch(0);
  cp_async_commit();
  if (nk > 1) fetch(1);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait1();  // this thread's copies of tile kt have landed
    __syncthreads();   // everyone's have; the planes are free again
    convert(kt);
    if (kt + 2 < nk) fetch(kt + 2);  // into the slot converted one step ago
    cp_async_commit();
    __syncthreads();
    // t1: Ar Br, t2: Ai Bi, t3: (Ar+Ai)(Br+Bi).  Each product's six MMAs of
    // this step sum into a fresh tile, added to its accumulator once: K / 16
    // roundings of the large sums, not 3 K / 8.  Two tiles alternate, so the
    // tensor cores run product p + 1 while product p is added.
    float tmp[2][32];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      // A fragments of the step's 8-deep slices, split into big and small
      uint32_t ab[BK / 8][4], as[BK / 8][4];
      const float* ap = aplanes + p * A_PLANE + row0 * LDA_S + tig;
#pragma unroll
      for (int h = 0; h < BK / 8; ++h) {
        split(ap[h * 8], ab[h][0], as[h][0]);
        split(ap[8 * LDA_S + h * 8], ab[h][1], as[h][1]);
        split(ap[h * 8 + 4], ab[h][2], as[h][2]);
        split(ap[8 * LDA_S + h * 8 + 4], ab[h][3], as[h][3]);
      }
      float* t = tmp[p & 1];
      fence_regs(t);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int h = 0; h < BK / 8; ++h) {
        const float* bb = bplanes + (2 * p) * B_PLANE + h * 64;  // K offset 8 h: 2 h core matrices
        const float* bs = bb + B_PLANE;
        wgmma_tf32(t, as[h], b_desc(bb), h);
        wgmma_tf32(t, ab[h], b_desc(bs), 1);
        wgmma_tf32(t, ab[h], b_desc(bb), 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (p > 0) {  // product p - 1 is done once at most this group is pending
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        float* u = tmp[(p - 1) & 1];
        fence_regs(u);
#pragma unroll
        for (int q = 0; q < 32; ++q) acc[p - 1][q] += u[q];
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(tmp[0]);
#pragma unroll
    for (int q = 0; q < 32; ++q) acc[2][q] += tmp[0][q];
  }

  // accumulator layout: register 4 j + 2 h + e holds row row0 + 8 h,
  // column 8 j + 2 tig + e
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + row0 + 8 * h;
      if (row >= M) continue;
#pragma unroll
      {
        const int col = n0 + 8 * j + 2 * tig, q = 4 * j + 2 * h;
        const float2 c0 = make_float2(acc[0][q] - acc[1][q], acc[2][q] - acc[0][q] - acc[1][q]);
        const float2 c1 = make_float2(acc[0][q + 1] - acc[1][q + 1],
                                      acc[2][q + 1] - acc[0][q + 1] - acc[1][q + 1]);
        // streaming stores (C is written once and not read here), two
        // complex values in one 16-byte store where the row pair allows it
        float2* dst = C + (long long)row * ldc + col;
        if (col + 1 < N && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
          __stcs(reinterpret_cast<float4*>(dst), make_float4(c0.x, c0.y, c1.x, c1.y));
        } else {
          if (col < N) __stcs(dst, c0);
          if (col + 1 < N) __stcs(dst + 1, c1);
        }
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
  cudaError_t err = cudaFuncSetAttribute(
      cmatmul_tf32x3, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)gy, (unsigned)batch);
  cmatmul_tf32x3<<<grid, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const float2*)A, (const float2*)B, (float2*)C, M, N, K, lda, ldb, ldc,
      a_bstride, b_bstride, c_bstride);
  return (int)cudaGetLastError();
}
