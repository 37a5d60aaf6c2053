// Complex64 matrix products on Hopper's tensor cores (sm_90a) at fp32
// accuracy, in two call forms of one kernel: the product C = A B, and the
// update in place C <- C + alpha A B.  Interleaved complex in and out, row
// strides and batch strides passed in (a batch stride of 0 shares an
// operand), any M, N, K.
//
// Replaces the TPU kernel feast_tpu/ops/pallas_kernels.py::
// _cmatmul_pallas_padded (launched by cmatmul_pallas, pallas_kernels.py:85)
// for the product, and, in the update form, the factor's trailing update
// A22 <- A22 - L21 U12 (ops/panel_lu.py::lu_factor_panel), which cuBLAS
// ran as an FP32 FFMA cgemm with no tensor cores.  The TPU kernel forms
// three real products per tile (Karatsuba) on the matrix unit at
// Precision.HIGHEST; this one does the same on the TF32 tensor cores
// ("3xTF32"): each fp32 operand x is split into big = tf32_rna(x) and
// small = tf32_rna(x - big), and each real product is small*big +
// big*small + big*big, accumulated in fp32 (small*small lies below fp32
// rounding).  The complex product is Karatsuba, as in the TPU body and in
// the plain version cx._cmatmul_planes:
//
//     t1 = Ar Br,  t2 = Ai Bi,  t3 = (Ar + Ai)(Br + Bi),
//     Cr = t1 - t2,  Ci = t3 - t1 - t2.
//
// Bound.  The trailing updates are rank-128 updates: K = 128, M = N =
// n - e.  Their least time is the larger of 16 M N + 16 M K bytes a matrix
// (C read and written once, the operands read once) at 3.35 TB/s and
// 18 M N K operations (three real products of three TF32 products) at
// 495 TFLOP/s: 7.91 ms by bytes at 16 x 10112 x 128 x 10112, the first
// update of the n = 10240 factor, against 7.61 ms by operations.  An FFMA
// kernel needs 8 M N K operations at 67 TFLOP/s, 25 ms there.
//
// Design.  A persistent grid, one block a SM, walks the (matrix, row tile,
// column tile) tiles of 128 x 128 over the whole batch, column tiles
// fastest, so the blocks at work at once share L21's row tile and U12's
// column block in L2.  A tile is 128 x 128 x K in stages of 16 of K.
// Three warpgroups, specialised:
//   * the producer (warpgroup 2, 40 registers) copies each stage's raw
//     complex64 tiles of A (128 x 16) and B (16 x 128) into a ring of
//     three raw slots: by the copy engine, one bulk copy a row counted on
//     an mbarrier's transaction count, where every row is 16-byte aligned
//     and a multiple of 16 bytes long (the factor's views are), else by
//     16- or 8-byte cp.async with zeros past the edges.  It converts B
//     into its six tf32 planes (big and small of Br, Bi, Br + Bi) in a
//     ring of two, K-major in the core-matrix layout wgmma's tf32 form
//     reads, with 16-byte stores, and marks them full; the copies run two
//     stages ahead of the conversion.
//   * two consumers (warpgroups 0 and 1, 232 registers, 64 rows of C
//     each) read their A fragments from the raw tile, form the plane of
//     each product and split it in registers, and issue
//     wgmma.mma_async m64n128k8 with B from shared memory, then release
//     the raw slot and the planes.
// Each product's six MMAs of a stage sum into a fresh register tile
// (small terms first), which is added into the two fp32 accumulators Cr
// and Ci: t1 into Cr and -Ci, t2 into -Cr and -Ci, t3 into Ci.  So the
// large sums take K / 16 roundings on the fp32 units, and the tensor
// cores' truncating adds see only a stage's partial sums; Karatsuba's
// cancellation stays inside a stage (0.4x cuBLAS's cgemm error at the
// trailing shapes).  While one consumer adds, the other's MMAs run.  The
// epilogue reads C (beta = 1; beta = 0 reads nothing), adds alpha times
// the accumulators with one rounding, and writes C back with streaming
// stores, 16 bytes where aligned.  The kernel allocates no device memory.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BM = 128, BN = 128, BK = 16;
constexpr int NCONS = 256;               // two consumer warpgroups
constexpr int NT = NCONS + 128;          // and the producer warpgroup
constexpr int NRAW = 3;                  // raw tiles in flight
constexpr int NPL = 2;                   // converted B tiles
constexpr int LDA_S = BK + 4;            // raw A row stride (complex), padded
constexpr int LDB_S = BN + 4;            // raw B row stride (complex), padded
constexpr int RAW_BYTES = (BM * LDA_S + BK * LDB_S) * 8;  // a raw A and B tile
constexpr int PLANE = BN * BK;           // tf32 in one B plane
constexpr int PL_BYTES = 6 * PLANE * 4;  // the six planes of a B tile
constexpr int SMEM_BYTES = NRAW * RAW_BYTES + NPL * PL_BYTES + 2 * (NRAW + NPL) * 8;

struct Args {
  const float2* A;
  const float2* B;
  float2* C;
  long long lda, ldb, ldc, sa, sb, sc;  // row and batch strides (complex)
  int M, N, K, batch, tm, tn;           // tm, tn: row and column tiles
  float alpha;
  int beta;                             // 0: C = alpha A B; 1: C += alpha A B
  int vec;                              // 16-byte access: bit 0 A, 1 B, 2 C
  int bulk;                             // A and B rows copied by bulk copies
};

struct Tile {
  int b, m0, n0;
};

__device__ __forceinline__ Tile tile_of(long long t, int tm, int tn) {
  const long long per = (long long)tm * tn;
  const int b = (int)(t / per), r = (int)(t - (long long)b * per);
  return {b, (r / tn) * BM, (r % tn) * BN};
}

// the barriers: raw_full, raw_empty (NRAW each), pl_full, pl_empty (NPL each)
struct Bars {
  uint32_t base;
  __device__ uint32_t raw_full(int i) const { return base + 8 * i; }
  __device__ uint32_t raw_empty(int i) const { return base + 8 * (NRAW + i); }
  __device__ uint32_t pl_full(int i) const { return base + 8 * (2 * NRAW + i); }
  __device__ uint32_t pl_empty(int i) const { return base + 8 * (2 * NRAW + NPL + i); }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// ok (0, 1 or 2) complex values from src into dst, zeros after them; base
// is a valid address to name where nothing is read
__device__ __forceinline__ void copy2(float2* dst, const float2* src, int ok, bool vec,
                                      const float2* base) {
  if (vec) {
    cp_async16(dst, ok ? src : base, 8 * ok);
  } else {
    cp_async8(dst, ok > 0 ? src : base, ok > 0 ? 8 : 0);
    cp_async8(dst + 1, ok > 1 ? src + 1 : base, ok > 1 ? 8 : 0);
  }
}

// bytes (a multiple of 16) from global src to shared dst by the copy
// engine, counted on the barrier's transaction count
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint32_t bar) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(d), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, int bytes) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n"
      ::"r"(bar), "r"(bytes)
      : "memory");
}
// the barrier's arrival when this thread's earlier cp.async copies land
__device__ __forceinline__ void mbar_arrive_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
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
// 32 BK bytes apart (SBO): wgmma's K-major layout without swizzle.  The
// entry (kk, col) lies at (col / 8) 8 BK + (kk / 4) 32 + (col % 8) 4 + kk % 4.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((32 * BK) >> 4) << 32);
}

// d (+)= a b for a 64 x 128 x 8 tf32 tile: a from registers (this warp's
// 16 rows, the m16n8k8 fragment layout), b through its descriptor
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a, uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// keep the compiler from moving register uses across the asynchronous MMAs
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void bar_producers() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

__device__ __forceinline__ float2* raw_a(char* sm, int slot) {
  return reinterpret_cast<float2*>(sm + slot * RAW_BYTES);
}
__device__ __forceinline__ float2* raw_b(char* sm, int slot) {
  return reinterpret_cast<float2*>(sm + slot * RAW_BYTES) + BM * LDA_S;
}
__device__ __forceinline__ float* planes_of(char* sm, int pl) {
  return reinterpret_cast<float*>(sm + NRAW * RAW_BYTES + pl * PL_BYTES);
}

__device__ __forceinline__ void produce(const Args& p, char* sm, const Bars& bars, int tid) {
  const int nk = (p.K + BK - 1) / BK;
  const long long tiles = (long long)p.batch * p.tm * p.tn;
  const bool va = p.vec & 1, vb = p.vec & 2;
  // this block's stages, over its tiles: stage j is tile blockIdx.x + (j /
  // nk) gridDim.x, k-step j % nk
  const long long jobs =
      blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x * nk + nk : 0;
  // the copies of stage j into raw slot j % NRAW, once the consumers are
  // done with the stage that held it: by the copy engine a row at a time
  // (bulk), else 16- or 8-byte cp.async with zeros past the edges
  auto issue = [&](long long j) {
    const Tile tl = tile_of(blockIdx.x + (j / nk) * gridDim.x, p.tm, p.tn);
    const int slot = (int)(j % NRAW), k0 = (int)(j % nk) * BK;
    const int mr = min(BM, p.M - tl.m0), nc = min(BN, p.N - tl.n0), kw = min(BK, p.K - k0);
    const float2* A = p.A + tl.b * p.sa + (long long)tl.m0 * p.lda + k0;
    const float2* B = p.B + tl.b * p.sb + (long long)k0 * p.ldb + tl.n0;
    float2* ra = raw_a(sm, slot);
    float2* rb = raw_b(sm, slot);
    mbar_wait(bars.raw_empty(slot), (uint32_t)((j / NRAW) & 1) ^ 1);
    if (p.bulk) {
      if (kw < BK) {  // the K tail: zeros beyond K on both sides
        for (int i = tid; i < BM * (BK - kw); i += 128)
          ra[(i / (BK - kw)) * LDA_S + kw + i % (BK - kw)] = make_float2(0.f, 0.f);
        for (int i = tid; i < (BK - kw) * BN; i += 128)
          rb[(kw + i / BN) * LDB_S + i % BN] = make_float2(0.f, 0.f);
        bar_producers();
      }
      if (tid == 0) mbar_arrive_tx(bars.raw_full(slot), 8 * kw * (mr + nc));
      if (tid < mr) bulk_copy(ra + tid * LDA_S, A + (long long)tid * p.lda, 8 * kw, bars.raw_full(slot));
      if (tid < kw) bulk_copy(rb + tid * LDB_S, B + (long long)tid * p.ldb, 8 * nc, bars.raw_full(slot));
    } else {
#pragma unroll
      for (int l = 0; l < 8; ++l) {  // A: 128 rows of 16, two complex a copy
        const int idx = tid + 128 * l, row = idx >> 3, kc = (idx & 7) * 2;
        const int ok = row < mr ? max(0, min(2, kw - kc)) : 0;
        copy2(ra + row * LDA_S + kc, A + (long long)row * p.lda + kc, ok, va, p.A);
      }
#pragma unroll
      for (int l = 0; l < 8; ++l) {  // B: 16 rows of 128
        const int idx = tid + 128 * l, kk = idx >> 6, nn = (idx & 63) * 2;
        const int ok = kk < kw ? max(0, min(2, nc - nn)) : 0;
        copy2(rb + kk * LDB_S + nn, B + (long long)kk * p.ldb + nn, ok, vb, p.B);
      }
      mbar_arrive_copies(bars.raw_full(slot));
    }
  };
  if (jobs > 0) issue(0);
  if (jobs > 1) issue(1);
  for (long long j = 0; j < jobs; ++j) {
    const int slot = (int)(j % NRAW), pl = (int)(j % NPL);
    mbar_wait(bars.raw_full(slot), (uint32_t)((j / NRAW) & 1));       // stage j landed
    mbar_wait(bars.pl_empty(pl), (uint32_t)((j / NPL) & 1) ^ 1);      // its planes are free
    // B into its planes: a thread converts 4 rows (kk) of one column a
    // pass and stores each plane's 4 values in one 16-byte store; a warp
    // reads 32 neighbouring columns of a row, and its stores fill 512
    // contiguous bytes of each plane
    const float2* rb = raw_b(sm, slot);
    float* planes = planes_of(sm, pl);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kq = i, col = tid;
      float x[3][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 v = rb[(4 * kq + r) * LDB_S + col];
        x[0][r] = v.x, x[1][r] = v.y, x[2][r] = v.x + v.y;
      }
      const int o = (col >> 3) * (8 * BK) + kq * 32 + (col & 7) * 4;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        uint32_t big[4], small[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) split(x[q][r], big[r], small[r]);
        *reinterpret_cast<uint4*>(planes + (2 * q) * PLANE + o) =
            make_uint4(big[0], big[1], big[2], big[3]);
        *reinterpret_cast<uint4*>(planes + (2 * q + 1) * PLANE + o) =
            make_uint4(small[0], small[1], small[2], small[3]);
      }
    }
    // the planes are read by the tensor cores through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(bars.pl_full(pl));
    if (j + 2 < jobs) issue(j + 2);
  }
}

__device__ __forceinline__ void consume(const Args& p, char* sm, const Bars& bars, int tid) {
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int r0 = (tid >> 7) * 64 + warp * 16 + g;  // the tile row of this thread's first rows
  const int nk = (p.K + BK - 1) / BK;
  const long long tiles = (long long)p.batch * p.tm * p.tn;
  const uint32_t planes0 = (uint32_t)__cvta_generic_to_shared(sm) + NRAW * RAW_BYTES;
  uint32_t s = 0;
  float u[64];  // a product's sum over one stage
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile tl = tile_of(t, p.tm, p.tn);
    float accr[64], acci[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) accr[i] = acci[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++s) {
      const int slot = s % NRAW, pl = s % NPL;
      mbar_wait(bars.pl_full(pl), (s / NPL) & 1);      // the stage's planes are ready
      mbar_wait(bars.raw_full(slot), (s / NRAW) & 1);  // (and its raw A landed before)
      const float2* ra = raw_a(sm, slot) + r0 * LDA_S + tig;
      const uint64_t d0 = b_desc(planes0 + pl * PL_BYTES);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        // A fragments of the stage's two 8-deep slices, split into big and
        // small: (row, k) = (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
        uint32_t ab[2][4], as[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 v[4] = {ra[8 * h], ra[8 * LDA_S + 8 * h], ra[8 * h + 4],
                               ra[8 * LDA_S + 8 * h + 4]};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            split(q == 0 ? v[i].x : q == 1 ? v[i].y : v[i].x + v[i].y, ab[h][i], as[h][i]);
        }
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // K offset 8 h: two core matrices, 256 bytes
          const uint64_t big = d0 + ((2 * q * PLANE * 4 + 256 * h) >> 4);
          const uint64_t small = big + ((PLANE * 4) >> 4);
          wgmma_tf32(u, as[h], big, h);
          wgmma_tf32(u, ab[h], small, 1);
          wgmma_tf32(u, ab[h], big, 1);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_regs(u);
        if (q == 0) {
#pragma unroll
          for (int i = 0; i < 64; ++i) accr[i] += u[i], acci[i] -= u[i];
        } else if (q == 1) {
#pragma unroll
          for (int i = 0; i < 64; ++i) accr[i] -= u[i], acci[i] -= u[i];
        } else {
#pragma unroll
          for (int i = 0; i < 64; ++i) acci[i] += u[i];
        }
      }
      __syncwarp();
      if (lane == 0) {  // this warp is done with the stage
        mbar_arrive(bars.pl_empty(pl));
        mbar_arrive(bars.raw_empty(slot));
      }
    }
    // accumulator layout: register 4 j + 2 h + e holds row r0 + 8 h,
    // column 8 j + 2 tig + e of the tile
    float2* C = p.C + tl.b * p.sc;
    const bool fast = (p.vec & 4) && tl.n0 + BN <= p.N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = tl.m0 + r0 + 8 * h;
      if (row >= p.M) continue;
      float2* crow = C + (long long)row * p.ldc + tl.n0 + 2 * tig;
      if (fast) {  // whole 16-byte pairs: the reads first, then the streaming stores
        float4* dst = reinterpret_cast<float4*>(crow);
#pragma unroll
        for (int j0 = 0; j0 < 16; j0 += 8) {
          float4 c[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            c[j] = p.beta ? __ldcg(dst + 4 * (j0 + j)) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int q = 4 * (j0 + j) + 2 * h;
            __stcs(dst + 4 * (j0 + j),
                   make_float4(c[j].x + p.alpha * accr[q], c[j].y + p.alpha * acci[q],
                               c[j].z + p.alpha * accr[q + 1], c[j].w + p.alpha * acci[q + 1]));
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int q = 4 * j + 2 * h + e;
            if (tl.n0 + 8 * j + 2 * tig + e >= p.N) continue;
            float2* dst = crow + 8 * j + e;
            const float2 c = p.beta ? __ldcg(dst) : make_float2(0.f, 0.f);
            __stcs(dst, make_float2(c.x + p.alpha * accr[q], c.y + p.alpha * acci[q]));
          }
      }
    }
  }
}

__global__ void __launch_bounds__(NT, 1) cmatmul_tf32x3(const __grid_constant__ Args p) {
  extern __shared__ __align__(128) char sm[];
  const Bars bars{(uint32_t)__cvta_generic_to_shared(sm) + NRAW * RAW_BYTES + NPL * PL_BYTES};
  // raw tiles start as zeros: the bulk copies leave rows past M and
  // columns past N as earlier stages left them, finite
  for (int i = threadIdx.x; i < NRAW * RAW_BYTES / 16; i += NT)
    reinterpret_cast<float4*>(sm)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (threadIdx.x == 0) {
    for (int i = 0; i < NRAW; ++i) {
      mbar_init(bars.raw_full(i), p.bulk ? 1 : 128);  // the copies of a stage
      mbar_init(bars.raw_empty(i), 8);                // every consumer warp
    }
    for (int i = 0; i < NPL; ++i) {
      mbar_init(bars.pl_full(i), 128);                // every producer thread
      mbar_init(bars.pl_empty(i), 8);                 // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the zeros are written through the generic proxy, the bulk copies
  // write through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  // one branch a role to the end: setmaxnreg moves registers from the
  // producer to the consumers
  if (threadIdx.x >= NCONS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    produce(p, sm, bars, threadIdx.x - NCONS);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    consume(p, sm, bars, threadIdx.x);
  }
}

bool aligned16(const void* ptr, long long row_stride, long long batch_stride) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0 && row_stride % 2 == 0 &&
         batch_stride % 2 == 0;
}

}  // namespace

// C <- alpha A B (beta = 0) or C <- C + alpha A B (beta = 1).  A: (batch or
// 1, M, K), B: (batch or 1, K, N), C: (batch, M, N), complex64 with unit
// column stride.  Row strides (lda, ldb, ldc) and batch strides are in
// complex elements; a batch stride of 0 shares the operand.  C must not
// overlap A or B.
extern "C" int feast_cmatmul_c64(const void* A, const void* B, void* C, int M, int N, int K,
                                 int batch, long long lda, long long ldb, long long ldc,
                                 long long a_bstride, long long b_bstride,
                                 long long c_bstride, float alpha, int beta, void* stream) {
  if (M < 1 || N < 1 || K < 0 || batch < 1 || (beta != 0 && beta != 1))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cmatmul_tf32x3, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (batch == 1) a_bstride = b_bstride = c_bstride = 0;
  Args p;
  p.A = static_cast<const float2*>(A);
  p.B = static_cast<const float2*>(B);
  p.C = static_cast<float2*>(C);
  p.lda = lda, p.ldb = ldb, p.ldc = ldc;
  p.sa = a_bstride, p.sb = b_bstride, p.sc = c_bstride;
  p.M = M, p.N = N, p.K = K, p.batch = batch;
  p.tm = (M + BM - 1) / BM, p.tn = (N + BN - 1) / BN;
  p.alpha = alpha, p.beta = beta;
  p.vec = (aligned16(A, lda, a_bstride) ? 1 : 0) | (aligned16(B, ldb, b_bstride) ? 2 : 0) |
          (aligned16(C, ldc, c_bstride) ? 4 : 0);
  // whole rows of 16-byte multiples for the copy engine
  p.bulk = (p.vec & 3) == 3 && K % 2 == 0 && N % 2 == 0;
  const long long tiles = (long long)batch * p.tm * p.tn;
  const int grid = (int)(tiles < sms ? tiles : sms);
  cmatmul_tf32x3<<<grid, NT, SMEM_BYTES, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
