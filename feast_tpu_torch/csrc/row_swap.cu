// Row swaps of the blocked LU for Hopper (sm_90a): a panel's row
// permutation applied in place to the columns outside the panel, on the
// rows it moves only.
//
// Replaces no TPU kernel.  The JAX package applies a panel's swaps to the
// other columns as one gather of every row >= j (feast_tpu/ops/pallas_lu.py
// ::lu_factor_pallas, feast_tpu/ops/lu.py), which XLA fuses into its
// update.  On the card that gather and the copy back were two passes over
// the trailing matrix a panel, though the panel's b swaps move at most 2b
// rows; this kernel moves those rows alone (ops/row_swap.py).
//
// Semantics (ops/row_swap.py::apply_panel_perm_plain, the gather): for
// each matrix, rows r >= j of the columns [0, j) and [j + b, n) take the
// old contents of row perm[r], perm being the panel kernel's permutation
// (identity on rows < j; b swaps of a pivot row g in [j, j + b) with a row
// p >= g).  Its moved rows, found on the device from perm:
//   * the pivot rows g with perm[g] != g;
//   * the rows s = perm[g] >= j + b: a row below the panel is only ever
//     swapped with a pivot row, whose contents stay put after its step, so
//     s receives perm[s], a pivot row's old contents, and each moved row
//     below the panel is some perm[g].
// At most 2b rows, each the destination of exactly one move.
//
// Bound.  Bytes: each moved row of the outside columns read once and
// written once, (n - b) 8-byte entries a row, and perm's b entries; a few
// hundred microseconds for a batch of 16 at n = 4096 where the gather read
// and wrote every row >= j (ops/row_swap.py's timing in chip_smoke.py k1).
//
// Design.  One block takes one column tile (TW = 16 complex entries, 128
// bytes of a row) of one matrix: it builds the list of moves from perm in
// shared memory, reads the tile of every source row into shared memory,
// synchronises, and writes each row's tile to its destination.  Blocks
// touch disjoint columns, so the swap is exact and in place.  Loads and
// stores are 16 bytes (two entries) a thread where the layout allows it,
// 8 threads a row, 32 rows a pass.  The grid is batch x ceil((n - b) / TW)
// blocks: 248 at batch 1 and n = 4096, thousands at the node batches.  The
// block of tile 0 adds its matrix's moved rows to an optional device count.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int NT = 256;     // threads a block
constexpr int TW = 16;      // complex entries of a column tile
constexpr int MAXB = 128;   // widest panel (ops/panel_lu.py MAX_BLOCK)

// E: complex entries a thread moves at once (2: 16-byte accesses, 1: 8).
template <int E>
__global__ void __launch_bounds__(NT)
row_swap_moved(float2* __restrict__ A, long long bstride, long long lda, int n,
               int j, int b, const int* __restrict__ perm, int tiles,
               unsigned long long* __restrict__ moved) {
  using V = typename std::conditional<E == 2, float4, float2>::type;
  constexpr int VPR = TW / E;     // accesses a tile row
  constexpr int RPP = NT / VPR;   // rows a pass
  __shared__ V stage[2 * MAXB * VPR];
  __shared__ int dst[2 * MAXB], src[2 * MAXB];
  __shared__ int count;

  const int mat = blockIdx.x / tiles;
  const int tile = blockIdx.x - mat * tiles;
  const int* p = perm + (long long)mat * n;
  const int e = j + b;
  if (threadIdx.x == 0) count = 0;
  __syncthreads();
  if (threadIdx.x < b) {
    const int g = j + threadIdx.x;
    const int s = p[g];
    if (s != g) {
      const int k = atomicAdd(&count, 1);
      dst[k] = g;
      src[k] = s;
    }
    if (s >= e) {
      const int k = atomicAdd(&count, 1);
      dst[k] = s;
      src[k] = p[s];
    }
  }
  __syncthreads();
  const int m = count;
  if (m == 0) return;   // the whole block: count is shared
  if (tile == 0 && threadIdx.x == 0 && moved != nullptr)
    atomicAdd(moved, (unsigned long long)m);

  // the tile's columns, counted over [0, j) then [e, n); a thread past the
  // last column stays for the barrier
  const int v = threadIdx.x % VPR;
  const int cv = tile * TW + v * E;
  const bool live = cv < n - b;
  float2* base = A + (long long)mat * bstride + (cv < j ? cv : cv + b);
  if (live)
    for (int i = threadIdx.x / VPR; i < m; i += RPP)
      stage[i * VPR + v] = *reinterpret_cast<const V*>(base + (long long)src[i] * lda);
  __syncthreads();
  if (live)
    for (int i = threadIdx.x / VPR; i < m; i += RPP)
      *reinterpret_cast<V*>(base + (long long)dst[i] * lda) = stage[i * VPR + v];
}

}  // namespace

// A: (batch, n, n) complex64, unit column stride, rows lda and matrices
// bstride entries apart; perm: (batch, n) int32, contiguous; moved: an
// int64 device count to add the moved rows to, or null.
extern "C" int feast_row_swap_c64(void* A, long long bstride, long long lda, int n,
                                  int j, int b, int batch, const void* perm,
                                  void* moved, void* stream) {
  if (b < 1 || b > MAXB || j < 0 || j + b > n || batch < 1)
    return (int)cudaErrorInvalidValue;
  const int tiles = n - b > 0 ? (n - b + TW - 1) / TW : 1;
  const dim3 grid((unsigned)((long long)batch * tiles));
  const bool vec = ((reinterpret_cast<unsigned long long>(A) & 15) == 0) &&
                   bstride % 2 == 0 && lda % 2 == 0 && j % 2 == 0 && b % 2 == 0 &&
                   n % 2 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    row_swap_moved<2><<<grid, NT, 0, s>>>((float2*)A, bstride, lda, n, j, b,
                                          (const int*)perm, tiles,
                                          (unsigned long long*)moved);
  else
    row_swap_moved<1><<<grid, NT, 0, s>>>((float2*)A, bstride, lda, n, j, b,
                                          (const int*)perm, tiles,
                                          (unsigned long long*)moved);
  return (int)cudaGetLastError();
}
