"""Row-sharded sparse FEAST: the matrix rows partitioned over a "row" mesh
dimension.

Counterpart of `feast_tpu/parallel/rowsharded.py`, on `torch.distributed`:

  * the operator is cut into row blocks, one per "row" rank, and A's
    entries never leave their rank: each holds its (rows, n) block with
    global column ids (`ops.sparse.RowBlock`, whose local block is DIA,
    BELL or CSR as `as_operator` picks for one card);
  * the m0-wide subspace blocks are replicated within a node group (they
    are O(n m0), skinny next to O(nnz)); an SpMM is the rank's local product,
    giving its (rows, m0) row block, then one all-gather over "row";
  * the quadrature nodes spread over "node" as in the replicated drivers,
    and the moment sum is an all-reduce over "node";
  * the m0 x m0 reduced eigenproblem and the column-wise Krylov recurrences
    are repeated on every rank (redundant O(m0^2) work for no extra
    traffic).

`feast_iterative_rows` is `feast_iterative` on a ("node", "row") mesh:
the driver builds its operators with `row_operators` and its AMG
hierarchy with `row_amg` (the V-cycle of `ops.amg.shifted_preconditioner`
over row blocks) when the mesh has a "row" dimension, so the sweep loop
is the one of the single-card driver.

The JAX package proves that A is never gathered by parsing XLA's compiled
module (`largest_allgather_elems`, `assert_no_large_allgather`); those two
are not ported.  Here every gather goes through `mesh.all_gather`, and the
tests record the elements it moves.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import contour as ct
from .._device import resolve_device
from ..ops import sparse as spmod
from ..ops.sparse import CSR
from . import mesh as pmesh


class ShardedCSR(NamedTuple):
    """Row-block-partitioned CSR, stacked on a leading shard axis.

    data / cols / rows: (n_shards, nnz_max); rows are LOCAL row ids within
    the shard's block, cols GLOBAL column ids.  Padding entries have
    data == 0 (they add nothing to local row 0)."""

    data: torch.Tensor
    cols: torch.Tensor
    rows: torch.Tensor
    n: int        # true matrix dimension
    n_pad: int    # padded to n_shards * rows_loc
    rows_loc: int

    def block(self, s: int, data=None) -> CSR:
        """Shard s as a (rows_loc, n_pad) CSR operator (its own data, or
        `data` of the same pattern, e.g. with a leading node axis)."""
        return CSR(self.data[s] if data is None else data, self.cols[s], self.rows[s],
                   (self.rows_loc, self.n_pad))


def partition_csr(A, n_shards: int, dtype=torch.complex128, device="cuda") -> ShardedCSR:
    """Split a scipy-sparse (or dense) matrix into `n_shards` row blocks, on
    `device` (default "cuda"; raises when CUDA is absent)."""
    import scipy.sparse as sp

    device = resolve_device(device)
    A = sp.csr_matrix(A).astype(np.complex128)
    n = A.shape[0]
    rows_loc = -(-n // n_shards)
    blocks = [A[s * rows_loc:min((s + 1) * rows_loc, n)].tocoo() for s in range(n_shards)]
    nnz_max = max(b.nnz for b in blocks)
    data = np.zeros((n_shards, nnz_max), dtype=np.complex128)
    cols = np.zeros((n_shards, nnz_max), dtype=np.int64)
    rows = np.zeros((n_shards, nnz_max), dtype=np.int64)
    for s, b in enumerate(blocks):
        data[s, :b.nnz], cols[s, :b.nnz], rows[s, :b.nnz] = b.data, b.col, b.row
    return ShardedCSR(torch.as_tensor(data, device=device).to(dtype),
                      torch.as_tensor(cols, device=device),
                      torch.as_tensor(rows, device=device), n, rows_loc * n_shards, rows_loc)


# ---------------------------------------------------------------------------
# row-sharded AMG (a V-cycle whose every product is shard-local)
# ---------------------------------------------------------------------------

class ShardedLevel(NamedTuple):
    """One hierarchy level: the union-pattern (A_l, B_l) pair on one
    partitioned structure (S_l(z) = A_l - z B_l stays elementwise), P by
    fine rows, R by coarse rows, the diagonals replicated (padding rows get
    dA = 1, dB = 0, so the Jacobi inverse is benign there)."""

    A: ShardedCSR
    B_data: torch.Tensor
    P: ShardedCSR
    R: ShardedCSR
    dA: torch.Tensor
    dB: torch.Tensor


class ShardedAMG(NamedTuple):
    levels: tuple
    Ac: torch.Tensor   # coarsest level, dense and replicated
    Bc: torch.Tensor


def _padded(v, n_pad, fill, dtype, device):
    out = np.full(n_pad, fill, dtype=np.complex128)
    out[:v.shape[0]] = v
    return torch.as_tensor(out, device=device).to(dtype)


def build_sharded_amg(A, B, d_row: int, dtype=torch.complex128, device="cuda",
                      **build_opts) -> ShardedAMG:
    """Row-partition the SA-AMG hierarchy (`ops.amg.build_amg_host`, strength
    aggregation: its explicit CSR transfers partition by row blocks) into
    `d_row` shards, every level padded by ceil division, on `device`
    (default "cuda"; raises when CUDA is absent).  The JAX package's
    layout; the driver's V-cycle runs on `row_amg`, the same partition as
    one rank's operators."""
    from ..ops import amg as amgmod

    device = resolve_device(device)
    build_opts.setdefault("aggregate", "strength")
    host_levels, Ac, Bc, _ = amgmod.build_amg_host(A, B, **build_opts)
    levels = []
    for Au, Bu, P, R in host_levels:
        Ab = partition_csr(Au, d_row, dtype, device)
        levels.append(ShardedLevel(
            Ab, partition_csr(Bu, d_row, dtype, device).data,
            partition_csr(P, d_row, dtype, device), partition_csr(R, d_row, dtype, device),
            _padded(Au.diagonal(), Ab.n_pad, 1.0, dtype, device),
            _padded(Bu.diagonal(), Ab.n_pad, 0.0, dtype, device)))
    return ShardedAMG(tuple(levels), torch.as_tensor(Ac, device=device).to(dtype),
                      torch.as_tensor(Bc, device=device).to(dtype))


def node_row_diag(A_sp, B_sp, n: int):
    """Host diagonals (dA, dB) of the pencil for the Jacobi preconditioner
    (B_sp=None: ones)."""
    import scipy.sparse as sp

    dA = sp.csr_matrix(A_sp).diagonal()
    dB = np.ones(n) if B_sp is None else sp.csr_matrix(B_sp).diagonal()
    return dA.astype(np.complex128), dB.astype(np.complex128)


# ---------------------------------------------------------------------------
# one rank's row blocks: the operators of feast_iterative on a "row" mesh
# ---------------------------------------------------------------------------

def _gather(mesh, n: int):
    """(..., rows, k) product blocks of the "row" ranks -> the (..., n, k)
    product: one all-gather, the ceil-division padding cropped."""
    _, size = pmesh._dim_rank(mesh, "row")

    def gather(Y):
        if size > 1:
            Y = pmesh.all_gather(Y.movedim(-2, 0), mesh, "row").movedim(0, -2)
        return Y[..., :n, :]

    return gather


def _row_block(M, s: int, rows: int):
    """Rows [s rows, (s + 1) rows) of scipy CSR M as a (rows, m) CSR (the
    last block zero-padded)."""
    import scipy.sparse as sp

    blk = sp.csr_matrix(M[s * rows:(s + 1) * rows])
    blk.resize((rows, M.shape[1]))
    return blk


def _share(mesh, n: int):
    """(this rank's "row" index, rows per rank) for an n-row operator."""
    s, size = pmesh._dim_rank(mesh, "row")
    return s, -(-n // size)


def row_operators(A, B, mesh, dtype):
    """This rank's RowBlock of A and of B (None stays None) on the mesh's
    "row" dimension.  A square block (one "row" rank) takes the operator
    format one card would; a rectangular one BELL or CSR."""
    import scipy.sparse as sp

    from ..ops import amg as amgmod

    dev = pmesh.mesh_device(mesh)
    A = sp.csr_matrix(A)
    n = A.shape[0]
    s, rows = _share(mesh, n)
    gather = _gather(mesh, n)
    dA, dB = node_row_diag(A, B, n)

    def op(M, d):
        blk = _row_block(sp.csr_matrix(M), s, rows)
        local = (spmod.as_operator(blk, dtype, dev) if rows == n
                 else amgmod._csr_op(blk, dtype, dev))
        return spmod.RowBlock(local, s * rows, M.shape, gather,
                              torch.as_tensor(d, device=dev).to(dtype))

    return op(A, dA), None if B is None else op(B, dB)


def row_amg(A, B, mesh, *, dtype=None, device=None, **build_opts):
    """The SA-AMG hierarchy of `ops.amg.build_amg` with every level's
    operators, P and R cut into this rank's row blocks (`RowBlock`); the
    diagonals and the dense coarsest level are replicated.  Strength
    aggregation by default, as the JAX package's sharded hierarchy.
    `ops.amg.shifted_preconditioner` runs its V-cycle unchanged: every
    product is the rank's rows plus one all-gather over "row", and the
    coarse LU is repeated on every rank."""
    from ..ops import amg as amgmod

    dt = spmod._complex(dtype)
    dev = pmesh.mesh_device(mesh, device)
    build_opts.setdefault("aggregate", "strength")
    host_levels, Ac, Bc, _ = amgmod.build_amg_host(A, B, **build_opts)

    def diag(M):
        return torch.as_tensor(np.asarray(M.diagonal(), dtype=np.complex128),
                               device=dev).to(dt)

    levels = []
    for Au, Bu, P, R in host_levels:
        s, rows = _share(mesh, Au.shape[0])
        sc, crows = _share(mesh, R.shape[0])
        fine, coarse = _gather(mesh, Au.shape[0]), _gather(mesh, R.shape[0])
        A_loc, B_loc = amgmod._pair_ops(_row_block(Au, s, rows), _row_block(Bu, s, rows),
                                        dt, dev)
        levels.append(amgmod.AMGLevel(
            spmod.RowBlock(A_loc, s * rows, Au.shape, fine),
            spmod.RowBlock(B_loc, s * rows, Bu.shape, fine),
            diag(Au), diag(Bu),
            spmod.RowBlock(amgmod._csr_op(_row_block(P, s, rows), dt, dev), s * rows,
                           P.shape, fine),
            spmod.RowBlock(amgmod._csr_op(_row_block(R, sc, crows), dt, dev), sc * crows,
                           R.shape, coarse)))
    return amgmod.AMG(tuple(levels), torch.as_tensor(Ac, device=dev).to(dt),
                      torch.as_tensor(Bc, device=dev).to(dt))


def feast_iterative_rows(A, B, X0, contour: Optional[ct.Contour] = None, *,
                         mesh, c: complex = 0.0 + 0.0j, r: float = 1.0,
                         nodes: int = 8, iters: int = 20, tol: float = 1e-10,
                         solver: str = "bicgstab", solve_tol: float = 1e-10,
                         solve_iters: int = 1000, precondition: str = "jacobi",
                         amg_opts: Optional[dict] = None, ortho: str = "cholqr2",
                         debug: bool = False, spurious: Optional[float] = None,
                         node_chunk: Optional[int] = None):
    """Residual-inverse-iteration FEAST with iterative node solves on a
    ("node", "row") mesh (`parallel.node_row_mesh`): `feast_iterative`
    with A's (and B's) row blocks on their "row" rank for the whole run.

    The same `solver` choices as the JAX package ("bicgstab" or
    "bicgstab_rr").  A and B are scipy sparse (or dense) on every rank; X0
    is broadcast from rank 0.  precondition: "jacobi" (diagonal), "amg"
    (the row-sharded SA-AMG V-cycle, `row_amg`; `amg_opts` carries the
    build options theta / omega / smooth / max_coarse / max_levels /
    aggregate, the apply options nu / cycles, and "dtype", the
    hierarchy's storage dtype, e.g. torch.float32 for a complex64 V-cycle
    whose coarse LU is the panel kernel on the card; the JAX package
    stores it in the driver's dtype), or False / None.

    Differences from the JAX package: the pencil is reordered as
    `feast_iterative` reorders it (reverse Cuthill-McKee when that narrows
    the band), which also makes each rank's rows a contiguous band; and
    `node_chunk` solves each rank's nodes in chunks, as on one card.

    Returns the same FeastResult on every rank."""
    from ..solvers.ifeast import feast_iterative

    pmesh._dim_rank(mesh, "row")
    if solver not in ("bicgstab", "bicgstab_rr"):
        raise ValueError(f"unknown solver {solver!r} (bicgstab|bicgstab_rr)")
    return feast_iterative(A, B, X0, contour, mesh=mesh, c=c, r=r, nodes=nodes,
                           iters=iters, tol=tol, solver=solver, solve_tol=solve_tol,
                           solve_iters=solve_iters, precondition=precondition,
                           amg_opts=amg_opts, ortho=ortho, debug=debug, spurious=spurious,
                           node_chunk=node_chunk, device=mesh.device_type)
