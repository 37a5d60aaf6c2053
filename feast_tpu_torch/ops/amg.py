"""Smoothed-aggregation AMG preconditioner for shifted sparse solves.

Counterpart of `feast_tpu/ops/amg.py`.  The hierarchy is shift-independent:
A and B are Galerkin-coarsened separately once on the host (P^H A P,
P^H B P per level, scipy); for every quadrature node z the level operator
is S_l(z) = A_l - z B_l, an elementwise combination on a shared (union)
sparsity pattern, formed on the device.  The per-node coarsest matrix is
dense and small, so its LU batches over the contour-node axis like the
dense path's factorizations (`ops/lu.py`).

  * setup (host, numpy/scipy, once): strength graph -> greedy aggregation
    (or contiguous fixed-size aggregates on banded levels) -> tentative P
    (piecewise constant, column-normalized) -> optional Jacobi smoothing
    P = (I - w D^-1 A) P_t -> Galerkin products; all levels stored on the
    union pattern of (A_l, B_l) so the shift never changes sparsity;
  * apply (device): V-cycle with damped-Jacobi smoothing, DIA / BELL /
    CSR products, STRETCH, BELL or CSR transfers, guarded-pivot LU on the
    coarsest level.  With a (nodes,) tensor of shifts every level operator, Jacobi
    diagonal and coarse factor carries a leading node axis and one call
    preconditions all nodes at once.

Used through `shifted_preconditioner(amg, z)` -> a callable M for the `M=`
hook of every solver in ops/krylov.py, and wired into
`feast_iterative(..., precondition="amg")`.  Each level takes the format
the JAX package gives it: DIA when banded, BELL when the block cost model
prefers it (unstructured levels), CSR otherwise.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import cx
from .._device import resolve_device
from . import lu as lumod
from .sparse import (BELL, CSR, DIA, STRETCH, STRETCHT, RowBlock, _bell_pick, _complex,
                     _per_node, _tensor, dia_able)


class AMGLevel(NamedTuple):
    """One hierarchy level.  A_op / B_op share one union sparsity structure
    (identical CSR indices, DIA offsets or BELL blocks and spill) so
    S_l(z) = A_l - z B_l combines their data elementwise.  Banded levels
    are DIA, unstructured ones BELL or CSR."""

    A_op: object         # DIA, BELL or CSR, union pattern
    B_op: object         # same class / structure as A_op
    dA: torch.Tensor     # (n,) diagonal of A_l
    dB: torch.Tensor     # (n,) diagonal of B_l
    P: object            # prolongation (n, nc) operator
    R: object            # restriction  (nc, n) = P^H


class AMG(NamedTuple):
    levels: Tuple[AMGLevel, ...]
    Ac: torch.Tensor  # coarsest-level dense A
    Bc: torch.Tensor  # coarsest-level dense B


def _shifted_op(A_op, B_op, z: torch.Tensor):
    """S = A - z B on the shared structure: same class, combined data.  A
    (nodes,) z gives data with a leading node axis."""
    if isinstance(A_op, RowBlock):
        return A_op.with_local(_shifted_op(A_op.local, B_op.local, z))
    d = A_op.data - _per_node(z, A_op.data.dim()) * B_op.data
    if isinstance(A_op, DIA):
        return DIA(d, A_op.offsets, A_op.shape)
    if isinstance(A_op, BELL):
        spill = None
        if A_op.spill is not None:  # the capped blocks' CSR shares one pattern
            spill = _shifted_op(A_op.spill, B_op.spill, z)
        return BELL(d, A_op.colb, A_op.shape, spill)
    return CSR(d, A_op.indices, A_op.row_ids, A_op.shape)


# ---------------------------------------------------------------------------
# host-side setup
# ---------------------------------------------------------------------------

def _aggregate(A, theta: float) -> Tuple[np.ndarray, int]:
    """Vanek-style greedy aggregation on the strength graph of A.

    strength: |a_ij| >= theta * sqrt(|a_ii| |a_jj|)  (symmetrized).
    Returns (agg_id per node, n_aggregates)."""
    import scipy.sparse as sp

    n = A.shape[0]
    Aa = sp.csr_matrix(abs(A))
    Aa = Aa.maximum(Aa.T)  # symmetrize strength
    d = np.sqrt(np.maximum(Aa.diagonal(), 1e-300))
    # strong connections: strip weak off-diagonals
    C = sp.csr_matrix(Aa, copy=True)
    C.data = (C.data >= theta * d[_csr_rows(C)] * d[C.indices]).astype(
        np.float64)
    C.setdiag(0.0)
    C.eliminate_zeros()
    C = C.tocsr()

    agg = np.full(n, -1, dtype=np.int64)
    n_agg = 0
    indptr, indices = C.indptr, C.indices
    # pass 1: seed aggregates from nodes whose strong neighborhood is free
    for i in range(n):
        if agg[i] >= 0:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        if (agg[nbrs] >= 0).any():
            continue
        agg[i] = n_agg
        agg[nbrs] = n_agg
        n_agg += 1
    # pass 2: attach remaining nodes to a neighboring aggregate
    for i in range(n):
        if agg[i] >= 0:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        placed = nbrs[agg[nbrs] >= 0]
        if placed.size:
            agg[i] = agg[placed[0]]
    # pass 3: leftover isolated nodes become singletons
    for i in range(n):
        if agg[i] < 0:
            agg[i] = n_agg
            n_agg += 1
    return agg, n_agg


def _csr_rows(A) -> np.ndarray:
    return np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))


def _union_pair(A, B):
    """Re-express sparse A and B on their union pattern (identical
    indices/indptr) so A - z*B is elementwise on device.

    scipy's csr addition prunes exact-zero results, so the union is built
    explicitly via sorted (row, col) keys."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A).sorted_indices()
    B = sp.csr_matrix(B).sorted_indices()
    n, m = A.shape

    def keys(M):
        return _csr_rows(M).astype(np.int64) * m + M.indices.astype(np.int64)

    ka, kb = keys(A), keys(B)
    ku = np.union1d(ka, kb)  # sorted unique keys = union pattern
    adata = np.zeros(ku.size, dtype=np.complex128)
    bdata = np.zeros(ku.size, dtype=np.complex128)
    adata[np.searchsorted(ku, ka)] = A.data
    bdata[np.searchsorted(ku, kb)] = B.data
    rows = (ku // m).astype(np.int64)
    cols = (ku % m).astype(np.int64)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    Au = sp.csr_matrix((adata, cols, indptr), shape=(n, m))
    Bu = sp.csr_matrix((bdata, cols, indptr), shape=(n, m))
    return Au, Bu


def build_amg_host(A, B=None, *, theta: float = 0.08,
                   omega: float = 2.0 / 3.0, smooth: bool = True,
                   max_coarse: int = 600, max_levels: int = 20,
                   aggregate: str = "auto", agg_size: int = 3):
    """Host-side (scipy) hierarchy construction.

    aggregate: "strength" — greedy strength-of-connection aggregation
    (the classic SA choice, any pattern); "structured" — CONTIGUOUS
    fixed-size-`agg_size` aggregates, which make the prolongation a
    stride-banded STRETCH operator (gather-free device transfers, see
    ops.sparse.STRETCH); "auto" — structured on levels whose operator is
    banded enough for DIA (where contiguity in the row order is the
    strength structure anyway), strength elsewhere.

    Returns (levels, Ac, Bc, strides): levels is a list of (Au, Bu, P, R)
    scipy-CSR tuples — Au/Bu on their union pattern (identical
    indices/indptr) — Ac/Bc the coarsest-level dense pair, and strides a
    per-level list (agg_size for structured levels, None for strength)."""
    import scipy.sparse as sp

    A_l = sp.csr_matrix(A).astype(np.complex128)
    n = A_l.shape[0]
    B_l = (sp.identity(n, dtype=np.complex128, format="csr") if B is None
           else sp.csr_matrix(B).astype(np.complex128))

    levels = []
    strides = []
    for _ in range(max_levels):
        if A_l.shape[0] <= max_coarse:
            break
        n_l = A_l.shape[0]
        structured = (aggregate == "structured"
                      or (aggregate == "auto" and dia_able(A_l)))
        if structured:
            agg = np.arange(n_l) // agg_size
            n_agg = -(-n_l // agg_size)
        else:
            agg, n_agg = _aggregate(A_l, theta)
        if n_agg >= n_l:  # aggregation stalled: stop coarsening
            break
        strides.append(agg_size if structured else None)
        # tentative prolongation: piecewise constant, unit columns
        sizes = np.bincount(agg, minlength=n_agg).astype(np.float64)
        vals = 1.0 / np.sqrt(sizes[agg])
        P = sp.csr_matrix((vals, (np.arange(A_l.shape[0]), agg)),
                          shape=(A_l.shape[0], n_agg)).astype(np.complex128)
        if smooth:
            # P = (I - w D^-1 A) P_tent — one damped-Jacobi smoothing step
            # turns piecewise constants into overlapping smooth basis
            # functions (the "SA" in SA-AMG)
            dg = A_l.diagonal()
            dg = np.where(np.abs(dg) > 0, dg, 1.0)
            Dinv = sp.diags(1.0 / dg)
            P = (P - omega * (Dinv @ (A_l @ P))).tocsr()
        R = P.conj().T.tocsr()
        Au, Bu = _union_pair(A_l, B_l)
        levels.append((Au, Bu, P, R))
        A_l = (R @ A_l @ P).tocsr()
        B_l = (R @ B_l @ P).tocsr()

    Ac = np.asarray(A_l.todense(), dtype=np.complex128)
    Bc = np.asarray(B_l.todense(), dtype=np.complex128)
    return levels, Ac, Bc, strides


def build_amg(A, B=None, *, theta: float = 0.08, omega: float = 2.0 / 3.0,
              smooth: bool = True, max_coarse: int = 600,
              max_levels: int = 20, dtype=None, device="cuda",
              aggregate: str = "auto", agg_size: int = 3) -> AMG:
    """Build the shift-independent hierarchy from scipy-sparse (or dense)
    A and optional B (defaults to identity).  Host-side setup; returns
    tensors on `device` ready for `shifted_preconditioner`.  dtype: real
    or complex storage dtype (default complex128)."""
    dtype = _complex(dtype)
    device = resolve_device(device)
    host_levels, Ac, Bc, strides = build_amg_host(
        A, B, theta=theta, omega=omega, smooth=smooth,
        max_coarse=max_coarse, max_levels=max_levels,
        aggregate=aggregate, agg_size=agg_size)
    levels = [_make_level(Au, Bu, P, R, dtype, device, stride=st)
              for (Au, Bu, P, R), st in zip(host_levels, strides)]
    return AMG(tuple(levels), _tensor(Ac, dtype, device), _tensor(Bc, dtype, device))


def _pair_ops(Au, Bu, dtype, device):
    """The (A, B) union-pattern operator pair: DIA when the union pattern
    is banded densely enough, BELL when the block cost model prefers it
    (`sparse.bell_pick_bs`), else CSR.  Both share one structure so S(z)
    combines their data arrays elementwise.  A rectangular pair (one
    rank's rows of a row-sharded level) is BELL or CSR."""
    if Au.shape[0] == Au.shape[1] and dia_able(Au):
        A_op = DIA.from_scipy(Au, dtype, device)
        B_op = DIA.from_scipy(Bu, dtype, device)
        if A_op.offsets == B_op.offsets:
            return A_op, B_op
        # scipy pruned a diagonal from one of them: rebuild on the union
        offs = tuple(sorted(set(A_op.offsets) | set(B_op.offsets)))

        def on(op):
            data = torch.zeros((len(offs), op.data.shape[-1]), dtype=dtype,
                               device=device)
            for k, off in enumerate(op.offsets):
                data[offs.index(off)] = op.data[k]
            return DIA(data, offs, op.shape)

        return on(A_op), on(B_op)
    # the level stores both A and B on the shared pattern: half the
    # picker's byte cap for each, as in the JAX package (`_union_pair`
    # gives both one sorted pattern, so Bu's entries follow Au's order)
    bs, st = _bell_pick(Au, dtype, 0.5e9)
    if bs is not None:
        return BELL.from_structure(st, bs, Au.shape, dtype, device, Au.data, Bu.data)
    return CSR.from_scipy(Au, dtype, device), CSR.from_scipy(Bu, dtype, device)


def _csr_op(M, dtype, device):
    """P or R of a strength-aggregated level: BELL when the cost model
    prefers it (the aggregate map inherits A's locality after
    reordering), else CSR."""
    bs, st = _bell_pick(M, dtype, 1.0e9)
    if bs is not None:
        return BELL.from_structure(st, bs, M.shape, dtype, device)[0]
    return CSR.from_scipy(M, dtype, device)


def _make_level(Au, Bu, P, R, dtype, device, stride=None) -> AMGLevel:
    A_op, B_op = _pair_ops(Au, Bu, dtype, device)
    P_op = R_op = None
    if stride is not None:
        # structured aggregation: P's columns sit at i // stride + d, the
        # stride-banded STRETCH form with gather-free transfers
        P_op = STRETCH.from_scipy(P, stride, dtype, device)
        if P_op is not None:
            R_op = STRETCHT(P_op)
    if P_op is None:
        P_op = _csr_op(P, dtype, device)
        R_op = _csr_op(R, dtype, device)
    return AMGLevel(A_op, B_op,
                    _tensor(np.asarray(Au.diagonal(), dtype=np.complex128), dtype, device),
                    _tensor(np.asarray(Bu.diagonal(), dtype=np.complex128), dtype, device),
                    P_op, R_op)


# ---------------------------------------------------------------------------
# device-side apply
# ---------------------------------------------------------------------------

def hierarchy_nnz(amg: AMG):
    """(stored S-entries, stored P-entries) per level; DIA levels count
    stored diagonal entries."""
    return ([int(L.A_op.nnz) for L in amg.levels],
            [int(L.P.nnz) for L in amg.levels])


def _cast_op(op, dtype):
    """Cast an operator's data to `dtype` (structure unchanged)."""
    if isinstance(op, STRETCHT):
        return STRETCHT(_cast_op(op.P, dtype))
    if isinstance(op, RowBlock):
        return op.with_local(_cast_op(op.local, dtype))
    d = op.data.to(dtype)
    if isinstance(op, DIA):
        return DIA(d, op.offsets, op.shape)
    if isinstance(op, BELL):
        spill = None if op.spill is None else _cast_op(op.spill, dtype)
        return BELL(d, op.colb, op.shape, spill)
    if isinstance(op, STRETCH):
        return STRETCH(d, op.offsets, op.stride, op.shape)
    return CSR(d, op.indices, op.row_ids, op.shape)


def shifted_preconditioner(amg: AMG, z: torch.Tensor, *, nu: int = 2,
                           omega: float = 2.0 / 3.0, cycles: int = 1,
                           dtype=None):
    """Return M: X -> approx (A - z B)^{-1} X (`cycles` V-cycles).

    z is a scalar tensor, or (nodes,) to precondition X (nodes, n, m) for
    all nodes at once.  The shifted level operators S_l = A_l - z B_l, the
    Jacobi diagonals and the coarse LU are formed once per z; each
    application is sparse products and axpys.

    dtype: run the whole V-cycle in this (real or complex) dtype, e.g.
    torch.float32 under a complex128 Krylov recurrence.  A preconditioner's
    accuracy never bounds the outer solver's final residual, only its
    iteration count, and the complex64 V-cycle moves half the bytes (its
    DIA products are the Hopper kernel on the card).  X is cast at the
    boundary, so the V-cycle always runs in the hierarchy's stored dtype.
    """
    hier_dt = amg.Ac.dtype
    if dtype is not None and _complex(dtype) != hier_dt:
        hier_dt = _complex(dtype)
        amg = AMG(
            tuple(AMGLevel(_cast_op(L.A_op, hier_dt), _cast_op(L.B_op, hier_dt),
                           L.dA.to(hier_dt), L.dB.to(hier_dt),
                           _cast_op(L.P, hier_dt), _cast_op(L.R, hier_dt))
                  for L in amg.levels),
            amg.Ac.to(hier_dt), amg.Bc.to(hier_dt))
    z = z.to(hier_dt)
    rdt = cx.real_dtype(hier_dt)

    S = [_shifted_op(L.A_op, L.B_op, z) for L in amg.levels]
    dinv = []
    for L in amg.levels:
        d = L.dA - _per_node(z, 1) * L.dB
        # guard exactly-zero diagonals (possible off the union diagonal)
        mag = cx.abs2(d)
        scale = torch.clamp(torch.sqrt(torch.amax(mag, dim=-1, keepdim=True)), min=1.0)
        d = torch.where(mag > 0, d, (torch.finfo(rdt).eps * scale).to(hier_dt))
        dinv.append(cx.creciprocal(d).unsqueeze(-1))
    LUc, permc = lumod.lu_factor(amg.Ac - _per_node(z, 2) * amg.Bc)
    # the coarse solve runs once per V-cycle: its diagonal-block
    # substitutions as matmuls
    dinvc = lumod.lu_diag_inv(LUc, lumod._auto_block(LUc.shape[-1]))

    def coarse(r):
        return lumod.lu_solve(LUc, permc, r, dinv=dinvc)

    def smooth(l: int, x, r, steps: int):
        for _ in range(steps):
            x = x + omega * ((r - S[l].matvec(x)) * dinv[l])
        return x

    def vcycle(l: int, r):
        if l == len(amg.levels):
            return coarse(r)
        L = amg.levels[l]
        x = smooth(l, torch.zeros_like(r), r, nu)
        xc = vcycle(l + 1, L.R.matvec(r - S[l].matvec(x)))
        x = x + L.P.matvec(xc)
        return smooth(l, x, r, nu)

    def M_inner(X):
        out = vcycle(0, X)
        for _ in range(cycles - 1):
            out = out + vcycle(0, X - S[0].matvec(out))
        return out

    def M(X: torch.Tensor) -> torch.Tensor:
        if X.dtype == hier_dt:
            return M_inner(X)
        return M_inner(X.to(hier_dt)).to(X.dtype)

    return M
