"""Sparse complex operators for the matrix-free solve path.

Counterpart of `feast_tpu/ops/sparse.py` on native complex tensors: `CSR`
(gather + index-add), `DIA` (few dense diagonals, a sum of shifted
elementwise products), `BELL` (blocked ELL: block-row gathers and a
batched block GEMM, the unstructured-pattern format), `STRETCH` /
`STRETCHT` (the stride-banded AMG transfers), `RowBlock` (one rank's rows
of a row-sharded operator), `as_operator` with the BELL block-size model
(`bell_fill`, `bell_plan`, `bell_hbm_bytes`, `bell_pick_bs`),
`shifted_matvec`, `jacobi_preconditioner`.

Every `matvec` takes X (..., n_cols, m): leading batch dimensions are the
contour-node axis of `feast_iterative` (the JAX package's `vmap`), and
an operator's `data` may carry the same leading dimensions (the shifted
level operators S_l(z_i) of the AMG V-cycle differ per node).

The complex64 DIA product on the card is the hand-written Hopper kernel
(`ops/dia_kernel.py`); complex128 and every CPU tensor take the plain
shifted-slice version.  BELL's product is plain JAX in the JAX package (a
gather plus a batched einsum, no Pallas kernel), so its port is a torch
gather plus a batched matmul.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cx
from .._device import resolve_device, same_device
from . import dia_kernel

_SPMM_BACKEND = "cuda"


def set_spmm_backend(name: str):
    """Select the complex64 DIA product on the card: "cuda" (the default:
    the Hopper kernel, which launches or raises) or "torch" (plain shifted
    slices).  CPU tensors and complex128 always take the plain version."""
    global _SPMM_BACKEND
    if name not in ("torch", "cuda"):
        raise ValueError(f"unknown spmm backend {name!r}")
    _SPMM_BACKEND = name


def _complex(dtype) -> torch.dtype:
    """Complex storage dtype from a real or complex one (default complex128)."""
    return torch.complex128 if dtype is None else cx.complex_dtype(dtype)


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), device=device).to(dtype)


class CSR:
    """Complex CSR matrix: data (..., nnz), column ids and expanded row ids."""

    def __init__(self, data, indices, row_ids, shape):
        self.data = data
        self.indices = indices    # (nnz,) int64 column ids
        self.row_ids = row_ids    # (nnz,) int64 row ids (expanded indptr)
        self.shape = tuple(shape)

    @classmethod
    def from_scipy(cls, A, dtype=None, device="cuda"):
        import scipy.sparse as sp

        device = resolve_device(device)
        A = sp.csr_matrix(A)
        row_ids = np.repeat(np.arange(A.shape[0], dtype=np.int64), np.diff(A.indptr))
        return cls(_tensor(A.data.astype(np.complex128), _complex(dtype), device),
                   torch.as_tensor(A.indices.astype(np.int64), device=device),
                   torch.as_tensor(row_ids, device=device), A.shape)

    @classmethod
    def from_dense(cls, A, dtype=None, device="cuda"):
        import scipy.sparse as sp

        return cls.from_scipy(sp.csr_matrix(np.asarray(A)), dtype, device)

    @property
    def nnz(self):
        return self.data.shape[-1]

    def matvec(self, X: torch.Tensor) -> torch.Tensor:
        """A @ X for X (..., n_cols, m)."""
        prod = self.data[..., :, None] * X.index_select(-2, self.indices)
        out = torch.zeros(prod.shape[:-2] + (self.shape[0], X.shape[-1]),
                          dtype=prod.dtype, device=prod.device)
        return out.index_add_(-2, self.row_ids, prod)

    def diagonal(self) -> torch.Tensor:
        """Diagonal entries (absent -> 0)."""
        on_diag = self.row_ids == self.indices
        d = torch.where(on_diag, self.data, torch.zeros_like(self.data))
        out = torch.zeros(d.shape[:-1] + (self.shape[0],), dtype=d.dtype,
                          device=d.device)
        return out.index_add_(-1, self.row_ids, d)

    def todense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.data.dtype, device=self.data.device)
        return out.index_put_((self.row_ids, self.indices), self.data,
                              accumulate=True)


class DIA:
    """Banded complex matrix in diagonal storage: `offsets` a static tuple,
    data (..., ndiag, n) with data[k, i] = A[i, i + offsets[k]] and 0 where
    the column is out of range (row-indexed, unlike scipy's dia_matrix).

        y[i] = sum_k data[k, i] * x[i + offsets[k]]
    """

    def __init__(self, data, offsets, shape):
        self.data = data
        self.offsets = tuple(int(o) for o in offsets)
        self.shape = tuple(shape)

    @classmethod
    def from_scipy(cls, A, dtype=None, device="cuda"):
        import scipy.sparse as sp

        device = resolve_device(device)
        Ad = sp.dia_matrix(sp.csr_matrix(A))
        n, m = Ad.shape
        offs = [int(o) for o in Ad.offsets]
        data = np.zeros((len(offs), n), dtype=np.complex128)
        # scipy stores data[k, j] = A[j - off, j] (column-indexed); re-index
        # by row: ours[k, i] = A[i, i + off] = theirs[k, i + off]
        for k, off in enumerate(offs):
            lo, hi = max(0, -off), min(n, m - off)
            data[k, lo:hi] = Ad.data[k, lo + off:hi + off]
        return cls(_tensor(data, _complex(dtype), device), offs, Ad.shape)

    @classmethod
    def from_csr(cls, A: CSR):
        """Host-side conversion (pulls the CSR arrays once)."""
        import scipy.sparse as sp

        M = sp.coo_matrix((A.data.cpu().numpy(), (A.row_ids.cpu().numpy(),
                                                  A.indices.cpu().numpy())),
                          shape=A.shape)
        return cls.from_scipy(M, A.data.dtype, A.data.device)

    @property
    def nnz(self):
        # stored entries (diagonals are dense in this format)
        return self.data.shape[-2] * self.data.shape[-1]

    @property
    def ndiag(self):
        return len(self.offsets)

    def matvec(self, X: torch.Tensor) -> torch.Tensor:
        """A @ X for X (..., n_cols, m): the Hopper kernel for complex64 on
        the card, plain shifted slices otherwise (see `set_spmm_backend`)."""
        if (_SPMM_BACKEND == "cuda" and self.data.dtype == torch.complex64
                and X.dtype == torch.complex64 and (self.data.is_cuda or X.is_cuda)):
            return dia_kernel.dia_matvec(self.data, self.offsets, X)
        return self._matvec_torch(X)

    def _matvec_torch(self, X: torch.Tensor) -> torch.Tensor:
        return dia_kernel.dia_matvec_plain(self.data, self.offsets, X)

    def diagonal(self) -> torch.Tensor:
        if 0 in self.offsets:
            return self.data[..., self.offsets.index(0), :]
        return torch.zeros(self.data.shape[:-2] + (self.shape[0],),
                           dtype=self.data.dtype, device=self.data.device)

    def todense(self) -> torch.Tensor:
        n, m = self.shape
        out = torch.zeros((n, m), dtype=self.data.dtype, device=self.data.device)
        for k, off in enumerate(self.offsets):
            lo, hi = max(0, -off), min(n, m - off)
            rows = torch.arange(lo, hi, device=out.device)
            out[rows, rows + off] += self.data[k, lo:hi]
        return out


class BELL:
    """Blocked-ELL complex matrix, the format for unstructured sparsity.

    Rows are grouped into block rows of `bs`; each block row stores `kmax`
    dense (bs, bs) blocks (zero blocks pointing at block column 0 pad the
    short rows), so the product gathers (bs, m) block rows of X and runs
    one batched GEMM, y[r] = sum_k block(r, k) @ X[colb[r, k]], with no
    scatter.  With kcap, the block slots beyond the kcap fullest of a block
    row spill to a small CSR (`spill`).  Reorder first (RCM, or
    `reorder.aggregate_block_permutation`) so nnz cluster into few blocks.

    Layout (the JAX package's): data (..., nbr, bs, kmax * bs) with
    data[r, a, k * bs + b] = block(r, k)[a, b], nbr padded to a multiple
    of 16; colb (nbr, kmax) int64 block-column ids; `shape` the logical
    shape.  Leading data dimensions are the node axis of shifted level
    operators."""

    def __init__(self, data, colb, shape, spill: "CSR" = None):
        self.data = data
        self.colb = colb
        self.shape = tuple(shape)
        self.spill = spill

    @property
    def bs(self):
        return self.data.shape[-2]

    @property
    def kmax(self):
        return self.data.shape[-1] // self.data.shape[-2]

    @property
    def nnz(self):
        # stored entries (blocks are dense in this format), like DIA.nnz
        d = self.data.shape
        return d[-3] * d[-2] * d[-1] + (self.spill.nnz if self.spill is not None else 0)

    @staticmethod
    def _structure(A, bs, kcap=None):
        """Host-side block structure of a scipy CSR: (colb (nbr, kmax),
        blk_of_nnz, r_in_blk, c_in_blk, vals, nbr, kmax, keep_nnz, coo,
        kfull), blk/r/c mapping each stored nnz to (flat block slot, row in
        block, column in block) and keep_nnz marking the entries of stored
        blocks (the rest spill to CSR).

        kcap: keep the kcap fullest blocks of each block row and spill the
        rest; "auto" picks the kcap the cost model below prices lowest
        (slot GEMMs against spilled CSR entries); None stores every block."""
        import scipy.sparse as sp

        A = sp.csr_matrix(A)
        n, m = A.shape
        coo = A.tocoo()
        nbr = -(-n // bs)
        ncb = -(-m // bs)
        keys = (coo.row // bs).astype(np.int64) * ncb + coo.col // bs
        uk, inv, cnt = np.unique(keys, return_inverse=True, return_counts=True)
        ub_row = (uk // ncb).astype(np.int64)
        ub_col = (uk % ncb).astype(np.int64)
        counts = np.bincount(ub_row, minlength=nbr)
        kfull = max(int(counts.max()) if counts.size else 1, 1)
        row_start = np.zeros(nbr + 1, dtype=np.int64)
        np.cumsum(counts, out=row_start[1:])
        # rank blocks within each row by descending nnz count (ties by
        # column) so a cap keeps the fullest blocks
        order = np.lexsort((ub_col, -cnt, ub_row))
        rank = np.empty(uk.size, dtype=np.int64)
        rank[order] = np.arange(uk.size) - row_start[ub_row[order]]
        if kcap == "auto":
            # nnz spilled if capped at k = suffix sum of cnt by rank
            nnz_at_rank = np.bincount(rank, weights=cnt, minlength=kfull)
            spill_at = np.concatenate((np.cumsum(nnz_at_rank[::-1])[::-1], [0.0]))
            ks = np.arange(1, kfull + 1)
            cost = nbr * ks * (_BELL_T0 + _BELL_T1 * bs) + spill_at[1:] * _CSR_T_NNZ
            kcap = int(ks[np.argmin(cost)])
        if kcap is None or kfull <= kcap:
            kmax, keep = kfull, np.ones(uk.size, dtype=bool)
        else:
            kmax, keep = int(kcap), rank < kcap
        # the block-row count padded to a multiple of 16 with zero blocks,
        # as in the JAX package (whose chunked product splits nbr evenly)
        nbr = -(-nbr // 16) * 16
        colb = np.zeros((nbr, kmax), dtype=np.int64)
        colb[ub_row[keep], rank[keep]] = ub_col[keep]
        blk_of_nnz = ub_row[inv] * kmax + np.minimum(rank[inv], kmax - 1)
        return (colb, blk_of_nnz, (coo.row % bs).astype(np.int64),
                (coo.col % bs).astype(np.int64), coo.data, nbr, kmax,
                keep[inv], coo, kfull)

    @staticmethod
    def _pack(blk, ri, ci, vals, keep, nbr, kmax, bs, dtype, device):
        data = np.zeros((nbr * kmax, bs, bs), dtype=np.complex128)
        data[blk[keep], ri[keep], ci[keep]] = vals[keep]
        data = (data.reshape(nbr, kmax, bs, bs).transpose(0, 2, 1, 3)
                .reshape(nbr, bs, kmax * bs))
        return _tensor(data, dtype, device)

    @staticmethod
    def _spill_csr(coo, vals, keep, shape, dtype, device):
        if keep.all():
            return None
        return CSR(_tensor(vals[~keep].astype(np.complex128), dtype, device),
                   torch.as_tensor(coo.col[~keep].astype(np.int64), device=device),
                   torch.as_tensor(coo.row[~keep].astype(np.int64), device=device),
                   shape)

    @classmethod
    def from_structure(cls, structure, bs, shape, dtype, device, *values):
        """Operators on one `_structure` of a scipy CSR: its own values, or
        each array of `values` (entries in the same order, as a pair on a
        shared pattern gives them), all sharing colb and the spill split."""
        colb, blk, ri, ci, vals, nbr, kmax, keep, coo, _ = structure
        colb_t = torch.as_tensor(colb, device=device)
        return tuple(cls(cls._pack(blk, ri, ci, v, keep, nbr, kmax, bs, dtype, device),
                         colb_t, shape, cls._spill_csr(coo, v, keep, shape, dtype, device))
                     for v in (values or (vals,)))

    @classmethod
    def from_scipy(cls, A, bs: int = 16, dtype=None, kcap="auto", device="cuda"):
        import scipy.sparse as sp

        device = resolve_device(device)
        A = sp.csr_matrix(A)
        return cls.from_structure(cls._structure(A, bs, kcap), bs, A.shape,
                                  _complex(dtype), device)[0]

    @classmethod
    def pair_from_scipy(cls, Au, Bu, bs: int = 16, dtype=None, kcap="auto",
                        device="cuda"):
        """Two matrices on one shared structure (the AMG union pairs, so
        S(z) = A - z B combines data elementwise).  Au and Bu must have the
        same sparsity pattern (`amg._union_pair` gives it); the block
        structure and any spill split are built once, from Au."""
        import scipy.sparse as sp

        device = resolve_device(device)
        Au = sp.csr_matrix(Au).sorted_indices()
        Bu = sp.csr_matrix(Bu).sorted_indices()
        return cls.from_structure(cls._structure(Au, bs, kcap), bs, Au.shape,
                                  _complex(dtype), device, Au.data, Bu.data)

    def matvec(self, X: torch.Tensor) -> torch.Tensor:
        """A @ X for X (..., n_cols, m): a gather of X's block rows and a
        batched block GEMM, in chunks of block rows so that the gathered
        (rows, kmax bs, m) temporary stays under `_gather_cap`."""
        if self.data.dim() == 3 and X.dim() > 2:
            # one operator for every node (a transfer P or R): fold the
            # nodes into the columns, so that the block GEMM reads the data
            # once; a broadcast matmul would copy it for each node
            lead, (nc, m) = X.shape[:-2], X.shape[-2:]
            Y = self.matvec(X.reshape(-1, nc, m).transpose(0, 1).reshape(nc, -1))
            return Y.reshape(-1, int(np.prod(lead)), m).transpose(0, 1).reshape(
                lead + (Y.shape[0], m))
        n, mcols = self.shape
        bs, kmax = self.bs, self.kmax
        m = X.shape[-1]
        ncb = -(-mcols // bs)
        lead = torch.broadcast_shapes(self.data.shape[:-3], X.shape[:-2])
        Xp = torch.nn.functional.pad(X, (0, 0, 0, ncb * bs - mcols))
        Xb = Xp.reshape(X.shape[:-2] + (ncb, bs, m))
        nbr = self.colb.shape[0]
        dt = torch.result_type(self.data, X)
        gbytes = (int(np.prod(lead)) * nbr * kmax * bs * m
                  * torch.empty((), dtype=dt).element_size())
        nchunks = max(1, -(-gbytes // _gather_cap(X.device)))
        rows = -(-nbr // nchunks)
        Y = torch.empty(lead + (nbr * bs, m), dtype=dt, device=X.device)
        for r0 in range(0, nbr, rows):
            cb = self.colb[r0:r0 + rows]
            r = cb.shape[0]
            G = Xb.index_select(-3, cb.reshape(-1)).reshape(
                X.shape[:-2] + (r, kmax * bs, m))
            Y[..., r0 * bs:(r0 + r) * bs, :] = torch.matmul(
                self.data[..., r0:r0 + r, :, :], G).reshape(lead + (r * bs, m))
        Y = Y[..., :n, :]
        if self.spill is not None:
            Y = Y + self.spill.matvec(X)
        return Y

    def _blocks4(self):
        """(..., nbr, kmax, bs, bs) logical-block view of the merged data."""
        bs, kmax = self.bs, self.kmax
        d = self.data
        return d.reshape(d.shape[:-2] + (bs, kmax, bs)).transpose(-3, -2)

    def diagonal(self) -> torch.Tensor:
        n = self.shape[0]
        nbr = self.colb.shape[0]
        D4 = self._blocks4()
        dblk = torch.diagonal(D4, dim1=-2, dim2=-1)           # (..., nbr, kmax, bs)
        on_diag = (self.colb == torch.arange(nbr, device=self.colb.device)[:, None])
        d = torch.sum(torch.where(on_diag[..., None], dblk, 0), dim=-2)
        d = d.reshape(d.shape[:-2] + (nbr * self.bs,))[..., :n]
        if self.spill is not None:
            d = d + self.spill.diagonal()
        return d

    def todense(self) -> torch.Tensor:
        n, m = self.shape
        bs, kmax = self.bs, self.kmax
        nbr = self.colb.shape[0]
        ncb = -(-m // bs)
        out = torch.zeros((nbr, ncb, bs, bs), dtype=self.data.dtype,
                          device=self.data.device)
        r = torch.arange(nbr, device=out.device).repeat_interleave(kmax)
        out.index_put_((r, self.colb.reshape(-1)),
                       self._blocks4().reshape(-1, bs, bs), accumulate=True)
        D = out.transpose(1, 2).reshape(nbr * bs, ncb * bs)[:n, :m]
        if self.spill is not None:
            D = D + self.spill.todense()
        return D


class STRETCH:
    """Stride-banded interpolation operator (n x nc, nc = ceil(n / s)):
    every entry of row i sits at column i // s + d for d in a small static
    offset set, the sparsity of a smoothed-aggregation prolongation whose
    aggregates are contiguous runs of fixed size s over a banded fine
    operator.  data[k, i] = P[i, i // s + offsets[k]].

    x[i // s + d] is the coarse block repeated s times and shifted by s d
    rows, so the product is a DIA product on the upsampled block; the
    transpose (`rmatvec`, wrapped by `STRETCHT`) shifts the other way and
    sums each group of s rows."""

    def __init__(self, data, offsets, stride, shape):
        self.data = data  # (ndepth, n)
        self.offsets = tuple(int(o) for o in offsets)
        self.stride = int(stride)
        self.shape = tuple(shape)

    @property
    def nnz(self):
        return self.data.numel()  # stored entries (DIA convention)

    @classmethod
    def from_scipy(cls, P, stride, dtype=None, device="cuda", max_depth: int = 24):
        """Convert a scipy sparse P, or return None when the pattern does
        not fit the stride-band form (then CSR applies)."""
        import scipy.sparse as sp

        device = resolve_device(device)
        P = sp.csr_matrix(P)
        P.sum_duplicates()
        coo = P.tocoo()
        n, nc = P.shape
        if stride < 1 or nc != -(-n // stride):
            return None
        d = coo.col.astype(np.int64) - coo.row.astype(np.int64) // stride
        offs = np.unique(d)
        if len(offs) > max_depth:
            return None
        data = np.zeros((len(offs), n), dtype=np.complex128)
        data[np.searchsorted(offs, d), coo.row] = coo.data
        return cls(_tensor(data, _complex(dtype), device),
                   tuple(int(o) for o in offs), stride, (n, nc))

    def _row_offsets(self):
        return tuple(self.stride * d for d in self.offsets)

    def matvec(self, Xc: torch.Tensor) -> torch.Tensor:
        """P @ Xc: (..., nc, m) -> (..., n, m)."""
        U = torch.repeat_interleave(Xc, self.stride, dim=-2)
        return dia_kernel.dia_matvec_plain(self.data, self._row_offsets(), U)

    def rmatvec(self, Y: torch.Tensor) -> torch.Tensor:
        """P^H @ Y: (..., n, m) -> (..., nc, m)."""
        n, nc = self.shape
        s = self.stride
        npad = nc * s
        T = torch.zeros(Y.shape[:-2] + (npad, Y.shape[-1]),
                        dtype=torch.result_type(self.data, Y), device=Y.device)
        wc = self.data.conj()
        for k, off in enumerate(self._row_offsets()):
            # row i of Y lands on row i + off of the upsampled coarse block
            lo, hi = max(0, -off), min(n, npad - off)
            if hi > lo:
                T[..., lo + off:hi + off, :].addcmul_(wc[k, lo:hi, None],
                                                      Y[..., lo:hi, :])
        return T.reshape(T.shape[:-2] + (nc, s, T.shape[-1])).sum(dim=-2)

    def todense(self) -> torch.Tensor:
        n, nc = self.shape
        out = torch.zeros((n, nc), dtype=self.data.dtype, device=self.data.device)
        rows = torch.arange(n, device=out.device)
        for k, d in enumerate(self.offsets):
            cols = rows // self.stride + d
            ok = (cols >= 0) & (cols < nc)
            out[rows[ok], cols[ok]] += self.data[k][ok]
        return out


class STRETCHT:
    """R = P^H for a STRETCH prolongation, with the `.matvec` interface."""

    def __init__(self, P: STRETCH):
        self.P = P

    @property
    def shape(self):
        return (self.P.shape[1], self.P.shape[0])

    @property
    def nnz(self):
        return self.P.nnz

    def matvec(self, Y: torch.Tensor) -> torch.Tensor:
        return self.P.rmatvec(Y)


class RowBlock:
    """Rows [r0, r0 + rows) of an (n, m) operator, the share of one rank of
    a row-sharded group (`parallel.rowsharded`): `local` (CSR, DIA or
    BELL) is the (rows, m) block with global column ids, and `gather`
    turns every rank's (..., rows, k) product block into the full
    (..., n, k) product.  The operator's entries never leave the rank;
    only product blocks travel.  `diag` is the whole operator's diagonal
    (the Jacobi preconditioner's), when known."""

    def __init__(self, local, r0: int, shape, gather, diag=None):
        self.local = local
        self.r0 = int(r0)
        self.shape = tuple(shape)
        self.gather = gather
        self.diag = diag

    @property
    def data(self):
        return self.local.data

    @property
    def nnz(self):
        return self.local.nnz

    def with_local(self, local) -> "RowBlock":
        """The same rows and gather over another local block (shifted or
        cast data)."""
        return RowBlock(local, self.r0, self.shape, self.gather)

    def own_rows(self, X: torch.Tensor) -> torch.Tensor:
        """This rank's rows of X (..., n, k), zero-padded to the block's."""
        rows = self.local.shape[0]
        Xr = X[..., self.r0:self.r0 + rows, :]
        if Xr.shape[-2] < rows:
            Xr = torch.nn.functional.pad(Xr, (0, 0, 0, rows - Xr.shape[-2]))
        return Xr

    def matvec(self, X: torch.Tensor) -> torch.Tensor:
        return self.gather(self.local.matvec(X))

    def diagonal(self) -> torch.Tensor:
        if self.diag is None:
            raise ValueError("RowBlock: diagonal not given")
        return self.diag


def dia_able(A, dia_fill: float = 0.45) -> bool:
    """True when scipy-sparse A is banded densely enough for DIA: stored
    DIA entries <= nnz / dia_fill."""
    coo = A.tocoo()
    offs = np.unique(coo.col.astype(np.int64) - coo.row.astype(np.int64))
    return len(offs) * A.shape[0] * dia_fill <= A.nnz


def bell_fill(A, bs: int = 16) -> float:
    """Stored entries over nnz that BELL would pay for this matrix at block
    size `bs` without a cap (host-side, structure only)."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    coo = A.tocoo()
    nbr = -(-A.shape[0] // bs)
    ncb = -(-A.shape[1] // bs)
    keys = (coo.row // bs).astype(np.int64) * ncb + coo.col // bs
    uk = np.unique(keys)
    counts = np.bincount((uk // ncb).astype(np.int64), minlength=nbr)
    kmax = max(int(counts.max()) if counts.size else 1, 1)
    return nbr * kmax * bs * bs / max(A.nnz, 1)


# The JAX package's SpMM cost model, fitted on a TPU (its
# benchmarks/results/bell_tune.json: a 200k-dof P1 FEM after RCM, m = 16):
# seconds per stored block T0 + T1 bs, and per CSR nnz.  It is the TPU's
# model, not the card's; it is kept unchanged so that both packages pick
# the same block size and spill split.  `chip_smoke.py --phases
# unstructured` times the card's product at every candidate bs.
_BELL_T0 = 60e-9
_BELL_T1 = 2.6e-9
_CSR_T_NNZ = 34e-9
_BELL_CANDIDATE_BS = (8, 16, 32, 64)


def _gather_cap(device) -> int:
    """Bytes the gathered block rows of one BELL product chunk may take: a
    32nd of the card's memory (2.5 GB on an 80 GB H100), 256 MiB on the
    host."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory // 32
    return 1 << 28


def _plan(structure):
    """(kcap, stored_slots, spill_nnz, kfull) of a `BELL._structure`."""
    (_colb, _blk, _ri, _ci, _vals, nbr_padded, kmax, keep, _coo, kfull) = structure
    return kmax, nbr_padded * kmax, float(np.count_nonzero(~keep)), kfull


def bell_plan(A, bs: int):
    """Host-side plan of the auto-kcap BELL structure at block size `bs`:
    (kcap, stored_slots, spill_nnz, kfull), from `BELL._structure` itself;
    stored_slots counts the padding of nbr to a multiple of 16."""
    return _plan(BELL._structure(A, bs, kcap="auto"))


def _plan_bytes(plan, bs: int, dtype) -> int:
    """The JAX package's byte model of one BELL operator: its stored blocks
    times the TPU's (8, 128) tile padding of the (nbr, bs, kcap bs) layout,
    plus the spill, at the complex itemsize of `dtype`.  The card stores the
    blocks unpadded; the caps price the padded bytes all the same, so that
    both packages admit the same block sizes."""
    kcap, slots, spill, _ = plan
    K = kcap * bs
    pad = (-(-bs // 8) * 8 / bs) * (-(-K // 128) * 128 / max(K, 1))
    itemsize = torch.empty((), dtype=_complex(dtype)).element_size()
    return int((slots * bs * bs * pad + spill) * itemsize)


def bell_hbm_bytes(A, bs: int, dtype=None) -> int:
    """Bytes of one BELL operator at block size `bs` with the auto-kcap
    plan as the JAX package counts them (`_plan_bytes`: TPU tile padding
    included), at the complex itemsize of `dtype` (default complex128)."""
    return _plan_bytes(bell_plan(A, bs), bs, dtype)


def _bell_pick(A, dtype, max_bytes):
    """(bs, structure) of `bell_pick_bs` on a scipy CSR, the structure the
    chosen block size was priced on (None, None for CSR), so that the
    operator is built without a second pass over the nnz."""
    best, best_cost, best_st = None, _CSR_T_NNZ * max(A.nnz, 1), None
    for bs in _BELL_CANDIDATE_BS:
        st = BELL._structure(A, bs, kcap="auto")
        plan = _plan(st)
        if _plan_bytes(plan, bs, dtype) > max_bytes:
            continue
        _, slots, spill, _ = plan
        cost = slots * (_BELL_T0 + _BELL_T1 * bs) + spill * _CSR_T_NNZ
        if cost < best_cost:
            best, best_cost, best_st = bs, cost, st
    return best, best_st


def bell_pick_bs(A, dtype=None, max_bytes: float = 1.0e9):
    """The block size the cost model above prices lowest among those whose
    operator (`bell_hbm_bytes`, the JAX package's padded bytes) fits
    `max_bytes`, or None when CSR's modeled time beats every admissible
    candidate (near-dense rows, point sparsity where each nnz is its own
    block)."""
    import scipy.sparse as sp

    return _bell_pick(sp.csr_matrix(A), dtype, max_bytes)[0]


def as_operator(A, dtype=None, device="cuda", dia_fill: float = 0.45,
                bell_bs=None, bell_max_fill: float = 32.0,
                bell_max_bytes: float = 1.0e9):
    """Coerce scipy-sparse / dense / tensor / CSR / DIA / BELL to a device
    operator, as the JAX package chooses:
      1. DIA when the matrix is banded with reasonably dense diagonals
         (stored DIA entries <= nnz / dia_fill);
      2. BELL otherwise, its block size from `bell_pick_bs` under the
         `bell_max_bytes` cap; `bell_bs` pins it (then `bell_max_fill`
         guards it);
      3. CSR as the last resort.
    Dense input becomes a complex tensor; None passes through, and so does
    an operator, which must already live on `device` (ValueError
    otherwise: it is never moved behind the caller's back)."""
    device = resolve_device(device)
    if A is None:
        return A
    if isinstance(A, (CSR, DIA, BELL, RowBlock)):
        if not same_device(A.data.device, device):
            raise ValueError(f"as_operator: the {type(A).__name__} operator lives on "
                             f"{A.data.device}, the solve runs on {device}; build it "
                             f"with device={str(device)!r}")
        return A
    import scipy.sparse as sp

    dtype = _complex(dtype)
    if isinstance(A, torch.Tensor):
        return A.to(device=device, dtype=dtype)
    if not sp.issparse(A):
        return _tensor(np.asarray(A, dtype=np.complex128), dtype, device)
    Ac = sp.csr_matrix(A)
    if dia_able(Ac, dia_fill):
        return DIA.from_scipy(Ac, dtype, device)
    if bell_bs is not None:
        if bell_fill(Ac, bell_bs) <= bell_max_fill:
            return BELL.from_scipy(Ac, bell_bs, dtype, device=device)
        return CSR.from_scipy(Ac, dtype, device)
    bs, st = _bell_pick(Ac, dtype, bell_max_bytes)
    if bs is not None:
        return BELL.from_structure(st, bs, Ac.shape, dtype, device)[0]
    return CSR.from_scipy(Ac, dtype, device)


def apply_op(M, X: torch.Tensor) -> torch.Tensor:
    """M @ X for an operator, a dense tensor, or None (the identity)."""
    if M is None:
        return X
    if isinstance(M, (CSR, DIA, BELL, RowBlock)):
        return M.matvec(X)
    return cx.cmatmul(M, X)


def _per_node(z: torch.Tensor, extra: int) -> torch.Tensor:
    """z (...,) shaped to broadcast against (..., a, b) (extra = 2) or
    (..., a) (extra = 1) tensors."""
    return z.reshape(z.shape + (1,) * extra) if z.dim() else z


def shifted_matvec(A, B, z: torch.Tensor):
    """Matrix-free X -> (A - z B) X with A, B operators / dense / None
    (identity); z a scalar tensor or (nodes,) against X (nodes, n, m)."""
    zb = _per_node(z, 2)
    if isinstance(A, RowBlock):
        # the shifted product of the rank's rows, then one gather
        def mv(X: torch.Tensor) -> torch.Tensor:
            BX = A.own_rows(X) if B is None else B.local.matvec(X)
            return A.gather(A.local.matvec(X) - zb * BX)

        return mv

    def mv(X: torch.Tensor) -> torch.Tensor:
        return apply_op(A, X) - zb * apply_op(B, X)

    return mv


def _diag_of(M, n, dtype, device):
    if M is None:
        return torch.ones(n, dtype=dtype, device=device)
    if isinstance(M, (CSR, DIA, BELL, RowBlock)):
        return M.diagonal()
    return torch.diagonal(M, dim1=-2, dim2=-1)


def jacobi_preconditioner(A, B, z: torch.Tensor):
    """M^{-1} = diag(A - z B)^{-1} as a callable for the Krylov solvers."""
    n = (A if A is not None else B).shape[0]
    dA = _diag_of(A, n, z.dtype, z.device)
    dB = _diag_of(B, n, z.dtype, z.device)
    dinv = cx.creciprocal(dA - _per_node(z, 1) * dB).unsqueeze(-1)

    def M(X: torch.Tensor) -> torch.Tensor:
        return X * dinv

    return M
