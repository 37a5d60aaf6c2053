"""Sparse complex operators for the matrix-free solve path.

Counterpart of `feast_tpu/ops/sparse.py` on native complex tensors: `CSR`
(gather + index-add), `DIA` (few dense diagonals, a sum of shifted
elementwise products), `STRETCH` / `STRETCHT` (the stride-banded AMG
transfers), `as_operator`, `shifted_matvec`, `jacobi_preconditioner`.

Every `matvec` takes X (..., n_cols, m): leading batch dimensions are the
contour-node axis of `feast_iterative` (the JAX package's `vmap`), and
an operator's `data` may carry the same leading dimensions (the shifted
level operators S_l(z_i) of the AMG V-cycle differ per node).

The complex64 DIA product on the card is the hand-written Hopper kernel
(`ops/dia_kernel.py`); complex128 and every CPU tensor take the plain
shifted-slice version.  `BELL` (blocked ELL) is not ported yet: where the
JAX package would pick it, the port picks CSR (same numbers, slower format).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cx
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
    def from_scipy(cls, A, dtype=None, device="cpu"):
        import scipy.sparse as sp

        A = sp.csr_matrix(A)
        row_ids = np.repeat(np.arange(A.shape[0], dtype=np.int64), np.diff(A.indptr))
        return cls(_tensor(A.data.astype(np.complex128), _complex(dtype), device),
                   torch.as_tensor(A.indices.astype(np.int64), device=device),
                   torch.as_tensor(row_ids, device=device), A.shape)

    @classmethod
    def from_dense(cls, A, dtype=None, device="cpu"):
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
    def from_scipy(cls, A, dtype=None, device="cpu"):
        import scipy.sparse as sp

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
    """Blocked-ELL storage of the JAX package: not ported yet.  `as_operator`
    and the AMG setup choose CSR where the JAX package would choose BELL."""

    @classmethod
    def from_scipy(cls, *args, **kwargs):
        raise NotImplementedError("feast_tpu_torch: BELL is not ported yet")

    pair_from_scipy = from_scipy


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
    def from_scipy(cls, P, stride, dtype=None, device="cpu", max_depth: int = 24):
        """Convert a scipy sparse P, or return None when the pattern does
        not fit the stride-band form (then CSR applies)."""
        import scipy.sparse as sp

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


def dia_able(A, dia_fill: float = 0.45) -> bool:
    """True when scipy-sparse A is banded densely enough for DIA: stored
    DIA entries <= nnz / dia_fill."""
    coo = A.tocoo()
    offs = np.unique(coo.col.astype(np.int64) - coo.row.astype(np.int64))
    return len(offs) * A.shape[0] * dia_fill <= A.nnz


def as_operator(A, dtype=None, device="cpu", dia_fill: float = 0.45):
    """Coerce scipy-sparse / dense / tensor / CSR / DIA to a device operator:
    DIA when the matrix is banded with reasonably dense diagonals, else CSR
    (the JAX package's BELL tier is not ported); dense input becomes a
    complex tensor; None and operators pass through."""
    if A is None or isinstance(A, (CSR, DIA)):
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
    return CSR.from_scipy(Ac, dtype, device)


def apply_op(M, X: torch.Tensor) -> torch.Tensor:
    """M @ X for an operator, a dense tensor, or None (the identity)."""
    if M is None:
        return X
    if isinstance(M, (CSR, DIA)):
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

    def mv(X: torch.Tensor) -> torch.Tensor:
        return apply_op(A, X) - zb * apply_op(B, X)

    return mv


def _diag_of(M, n, dtype, device):
    if M is None:
        return torch.ones(n, dtype=dtype, device=device)
    if isinstance(M, (CSR, DIA)):
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
