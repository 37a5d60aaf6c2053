"""Nonlinear eigenproblem (NEP) types.

Counterpart of `feast_tpu/nep.py`.  T is held in SPMF form (sum of
products of matrices and functions),

    T(z) = sum_j f_j(z) A_j,

with complex coefficient matrices A_j on one device (complex128 unless a
`dtype` is given) and scalar functions f_j that take and return complex
tensors (broadcasting over any shape of z).  The form gives

  * node matrices T(z_i) term by term (`eval_nodes`);
  * residual columns T(lam_k) x_k for every Ritz value at once:
    R = sum_j scale_cols(A_j X, f_j(lam)), d matrix products (`apply_cols`);
  * ||T(lam)||_F from the Gram tensor G_jk = <A_j, A_k>_F:
    ||T(lam)||_F^2 = sum_jk conj(f_j) f_k G_jk (`fro_norms`).

`CallableNEP` wraps a host callable z -> numpy matrix; the drivers then
form its residuals on the host.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from . import cx
from ._device import as_tensor, resolve_device, same_device

C128 = torch.complex128


def one(z: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(z)


def neg_z(z: torch.Tensor) -> torch.Tensor:
    return -z


class SPMF:
    """T(z) = sum_j f_j(z) A_j.

    terms: (A_j, f_j) pairs; A_j numpy arrays or tensors (moved to
    `device`), f_j complex tensor -> complex tensor.  dtype: the storage
    dtype of the A_j, real or complex (the JAX package's argument; default
    complex128).  The Gram tensor is formed from the inputs in complex128,
    as the JAX package forms it from its host inputs."""

    def __init__(self, terms: Sequence[Tuple[object, Callable]], device="cuda",
                 dtype=None):
        dev = resolve_device(device)
        self.device = dev
        self.dtype = C128 if dtype is None else cx.complex_dtype(dtype)
        self.funcs: List[Callable] = [f for _, f in terms]
        mats = [as_tensor(A, C128, dev) for A, _ in terms]
        self.n = mats[0].shape[0]
        self.d = len(mats)
        G = torch.empty((self.d, self.d), dtype=C128, device=dev)
        for j in range(self.d):
            for k in range(j, self.d):
                G[j, k] = torch.vdot(mats[j].reshape(-1), mats[k].reshape(-1))
                G[k, j] = G[j, k].conj()
        self._gram = G
        self.mats: List[torch.Tensor] = [A.to(self.dtype) for A in mats]

    # -- evaluation ---------------------------------------------------------
    def coeffs(self, lam: torch.Tensor) -> torch.Tensor:
        """f_j(lam) for all terms: (d, *lam.shape)."""
        return torch.stack([torch.as_tensor(f(lam), device=lam.device)
                            .to(lam.dtype).expand(lam.shape) for f in self.funcs])

    def eval_at(self, z) -> torch.Tensor:
        """T(z) for one scalar z."""
        z = torch.as_tensor(z, dtype=C128, device=self.device)
        co = self.coeffs(z)
        out = torch.zeros((self.n, self.n), dtype=C128, device=self.device)
        for j in range(self.d):
            out = out + co[j] * self.mats[j]
        return out

    def eval_nodes(self, z: torch.Tensor, out_dtype=None, out=None) -> torch.Tensor:
        """T(z_i) over a node axis: (N, n, n).

        Term by term, each term cast to `out_dtype` before it is added, so
        the peak is the output and one cast coefficient matrix, never a
        (d, N, n, n) stack.  out: an (N, n, n) tensor (a view into a larger
        buffer, such as the zero-padded one of the K1 route) that receives
        the result in place."""
        dt = out_dtype or self.dtype
        N = z.shape[0]
        if out is None:
            out = torch.zeros((N, self.n, self.n), dtype=dt, device=self.device)
        else:
            out.zero_()
        co = self.coeffs(z).to(dt).cpu()   # (d, N): scalars for add_'s alpha
        for j in range(self.d):
            Aj = self.mats[j].to(dt)
            for i in range(N):
                out[i].add_(Aj, alpha=complex(co[j, i]))
            del Aj
        return out

    def apply_block(self, z: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
        """T(z_i) V_i without forming T(z_i): z (N,), V (N, n, m); d
        products, each one (n, n) x (n, N m) matmul over all nodes."""
        N, n, m = V.shape
        co = self.coeffs(z)                              # (d, N)
        flat = V.permute(1, 0, 2).reshape(n, N * m)
        out = torch.zeros_like(V)
        for j in range(self.d):
            AV = (self.mats[j].to(V.dtype) @ flat).reshape(n, N, m).permute(1, 0, 2)
            out = out + co[j][:, None, None] * AV
        return out

    def apply_cols(self, X: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
        """Columns T(lam_k) x_k for all k at once: (n, m)."""
        co = self.coeffs(lam)                            # (d, m)
        out = torch.zeros_like(X)
        for j in range(self.d):
            out = out + cx.scale_cols(self.mats[j].to(X.dtype) @ X, co[j])
        return out

    def fro_norms(self, lam: torch.Tensor) -> torch.Tensor:
        """||T(lam_k)||_F for each k."""
        co = self.coeffs(lam)                            # (d, m)
        acc = torch.einsum("jm,jk,km->m", co.conj(), self._gram, co).real
        return torch.sqrt(torch.clamp(acc, min=0.0))


class PolynomialNEP(SPMF):
    """T(z) = A_0 + A_1 z + ... + A_d z^d."""

    def __init__(self, coeff_mats: Sequence, device="cuda", dtype=None):
        def monomial(p):
            if p == 0:
                return one
            return lambda z: cx.cpow_scalar(z, p)

        super().__init__([(A, monomial(p)) for p, A in enumerate(coeff_mats)], device,
                         dtype)
        self.degree = len(self.mats) - 1


class LinearPencilNEP(SPMF):
    """T(z) = A - z B (B = I when omitted): linear problems through the
    nonlinear solvers."""

    def __init__(self, A, B=None, device="cuda", dtype=None):
        if B is None:
            B = torch.eye(A.shape[0], dtype=C128)
        super().__init__([(A, one), (B, neg_z)], device, dtype)


class CallableNEP:
    """A host callable z -> numpy matrix.  Node matrices are built on the
    host and moved to `device` (as `dtype`, default complex128, unless the
    caller names another); the residuals T(lam) x run on the host."""

    def __init__(self, fn: Callable, n: int, device="cuda", dtype=None):
        self.fn = fn
        self.n = n
        self.device = resolve_device(device)
        self.dtype = C128 if dtype is None else cx.complex_dtype(dtype)

    def eval_nodes(self, z: torch.Tensor, out_dtype=None, out=None) -> torch.Tensor:
        mats = np.stack([np.asarray(self.fn(complex(zi)), dtype=np.complex128)
                         for zi in z.cpu().numpy()])
        T = torch.as_tensor(mats, dtype=out_dtype or self.dtype, device=self.device)
        if out is None:
            return T
        out.copy_(T)
        return out

    def host_apply_cols(self, Xn: np.ndarray, lamn: np.ndarray) -> np.ndarray:
        cols = [np.asarray(self.fn(complex(l)), dtype=np.complex128) @ Xn[:, i]
                for i, l in enumerate(lamn)]
        return np.stack(cols, axis=1)

    def host_fro_norms(self, lamn: np.ndarray) -> np.ndarray:
        return np.array([np.linalg.norm(np.asarray(self.fn(complex(l))))
                         for l in lamn])


def as_nep(T, n=None, dtype=None, device="cuda"):
    """Coerce user input into a NEP on `device`: an SPMF or CallableNEP as
    it is (its device must match), a host callable (needs n), or a list of
    polynomial coefficients; `dtype` goes to the last two, as in the JAX
    package."""
    dev = resolve_device(device)
    if isinstance(T, (SPMF, CallableNEP)):
        if not same_device(T.device, dev):
            raise ValueError(f"NEP lives on {T.device}, the solve runs on {dev}")
        return T
    if callable(T):
        if n is None:
            raise ValueError("CallableNEP needs the problem size n")
        return CallableNEP(T, n, dev, dtype)
    if isinstance(T, (list, tuple)):
        return PolynomialNEP(T, dev, dtype)
    raise TypeError(f"cannot interpret {type(T)} as a NEP")
