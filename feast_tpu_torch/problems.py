"""Problem gallery: the NEP families the reference exercises.

Counterpart of `feast_tpu/problems.py`: the same generators, drawing the
same numbers from the same numpy generators in the same order, so both
packages build the same matrices from one seed.  Generators return the
port's NEP types on `device` (default "cuda"); `butterfly` also returns the
numpy coefficients for `companion`.  The MatrixMarket loaders
(`load_system5`, `load_quadratic`, `load_butterfly`) read the reference's
fixture files from `data_dir`, or from the directory named by the
FEAST_REF_DATA environment variable.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from . import cx
from ._device import resolve_device
from .nep import SPMF, PolynomialNEP, neg_z, one


def butterfly(m: int = 8, device="cuda") -> Tuple[PolynomialNEP, list]:
    """The NLEVP 'butterfly' quartic PEP on an m x m grid (N = m^2):
    T(z) = M0 + z M1 + z^2 M2 + z^3 M3 + z^4 M4 from Kronecker products of
    shift/tridiagonal blocks with the standard coefficient table."""
    Nshift = np.diag(np.ones(m - 1), -1)
    I_m = np.eye(m)
    Mh0 = (4 * I_m + Nshift + Nshift.T) / 6.0
    Mh1 = Nshift - Nshift.T
    Mh2 = -(2 * I_m - Nshift - Nshift.T)
    Mh3 = Mh1
    Mh4 = -Mh2
    c = np.array([[0.6, 1.3], [1.3, 0.1], [0.1, 1.2], [1.0, 1.0], [1.2, 1.0]])
    blocks = [Mh0, Mh1, Mh2, Mh3, Mh4]
    coeffs = [
        (c[k, 0] * np.kron(I_m, blocks[k]) + c[k, 1] * np.kron(blocks[k], I_m)
         ).astype(np.complex128)
        for k in range(5)
    ]
    return PolynomialNEP(coeffs, device), coeffs


def loaded_string(n: int = 100, kappa: float = 1.0, mass: float = 1.0,
                  device="cuda") -> SPMF:
    """NLEVP 'loaded_string': T(lam) = A - lam B + kappa lam/(lam - sigma)
    e_n e_n^T with sigma = kappa/mass (rational NEP; the reference runs it
    with K=3 moments at c=800 r=790)."""
    A = n * (np.diag(np.full(n, 2.0)) - np.diag(np.ones(n - 1), 1)
             - np.diag(np.ones(n - 1), -1))
    A[-1, -1] = n * 1.0
    B = (np.diag(np.full(n, 4.0)) + np.diag(np.ones(n - 1), 1)
         + np.diag(np.ones(n - 1), -1)) / (6.0 * n)
    B[-1, -1] = 2.0 / (6.0 * n)
    C = np.zeros((n, n))
    C[-1, -1] = 1.0
    sigma = kappa / mass

    def rational(z):
        return cx.cdiv(kappa * z, torch.complex(z.real - sigma, z.imag))

    return SPMF([(A.astype(np.complex128), one), (B.astype(np.complex128), neg_z),
                 (C.astype(np.complex128), rational)], device)


def hadeler(n: int = 200, b0: float = 100.0, device="cuda") -> SPMF:
    """NLEVP 'hadeler': T(z) = (e^z - 1) B1 + z^2 B2 - b0 I (the reference
    runs it at c=-30 r=10)."""
    i = np.arange(1, n + 1)
    B1 = (n + 1 - np.maximum.outer(i, i)) * np.outer(i, i)
    B2 = n * np.eye(n) + 1.0 / np.add.outer(i, i)
    B0 = b0 * np.eye(n)

    def expm1_f(z):
        ez = torch.exp(z.real)
        return torch.complex(ez * torch.cos(z.imag) - 1.0, ez * torch.sin(z.imag))

    return SPMF([(B1.astype(np.complex128), expm1_f),
                 (B2.astype(np.complex128), lambda z: z * z),
                 (B0.astype(np.complex128), lambda z: -torch.ones_like(z))], device)


def delay_nep(A0: np.ndarray, A1: np.ndarray, tau: float = 1.0,
              device="cuda") -> SPMF:
    """Delay eigenvalue problem T(z) = -z I + A0 + A1 e^{-tau z}."""
    n = A0.shape[0]

    def exp_f(z):
        e = torch.exp(-tau * z.real)
        return torch.complex(e * torch.cos(tau * z.imag), -e * torch.sin(tau * z.imag))

    return SPMF([(np.eye(n, dtype=np.complex128), neg_z),
                 (np.asarray(A0, dtype=np.complex128), one),
                 (np.asarray(A1, dtype=np.complex128), exp_f)], device)


def laplacian_1d(n: int, sparse: bool = False):
    """1-D Laplacian tridiag(-1, 2, -1), dense numpy or scipy CSR."""
    if sparse:
        import scipy.sparse as sp

        return sp.diags([np.full(n, 2.0), -np.ones(n - 1), -np.ones(n - 1)],
                        [0, 1, -1], format="csr").astype(np.complex128)
    return (np.diag(np.full(n, 2.0)) - np.diag(np.ones(n - 1), 1)
            - np.diag(np.ones(n - 1), -1)).astype(np.complex128)


def _data_dir(data_dir: Optional[str]) -> str:
    d = data_dir or os.environ.get("FEAST_REF_DATA")
    if not d or not os.path.isdir(d):
        raise FileNotFoundError(f"fixture dir {d} not found (pass data_dir= "
                                "or set FEAST_REF_DATA)")
    return d


def _read_dense(d: str, name: str) -> np.ndarray:
    from .io import read_matrix_market

    return read_matrix_market(os.path.join(d, name), out="dense")


def load_system5(data_dir: Optional[str] = None,
                 device="cuda") -> Tuple[PolynomialNEP, list]:
    """1000 x 1000 real quadratic from system5A{0,1,2}.mtx (the reference's
    polynomial test: slice c = -1.55, r = 0.05, m0 = 80, K = 2)."""
    d = _data_dir(data_dir)
    coeffs = [_read_dense(d, f"system5A{k}.mtx") for k in range(3)]
    return PolynomialNEP(coeffs, device), coeffs


def load_quadratic(data_dir: Optional[str] = None,
                   device="cuda") -> Tuple[PolynomialNEP, list]:
    """15 x 15 rank-deficient quadratic (z + 0.2)(z - 0.1) A1 + A0 from
    quadraticM{0,1}.mtx."""
    d = _data_dir(data_dir)
    A0 = _read_dense(d, "quadraticM0.mtx")
    A1 = _read_dense(d, "quadraticM1.mtx")
    coeffs = [A0 - 0.02 * A1, 0.1 * A1, A1]
    return PolynomialNEP(coeffs, device), coeffs


def load_butterfly(data_dir: Optional[str] = None,
                   device="cuda") -> Tuple[PolynomialNEP, list]:
    """64 x 64 quartic from butterflyM{0..4}.mtx; `butterfly()` when the
    fixture directory is absent."""
    try:
        d = _data_dir(data_dir)
    except FileNotFoundError:
        return butterfly(device=device)
    coeffs = [_read_dense(d, f"butterflyM{k}.mtx") for k in range(5)]
    return PolynomialNEP(coeffs, device), coeffs


def gun_like(n: int = 256, seed: int = 0, planted: Optional[int] = None,
             cluster: Tuple[float, float] = (100.0, 110.0),
             cache_dir: Optional[str] = None, device="cuda") -> SPMF:
    """A gun-NLEP-shaped problem T(z) = K - z M + i sqrt(z - s1^2) W1
    + i sqrt(z - s2^2) W2 (the RF-gun cavity NLEP's structure at any size).

    planted=None: a GOE-bulk pencil with a dense uniform spectrum.
    planted=m: m pencil eigenvalues in `cluster` = (lo, hi), everything else
    far above, both branch points below the cluster (the real gun's
    phenomenology; at n = 9956 with m0 = 84 the reference's configuration).

    The random numbers are drawn on the host from np.random.default_rng(seed)
    in the JAX package's order; the dense work (the four reflector updates
    of K, the two (n x n/64)(n/64 x n) low-rank products) runs in float64 on
    `device`.  cache_dir: load the parts from, or save them once to, an npz
    file there."""
    dev = resolve_device(device)
    parts = path = None
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        tag = "none" if planted is None else str(planted)
        path = os.path.join(cache_dir, f"gun_like_n{n}_seed{seed}_p{tag}"
                                       f"_c{cluster[0]:g}-{cluster[1]:g}.npz")
        if os.path.exists(path):
            with np.load(path) as z:
                parts = {k: (torch.as_tensor(z[k], device=dev) if z[k].ndim == 2
                             else z[k][()]) for k in z.files}
    if parts is None:
        parts = _gun_like_parts(n, seed, planted, cluster, dev)
        if path is not None:
            tmp = path + ".tmp.npz"
            np.savez(tmp, **{k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
                             for k, v in parts.items()})
            os.replace(tmp, path)
    return _gun_like_assemble(parts, dev)


def _gun_like_parts(n, seed, planted, cluster, dev) -> dict:
    """The gun_like coefficient arrays (real float64 tensors on `dev`)."""
    f64 = torch.float64
    rng = np.random.default_rng(seed)
    if planted is None:
        Kd = torch.as_tensor(rng.standard_normal((n, n)), device=dev)
        K = (Kd + Kd.T) / 2 + n * torch.eye(n, dtype=f64, device=dev)
        Md = torch.as_tensor(rng.standard_normal((n, n)), device=dev)
        M = ((Md + Md.T) / 2 + n * torch.eye(n, dtype=f64, device=dev)) / n
        del Kd, Md
        wscale = 1.0 / n
    else:
        lo, hi = cluster
        d = np.concatenate([rng.uniform(lo, hi, planted),
                            rng.uniform(4.0 * hi, 40.0 * hi, n - planted)])
        # K = Q D Q^T with Q a product of 4 Householder reflectors
        K = torch.diag(torch.as_tensor(d, device=dev))
        for _ in range(4):
            v = rng.standard_normal((n, 1))
            v /= np.linalg.norm(v)
            v = torch.as_tensor(v[:, 0], device=dev)
            w = K @ v
            vw = float(torch.dot(v, w))
            K.addr_(v, w, alpha=-2.0)
            K.addr_(w, v, alpha=-2.0)
            K.addr_(v, v, alpha=4.0 * vw)
        M = None                                   # the identity
        wscale = 0.6 / np.sqrt(lo)
    rk = 4 if planted is None else max(4, n // 64)

    def _lowrank(scale2=None):
        U = rng.standard_normal((n, rk))
        V = rng.standard_normal((rk, n))
        if scale2 is not None:
            # ||UV||_2 from the rk x rk product (eigs of (U^T U)(V V^T))
            s2max = np.linalg.eigvals((U.T @ U) @ (V @ V.T)).real.max()
            U = U * (scale2 / np.sqrt(s2max))
        return torch.as_tensor(U, device=dev) @ torch.as_tensor(V, device=dev)

    if planted is None:
        W1 = _lowrank() / n
        W2 = _lowrank() / n
        s1, s2 = 0.0, 108.8774
    else:
        W1 = _lowrank(scale2=wscale)
        W2 = _lowrank(scale2=wscale)
        # both branch points below the cluster, as the real gun's contour
        # sits above both cuts
        s1, s2 = 0.0, np.sqrt(0.8 * cluster[0])
    parts = {"K": K, "W1": W1, "W2": W2, "s1": np.float64(s1), "s2": np.float64(s2),
             "m_identity": np.bool_(planted is not None)}
    if M is not None:
        parts["M"] = M
    return parts


def _isqrt_shift(s: float):
    """z -> i sqrt(z - s^2), the square root by the JAX package's rule."""
    def f(z):
        w = cx.csqrt(torch.complex(z.real - s * s, z.imag))
        return torch.complex(-w.imag, w.real)
    return f


def _gun_like_assemble(parts: dict, dev) -> SPMF:
    K = parts["K"]
    n = K.shape[0]
    s1, s2 = float(parts["s1"]), float(parts["s2"])
    M = (torch.eye(n, dtype=torch.complex128, device=dev) if bool(parts["m_identity"])
         else parts["M"])
    return SPMF([(K, one), (M, neg_z), (parts["W1"], _isqrt_shift(s1)),
                 (parts["W2"], _isqrt_shift(s2))], dev)


def fiber_like(n: int = 2400, seed: int = 0, device="cuda") -> SPMF:
    """A fiber-NLEP-shaped problem: T(z) = A - z I + s(z) e_n e_n^T with a
    graded tridiagonal A and the branch-singular rank-1 boundary term
    s(z) = sqrt(z - b) z / (1 + sqrt(z - b)), b = -0.5 (the regime of the
    reference's K=10 moment run).  seed is accepted as in the JAX package,
    whose generator draws nothing from it either."""
    prof = 1.0 + 0.5 * np.exp(-np.linspace(0, 4, n))
    A = (np.diag(2.0 * prof) - np.diag(np.ones(n - 1), 1)
         - np.diag(np.ones(n - 1), -1)).astype(np.complex128)
    C = np.zeros((n, n))
    C[-1, -1] = 1.0
    b = -0.5

    def s_f(z):
        w = cx.csqrt(torch.complex(z.real - b, z.imag))
        return cx.cdiv(w * z, torch.complex(1.0 + w.real, w.imag))

    return SPMF([(A, one), (np.eye(n, dtype=np.complex128), neg_z),
                 (C.astype(np.complex128), s_f)], device)


def fem2d_unstructured(n_points: int = 4000, seed: int = 0, dirichlet: bool = True):
    """Unstructured sparse generalized pencil: P1 finite-element stiffness K
    and mass M on a Delaunay triangulation of random points in the unit
    square.  Returns (K, M, points) with K, M scipy CSR (complex128); with
    dirichlet the convex-hull boundary nodes are eliminated."""
    import scipy.sparse as sp
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    pts = rng.random((n_points, 2))
    tri = Delaunay(pts)
    t = tri.simplices
    p0, p1, p2 = pts[t[:, 0]], pts[t[:, 1]], pts[t[:, 2]]
    d1 = p1 - p0
    d2 = p2 - p0
    det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    area = 0.5 * np.abs(det)
    ok = area > 1e-14                       # drop degenerate slivers
    t, d1, d2, det, area = t[ok], d1[ok], d2[ok], det[ok], area[ok]
    g1 = np.stack([d2[:, 1], -d2[:, 0]], axis=1) / det[:, None]
    g2 = np.stack([-d1[:, 1], d1[:, 0]], axis=1) / det[:, None]
    g0 = -(g1 + g2)
    G = np.stack([g0, g1, g2], axis=1)
    KL = area[:, None, None] * np.einsum("tid,tjd->tij", G, G)
    ML = (area / 12.0)[:, None, None] * (np.ones((3, 3)) + np.eye(3))
    rows = np.repeat(t, 3, axis=1).ravel()
    cols = np.tile(t, (1, 3)).ravel()
    nv = n_points
    K = sp.coo_matrix((KL.ravel(), (rows, cols)), shape=(nv, nv)).tocsr()
    M = sp.coo_matrix((ML.ravel(), (rows, cols)), shape=(nv, nv)).tocsr()
    if dirichlet:
        bnd = np.unique(tri.convex_hull)
        keep = np.setdiff1d(np.arange(nv), bnd)
        K = K[keep][:, keep].tocsr()
        M = M[keep][:, keep].tocsr()
        pts = pts[keep]
    return (K.astype(np.complex128), M.astype(np.complex128), pts)
