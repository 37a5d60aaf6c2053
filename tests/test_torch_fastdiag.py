"""The port's fast-diagonalization solver (ops/fastdiag.py) against
feast_tpu and dense solves on the CPU: both separable forms, the
commutation guard, the B2 rule, a node batch of shifts, and the deep
interior slice that feast_iterative reaches only with it.

Tolerances: float64 transforms to 1e-12 relative of the dense solve and of
the JAX result; float32 transforms to 1e-6 relative; the FEAST slice's
eigenvalues to 1e-10 of the spectrum's scale against the JAX result, with
the same iteration count."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import feast_tpu as jt
import feast_tpu_torch as ft
from feast_tpu import cx as jcx
from feast_tpu.ops import fastdiag as jfd
from feast_tpu_torch.ops import fastdiag as tfd

torch.set_num_threads(2)


def _tridiag(n, d, o):
    return sp.diags([np.full(n, d), np.full(n - 1, o), np.full(n - 1, o)],
                    [0, 1, -1], format="csr")


def _pencil_kron(N):
    T1 = _tridiag(N, 2.0, -1.0)
    M1 = _tridiag(N, 4 / 6, 1 / 6)
    I = sp.identity(N, format="csr")
    return T1, M1, (sp.kron(T1, I) + sp.kron(I, T1)).tocsr(), sp.kron(M1, M1).tocsr()


def _fem_parts():
    """tests/test_fastdiag.py::test_fem_form_matches_dense_solve's
    non-commuting per-axis pairs."""
    N1, N2 = 10, 14
    A1 = _tridiag(N1, 2.0, -1.0).toarray()
    A1[0, 0] = 5.0
    A1 = (A1 + A1.T) / 2
    M1 = _tridiag(N1, 4 / 6, 1 / 6).toarray()
    A2 = _tridiag(N2, 3.0, -0.7).toarray()
    A2[-1, -1] = 0.5
    A2 = (A2 + A2.T) / 2
    M2 = _tridiag(N2, 4 / 6, 1 / 6).toarray()
    return A1, A2, M1, M2


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _both(build_kw, z, X, dtype_t, dtype_j):
    fd = tfd.build(dtype=dtype_t, device="cpu", **build_kw)
    got = tfd.solve(fd, z, torch.as_tensor(X)).numpy()
    fdj = jfd.build(dtype=dtype_j, **build_kw)
    want_j = jcx.to_numpy(jfd.solve(fdj, jcx.as_cx(z, jnp.float64),
                                    jcx.from_numpy(X, jnp.float64)))
    return got, want_j


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 1e-6)])
def test_kron_form_matches_jax_and_dense(dtype, tol):
    N = 12
    T1, M1, K, B = _pencil_kron(N)
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N * N, 3)) + 1j * rng.standard_normal((N * N, 3))
    z = 0.37 + 0.21j
    got, want_j = _both(dict(A1=T1, B1=M1, form="kron"), z, X,
                        getattr(torch, dtype), getattr(jnp, dtype))
    want = np.linalg.solve(K.toarray() - z * B.toarray(), X)
    assert _rel(got, want) < (1e-11 if dtype == "float64" else tol)
    assert _rel(got, want_j) < tol


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 1e-6)])
def test_fem_form_matches_jax_and_dense(dtype, tol):
    A1, A2, M1, M2 = _fem_parts()
    A = np.kron(A1, M2) + np.kron(M1, A2)
    B = np.kron(M1, M2)
    rng = np.random.default_rng(1)
    X = rng.standard_normal((140, 2)) + 1j * rng.standard_normal((140, 2))
    z = -1.3 + 0.4j
    got, want_j = _both(dict(A1=A1, A2=A2, B1=M1, B2=M2, form="fem"), z, X,
                        getattr(torch, dtype), getattr(jnp, dtype))
    want = np.linalg.solve(A - z * B, X)
    assert _rel(got, want) < (1e-10 if dtype == "float64" else tol)
    assert _rel(got, want_j) < tol


def test_kron_commutation_guard():
    A1 = _tridiag(8, 2.0, -1.0).toarray()
    A1[0, 0] = 9.0  # no longer commutes with the Toeplitz mass
    M1 = _tridiag(8, 4 / 6, 1 / 6).toarray()
    with pytest.raises(ValueError, match="commuting"):
        tfd.build(A1=A1, B1=M1, form="kron", device="cpu")
    with pytest.raises(ValueError, match="form"):
        tfd.build(A1=A1, form="lu", device="cpu")


def test_b2_rule_matches_jax():
    """The JAX package's rule, kept: B2 defaults to B1 only when A2 is A1;
    B2 = None with a distinct A2 is the identity on axis 1."""
    A1, A2, M1, _ = _fem_parts()
    I2 = np.eye(A2.shape[0])
    implicit = tfd.build(A1=A1, A2=A2, B1=M1, form="fem", dtype=torch.float64,
                         device="cpu")
    explicit = tfd.build(A1=A1, A2=A2, B1=M1, B2=I2, form="fem",
                         dtype=torch.float64, device="cpu")
    # the same pencil (LAPACK's standard and generalized eigh round apart)
    torch.testing.assert_close(implicit.dA, explicit.dA, rtol=0, atol=1e-12)
    torch.testing.assert_close(implicit.dB, explicit.dB, rtol=0, atol=0)
    jimp = jfd.build(A1=A1, A2=A2, B1=M1, form="fem", dtype=jnp.float64)
    np.testing.assert_allclose(implicit.dA.numpy(), np.asarray(jimp.dA), atol=1e-12)
    np.testing.assert_allclose(implicit.dB.numpy(), np.asarray(jimp.dB), atol=1e-12)
    # A2 omitted: B2 follows B1 (the symmetric grid)
    sym = tfd.build(A1=A1, B1=M1, form="fem", dtype=torch.float64, device="cpu")
    both = tfd.build(A1=A1, A2=A1, B1=M1, B2=M1, form="fem", dtype=torch.float64,
                     device="cpu")
    torch.testing.assert_close(sym.dA, both.dA, rtol=0, atol=0)


def test_node_batch_of_shifts_and_preconditioner():
    """A (chunk,) tensor of shifts against X (chunk, n, m): each node's
    block solved at its own shift, as feast_iterative calls it."""
    N = 9
    T1, M1, K, B = _pencil_kron(N)
    fd = tfd.build(A1=T1, B1=M1, form="kron", dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(2)
    X = rng.standard_normal((3, N * N, 2)) + 1j * rng.standard_normal((3, N * N, 2))
    z = torch.tensor([0.5 + 0.1j, 1.0 - 0.3j, -2.0 + 0.0j], dtype=torch.complex128)
    got = tfd.preconditioner(fd)(z)(torch.as_tensor(X)).numpy()
    for i in range(3):
        want = np.linalg.solve(K.toarray() - complex(z[i]) * B.toarray(), X[i])
        assert _rel(got[i], want) < 1e-12


def test_feast_iterative_deep_interior_matches_jax():
    """tests/test_fastdiag.py::test_feast_iterative_deep_interior: a slice
    at 0.45 lam_max of the N = 40 tensor pencil, the node solves made
    direct by the fastdiag preconditioner."""
    N = 40
    T1, M1, K, B = _pencil_kron(N)
    k = np.arange(1, N + 1)
    t = 2 - 2 * np.cos(k * np.pi / (N + 1))
    m = (2 + np.cos(k * np.pi / (N + 1))) / 3
    lam = np.sort(((t[:, None] + t[None, :]) / (m[:, None] * m[None, :])).ravel())
    sigma = 0.45 * lam[-1]
    i0 = int(np.argmin(np.abs(lam - sigma)))
    lo, hi = i0 - 2, i0 + 2
    while lo > 0 and lam[lo] - lam[lo - 1] < 1e-9 * sigma:
        lo -= 1
    while hi + 1 < len(lam) and lam[hi + 1] - lam[hi] < 1e-9 * sigma:
        hi += 1
    c = (lam[lo] + lam[hi]) / 2
    r = (lam[hi] - lam[lo]) / 2 + 0.4 * min(lam[lo] - lam[lo - 1], lam[hi + 1] - lam[hi])
    exact = lam[(lam >= c - r) & (lam <= c + r)]
    m0 = len(exact) + 4
    rng = np.random.default_rng(3)
    X0 = rng.standard_normal((N * N, m0)) + 1j * rng.standard_normal((N * N, m0))
    Kc, Bc = K.astype(np.complex128), B.astype(np.complex128)
    kw = dict(c=complex(c), r=float(r), nodes=8, iters=8, tol=1e-10,
              tol_mode="contour", solver="bicgstab_rr", solve_tol=1e-10,
              solve_iters=50)
    out = ft.feast_iterative(
        Kc, Bc, X0, device="cpu", precondition=tfd.preconditioner(
            tfd.build(A1=T1, B1=M1, form="kron", dtype=torch.float64, device="cpu")),
        **kw)
    outj = jt.feast_iterative(
        Kc, Bc, X0, precondition=jfd.preconditioner(
            jfd.build(A1=T1, B1=M1, form="kron", dtype=jnp.float64)), **kw)
    assert out.converged and bool(outj.converged)
    lamf, Xf, res = out.filtered()
    got = np.sort(lamf.real)
    assert len(got) == len(exact)
    assert np.allclose(got, exact, rtol=1e-8)
    np.testing.assert_allclose(got, np.sort(outj.filtered()[0].real), rtol=0,
                               atol=1e-10 * (abs(c) + r))
    assert out.n_iter == int(outj.n_iter)
    assert res.max() < 1e-10 * (abs(c) + r)
    host = np.linalg.norm(Kc @ Xf - (Bc @ Xf) * lamf[None, :], axis=0)
    assert host.max() < 1e-10 * (abs(c) + r)
