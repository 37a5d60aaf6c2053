"""feast_tpu_torch Krylov solvers against feast_tpu on the fixtures of
tests/test_krylov_sparse.py: same seeded systems through both packages,
iteration counts within 1 (the recurrences are the same, the matmuls round
differently), solutions to 1e-9 relative; and the explicit node axis
against one solve per node."""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from feast_tpu import cx as jcx
from feast_tpu.ops import krylov as jkr
from feast_tpu.ops import sparse as jsp
from feast_tpu_torch.ops import krylov as tkr
from feast_tpu_torch.ops import sparse as tsp

torch.set_num_threads(2)


def _rand(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _dense_system(seed, n, m, noise):
    rng = np.random.default_rng(seed)
    A = np.diag(np.arange(1.0, n + 1.0)).astype(np.complex128) + noise * _rand(rng, n, n)
    return A, _rand(rng, n, m)


def _both(A, B, jfn, tfn, **kw):
    Ac = jcx.from_numpy(A)
    out_j = jax.jit(lambda b: jfn(lambda X: jcx.cmatmul(Ac, X), b, **kw))(jcx.from_numpy(B))
    At = torch.as_tensor(A)
    out_t = tfn(lambda X: At @ X, torch.as_tensor(B), **kw)
    return out_j, out_t


def _check(A, B, out_j, out_t):
    Xt, Xj = out_t.x.numpy(), jcx.to_numpy(out_j.x)
    assert np.linalg.norm(A @ Xt - B) / np.linalg.norm(B) < 1e-9
    assert np.abs(Xt - Xj).max() / np.abs(Xj).max() < 1e-9
    assert abs(int(out_t.iters) - int(out_j.iters)) <= 1
    assert bool(out_t.converged.all()) == bool(np.asarray(out_j.converged).all())
    np.testing.assert_allclose(out_t.resnorm.numpy(), np.asarray(out_j.resnorm),
                               rtol=0, atol=1e-9)


def test_bicgstab_matches_jax():
    A, B = _dense_system(0, 80, 6, 0.3)
    out_j, out_t = _both(A, B, jkr.bicgstab, tkr.bicgstab, tol=1e-10, maxiter=2000)
    _check(A, B, out_j, out_t)
    assert bool(out_t.converged.all())


def test_gmres_matches_jax():
    A, B = _dense_system(1, 60, 4, 0.3)
    out_j, out_t = _both(A, B, jkr.gmres, tkr.gmres, tol=1e-10, restart=40)
    _check(A, B, out_j, out_t)


@pytest.mark.parametrize("ell", [2, 4])
def test_bicgstab_l_matches_jax(ell):
    A, B = _dense_system(4, 120, 5, 0.4)
    out_j, out_t = _both(A, B, jkr.bicgstab_l, tkr.bicgstab_l, ell=ell, tol=1e-10,
                         maxiter=500)
    _check(A, B, out_j, out_t)
    assert bool(out_t.converged.all())


def test_bicgstab_l_warm_start_and_preconditioner():
    """x0 in true coordinates plus right preconditioning, as the JAX test."""
    rng = np.random.default_rng(4)
    n, m = 120, 5
    A, B = _dense_system(4, n, m, 0.4)
    At = torch.as_tensor(A)
    dinv = torch.as_tensor(1.0 / np.diag(A))[:, None]
    x0 = np.linalg.solve(A, B) + 0.01 * _rand(rng, n, m)
    out = tkr.bicgstab_l(lambda X: At @ X, torch.as_tensor(B), x0=torch.as_tensor(x0),
                         ell=2, tol=1e-10, maxiter=500, M=lambda X: X * dinv)
    assert np.linalg.norm(A @ out.x.numpy() - B) / np.linalg.norm(B) < 1e-9
    assert int(out.iters) <= 10


def test_bicgstab_rr_matches_jax_and_true_residual():
    rng = np.random.default_rng(7)
    n, m = 400, 5
    Ad = (np.diag(2.0 + rng.random(n)) + np.diag(-0.5 * rng.random(n - 1), 1)
          + np.diag(-0.5 * rng.random(n - 1), -1)).astype(complex)
    Ad += 1j * 0.1 * np.diag(rng.random(n))
    Bn = _rand(rng, n, m)
    kw = dict(tol=1e-12, maxiter=300, replace_every=20)
    out_j, out_t = _both(Ad, Bn, jkr.bicgstab_rr, tkr.bicgstab_rr, **kw)
    _check(Ad, Bn, out_j, out_t)
    assert float(out_t.resnorm.max()) < 1e-12
    true_rel = (np.linalg.norm(Ad @ out_t.x.numpy() - Bn, axis=0)
                / np.linalg.norm(Bn, axis=0))
    np.testing.assert_allclose(true_rel, out_t.resnorm.numpy(), rtol=1e-6, atol=1e-14)


def test_jacobi_preconditioned_shifted_solve_matches_jax():
    rng = np.random.default_rng(5)
    n = 200
    L = sp.diags([np.full(n, 2.0), -np.ones(n - 1), -np.ones(n - 1)],
                 [0, 1, -1], format="csr").astype(np.complex128)
    zc = 3.0 + 0.5j
    B = _rand(rng, n, 3)
    Aj = jsp.CSR.from_scipy(L)
    zj = jcx.as_cx(zc)
    out_j = jkr.bicgstab(jsp.shifted_matvec(Aj, None, zj), jcx.from_numpy(B), tol=1e-10,
                         maxiter=2000, M=jsp.jacobi_preconditioner(Aj, None, zj))
    At = tsp.CSR.from_scipy(L, device="cpu")
    zt = torch.tensor(zc, dtype=torch.complex128)
    out_t = tkr.bicgstab(tsp.shifted_matvec(At, None, zt), torch.as_tensor(B), tol=1e-10,
                         maxiter=2000, M=tsp.jacobi_preconditioner(At, None, zt))
    S = L.toarray() - zc * np.eye(n)
    assert np.linalg.norm(S @ out_t.x.numpy() - B) < 1e-8
    assert abs(int(out_t.iters) - int(out_j.iters)) <= 1
    assert np.abs(out_t.x.numpy() - jcx.to_numpy(out_j.x)).max() < 1e-9


def test_safe_div_and_zero_column():
    a = torch.tensor([1 + 1j, 2.0, 3.0], dtype=torch.complex128)
    b = torch.tensor([2.0, 0.0, 1j], dtype=torch.complex128)
    np.testing.assert_allclose(tkr._safe_div(a, b).numpy(), [0.5 + 0.5j, 0.0, -3j], atol=1e-15)
    A, B = _dense_system(2, 30, 3, 0.1)
    B[:, 1] = 0.0                       # a zero right-hand side scales by 1
    At = torch.as_tensor(A)
    out = tkr.bicgstab(lambda X: At @ X, torch.as_tensor(B), tol=1e-10, maxiter=200)
    assert float(out.x[:, 1].abs().max()) == 0.0
    assert np.linalg.norm(A @ out.x.numpy() - B) / np.linalg.norm(B) < 1e-9


@pytest.mark.parametrize("name,kw", [
    ("bicgstab", dict(tol=1e-10, maxiter=2000)),
    ("bicgstab_rr", dict(tol=1e-10, maxiter=2000, replace_every=25)),
    ("gmres", dict(tol=1e-10, restart=30, maxrestart=20)),
    ("bicgstab_l", dict(tol=1e-10, ell=2, maxiter=500)),
])
def test_node_axis_equals_one_solve_per_node(name, kw):
    """The explicit node axis freezes each system by its own stop test: the
    batched solve gives each node the iterates and the iteration count of a
    solve on its own (1e-9; counts within 1 where a stop test sits on the
    tolerance).  The shifts make the nodes need different depths."""
    fn = getattr(tkr, name)
    A, B = _dense_system(11, 80, 4, 0.3)
    At, Bt = torch.as_tensor(A), torch.as_tensor(B)
    z = torch.tensor([0.0, 5.0 + 2.0j, -3.0], dtype=torch.complex128)
    batched = fn(lambda X: At @ X - z[:, None, None] * X, Bt.expand(3, 80, 4), **kw)
    assert batched.iters.shape == (3,) and batched.resnorm.shape == (3, 4)
    assert len(set(batched.iters.tolist())) > 1
    for i in range(3):
        one = fn(lambda X: At @ X - z[i] * X, Bt, **kw)
        assert abs(int(batched.iters[i]) - int(one.iters)) <= 1
        scale = float(one.x.abs().max())
        assert float((batched.x[i] - one.x).abs().max()) / scale < 1e-9
        S = A - complex(z[i]) * np.eye(80)
        assert np.linalg.norm(S @ batched.x[i].numpy() - B) / np.linalg.norm(B) < 1e-9
