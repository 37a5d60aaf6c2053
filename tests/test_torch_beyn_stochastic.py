"""The port's Beyn, block-SS, moment, Krylov-node-solve and stochastic
count solvers against feast_tpu on the same seeded inputs, case for case
with tests/test_nlfeast.py (nlfeast and companion are in
test_torch_nlfeast.py): torch complex128 on the CPU against JAX x64.
Each case holds the port to the JAX package's eigenvalues (1e-10 unless a
line says why not) and iteration count, and to the reference's own
criteria."""

import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import feast_tpu as jt
import feast_tpu_torch as ft
from feast_tpu import cx as jcx

torch.set_num_threads(2)

CPU = dict(device="cpu")


def _rand_c(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _match_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert len(a) == len(b), f"{len(a)} against {len(b)} eigenvalues"
    if len(a) == 0:
        return 0.0
    D = np.abs(a[:, None] - b[None, :])
    r, c = linear_sum_assignment(D)
    return D[r, c].max()


def _same_run(tout, jout, spurious, atol=1e-10):
    """The port's filtered eigenvalues equal the JAX package's to atol,
    after as many iterations; returns the port's filtered triple."""
    lt, Xt, rt = tout.filtered(spurious=spurious)
    lj, _, _ = jout.filtered(spurious=spurious)
    assert _match_err(lt, lj) < atol
    assert tout.n_iter == int(jout.n_iter)
    assert tout.converged == bool(jout.converged)
    return lt, Xt, rt


def _companion_inside(out, c, r, lam_of):
    lam_e, res_e = lam_of(out)
    return np.sort_complex(lam_e[(np.abs(lam_e - c) <= r) & (res_e < 1e-10)])


def _tlam(out):
    return out.lam.numpy(), out.res.numpy()


def _jlam(out):
    return jcx.to_numpy(out.lam), np.asarray(out.res)


@pytest.fixture(scope="module")
def generic_quadratic():
    """A well-posed random quadratic (n = 20) and its companion solutions
    in both packages."""
    rng = np.random.default_rng(42)
    n = 20
    coeffs = [_rand_c(rng, n, n), _rand_c(rng, n, n), _rand_c(rng, n, n)]
    return coeffs, ft.companion(coeffs, **CPU), jt.companion(coeffs)


@pytest.fixture(scope="module")
def quadratic_fixture():
    """The reference's 15 x 15 rank-deficient quadratic when its data is
    mounted, else the same synthetic fallback as tests/test_nlfeast.py."""
    try:   # the reference's data directory, where the JAX package looks for it
        data = jt.problems._data_dir(None)
    except FileNotFoundError:
        data = None
    if data is not None:
        from scipy.io import mmread

        def _load(name):
            m = mmread(os.path.join(data, name))
            return np.asarray(m.todense() if hasattr(m, "todense") else m,
                              dtype=np.complex128)

        A0, A1 = _load("quadraticM0.mtx"), _load("quadraticM1.mtx")
    else:
        rng = np.random.default_rng(1234)
        A0 = _rand_c(rng, 15, 15)
        A1 = _rand_c(rng, 15, 15)
        A0[:, 0] = 0.0
    coeffs = [A0 - 0.02 * A1, 0.1 * A1, A1]
    return coeffs, ft.companion(coeffs, **CPU), jt.companion(coeffs)


def test_quadratic_moments(quadratic_fixture):
    coeffs, tcomp, _ = quadratic_fixture
    c, r = 0.0 + 0.0j, 0.25
    want = _companion_inside(tcomp, c, r, _tlam)
    X0 = _rand_c(np.random.default_rng(7), coeffs[0].shape[0], 4)
    kw = dict(nodes=16, iters=10, moments=2, c=c, r=r, tol=1e-13, spurious=1e-3)
    out = ft.nlfeast_moments(coeffs, X0, **CPU, **kw)
    lam, _, _ = _same_run(out, jt.nlfeast_moments(jt.PolynomialNEP(coeffs), X0, **kw), 1e-3)
    assert len(lam) >= len(want)
    for w in want:
        assert np.min(np.abs(lam - w)) < 1e-7


def test_quadratic_beyn(generic_quadratic):
    coeffs, tcomp, _ = generic_quadratic
    c, r = 0.0 + 0.0j, 0.6
    want = _companion_inside(tcomp, c, r, _tlam)
    X0 = _rand_c(np.random.default_rng(9), coeffs[0].shape[0], len(want) + 4)
    lam, X, rres = ft.beyn(coeffs, X0, nodes=64, c=c, r=r, **CPU).sorted_numpy()
    lj, _, rj = jt.beyn(jt.PolynomialNEP(coeffs), X0, nodes=64, c=c, r=r).sorted_numpy()
    # single-shot Beyn is quadrature-limited (no refinement), as the
    # reference's beyn: the eigenvalues are ~filter-decay accurate
    good = (np.abs(lam - c) <= r) & (rres < 1e-2)
    goodj = (np.abs(lj - c) <= r) & (rj < 1e-2)
    got = np.sort_complex(lam[good])
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, atol=2e-3)
    assert _match_err(got, lj[goodj]) < 1e-10
    np.testing.assert_allclose(np.sort(rres[good]), np.sort(rj[goodj]), rtol=1e-6, atol=1e-14)


def test_quadratic_block_ss(quadratic_fixture):
    coeffs, tcomp, _ = quadratic_fixture
    c, r = 0.0 + 0.0j, 0.25
    want = _companion_inside(tcomp, c, r, _tlam)
    X0 = _rand_c(np.random.default_rng(11), coeffs[0].shape[0], 6)
    out = ft.block_ss(coeffs, X0, nodes=32, moments=2, c=c, r=r, **CPU)
    jout = jt.block_ss(jt.PolynomialNEP(coeffs), X0, nodes=32, moments=2, c=c, r=r)
    lam, rres = _tlam(out)
    lj, rj = _jlam(jout)
    good = (np.abs(lam - c) <= r) & (rres < 1e-8)
    goodj = (np.abs(lj - c) <= r) & (rj < 1e-8)
    for w in want:
        assert np.min(np.abs(lam[good] - w)) < 1e-7
    assert _match_err(lam[good], lj[goodj]) < 1e-10


def test_exponential_dep_cross_method():
    rng = np.random.default_rng(3)
    n = 30
    A0 = _rand_c(rng, n, n) / 4
    A1 = _rand_c(rng, n, n) / 4
    # T(z) = -z I + A0 + A1 exp(-z)
    jT = jt.SPMF([
        (np.eye(n, dtype=np.complex128), lambda z: jcx.CX(-z.re, -z.im)),
        (A0, lambda z: jcx.CX(jnp.ones_like(z.re), jnp.zeros_like(z.im))),
        (A1, lambda z: jcx.CX(jnp.exp(-z.re) * jnp.cos(z.im),
                              -jnp.exp(-z.re) * jnp.sin(z.im))),
    ])
    tT = ft.problems.delay_nep(A0, A1, 1.0, **CPU)
    c, r = 0.0 + 0.0j, 0.8
    X0 = _rand_c(rng, n, 12)
    kw = dict(nodes=32, iters=25, c=c, r=r, tol=1e-10, spurious=1e-4)
    lam1, _, r1 = _same_run(ft.nlfeast(tT, X0, **CPU, **kw), jt.nlfeast(jT, X0, **kw), 1e-4)
    assert len(lam1) > 0 and r1.max() < 1e-10
    X1 = _rand_c(rng, n, 16)
    lam2, _, r2 = ft.beyn(tT, X1, nodes=64, c=c, r=r, relative_res=True, **CPU).sorted_numpy()
    lj, _, rj = jt.beyn(jT, X1, nodes=64, c=c, r=r, relative_res=True).sorted_numpy()
    good2 = (np.abs(lam2 - c) <= r) & (r2 < 1e-8)
    got2 = np.sort_complex(lam2[good2])
    assert _match_err(got2, lj[(np.abs(lj - c) <= r) & (rj < 1e-8)]) < 1e-10
    assert len(lam1) == len(got2)
    np.testing.assert_allclose(np.sort_complex(lam1), got2, atol=1e-7)


def test_contour_estimate_eig():
    n = 100
    L = ft.problems.laplacian_1d(n)
    kt = ft.circular_contour_trapezoidal(0.05 + 0j, 0.05, 8)
    kj = jt.circular_contour_trapezoidal(0.05 + 0j, 0.05, 8)
    est = ft.contour_estimate_eig(L, kt, samples=100, seed=1, **CPU)
    assert 7 <= est <= 13  # true count is 10
    assert abs(est - jt.contour_estimate_eig(L, kj, samples=100, seed=1)) < 1e-8


def test_contour_estimate_eig_generalized_and_mixed():
    n = 50
    A = np.diag(np.arange(1.0, n + 1.0)).astype(np.complex128)
    B = np.eye(n, dtype=np.complex128)
    kt = ft.circular_contour_trapezoidal(3.0 + 0j, 2.2, 8)  # eigs 1..5 inside
    kj = jt.circular_contour_trapezoidal(3.0 + 0j, 2.2, 8)
    est = ft.contour_estimate_eig(A, kt, B, samples=50, seed=3, **CPU)
    assert 3.5 <= est <= 6.5
    assert abs(est - jt.contour_estimate_eig(A, kj, B, samples=50, seed=3)) < 1e-8
    est32 = ft.contour_estimate_eig(A, kt, B, samples=50, seed=3, mixed_prec=True, **CPU)
    assert abs(est32 - est) < 0.5
    # complex64 factors and solves: the two packages round alike to ~eps32
    jest32 = jt.contour_estimate_eig(A, kj, B, samples=50, seed=3, mixed_prec=True)
    assert abs(est32 - jest32) < 1e-5


def test_nlfeast_it_butterfly():
    tT, _ = ft.problems.butterfly(**CPU)
    jT, _ = jt.problems.butterfly()
    X0 = _rand_c(np.random.default_rng(0), 64, 18)
    kw = dict(nodes=16, iters=15, c=1.0 + 1.0j, r=0.5, tol=1e-10, spurious=5e-3,
              solve_tol=1e-10)
    lam, _, res = _same_run(ft.nlfeast_it(tT, X0, **CPU, **kw), jt.nlfeast_it(jT, X0, **kw),
                            5e-3)
    assert len(lam) == 13
    assert res.max() < 1e-10


def test_beyn_extraction_variants():
    """qr / rr / rr2 extraction agree with the svd step on a clean problem,
    and each with its JAX counterpart on the same moments."""
    from feast_tpu_torch.ops import lu as tlu

    # the packages export the function `nlfeast`, which shadows the module
    jnl = importlib.import_module("feast_tpu.solvers.nlfeast")
    tnl = importlib.import_module("feast_tpu_torch.solvers.nlfeast")

    A = np.diag(np.arange(1.0, 26.0)).astype(np.complex128)
    X = _rand_c(np.random.default_rng(0), 25, 5)
    k = ft.circular_contour_trapezoidal(1.5 + 0j, 2.0, 16)
    z, w = k.device_nodes(device="cpu"), k.device_weights(device="cpu")
    S = torch.as_tensor(A)[None] - z[:, None, None] * torch.eye(25, dtype=torch.complex128)
    LU, perm = tlu.lu_factor(S)
    terms = tlu.lu_solve(LU, perm, torch.as_tensor(X)) * w[:, None, None]
    Q0 = terms.sum(0)
    Q1 = (terms * z[:, None, None]).sum(0)
    Q0j, Q1j, Xj = (jcx.from_numpy(a.numpy() if torch.is_tensor(a) else a)
                    for a in (Q0, Q1, X))
    variants = [(tnl.beyn_qr_extract, jnl.beyn_qr_extract, ()),
                (tnl.beyn_rr2_extract, jnl.beyn_rr2_extract, ()),
                (tnl.beyn_rr_extract, jnl.beyn_rr_extract, "X"),
                (tnl.beyn_svd_extract, jnl.beyn_svd_extract, ())]
    for text, jext, extra in variants:
        lam = text(Q0, Q1, *((torch.as_tensor(X),) if extra else ()))[0].numpy()
        lamj = jcx.to_numpy(jext(Q0j, Q1j, *((Xj,) if extra else ()))[0])
        inside = np.abs(lam - 1.5) <= 2.0
        # one filter application, 16 trapezoid nodes: ~1e-5 accuracy
        np.testing.assert_allclose(np.sort(lam[inside].real), [1, 2, 3], atol=1e-4)
        assert _match_err(lam[inside], lamj[np.abs(lamj - 1.5) <= 2.0]) < 1e-10


