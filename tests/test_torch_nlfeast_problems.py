"""The port's nonlinear solvers on the gallery problems and the
experimental moment variants against feast_tpu, case for case with
tests/test_problems.py and tests/test_experimental.py (torch complex128 on
the CPU against JAX x64, the same seeded inputs): eigenvalues to 1e-10 of
the JAX package's and the same iteration count, plus the reference's own
criteria."""

import importlib

import numpy as np
import pytest
import scipy.linalg as sla
import torch
from scipy.optimize import linear_sum_assignment

import feast_tpu as jt
import feast_tpu_torch as ft
from feast_tpu import cx as jcx

torch.set_num_threads(2)

CPU = dict(device="cpu")


def _x0(rng, n, m):
    return rng.standard_normal((n, m)) + 1j * rng.standard_normal((n, m))


def _match_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert len(a) == len(b), f"{len(a)} against {len(b)} eigenvalues"
    if len(a) == 0:
        return 0.0
    D = np.abs(a[:, None] - b[None, :])
    r, c = linear_sum_assignment(D)
    return D[r, c].max()


def _same_run(tout, jout, spurious, atol=1e-10):
    lt, Xt, rt = tout.filtered(spurious=spurious)
    lj, _, _ = jout.filtered(spurious=spurious)
    assert _match_err(lt, lj) < atol
    assert tout.n_iter == int(jout.n_iter)
    assert tout.converged == bool(jout.converged)
    return lt, Xt, rt


@pytest.fixture(scope="module")
def gun128():
    """gun_like(128) in both packages and the interior slice the JAX tests
    put their contour around."""
    tT = ft.problems.gun_like(128, **CPU)
    jT = jt.problems.gun_like(128)
    K, M = tT.mats[0].numpy(), tT.mats[1].numpy()
    w = np.sort(sla.eigvals(K, M).real)
    mid = len(w) // 2
    c = complex((w[mid] + w[mid + 3]) / 2, 0)
    r = (w[mid + 3] - w[mid]) / 2 + 0.3 * (w[mid + 4] - w[mid + 3])
    return tT, jT, c, r


def test_gun_like_sqrt_branch_cross_method(gun128):
    """sqrt-branch NEP: nlfeast and nlfeast_moments agree to 1e-7."""
    tT, jT, c, r = gun128
    rng = np.random.default_rng(1)
    X1, X2 = _x0(rng, 128, 12), _x0(rng, 128, 8)
    kw1 = dict(nodes=64, iters=30, c=c, r=r, tol=1e-11, spurious=1e-4)
    lam1, _, r1 = _same_run(ft.nlfeast(tT, X1, **CPU, **kw1), jt.nlfeast(jT, X1, **kw1), 1e-4)
    kw2 = dict(nodes=64, iters=15, moments=2, c=c, r=r, tol=1e-12, spurious=1e-4)
    lam2, _, r2 = _same_run(ft.nlfeast_moments(tT, X2, **CPU, **kw2),
                            jt.nlfeast_moments(jT, X2, **kw2), 1e-4)
    assert len(lam1) > 0
    assert r1.max() < 1e-11 and r2.max() < 1e-12
    np.testing.assert_allclose(np.sort_complex(lam1), np.sort_complex(lam2), atol=1e-7)


def test_nlfeast_mixed_precision_matches_full(gun128):
    """mixed_prec: complex64 node LU + complex128 refinement in SPMF form
    reproduces the complex128 path to the residual floor."""
    tT, jT, c, r = gun128
    X0 = _x0(np.random.default_rng(1), 128, 12)
    kw = dict(nodes=64, iters=30, c=c, r=r, tol=1e-11, spurious=1e-4)
    lam1, _, r1 = _same_run(ft.nlfeast(tT, X0, mixed_prec=True, **CPU, **kw),
                            jt.nlfeast(jT, X0, mixed_prec=True, **kw), 1e-4)
    lam2, _, r2 = ft.nlfeast(tT, X0, **CPU, **kw).filtered(spurious=1e-4)
    assert r1.max() < 1e-11 and r2.max() < 1e-11
    np.testing.assert_allclose(np.sort_complex(lam1), np.sort_complex(lam2), atol=1e-9)


def test_loaded_string_moments_k3():
    """BASELINE row: loaded_string, m0=14, 16 nodes, K=3, c=800 r=790,
    against the exact values of its quadratic linearization."""
    n, kappa, mass = 100, 1.0, 1.0
    sigma = kappa / mass
    tT = ft.problems.loaded_string(n, kappa, mass, **CPU)
    A, B, C = (m.numpy() for m in tT.mats)
    lin = sla.eigvals(np.block([[np.zeros((n, n)), np.eye(n)],
                                [sla.solve(B, -sigma * A),
                                 sla.solve(B, A + sigma * B + kappa * C)]]))
    realw = np.sort(lin[np.abs(lin.imag) < 1e-6].real)
    want = realw[(realw > 10.0) & (realw < 1590.0)]
    X0 = _x0(np.random.default_rng(0), n, 14)
    kw = dict(nodes=16, iters=10, moments=3, c=800.0 + 0j, r=790.0, tol=1e-14,
              spurious=1e-5)
    lam, _, res = _same_run(ft.nlfeast_moments(tT, X0, **CPU, **kw),
                            jt.nlfeast_moments(jt.problems.loaded_string(n, kappa, mass),
                                               X0, **kw), 1e-5, atol=1e-10 * 1590)
    assert len(lam) == len(want)
    np.testing.assert_allclose(np.sort(lam.real), want, rtol=1e-10)
    assert res.max() < 1e-13


def test_fiber_like_moments_k10():
    """K = 10 moments on the fiber-shaped problem, cross-validated against
    single-shot Beyn on a fine contour."""
    n = 256
    tT = ft.problems.fiber_like(n, **CPU)
    jT = jt.problems.fiber_like(n)
    w = np.sort(np.linalg.eigvalsh(tT.mats[0].numpy()).real)
    c = complex((w[0] + w[5]) / 2, 0)
    r = (w[5] - w[0]) * 0.75
    rng = np.random.default_rng(0)
    X0, X1 = _x0(rng, n, 14), _x0(rng, n, 24)
    kw = dict(nodes=32, iters=20, moments=10, c=c, r=r, tol=1e-11, spurious=1e-4)
    out = ft.nlfeast_moments(tT, X0, **CPU, **kw)
    lam, _, res = _same_run(out, jt.nlfeast_moments(jT, X0, **kw), 1e-4)
    assert out.converged and len(lam) == 7 and res.max() < 1e-11
    ref = ft.beyn(tT, X1, nodes=256, c=c, r=r, **CPU)
    lam_b, res_b = ref.lam.numpy(), ref.res.numpy()
    good = (np.abs(lam_b - c) <= r) & (res_b < 1e-8)
    np.testing.assert_allclose(np.sort_complex(lam), np.sort_complex(lam_b[good]), atol=1e-8)


def test_hadeler_nlfeast():
    """BASELINE row: hadeler, c=-30 r=10: 12 real eigenvalues."""
    X0 = _x0(np.random.default_rng(0), 200, 15)
    kw = dict(nodes=8, iters=30, c=-30.0 + 0j, r=10.0, tol=1e-14, spurious=1e-2)
    lam, _, res = _same_run(ft.nlfeast(ft.problems.hadeler(200, 100.0, **CPU), X0, **CPU, **kw),
                            jt.nlfeast(jt.problems.hadeler(200, 100.0), X0, **kw), 1e-2,
                            atol=1e-10 * 40)
    assert len(lam) == 12 and res.max() < 1e-14
    assert (lam.real > -40).all() and (lam.real < -20).all()
    assert np.abs(lam.imag).max() < 1e-8


def test_gen_feast_qz_pencil_option():
    """The QZ Rayleigh-Ritz pencil matches the LU-reduction one, and the
    JAX package's QZ path on the same basis; gen_feast(pencil="qz") runs."""
    rng = np.random.default_rng(0)
    A = np.diag(np.arange(1.0, 26.0)).astype(np.complex128)
    B = np.eye(25, dtype=np.complex128)
    X0 = _x0(rng, 25, 5)
    tfeast = importlib.import_module("feast_tpu_torch.solvers.feast")
    jfeast = importlib.import_module("feast_tpu.solvers.feast")
    from feast_tpu.ops import qr as jqr
    from feast_tpu_torch.ops import qr as tqr

    Q = tqr.cholqr2(torch.as_tensor(X0))[0]
    At, Bt = torch.as_tensor(A), torch.as_tensor(B)
    lam_lu = tfeast._rayleigh_ritz(Q, At, Bt, pencil="lu")[0].numpy()
    lam_qz = tfeast._rayleigh_ritz(Q, At, Bt, pencil="qz")[0].numpy()
    np.testing.assert_allclose(np.sort(lam_lu.real), np.sort(lam_qz.real), atol=1e-10)
    Qj = jqr.cholqr2(jcx.from_numpy(X0))[0]
    lam_j = jcx.to_numpy(jfeast._rayleigh_ritz(Qj, jcx.from_numpy(A), jcx.from_numpy(B),
                                               pencil="qz")[0])
    assert _match_err(lam_qz, lam_j) < 1e-10
    res = ft.gen_feast(A, B, X0, c=1.5 + 0j, r=2.0, nodes=8, pencil="qz", **CPU)
    lam, _, r = res.filtered()
    assert res.converged and r.max() < 1e-12
    np.testing.assert_allclose(np.sort(lam.real), [1.0, 2.0, 3.0], atol=1e-10)


# ---------------------------------------------------------------------------
# experimental moment variants
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def quad():
    rng = np.random.default_rng(42)
    n = 20
    coeffs = [_x0(rng, n, n), _x0(rng, n, n), _x0(rng, n, n)]
    exact = ft.companion(coeffs, **CPU)
    lam_e, res_e = exact.lam.numpy(), exact.res.numpy()
    c, r = 0.0 + 0.0j, 0.6
    want = np.sort_complex(lam_e[(np.abs(lam_e - c) <= r) & (res_e < 1e-10)])
    X0 = _x0(np.random.default_rng(1), n, len(want) + 3)
    return coeffs, X0, want, c, r


@pytest.mark.parametrize("name", ["nlfeast_moments_all", "nlfeast_moments_ss", "nlfeast_rr"])
def test_variant_finds_contour_spectrum(quad, name):
    coeffs, X0, want, c, r = quad
    kw = dict(nodes=32, iters=20, c=c, r=r, tol=1e-10, spurious=1e-3)
    out = getattr(ft, name)(ft.PolynomialNEP(coeffs, **CPU), X0, **CPU, **kw)
    lam, _, _ = _same_run(out, getattr(jt, name)(jt.PolynomialNEP(coeffs), X0, **kw), 1e-3)
    assert len(lam) >= len(want)
    for w in want:
        assert np.min(np.abs(lam - w)) < 1e-6
