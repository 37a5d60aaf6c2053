"""The port's nlfeast and companion against feast_tpu on the same seeded
inputs, case for case with tests/test_nlfeast.py (the Beyn, block-SS,
moment, Krylov and stochastic cases are in test_torch_beyn_stochastic.py):
torch complex128 on the CPU against JAX x64.  Each case holds the port to
the JAX package's eigenvalues (1e-10) and iteration count, and to the
reference's own criteria."""

import numpy as np
import pytest
import scipy.linalg as sla
import torch
from scipy.optimize import linear_sum_assignment

import feast_tpu as jt
import feast_tpu_torch as ft
from feast_tpu import cx as jcx
from feast_tpu_torch import interop

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


# ---------------------------------------------------------------------------
# linear pencil through the nonlinear machinery
# ---------------------------------------------------------------------------

def test_nlfeast_linear_pencil():
    rng = np.random.default_rng(0)
    A = np.diag(np.arange(1.0, 26.0)).astype(np.complex128)
    X0 = _rand_c(rng, 25, 6)
    kw = dict(nodes=8, iters=20, c=1.5 + 0j, r=2.0, tol=1e-11)
    out = ft.nlfeast(ft.LinearPencilNEP(A, **CPU), X0, **CPU, **kw)
    lam, X, r = _same_run(out, jt.nlfeast(jt.LinearPencilNEP(A), X0, **kw), 1e-5)
    np.testing.assert_allclose(np.sort(lam.real), [1, 2, 3], atol=1e-9)
    assert r.max() < 1e-11


# ---------------------------------------------------------------------------
# quadratic polynomial NEP: nlfeast vs companion (exact dense)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def generic_quadratic():
    """A well-posed random quadratic (n = 20) and its companion solutions
    in both packages."""
    rng = np.random.default_rng(42)
    n = 20
    coeffs = [_rand_c(rng, n, n), _rand_c(rng, n, n), _rand_c(rng, n, n)]
    return coeffs, ft.companion(coeffs, **CPU), jt.companion(coeffs)


def test_companion_matches_jax(generic_quadratic):
    coeffs, tout, jout = generic_quadratic
    lt, rt = _tlam(tout)
    lj, rj = _jlam(jout)
    assert _match_err(lt, lj) < 1e-10 * np.abs(lj).max()
    assert rt.max() < 1e-12 and rj.max() < 1e-12


def test_quadratic_nlfeast_vs_companion(generic_quadratic):
    coeffs, tcomp, jcomp = generic_quadratic
    c, r = 0.0 + 0.0j, 0.6
    want = _companion_inside(tcomp, c, r, _tlam)
    assert len(want) > 0
    assert _match_err(want, _companion_inside(jcomp, c, r, _jlam)) < 1e-10
    X0 = _rand_c(np.random.default_rng(5), coeffs[0].shape[0], len(want) + 5)
    kw = dict(nodes=32, iters=30, c=c, r=r, tol=1e-11, spurious=1e-3)
    out = ft.nlfeast(ft.PolynomialNEP(coeffs, **CPU), X0, **CPU, **kw)
    lam, _, rres = _same_run(out, jt.nlfeast(jt.PolynomialNEP(coeffs), X0, **kw), 1e-3)
    assert len(lam) == len(want)
    np.testing.assert_allclose(np.sort_complex(lam), want, atol=1e-7)
    assert rres.max() < 1e-11


# ---------------------------------------------------------------------------
# callable NEP (host mode)
# ---------------------------------------------------------------------------

def test_callable_nep_host_mode():
    A = np.diag(np.arange(1.0, 26.0)).astype(np.complex128)

    def T(z):
        return A - z * np.eye(25)

    X0 = _rand_c(np.random.default_rng(0), 25, 6)
    kw = dict(nodes=8, iters=20, c=1.5 + 0j, r=2.0, tol=1e-11)
    lam, _, _ = _same_run(ft.nlfeast(T, X0, **CPU, **kw), jt.nlfeast(T, X0, **kw), 1e-5)
    np.testing.assert_allclose(np.sort(lam.real), [1, 2, 3], atol=1e-9)
    with pytest.raises(ValueError, match="mixed_prec"):
        ft.nlfeast(T, X0, mixed_prec=True, **CPU, **kw)
    with pytest.raises(ValueError, match="store=False"):
        ft.nlfeast(T, X0, store=False, **CPU, **kw)


def test_callable_nep_off_origin_contour():
    A = np.diag(np.arange(100.0, 125.0)).astype(np.complex128)

    def T(zv):
        return A - zv * np.eye(25)

    X0 = _rand_c(np.random.default_rng(0), 25, 6)
    kw = dict(nodes=8, iters=20, c=101.5 + 0j, r=2.0, tol=1e-11)
    lam, _, r = _same_run(ft.nlfeast(T, X0, **CPU, **kw), jt.nlfeast(T, X0, **kw), 1e-5)
    np.testing.assert_allclose(np.sort(lam.real), [100, 101, 102, 103], atol=1e-8)
    assert r.max() < 1e-11


def test_nlfeast_rectangular_contour(generic_quadratic):
    """Any Contour: here a Gauss rectangle (the reference hard-codes the
    trapezoid circle)."""
    coeffs, tcomp, _ = generic_quadratic
    X0 = _rand_c(np.random.default_rng(1), coeffs[0].shape[0], 14)
    kt = ft.rectangular_contour_gauss(-0.6 - 0.6j, 0.6 + 0.6j, 32)
    kj = jt.contour.rectangular_contour_gauss(-0.6 - 0.6j, 0.6 + 0.6j, 32)
    np.testing.assert_array_equal(kt.nodes, np.asarray(kj.nodes))
    kw = dict(iters=30, tol=1e-11, spurious=1e-3)
    lam, _, r = _same_run(ft.nlfeast(coeffs, X0, contour=kt, **CPU, **kw),
                          jt.nlfeast(jt.PolynomialNEP(coeffs), X0, contour=kj, **kw), 1e-3)
    le, re_ = _tlam(tcomp)
    want = np.sort_complex(le[(np.abs(le.real) < 0.6) & (np.abs(le.imag) < 0.6)
                              & (re_ < 1e-10)])
    assert len(lam) == len(want)
    np.testing.assert_allclose(np.sort_complex(lam), want, atol=1e-7)
    assert r.max() < 1e-11


def test_companion_singular_leading_coefficient():
    """A singular leading coefficient: "auto" switches to QZ and returns the
    finite eigenvalues (the infinite ones come out huge), against scipy on
    the same linearization and against the JAX package."""
    rng = np.random.default_rng(17)
    n = 8
    A0 = rng.standard_normal((n, n)).astype(np.complex128)
    A1 = rng.standard_normal((n, n)).astype(np.complex128)
    A2 = rng.standard_normal((n, n)).astype(np.complex128)
    A2[:, -2:] = 0.0  # rank n-2 leading coefficient -> 2 infinite eigenvalues
    out = ft.companion([A0, A1, A2], **CPU)
    lam = out.lam.numpy()
    NL = 2 * n
    C1 = np.zeros((NL, NL), dtype=np.complex128)
    C2 = np.zeros((NL, NL), dtype=np.complex128)
    C1[:n, :n] = A0
    for i in range(n, NL):
        C1[i, i] = 1.0
        C2[i, i - n] = 1.0
    C2[:n, :n] = -A1
    C2[:n, n:] = -A2
    ref = sla.eigvals(C1, C2)
    ref_fin = ref[np.isfinite(ref) & (np.abs(ref) < 1e6)]
    finite = np.isfinite(lam) & (np.abs(lam) < 1e6)
    got_fin = lam[finite]
    assert _match_err(got_fin, ref_fin) < 1e-7
    assert out.res.numpy()[finite].max() < 1e-7
    lj = jcx.to_numpy(jt.companion([A0, A1, A2]).lam)
    assert _match_err(got_fin, lj[np.isfinite(lj) & (np.abs(lj) < 1e6)]) < 1e-10
    with pytest.raises(ValueError, match="method"):
        ft.companion([A0, A1, A2], method="svd", **CPU)


def test_nlfeast_store_false_matches_store_true():
    """store=False with mixed precision (chunked re-factorization every
    pass, complex64 factors, complex128 refinement) reproduces the stored
    complex128 path, in both packages."""
    n = 128
    gkw = dict(planted=12, cluster=(50.0, 56.0))
    tT = ft.problems.gun_like(n, **gkw, **CPU)
    jT = jt.problems.gun_like(n, **gkw)
    rng = np.random.default_rng(3)
    X0 = rng.standard_normal((n, 30)) + 1j * rng.standard_normal((n, 30))
    kw = dict(nodes=16, iters=10, c=53.0 + 0.0j, r=5.0, tol=1e-10, spurious=1e-5)
    mixed = dict(store=False, factor_chunk=3, mixed_prec=True)
    la, _, ra = _same_run(ft.nlfeast(tT, X0, **CPU, **mixed, **kw),
                          jt.nlfeast(jT, X0, **mixed, **kw), 1e-5)
    lb, _, rb = _same_run(ft.nlfeast(tT, X0, **CPU, **kw), jt.nlfeast(jT, X0, **kw), 1e-5)
    assert len(la) == len(lb) == 12
    np.testing.assert_allclose(np.sort_complex(la), np.sort_complex(lb), atol=1e-9)
    assert max(ra.max(), rb.max()) < 1e-10


def test_entry_points_raise_without_cuda(monkeypatch):
    A = np.diag(np.arange(1.0, 7.0)).astype(np.complex128)
    X0 = _rand_c(np.random.default_rng(0), 6, 2)
    coeffs = [A, -np.eye(6)]
    k = ft.circular_contour_trapezoidal(2.0, 1.5, 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: ft.nlfeast(coeffs, X0, c=2.0, r=1.5),
                 lambda: ft.nlfeast_moments(coeffs, X0, c=2.0, r=1.5),
                 lambda: ft.beyn(coeffs, X0, c=2.0, r=1.5),
                 lambda: ft.block_ss(coeffs, X0, c=2.0, r=1.5),
                 lambda: ft.companion(coeffs),
                 lambda: ft.contour_estimate_eig(A, k)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # a NEP built on one device is not silently moved to another
    T = ft.PolynomialNEP(coeffs, **CPU)
    with pytest.raises(RuntimeError, match="CUDA"):
        ft.nlfeast(T, X0, c=2.0, r=1.5)


def test_interop_contour_drives_nlfeast():
    A = np.diag(np.arange(1.0, 7.0)).astype(np.complex128)
    X0 = _rand_c(np.random.default_rng(0), 6, 3)
    kj = jt.circular_contour_trapezoidal(2.0 + 0j, 1.5, 16)
    kt = interop.contour_from(kj)
    assert kt.kind == "circle" and len(kt) == 16
    out = ft.nlfeast(ft.LinearPencilNEP(A, **CPU), X0, contour=kt, tol=1e-11, **CPU)
    lam, _, _ = _same_run(out, jt.nlfeast(jt.LinearPencilNEP(A), X0, contour=kj, tol=1e-11),
                          1e-5)
    np.testing.assert_allclose(np.sort(lam.real), [1, 2, 3], atol=1e-10)
