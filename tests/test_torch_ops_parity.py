"""Public building blocks of the port that the drivers use but no other
test holds against the JAX package: the CholeskyQR pass and the small
triangular solves of `ops.qr`, the pencil vectors of `ops.qz`, `ops.svd`'s
singular values and `contour`'s region tests.  Seeded complex128 inputs
(m <= 16, n <= 64), JAX in x64; 1e-12 relative unless a case says why.
Every returned tensor goes through `np.asarray`, which refuses a tensor
with the conjugate or negative bit (`_host`)."""

import numpy as np
import pytest
import torch

from feast_tpu import contour as jct
from feast_tpu import cx as jcx
from feast_tpu.ops import qr as jqr
from feast_tpu.ops import qz as jqz
from feast_tpu.ops import svd as jsvd
from feast_tpu_torch import contour as tct
from feast_tpu_torch.ops import qr as tqr
from feast_tpu_torch.ops import qz as tqz
from feast_tpu_torch.ops import svd as tsvd

torch.set_num_threads(2)


def _rand(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _host(t):
    """t as numpy; a lazy conjugate or negation is a fault of the port."""
    assert not (t.is_conj() or t.is_neg())
    return np.asarray(t)


def _j(x):
    return jcx.from_numpy(x)


def _jn(x):
    return jcx.to_numpy(x)


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("shift", [True, False])
def test_cholqr_matches_jax(shift):
    a = _rand(np.random.default_rng(0), 40, 12)
    Qt, Rt = tqr.cholqr(torch.as_tensor(a), shift=shift)
    Qj, Rj = jqr.cholqr(_j(a), shift=shift)
    assert _rel(_host(Qt), _jn(Qj)) < 1e-12
    assert _rel(_host(Rt), _jn(Rj)) < 1e-12
    assert _rel(_host(Qt) @ _host(Rt), a) < 1e-13
    np.testing.assert_array_equal(np.tril(_host(Rt), -1), 0)


def test_colscale_unit_over_a_1e200_column_range_matches_jax():
    """Columns scaled 1 .. 1e-200: squaring the smallest underflows without
    the max-abs pre-scale."""
    a = _rand(np.random.default_rng(1), 40, 12) * np.logspace(0, -200, 12)[None, :]
    got = _host(tqr.colscale_unit(torch.as_tensor(a)))
    assert _rel(got, _jn(jqr.colscale_unit(_j(a)))) < 1e-12
    np.testing.assert_allclose(np.linalg.norm(got, axis=0), 1.0, rtol=1e-14)


@pytest.mark.parametrize("unit", [False, True])
def test_solve_lower_matches_jax(unit):
    """A well-conditioned lower factor (the diagonal dominant); unit=True
    ignores the diagonal."""
    rng = np.random.default_rng(2)
    L = np.tril(_rand(rng, 12, 12)) + 6 * np.eye(12)
    B = _rand(rng, 12, 5)
    got = _host(tqr.solve_lower(torch.as_tensor(L), torch.as_tensor(B), unit=unit))
    assert _rel(got, _jn(jqr.solve_lower(_j(L), _j(B), unit=unit))) < 1e-12
    Lu = np.tril(L, -1) + np.eye(12) if unit else L
    assert _rel(Lu @ got, B) < 1e-12


def test_solve_upper_and_right_solve_upper_match_jax():
    rng = np.random.default_rng(3)
    U = np.triu(_rand(rng, 12, 12)) + 6 * np.eye(12)
    B, A = _rand(rng, 12, 5), _rand(rng, 40, 12)
    got = _host(tqr.solve_upper(torch.as_tensor(U), torch.as_tensor(B)))
    assert _rel(got, _jn(jqr.solve_upper(_j(U), _j(B)))) < 1e-12
    assert _rel(U @ got, B) < 1e-12
    got = _host(tqr.right_solve_upper(torch.as_tensor(A), torch.as_tensor(U)))
    assert _rel(got, _jn(jqr.right_solve_upper(_j(A), _j(U)))) < 1e-12
    assert _rel(got @ U, A) < 1e-12


def _pencil(seed, n=12):
    """Upper triangular (S, T) with distinct generalized eigenvalues."""
    rng = np.random.default_rng(seed)
    S = np.triu(_rand(rng, n, n))
    T = np.triu(_rand(rng, n, n)) + 3 * np.eye(n)
    return S, T


@pytest.mark.parametrize("fn", ["pencil_eigvecs", "pencil_left_nullvecs"])
def test_pencil_vectors_match_jax(fn):
    S, T = _pencil(4)
    got = _host(getattr(tqz, fn)(torch.as_tensor(S), torch.as_tensor(T)))
    assert _rel(got, _jn(getattr(jqz, fn)(_j(S), _j(T)))) < 1e-12
    alpha, beta = np.diag(S), np.diag(T)
    for i in range(S.shape[0]):
        M = beta[i] * S - alpha[i] * T
        # right: M y = 0; left (conjugated): conj(h)^H M = 0, i.e. h^T M = 0
        r = M @ got[:, i] if fn == "pencil_eigvecs" else got[:, i] @ M
        assert np.abs(r).max() < 1e-12 * np.abs(M).max() * np.abs(got[:, i]).max()


def test_svd_vals_matches_jax():
    """Singular values over six decades: relative to s_max, as the one-sided
    Jacobi of both packages is accurate (ops/svd.py)."""
    rng = np.random.default_rng(5)
    a = _rand(rng, 40, 10) @ np.diag(np.logspace(0, -6, 10))
    got = _host(tsvd.svd_vals(torch.as_tensor(a)))
    want = np.asarray(jsvd.svd_vals(_j(a)))
    assert np.abs(got - want).max() < 1e-12 * want.max()
    np.testing.assert_allclose(got, np.linalg.svd(a, compute_uv=False), rtol=1e-9)


_REGIONS = {
    "circle": (lambda m: m.circular_contour_trapezoidal(0.5 + 0.25j, 1.5, 8)),
    "rect": (lambda m: m.rectangular_contour_gauss(-1.0 - 0.5j, 1.5 + 1.0j)),
    "ellipse": (lambda m: m.elliptical_contour_trapezoidal(0.25 - 0.25j, 1.5, 0.75, 8)),
}


def _points(seed=6):
    """Random points over the regions and the points exactly on the circle's
    and the ellipse's axes' ends (the boundary counts as inside)."""
    rng = np.random.default_rng(seed)
    lam = 3 * (rng.random(64) - 0.5) + 3j * (rng.random(64) - 0.5)
    return np.concatenate([lam, [2.0 + 0.25j, 0.5 + 1.75j, 1.75 - 0.25j]])


@pytest.mark.parametrize("kind", sorted(_REGIONS))
def test_in_region_matches_jax_in_contour(kind):
    lam = _points()
    k_t, k_j = _REGIONS[kind](tct), _REGIONS[kind](jct)
    assert k_t.kind == k_j.kind == kind
    want = np.asarray(jct.in_contour(lam, k_j))
    assert 0 < want.sum() < len(lam)
    np.testing.assert_array_equal(tct.in_region(lam, k_t.kind, k_t.params), want)
    np.testing.assert_array_equal(
        _host(tct.in_region(torch.as_tensor(lam), k_t.kind, k_t.params)), want)
    with pytest.raises(ValueError, match="no region test"):
        tct.in_region(lam, "custom", ())


def test_in_contour_circle_matches_jax():
    lam = _points()
    want = np.asarray(jct.in_contour_circle(lam, 0.5 + 0.25j, 1.5))
    assert 0 < want.sum() < len(lam)
    np.testing.assert_array_equal(tct.in_contour_circle(lam, 0.5 + 0.25j, 1.5), want)
    np.testing.assert_array_equal(
        _host(tct.in_contour_circle(torch.as_tensor(lam), 0.5 + 0.25j, 1.5)), want)
