"""The port's Householder QR, Jacobi SVD, QZ and the zero-padded route of
the panel LU against feast_tpu on the same seeded inputs (torch on the CPU
against JAX x64; the JAX LU in float32 pairs)."""

import jax
import numpy as np
import pytest
import scipy.linalg as sla
import torch
from scipy.optimize import linear_sum_assignment

from feast_tpu import cx as jcx
from feast_tpu.ops import eig as jeig
from feast_tpu.ops import lu as jlu
from feast_tpu.ops import qr as jqr
from feast_tpu.ops import qz as jqz
from feast_tpu.ops import svd as jsvd
from feast_tpu_torch.ops import eig as teig
from feast_tpu_torch.ops import lu as tlu
from feast_tpu_torch.ops import panel_lu
from feast_tpu_torch.ops import qr as tqr
from feast_tpu_torch.ops import qz as tqz
from feast_tpu_torch.ops import svd as tsvd

torch.set_num_threads(2)


def _rand(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.complex128)


def _graded(rng, n, m, lo):
    u, _ = np.linalg.qr(_rand(rng, n, m))
    v, _ = np.linalg.qr(_rand(rng, m, m))
    return u @ np.diag(np.logspace(0, lo, m)) @ v.conj().T


def _match_err(a, b):
    D = np.abs(np.asarray(a)[:, None] - np.asarray(b)[None, :])
    r, c = linear_sum_assignment(D)
    return D[r, c].max()


# ---------------------------------------------------------------------------
# Householder QR and SVD
# ---------------------------------------------------------------------------

def test_householder_qr():
    rng = np.random.default_rng(3)
    a = _graded(rng, 100, 10, -12)
    Q, R = (t.numpy() for t in tqr.householder_qr(_t(a)))
    assert np.abs(Q.conj().T @ Q - np.eye(10)).max() < 1e-13
    assert np.abs(Q @ R - a).max() < 1e-13
    assert np.abs(np.tril(R, -1)).max() == 0.0
    Rj = jcx.to_numpy(jqr.householder_qr(jcx.from_numpy(a))[1])
    np.testing.assert_allclose(R, Rj, atol=1e-13)
    # Q's columns of the 1e-12 directions follow rounding in both packages;
    # on a well-conditioned matrix the two factors agree entry for entry
    b = _rand(rng, 100, 10)
    Q, R = (t.numpy() for t in tqr.householder_qr(_t(b)))
    Qj, Rj = (jcx.to_numpy(t) for t in jqr.householder_qr(jcx.from_numpy(b)))
    np.testing.assert_allclose(Q, Qj, atol=1e-13)
    np.testing.assert_allclose(R, Rj, atol=1e-12)


def test_orthonormalize_householder_matches_jax():
    a = _rand(np.random.default_rng(4), 60, 8)
    a[:, 2] *= 1e-9
    Q = tqr.orthonormalize(_t(a), method="householder").numpy()
    Qj = jcx.to_numpy(jqr.orthonormalize(jcx.from_numpy(a), method="householder"))
    assert np.abs(Q.conj().T @ Q - np.eye(8)).max() < 1e-14
    np.testing.assert_allclose(Q, Qj, atol=1e-12)


@pytest.mark.parametrize("n,m", [(100, 31), (16, 16), (25, 25), (40, 12)])
def test_svd_matches_numpy(n, m):
    a = _rand(np.random.default_rng(n * m), n, m)
    U, s, Vh = (t.numpy() for t in tsvd.svd(_t(a)))
    sref = np.linalg.svd(a, compute_uv=False)
    sj = np.asarray(jax.jit(jsvd.svd)(jcx.from_numpy(a))[1])
    assert np.abs(s - sref).max() < 1e-12 * sref[0]
    assert np.abs(s - sj).max() < 1e-12 * sref[0]
    assert np.abs(U @ np.diag(s) @ Vh - a).max() < 1e-12 * sref[0]
    assert np.abs(U.conj().T @ U - np.eye(len(s))).max() < 1e-12
    assert np.abs(Vh @ Vh.conj().T - np.eye(len(s))).max() < 1e-12


def test_svd_rank_deficient():
    rng = np.random.default_rng(9)
    a = _rand(rng, 50, 4) @ _rand(rng, 4, 12)  # rank 4
    s = tsvd.svd(_t(a))[1].numpy()
    sj = np.asarray(jsvd.svd(jcx.from_numpy(a))[1])
    sref = np.linalg.svd(a, compute_uv=False)
    assert (s[4:] < 1e-12 * s[0]).all()
    assert np.abs(s[:4] - sref[:4]).max() < 1e-12 * sref[0]
    assert np.abs(s - sj).max() < 1e-12 * sref[0]


@pytest.mark.parametrize("reduce", ["direct", "householder"])
def test_svd_relative_accuracy_by_reduction(reduce):
    a = _graded(np.random.default_rng(11), 80, 10, -8)
    U, s, Vh = (t.numpy() for t in tsvd.svd(_t(a), reduce=reduce))
    sj = np.asarray(jsvd.svd(jcx.from_numpy(a), reduce=reduce)[1])
    sref = np.linalg.svd(a, compute_uv=False)
    rel = np.abs(s - sref) / sref
    assert rel.max() < (1e-7 if reduce == "direct" else 1e-4)
    assert (np.abs(s - sj) / sj).max() < 1e-12 or np.abs(s - sj).max() < 1e-12 * sj[0]
    assert np.abs(U @ np.diag(s) @ Vh - a).max() < 1e-13


def test_svd_extreme_scale_columns():
    rng = np.random.default_rng(31)
    n, m = 60, 12
    U0, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (U0[:, :m] * np.logspace(0, -16, m)[None, :]) @ np.linalg.qr(
        rng.standard_normal((m, m)))[0]
    A = A.astype(np.complex128)
    U, s, Vh = (t.numpy() for t in tsvd.svd(_t(A)))
    sj = np.asarray(jsvd.svd(jcx.from_numpy(A))[1])
    assert np.isfinite(U).all() and np.isfinite(s).all() and np.isfinite(Vh).all()
    ref = np.linalg.svd(A, compute_uv=False)
    np.testing.assert_allclose(s[:6], ref[:6], rtol=5e-10)
    # both hold the 1e-7 value to eps s_max absolute, so to 1e-9 relative
    np.testing.assert_allclose(s[:6], sj[:6], rtol=5e-10)
    assert np.abs(U * s[None, :] @ Vh - A).max() < 1e-13


def test_jacobi_schedule_pairs_every_column_once_per_round():
    sched = tsvd._round_robin_pairs(10)
    assert sched.shape == (9, 2, 5)
    seen = set()
    for p, q in sched:
        assert sorted(np.concatenate([p, q]).tolist()) == list(range(10))
        seen |= {tuple(sorted(x)) for x in zip(p.tolist(), q.tolist())}
    assert len(seen) == 45
    np.testing.assert_array_equal(sched, jsvd._round_robin_pairs(10))


# ---------------------------------------------------------------------------
# QZ
# ---------------------------------------------------------------------------

def test_hessenberg_triangular_reduction():
    rng = np.random.default_rng(0)
    n = 12
    a, b = _rand(rng, n, n), _rand(rng, n, n)
    H, T, Q, Z = (t.numpy() for t in tqz.hessenberg_triangular(_t(a), _t(b)))
    Hj, Tj = (jcx.to_numpy(t) for t in jqz.hessenberg_triangular(
        jcx.from_numpy(a), jcx.from_numpy(b))[:2])
    assert np.abs(np.tril(H, -2)).max() < 1e-13
    assert np.abs(np.tril(T, -1)).max() < 1e-13
    assert np.abs(Q.conj().T @ Q - np.eye(n)).max() < 1e-13
    assert np.abs(Q @ H @ Z.conj().T - a).max() < 1e-12
    assert np.abs(Q @ T @ Z.conj().T - b).max() < 1e-12
    np.testing.assert_allclose(H, Hj, atol=1e-11)
    np.testing.assert_allclose(T, Tj, atol=1e-11)


def _jax_lam(a, b, **kw):
    al, be, _ = jax.jit(jqz.gen_eig_qz)(jcx.from_numpy(a), jcx.from_numpy(b), **kw)
    return jcx.to_numpy(al), jcx.to_numpy(be)


@pytest.mark.parametrize("n,seed", [(6, 0), (12, 1), (24, 2), (40, 3)])
def test_qz_eigenvalues_and_vectors(n, seed):
    rng = np.random.default_rng(seed)
    a, b = _rand(rng, n, n), _rand(rng, n, n)
    al, be, V = (t.numpy() for t in tqz.gen_eig_qz(_t(a), _t(b)))
    lam = al / be
    scale = np.linalg.norm(a) + np.linalg.norm(b)
    assert _match_err(lam, sla.eigvals(a, b)) < 1e-11 * scale
    aj, bj = _jax_lam(a, b)
    assert _match_err(lam, aj / bj) < 1e-10 * max(np.abs(lam).max(), 1.0)
    res = np.linalg.norm(a @ V - b @ V @ np.diag(lam), axis=0)
    assert res.max() < 1e-11 * scale


def test_qz_schur_form():
    rng = np.random.default_rng(5)
    n = 16
    a, b = _rand(rng, n, n), _rand(rng, n, n)
    S, T, Q, Z = (t.numpy() for t in tqz.qz(_t(a), _t(b)))
    assert np.abs(np.tril(S, -1)).max() == 0.0 and np.abs(np.tril(T, -1)).max() == 0.0
    np.testing.assert_allclose(Q @ S @ Z.conj().T, a, atol=1e-11 * np.linalg.norm(a))
    np.testing.assert_allclose(Q @ T @ Z.conj().T, b, atol=1e-11 * np.linalg.norm(b))
    Sj, Tj = (jcx.to_numpy(t) for t in jqz.qz(jcx.from_numpy(a), jcx.from_numpy(b))[:2])
    lam, lamj = np.diag(S) / np.diag(T), np.diag(Sj) / np.diag(Tj)
    assert _match_err(lam, lamj) < 1e-10 * np.abs(lamj).max()


def test_qz_singular_B_infinite_eigenvalue():
    rng = np.random.default_rng(7)
    n = 8
    a, b = _rand(rng, n, n), _rand(rng, n, n)
    b[0, :] = 0.0
    al, be, _ = (t.numpy() for t in tqz.gen_eig_qz(_t(a), _t(b)))
    finite = np.abs(be) > 1e-8 * np.abs(al)
    assert finite.sum() == n - 1
    ref = sla.eigvals(a, b)
    ref_f = np.sort_complex(ref[np.abs(ref) < 1e8])
    got = np.sort_complex((al / be)[finite])
    np.testing.assert_allclose(got, ref_f, atol=1e-10 * np.linalg.norm(a))
    aj, bj = _jax_lam(a, b)
    fj = np.abs(bj) > 1e-8 * np.abs(aj)
    assert _match_err(got, aj[fj] / bj[fj]) < 1e-10 * np.abs(got).max()


def test_qz_matches_gen_eig_on_nice_pencil():
    rng = np.random.default_rng(9)
    n = 10
    a = _rand(rng, n, n)
    b = _rand(rng, n, n) + 4.0 * np.eye(n)
    al, be, _ = (t.numpy() for t in tqz.gen_eig_qz(_t(a), _t(b)))
    w, _ = teig.gen_eig(_t(a), _t(b))
    assert _match_err(al / be, w.numpy()) < 1e-11
    wj, _ = jeig.gen_eig(jcx.from_numpy(a), jcx.from_numpy(b))
    assert _match_err(al / be, jcx.to_numpy(wj)) < 1e-10


def test_qz_pencil_rq_refinement_clustered():
    rng = np.random.default_rng(3)
    n, sep = 24, 1e-6
    lam = np.concatenate([2.0 + sep * np.arange(5) * (1 + 1j),
                          -1.0 + rng.standard_normal(n - 5) + 1j * rng.standard_normal(n - 5)])
    X = _rand(rng, n, n) / np.sqrt(n) + 2.5 * np.eye(n)
    B = np.eye(n) + 0.25 * _rand(rng, n, n) / np.sqrt(n)
    A = B @ X @ np.diag(lam) @ np.linalg.inv(X)

    def max_err(wd):
        err, pool = 0.0, list(lam)
        for v in wd:
            i = int(np.argmin(np.abs(np.array(pool) - v)))
            err = max(err, abs(pool[i] - v) / max(abs(pool[i]), 1.0))
            pool.pop(i)
        return err

    a0, b0, _ = tqz.gen_eig_qz(_t(A), _t(B), refine_rq=False)
    a1, b1, _ = tqz.gen_eig_qz(_t(A), _t(B))
    e_raw, e_rq = max_err((a0 / b0).numpy()), max_err((a1 / b1).numpy())
    assert e_rq < 5e-13
    assert e_rq <= max(e_raw * 2, 5e-13)
    aj, bj = _jax_lam(A, B)
    assert _match_err((a1 / b1).numpy(), aj / bj) < 1e-10


def test_qz_rq_keeps_infinite_eigenvalues():
    rng = np.random.default_rng(11)
    n = 8
    A, B = _rand(rng, n, n), _rand(rng, n, n)
    B[:, -2:] = 0.0  # rank n-2: two infinite eigenvalues
    alpha, beta, _ = (t.numpy() for t in tqz.gen_eig_qz(_t(A), _t(B)))
    scale = np.sqrt(np.abs(alpha) ** 2 + np.abs(beta) ** 2)
    assert int((np.abs(beta) / scale < 1e-8).sum()) == 2
    fin = np.abs(beta) / scale >= 1e-8
    got = np.sort_complex(alpha[fin] / beta[fin])
    ref = sla.eigvals(A, B)
    np.testing.assert_allclose(got, np.sort_complex(ref[np.isfinite(ref)]),
                               rtol=1e-8, atol=1e-8)
    aj, bj = _jax_lam(A, B)
    sj = np.sqrt(np.abs(aj) ** 2 + np.abs(bj) ** 2)
    fj = np.abs(bj) / sj >= 1e-8
    assert _match_err(got, aj[fj] / bj[fj]) < 1e-10 * np.abs(got).max()


def test_qz_one_by_one():
    S, T, Q, Z = tqz.qz(_t([[2.0 + 1j]]), _t([[0.5]]))
    assert complex(S[0, 0] / T[0, 0]) == pytest.approx(4.0 + 2j)
    assert Q.item() == 1 and Z.item() == 1


# ---------------------------------------------------------------------------
# the zero-padded route of the panel LU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [200, 300])
def test_padded_panel_route_matches_jax(n):
    """The card's route for an n that is no multiple of 128, run here with
    the kernel's plain version: zero-pad, factor, crop.  Same perm as the
    JAX package's float32 factor of the unpadded matrix, LU to 1e-5."""
    rng = np.random.default_rng(n)
    A = _rand(rng, 2, n, n)
    n_pad = -(-n // 128) * 128
    buf = torch.zeros((2, n_pad, n_pad), dtype=torch.complex64)
    buf[:, :n, :n] = torch.as_tensor(A, dtype=torch.complex64)
    LUp, permp = panel_lu.lu_factor_panel(buf, panel=panel_lu.panel_factor_plain,
                                          inplace=True)
    LU, perm = LUp[:, :n, :n].numpy(), permp[:, :n].numpy()
    assert LUp.data_ptr() == buf.data_ptr()
    # the pad rows never pivot into A's part and the pad block stays apart
    assert (perm < n).all() and (permp[:, n:].numpy() >= n).all()
    assert not LUp[:, :n, n:].any() and not LUp[:, n:, :n].any()
    LUj, permj = jlu.lu_factor_batched(jcx.from_numpy(A, np.float32))
    np.testing.assert_array_equal(perm, np.asarray(permj))
    LUj = jcx.to_numpy(LUj)
    # Both are float32 factors whose trailing updates sum in other orders,
    # each about n eps32 / 4 from the complex128 factor with the same pivots
    # (7.6e-6 for the JAX one at n = 300, and 1.02e-5 between the JAX factor
    # and the port's own plain blocked one there).  So: 1e-5 relative in
    # norm where rounding allows it, else twice the JAX factor's own error;
    # and as close to the complex128 factor as the JAX factor, within 25%.
    LU64, perm64 = tlu.lu_factor(torch.as_tensor(A))
    np.testing.assert_array_equal(perm64.numpy(), perm)
    nrm = np.linalg.norm(LUj)
    err_jax = np.linalg.norm(LUj - LU64.numpy()) / nrm
    assert np.linalg.norm(LU - LUj) / nrm <= max(1e-5, 2 * err_jax)
    assert np.linalg.norm(LU - LU64.numpy()) / nrm <= 1.25 * err_jax
    if n == 200:
        assert np.linalg.norm(LU - LUj) <= 1e-5 * nrm
    # and a factor of A itself
    for i in range(2):
        L = np.tril(LU[i], -1) + np.eye(n)
        err = np.abs(A[i][perm[i]] - L @ np.triu(LU[i])).max()
        assert err < 1e-4 * np.abs(A[i]).max()


def test_factor_buffer_shapes_and_plain_route():
    """CPU tensors (and complex128) are not padded; lu_factor_inplace then
    takes the plain blocked path."""
    buf = tlu.factor_buffer((3,), 200, torch.complex64, "cpu")
    assert buf.shape == (3, 200, 200) and not buf.any()
    A = _rand(np.random.default_rng(1), 3, 200, 200)
    buf[:] = torch.as_tensor(A, dtype=torch.complex64)
    LU, perm = tlu.lu_factor_inplace(buf, 200)
    LU2, perm2 = tlu.lu_factor(torch.as_tensor(A, dtype=torch.complex64))
    assert torch.equal(perm, perm2) and torch.equal(LU, LU2)
