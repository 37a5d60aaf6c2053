"""feast_tpu_torch QR and eig (and the Schur kernel's plain version)
against feast_tpu on the same seeded inputs.  The JAX Schur kernel runs
in Pallas interpret mode, as its own tests run it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from feast_tpu import cx as jcx
from feast_tpu.ops import eig as jeig
from feast_tpu.ops import pallas_eig
from feast_tpu.ops import qr as jqr
from feast_tpu_torch.ops import eig as teig
from feast_tpu_torch.ops import qr as tqr
from feast_tpu_torch.ops import schur_kernel

torch.set_num_threads(2)


def _rand(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _match_err(a, b):
    """Largest distance between two eigenvalue sets under the best pairing."""
    a, b = np.asarray(a), np.asarray(b)
    D = np.abs(a[:, None] - b[None, :])
    r, c = linear_sum_assignment(D)
    return D[r, c].max()


def test_orthonormalize_matches_jax():
    rng = np.random.default_rng(0)
    A = _rand(rng, 300, 12)
    A[:, 3] *= 1e-9                          # wide column dynamic range
    Qt = tqr.orthonormalize(torch.as_tensor(A)).numpy()
    Qj = jcx.to_numpy(jqr.orthonormalize(jcx.from_numpy(A)))
    assert np.abs(Qt.conj().T @ Qt - np.eye(12)).max() < 1e-14
    # same span: the projector onto one basis fixes the other
    assert np.abs(Qt @ (Qt.conj().T @ Qj) - Qj).max() < 1e-12
    np.testing.assert_allclose(Qt, Qj, atol=1e-12)


@pytest.mark.parametrize("method", ["cholqr2", "cholqr3"])
def test_cholqr_factors_match_jax(method):
    A = _rand(np.random.default_rng(1), 80, 6)
    Qt, Rt = getattr(tqr, method)(torch.as_tensor(A))
    Qj, Rj = getattr(jqr, method)(jcx.from_numpy(A))
    np.testing.assert_allclose(Qt.numpy(), jcx.to_numpy(Qj), atol=1e-12)
    np.testing.assert_allclose(Rt.numpy(), jcx.to_numpy(Rj), atol=1e-12)
    np.testing.assert_allclose(Qt.numpy() @ Rt.numpy(), A, atol=1e-12)


def test_cholesky_semidefinite_guard_matches_jax():
    rng = np.random.default_rng(2)
    V = _rand(rng, 20, 6)
    V[:, 4] = V[:, 1]                         # exactly dependent column
    G = V.conj().T @ V
    Lt = tqr.cholesky(torch.as_tensor(G)).numpy()
    Lj = jcx.to_numpy(jqr.cholesky(jcx.from_numpy(G)))
    assert np.isfinite(Lt).all()
    np.testing.assert_allclose(Lt, Lj, atol=1e-9)


@pytest.mark.parametrize("n,seed", [(2, 0), (12, 1)])
def test_schur_plain_matches_pallas_interpret(n, seed):
    A = _rand(np.random.default_rng(seed), n, n)
    Tj, Zj, Yj, Xj = pallas_eig.schur_pallas(jcx.from_numpy(A, jnp.float32),
                                             want_y=True, interpret=True)
    At = torch.as_tensor(A, dtype=torch.complex64)
    T, Z, Y, X = (t.numpy() for t in schur_kernel.schur(At, want_y=True))
    ref = np.diag(jcx.to_numpy(Tj))
    assert _match_err(np.diag(T), ref) / np.abs(ref).max() < 1e-4
    nrm = np.linalg.norm(A)
    assert np.linalg.norm(A @ Z - Z @ T) / nrm < 1e-5
    assert np.abs(Z.conj().T @ Z - np.eye(n)).max() < 1e-5
    assert np.abs(np.tril(T, -1)).max() == 0.0
    assert np.abs(X @ Y - np.eye(n)).max() < 1e-4
    # columns of Z Y are eigenvectors of A
    V = Z @ Y
    V = V / np.linalg.norm(V, axis=0)
    assert np.linalg.norm(A @ V - V * np.diag(T), axis=0).max() / nrm < 1e-5


def test_schur_plain_defective_cluster():
    n = 12
    rng = np.random.default_rng(5)
    J = np.diag(np.full(n, 2.0)) + np.diag(np.ones(n - 1), 1)
    S = _rand(rng, n, n)
    A = S @ J @ np.linalg.inv(S)
    T, Z = (t.numpy() for t in
            schur_kernel.schur(torch.as_tensor(A, dtype=torch.complex64)))
    assert np.abs(Z.conj().T @ Z - np.eye(n)).max() < 2e-5
    assert np.abs(Z @ T @ Z.conj().T - A).max() / np.abs(A).max() < 2e-5
    assert abs(np.diag(T).mean() - 2.0) < 1e-3


def test_eig_full_and_mixed_match_jax():
    n = 24
    A = _rand(np.random.default_rng(3), n, n)
    wj, _ = jeig.eig(jcx.from_numpy(A))              # CPU: the full f64 path
    wt, Vt = teig.eig(torch.as_tensor(A))
    assert _match_err(wt.numpy(), jcx.to_numpy(wj)) < 1e-12
    Vt = Vt.numpy()
    assert np.linalg.norm(A @ Vt - Vt * wt.numpy(), axis=0).max() < 1e-12
    wjm, _ = jeig.eig_mixed(jcx.from_numpy(A), ii_steps=3)
    wtm, Vtm = teig.eig_mixed(torch.as_tensor(A), ii_steps=3)
    assert _match_err(wtm.numpy(), jcx.to_numpy(wjm)) < 1e-12
    assert _match_err(wtm.numpy(), np.linalg.eigvals(A)) < 1e-12
    Vtm = Vtm.numpy()
    assert np.linalg.norm(A @ Vtm - Vtm * wtm.numpy(), axis=0).max() < 1e-12
    assert teig._indep_ok(torch.as_tensor(Vtm))


def test_gen_eig_matches_jax():
    n = 16
    rng = np.random.default_rng(4)
    A = _rand(rng, n, n)
    B = _rand(rng, n, n) + 4 * np.eye(n)
    wj, _ = jeig.gen_eig(jcx.from_numpy(A), jcx.from_numpy(B))
    wt, Vt = teig.gen_eig(torch.as_tensor(A), torch.as_tensor(B))
    assert _match_err(wt.numpy(), jcx.to_numpy(wj)) < 1e-12
    Vt = Vt.numpy()
    R = A @ Vt - (B @ Vt) * wt.numpy()
    assert np.linalg.norm(R, axis=0).max() < 1e-12
    wjm, _ = jeig._gen_eig_mixed(jcx.from_numpy(A), jcx.from_numpy(B))
    wtm, _ = teig._gen_eig_mixed(torch.as_tensor(A), torch.as_tensor(B))
    assert _match_err(wtm.numpy(), jcx.to_numpy(wjm)) < 1e-12


def test_tri_eigvecs_and_inverse_match_jax():
    rng = np.random.default_rng(6)
    T = np.triu(_rand(rng, 10, 10))
    T[3, 3] = T[7, 7]                         # repeated eigenvalue: smln floor
    Yt = teig.tri_eigvecs(torch.as_tensor(T))
    Yj = jeig.tri_eigvecs(jcx.from_numpy(T))
    np.testing.assert_allclose(Yt.numpy(), jcx.to_numpy(Yj), rtol=1e-12, atol=1e-12)
    assert np.isfinite(Yt.numpy()).all()
    T = np.triu(_rand(rng, 10, 10)) + 3 * np.diag(np.arange(10))
    Yt = teig.tri_eigvecs(torch.as_tensor(T))
    Xt = teig.tri_unit_inv(Yt).numpy()
    Xj = jeig.tri_unit_inv(jeig.tri_eigvecs(jcx.from_numpy(T)))
    np.testing.assert_allclose(Xt, jcx.to_numpy(Xj), rtol=1e-12, atol=1e-12)
    assert np.abs(Xt @ Yt.numpy() - np.eye(10)).max() < 1e-12


def test_backend_switches_validate():
    with pytest.raises(ValueError):
        teig.set_schur_backend("pallas")
    with pytest.raises(ValueError):
        teig.set_eig_mode("fast")
    with pytest.raises(ValueError):
        tqr.orthonormalize(torch.ones((4, 2), dtype=torch.complex128),
                           method="givens")
    Q = tqr.orthonormalize(torch.eye(4, 2, dtype=torch.complex128), method="householder")
    assert torch.allclose(Q.mH @ Q, torch.eye(2, dtype=torch.complex128), atol=1e-15)
