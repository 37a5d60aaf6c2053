"""The port's dense leftovers against feast_tpu on the CPU (torch complex128
against JAX x64): Hermitian eigh and the Hermitian FEAST paths, host
Rayleigh-Ritz, the node-loop pipeline, the two-sided driver, and the plain
Schur at entry scales far from 1.

Tolerances: eigh eigenvalues to 1e-12 and cluster projectors to 1e-10
(inside a degenerate cluster the two packages' vectors may differ by a
unitary, so vectors are never compared column by column); FEAST
eigenvalues to 1e-10 against the JAX result with the same iteration
count."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import feast_tpu as jt
import feast_tpu_torch as ft
from feast_tpu import cx as jcx
from feast_tpu.ops import eig as jeig
from feast_tpu.ops import eigh as jeigh
from feast_tpu_torch.ops import eig as teig
from feast_tpu_torch.ops import eigh as teigh

tfeast = importlib.import_module("feast_tpu_torch.solvers.feast")

torch.set_num_threads(2)


def _x0(rng, n, m):
    return rng.standard_normal((n, m)) + 1j * rng.standard_normal((n, m))


@pytest.fixture
def diag25():
    A = np.diag(np.arange(1.0, 26.0)).astype(np.complex128)
    return A, _x0(np.random.default_rng(0), 25, 5)


def _unitary(n, seed):
    q, _ = np.linalg.qr(_x0(np.random.default_rng(seed), n, n))
    return q


def _hermitian(kind):
    """The matrices of tests/test_eig.py::test_eigh_embedding*."""
    if kind in ("random8", "random32"):
        n = int(kind[6:])
        a = _x0(np.random.default_rng(n), n, n)
        return (a + a.conj().T) / 2
    if kind == "double":      # clusters of 3 and 4
        lam = np.array([1.0] * 3 + [2.0] * 4 + list(np.arange(3.0, 8.0)))
    else:                     # a 4-fold cluster
        lam = np.concatenate([np.full(4, 2.5), [1.0, 3.0], np.linspace(4, 9, 6)])
    q = _unitary(12, 5 if kind == "double" else 21)
    H = (q * lam[None, :]) @ q.conj().T
    return (H + H.conj().T) / 2


def _cluster_projectors(w, V, tol=1e-8):
    """V_c V_c^H for each cluster of equal eigenvalues (sorted w)."""
    out, start = [], 0
    for i in range(1, len(w) + 1):
        if i == len(w) or w[i] - w[i - 1] > tol * (1 + abs(w[i])):
            Vc = V[:, start:i]
            out.append(Vc @ Vc.conj().T)
            start = i
    return out


@pytest.mark.parametrize("kind", ["random8", "random32", "double", "quadruple"])
def test_eigh_matches_jax(kind):
    H = _hermitian(kind)
    n = H.shape[0]
    w, V = teigh.eigh_cx(torch.as_tensor(H))
    w, V = w.numpy(), V.numpy()
    wj, Vj = jeigh.eigh_cx(jcx.from_numpy(H))
    wj, Vj = np.asarray(wj), jcx.to_numpy(Vj)
    oj = np.argsort(wj)
    wj, Vj = wj[oj], Vj[:, oj]
    np.testing.assert_allclose(w, wj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(w, np.linalg.eigvalsh(H), rtol=0, atol=1e-12)
    assert np.linalg.norm(H @ V - V * w[None, :], axis=0).max() < 1e-12 * n
    assert np.abs(V.conj().T @ V - np.eye(n)).max() < 1e-12 * n
    for P, Pj in zip(_cluster_projectors(w, V), _cluster_projectors(wj, Vj)):
        np.testing.assert_allclose(P, Pj, rtol=0, atol=1e-10)
    # gram_eigh: the eigenvalues of A^H A
    g, _ = teigh.gram_eigh(torch.as_tensor(H))
    gj, _ = jeigh.gram_eigh(jcx.from_numpy(H))
    np.testing.assert_allclose(g.numpy(), np.sort(np.asarray(gj)), rtol=0, atol=1e-12)


def _filtered_sorted(res):
    lam, X, r = res.filtered()
    return np.sort(lam.real), r


def _same(rt, rj, atol=1e-10):
    lt, rest = _filtered_sorted(rt)
    lj, _ = _filtered_sorted(rj)
    np.testing.assert_allclose(lt, lj, rtol=0, atol=atol)
    assert rt.n_iter == int(rj.n_iter) and rt.converged == bool(rj.converged)
    return lt, rest


def test_feast_hermitian_matches_jax():
    """tests/test_eig.py::test_feast_hermitian_fast_path: the lowest ten
    Laplacian eigenvalues, standard and as a B = I pencil."""
    L = jt.problems.laplacian_1d(100)
    X0 = _x0(np.random.default_rng(1), 100, 15)
    kw = dict(c=0.05 + 0j, r=0.05, nodes=8, iters=30, tol=1e-14)
    rt = ft.feast(L, X0, hermitian=True, device="cpu", **kw)
    lam, r = _same(rt, jt.feast(L, X0, hermitian=True, **kw))
    assert len(lam) == 10 and r.max() < 1e-14
    assert np.abs(rt.lam.numpy().imag).max() == 0.0
    I = np.eye(100, dtype=np.complex128)
    rg = ft.gen_feast(L, I, X0, pencil="hermitian", device="cpu", **kw)
    _same(rg, jt.gen_feast(L, I, X0, pencil="hermitian", **kw), atol=1e-12)
    np.testing.assert_allclose(_filtered_sorted(rg)[0], lam, rtol=0, atol=1e-12)


def test_feast_compiled_hermitian_pencil_matches_jax():
    """tests/test_feast.py::test_feast_compiled_hermitian_pencil, also with
    a Hermitian positive definite B (the Cholesky reduction)."""
    rng = np.random.default_rng(3)
    n = 40
    A = rng.standard_normal((n, n))
    A = ((A + A.T) / 2 + np.diag(np.arange(n, dtype=float))).astype(np.complex128)
    X0 = _x0(rng, n, 8)
    ref = np.linalg.eigvalsh(A)
    c = complex(ref[2] + ref[3]) / 2
    r = float(ref[3] - ref[2]) * 1.2
    kw = dict(c=c, r=r, nodes=8, tol=1e-10)
    rt = ft.feast_compiled(A, X0, hermitian=True, device="cpu", **kw)
    lam, res = _same(rt, jt.feast_compiled(A, X0, hermitian=True, **kw))
    np.testing.assert_allclose(lam, ref[np.abs(ref - c) <= r], rtol=0, atol=1e-8)
    assert res.max() < 1e-10
    B = (np.eye(n) + 0.1 * np.diag(np.ones(n - 1), 1)
         + 0.1 * np.diag(np.ones(n - 1), -1)).astype(np.complex128)
    rb = ft.feast_compiled(A, X0, B=B, pencil="hermitian", mixed_prec=True,
                           device="cpu", **kw)
    _same(rb, jt.feast_compiled(A, X0, B=B, pencil="hermitian", mixed_prec=True, **kw))
    lb, Xb, _ = rb.filtered()
    assert np.linalg.norm(A @ Xb - (B @ Xb) * lb[None, :], axis=0).max() < 1e-10


@pytest.mark.parametrize("hermitian", [False, True])
def test_host_rr_matches_jax(diag25, hermitian):
    """tests/test_feast.py::test_host_rr_honors_hermitian_pencil, and the
    general pencil: eigenvalues come out real with eigh."""
    A, X0 = diag25
    kw = dict(c=1.5 + 0j, r=2.0, nodes=8, tol=1e-10, rr="host", hermitian=hermitian)
    rt = ft.feast(A, X0, device="cpu", **kw)
    lam, res = _same(rt, jt.feast(A, X0, **kw))
    np.testing.assert_allclose(lam, [1.0, 2.0, 3.0], atol=1e-9)
    assert res.max() < 1e-10
    if hermitian:
        assert np.abs(rt.lam.numpy().imag).max() == 0.0
    # the host RR and the device RR give the same eigenvalues
    rd = ft.feast(A, X0, device="cpu", **{**kw, "rr": "device"})
    np.testing.assert_allclose(_filtered_sorted(rd)[0], lam, rtol=0, atol=1e-12)


@pytest.mark.parametrize("store,mixed_prec,rr", [(True, True, "host"),
                                                 (True, False, "device"),
                                                 (False, True, "device")])
def test_node_loop_matches_jax(diag25, store, mixed_prec, rr):
    """tests/test_feast.py::test_node_loop_matches_scan: the per-node
    pipeline against the JAX node loop and the port's stacked path."""
    A, X0 = diag25
    kw = dict(c=1.5 + 0j, r=2.0, nodes=8, iters=15, store=store,
              mixed_prec=mixed_prec, rr=rr)
    rt = ft.feast(A, X0, node_loop=True, device="cpu", **kw)
    lam, res = _same(rt, jt.feast(A, X0, node_loop=True, **kw))
    assert res.max() < 1e-9
    stacked = ft.feast(A, X0, device="cpu", **kw)
    np.testing.assert_allclose(_filtered_sorted(stacked)[0], lam, rtol=0, atol=1e-12)
    assert stacked.n_iter == rt.n_iter


def test_node_loop_generalized_matches_jax():
    """tests/test_feast.py::test_node_loop_generalized."""
    rng = np.random.default_rng(3)
    n, m0 = 60, 10
    A = np.diag(np.arange(1.0, n + 1.0)).astype(np.complex128)
    A += 0.02 * _x0(rng, n, n)
    B = (np.eye(n) + 0.1 * np.diag(np.ones(n - 1), 1)
         + 0.1 * np.diag(np.ones(n - 1), -1)).astype(np.complex128)
    X0 = _x0(rng, n, m0)
    kw = dict(c=4.0 + 0j, r=2.5, nodes=8, node_loop=True, mixed_prec=True,
              tol=1e-10, iters=15)
    rt = ft.gen_feast(A, B, X0, device="cpu", **kw)
    assert rt.converged
    lam, _ = _same(rt, jt.gen_feast(A, B, X0, **kw))
    lt, Xt, _ = rt.filtered()
    assert np.linalg.norm(A @ Xt - (B @ Xt) * lt[None, :], axis=0).max() < 1e-10
    rs = ft.gen_feast(A, B, X0, device="cpu", **{**kw, "node_loop": False})
    np.testing.assert_allclose(_filtered_sorted(rs)[0], lam, rtol=0, atol=1e-12)


def test_node_loop_default_stays_stacked(diag25, monkeypatch):
    """A difference kept on purpose: node_loop=None is the stacked path at
    every size (the JAX package switches to the node loop above a 6 GB
    stacked store, a threshold for a 16 GB TPU)."""
    A, X0 = diag25
    calls = []
    monkeypatch.setattr(tfeast, "_factor_hostloop",
                        lambda *a, **k: calls.append("loop"))
    scan = tfeast._factor_scan
    monkeypatch.setattr(tfeast, "_factor_scan",
                        lambda *a, **k: calls.append("scan") or scan(*a, **k))
    res = ft.feast(A, X0, c=1.5, r=2.0, nodes=8, device="cpu")
    assert res.converged and calls == ["scan"]
    assert not hasattr(tfeast, "_node_loop_auto")


def _grcar_on_diag25_contour():
    """The grcar matrix of the reference's two-sided test (a non-normal
    banded Toeplitz matrix) at n = 25, scaled and shifted so that three of
    its eigenvalues fall inside diag25's contour (c = 1.5, r = 2), with a
    non-identity B.  Sharing diag25's shapes and contour lets the JAX side
    reuse one compiled program."""
    n = 25
    G = (np.diag(np.full(n, 1.0)) + np.diag(np.ones(n - 1), 1)
         + np.diag(np.ones(n - 2), 2) + np.diag(np.ones(n - 3), 3)
         - np.diag(np.ones(n - 1), -1))
    w0 = 1.5758459848               # a real eigenvalue of G
    A = (1.5 * np.eye(n) + 4.0 * (G - w0 * np.eye(n))).astype(np.complex128)
    B = (np.eye(n) + 0.05 * np.diag(np.ones(n - 1), 1)).astype(np.complex128)
    return A, B


def _left_residuals(A, B, lam, Xl):
    return np.linalg.norm(Xl.conj().T @ A - lam[:, None] * (Xl.conj().T @ B), axis=1)


DUAL_KW = dict(c=1.5 + 0j, r=2.0, nodes=8, tol=1e-10)


@pytest.fixture(scope="module")
def jax_dual25():
    """The JAX package's two-sided solve of diag25 (B = I), once: each
    option of the JAX driver is a separate compile of about 25 s on the
    CPU, and its option matrix converges to the same result."""
    A = np.diag(np.arange(1.0, 26.0)).astype(np.complex128)
    X0 = _x0(np.random.default_rng(0), 25, 5)
    return jt.dual_gen_feast(A, np.eye(25, dtype=np.complex128), X0, X0.copy(),
                             **DUAL_KW)


@pytest.mark.parametrize("kw", [{}, {"store": False}, {"mixed_prec": True},
                                {"rr": "host"}],
                         ids=["default", "store_false", "mixed_prec", "rr_host"])
def test_dual_gen_feast_matches_jax(diag25, jax_dual25, kw):
    """tests/test_feast.py::test_dual_gen_feast and its option matrix, each
    option held to the JAX package's solve."""
    A, X0 = diag25
    B = np.eye(25, dtype=np.complex128)
    rt = ft.dual_gen_feast(A, B, X0, X0.copy(), device="cpu", **DUAL_KW, **kw)
    lam, Xr, Xl, res = rt.filtered()
    lj = np.sort(jax_dual25.filtered()[0].real)
    np.testing.assert_allclose(np.sort(lam.real), lj, rtol=0, atol=1e-10)
    assert rt.n_iter == int(jax_dual25.n_iter) and rt.converged
    np.testing.assert_allclose(np.sort(lam.real), [1.0, 2.0, 3.0], atol=1e-10)
    assert res.max() < 1e-10
    assert _left_residuals(A, B, lam, Xl).max() < 1e-10


def test_dual_gen_feast_grcar_matches_jax(jax_dual25):
    """tests/test_feast.py::test_grcar_two_sided on the grcar pencil above:
    right and left pairs, eigenvalues against the JAX package and LAPACK."""
    A, B = _grcar_on_diag25_contour()
    wref = np.linalg.eigvals(np.linalg.solve(B, A))
    c, r = DUAL_KW["c"], DUAL_KW["r"]
    want = np.sort_complex(wref[np.abs(wref - c) <= r])
    assert len(want) == 3
    X0 = _x0(np.random.default_rng(2), 25, 5)
    rt = ft.dual_gen_feast(A, B, X0, X0.copy(), iters=20, device="cpu", **DUAL_KW)
    rj = jt.dual_gen_feast(A, B, X0, X0.copy(), iters=20, **DUAL_KW)
    lam, Xr, Xl, res = rt.filtered()
    assert rt.converged and len(lam) == 3 and res.max() < 1e-10
    assert rt.n_iter == int(rj.n_iter)
    np.testing.assert_allclose(np.sort_complex(lam), np.sort_complex(rj.filtered()[0]),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(np.sort_complex(lam), want, atol=1e-8)
    assert _left_residuals(A, B, lam, Xl).max() < 1e-8


def test_eig_left_and_two_sided_match_jax():
    rng = np.random.default_rng(4)
    n = 12
    A, B = _x0(rng, n, n), np.eye(n) + 0.1 * _x0(rng, n, n)
    w, Y = teig.eig_left(torch.as_tensor(A))
    w, Y = w.numpy(), Y.numpy()
    assert np.linalg.norm(Y.conj().T @ A - w[:, None] * Y.conj().T, axis=1).max() < 1e-12
    wj, _ = jeig.eig_left(jcx.from_numpy(A))
    np.testing.assert_allclose(np.sort_complex(w), np.sort_complex(jcx.to_numpy(wj)),
                               rtol=0, atol=1e-12)
    w2, V, (wl, W) = teig.gen_eig_two_sided(torch.as_tensor(A), torch.as_tensor(B))
    w2, V, wl, W = (t.numpy() for t in (w2, V, wl, W))
    assert np.linalg.norm(A @ V - (B @ V) * w2[None, :], axis=0).max() < 1e-11
    # W: right eigenvectors of the adjoint pencil, values conj(w)
    assert np.linalg.norm(A.conj().T @ W - (B.conj().T @ W) * wl[None, :],
                          axis=0).max() < 1e-11
    wj2, _, (wlj, _) = jeig.gen_eig_two_sided(jcx.from_numpy(A), jcx.from_numpy(B))
    np.testing.assert_allclose(np.sort_complex(w2), np.sort_complex(jcx.to_numpy(wj2)),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.sort_complex(wl), np.sort_complex(jcx.to_numpy(wlj)),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("n", [8, 48])
@pytest.mark.parametrize("scale", [1e-15, 1e-20, 1e18])
def test_plain_schur_holds_at_far_scales(n, scale):
    """The plain complex64 Schur scales A by a power of two first, as the
    kernel does (csrc/schur.cu): at these scales it ends before its sweep
    cap, and its eigenvalues are finite and no worse than the JAX
    package's complex64 eig on the same matrix (which runs to its cap
    there: errors of order one, or NaN).  The bound 1e-4 relative is the
    float32 accuracy of a 48 x 48 eig."""
    rng = np.random.default_rng(n)
    A = ((rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
         * scale).astype(np.complex64)
    ref = np.linalg.eigvals(A.astype(np.complex128))

    def err(w):
        if not np.isfinite(w).all():
            return np.inf
        return max(np.abs(ref - w[:, None]).min(axis=0).max(),
                   np.abs(w - ref[:, None]).min(axis=0).max()) / scale

    _, _, (sweeps, _) = teig._schur_plain(torch.as_tensor(A))
    assert sweeps < 30 * n
    w, _ = teig.eig(torch.as_tensor(A))
    wj, _ = jeig.eig(jcx.from_numpy(A, jnp.float32))
    assert err(w.numpy()) < 1e-4
    assert err(w.numpy()) <= err(jcx.to_numpy(wj))


def test_plain_schur_prescale_changes_no_bit_in_the_normal_range():
    """A power of two changes no bit of the homogeneous Schur steps: the
    plain Schur of A and of A * 2^k agree exactly up to that factor."""
    g = torch.Generator().manual_seed(7)
    for dt in (torch.complex64, torch.complex128):
        A = torch.randn((24, 24), dtype=dt, generator=g)
        T1, Z1, st1 = teig._schur_plain(A)
        T2, Z2, st2 = teig._schur_plain(A * 2.0 ** 9)
        assert torch.equal(T2, T1 * 2.0 ** 9) and torch.equal(Z2, Z1) and st1 == st2
