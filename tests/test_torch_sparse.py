"""feast_tpu_torch sparse operators (CSR, DIA, STRETCH), the plain versions
of the DIA and complex-GEMM kernels, and the reordering helpers, against
feast_tpu and scipy on the same seeded inputs.  The JAX Pallas kernels run
in interpret mode, as their own tests run them."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from feast_tpu import cx as jcx
from feast_tpu.ops import pallas_kernels as pk
from feast_tpu.ops import reorder as jreorder
from feast_tpu.ops import sparse as jsp
from feast_tpu_torch import cx as tcx
from feast_tpu_torch import interop
from feast_tpu_torch.ops import dia_kernel
from feast_tpu_torch.ops import reorder as treorder
from feast_tpu_torch.ops import sparse as tsp

torch.set_num_threads(2)


def _rand(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _banded(rng, n, m, offs):
    Ad = np.zeros((n, m), dtype=np.complex128)
    for off in offs:
        i = np.arange(max(0, -off), min(n, m - off))
        Ad[i, i + off] = _rand(rng, len(i))
    return Ad


# complex128 against scipy and the JAX classes: exact same sums, 1e-12
@pytest.mark.parametrize("n,m,offs", [(64, 64, (-3, -1, 0, 2)),
                                      (40, 56, (-2, 0, 13, 20)),
                                      (50, 50, (2, 5))])
def test_dia_matches_jax_and_scipy(n, m, offs):
    rng = np.random.default_rng(n + m)
    Ad = _banded(rng, n, m, offs)
    X = _rand(rng, m, 7)
    At = tsp.DIA.from_scipy(sp.csr_matrix(Ad), device="cpu")
    Aj = jsp.DIA.from_scipy(sp.csr_matrix(Ad))
    assert At.offsets == Aj.offsets and At.shape == Aj.shape
    assert At.nnz == Aj.nnz and At.ndiag == Aj.ndiag
    np.testing.assert_allclose(At.data.numpy(), jcx.to_numpy(Aj.data), atol=0)
    got = At.matvec(torch.as_tensor(X)).numpy()
    np.testing.assert_allclose(got, Ad @ X, atol=1e-12)
    np.testing.assert_allclose(got, jcx.to_numpy(Aj.matvec(jcx.from_numpy(X))), atol=1e-12)
    np.testing.assert_allclose(At.todense().numpy(), Ad, atol=1e-12)
    k = min(n, m)
    np.testing.assert_allclose(At.diagonal().numpy()[:k], np.diag(Ad)[:k], atol=1e-12)
    # CSR -> DIA roundtrip, and the interop carrier
    A2 = tsp.DIA.from_csr(tsp.CSR.from_scipy(sp.csr_matrix(Ad), device="cpu"))
    np.testing.assert_allclose(A2.matvec(torch.as_tensor(X)).numpy(), Ad @ X, atol=1e-12)
    A3 = interop.operator_from(Aj, device="cpu")
    np.testing.assert_allclose(A3.matvec(torch.as_tensor(X)).numpy(), got, atol=1e-12)


def test_csr_matches_jax_and_scipy():
    rng = np.random.default_rng(2)
    n = 50
    Ad = (sp.random(n, n, density=0.1, random_state=3).toarray()
          + 1j * sp.random(n, n, density=0.1, random_state=4).toarray())
    At = tsp.CSR.from_scipy(sp.csr_matrix(Ad), device="cpu")
    Aj = jsp.CSR.from_scipy(sp.csr_matrix(Ad))
    X = _rand(rng, n, 7)
    got = At.matvec(torch.as_tensor(X)).numpy()
    np.testing.assert_allclose(got, Ad @ X, atol=1e-12)
    np.testing.assert_allclose(got, jcx.to_numpy(Aj.matvec(jcx.from_numpy(X))), atol=1e-12)
    np.testing.assert_allclose(At.diagonal().numpy(), np.diag(Ad), atol=1e-12)
    np.testing.assert_allclose(At.todense().numpy(), Ad, atol=1e-12)
    assert At.nnz == Aj.nnz
    A3 = interop.operator_from(Aj, device="cpu")
    np.testing.assert_allclose(A3.matvec(torch.as_tensor(X)).numpy(), got, atol=1e-12)
    Ab = tsp.CSR.from_dense(Ad, device="cpu")
    np.testing.assert_allclose(Ab.matvec(torch.as_tensor(X)).numpy(), got, atol=1e-12)


@pytest.mark.parametrize("n,stride", [(30, 3), (31, 3), (40, 4)])
def test_stretch_matches_jax_and_scipy(n, stride):
    """A smoothed-aggregation prolongation with contiguous aggregates:
    matvec, rmatvec (through STRETCHT) and todense, 1e-12."""
    rng = np.random.default_rng(n)
    nc = -(-n // stride)
    L = sp.diags([np.full(n, 2.0), -np.ones(n - 1), -np.ones(n - 1)], [0, 1, -1])
    Pt = sp.csr_matrix((np.ones(n), (np.arange(n), np.arange(n) // stride)), shape=(n, nc))
    P = ((sp.identity(n) - 0.3 * L) @ Pt).tocsr().astype(np.complex128)
    P.data = P.data * (1 + 0.2j)
    St = tsp.STRETCH.from_scipy(P, stride, device="cpu")
    Sj = jsp.STRETCH.from_scipy(P, stride)
    assert St.offsets == Sj.offsets and St.nnz == Sj.nnz
    Xc, Y = _rand(rng, nc, 5), _rand(rng, n, 5)
    Pd = P.toarray()
    np.testing.assert_allclose(St.todense().numpy(), Pd, atol=1e-12)
    up = St.matvec(torch.as_tensor(Xc)).numpy()
    np.testing.assert_allclose(up, Pd @ Xc, atol=1e-12)
    np.testing.assert_allclose(up, jcx.to_numpy(Sj.matvec(jcx.from_numpy(Xc))), atol=1e-12)
    Rt = tsp.STRETCHT(St)
    assert Rt.shape == (nc, n)
    down = Rt.matvec(torch.as_tensor(Y)).numpy()
    np.testing.assert_allclose(down, Pd.conj().T @ Y, atol=1e-12)
    np.testing.assert_allclose(down, jcx.to_numpy(Sj.rmatvec(jcx.from_numpy(Y))), atol=1e-12)
    Rc = interop.operator_from(jsp.STRETCHT(Sj), device="cpu")
    np.testing.assert_allclose(Rc.matvec(torch.as_tensor(Y)).numpy(), down, atol=1e-12)
    # a pattern off the stride band has no STRETCH form
    assert tsp.STRETCH.from_scipy(sp.random(n, nc + 1, density=0.2, random_state=0), stride,
                                  device="cpu") is None


def test_operators_batch_over_nodes():
    """Leading batch dims on X and on an operator's data (the contour-node
    axis) give the per-node products, 1e-12."""
    rng = np.random.default_rng(9)
    n, m, nodes = 60, 4, 3
    Ad = _banded(rng, n, n, (-5, -1, 0, 1, 5))
    Bd = _banded(rng, n, n, (-5, -1, 0, 1, 5))
    z = _rand(rng, nodes)
    X = _rand(rng, nodes, n, m)
    for cls in (tsp.DIA, tsp.CSR):
        A = cls.from_scipy(sp.csr_matrix(Ad), device="cpu")
        B = cls.from_scipy(sp.csr_matrix(Bd), device="cpu")
        shared = A.matvec(torch.as_tensor(X)).numpy()
        zt = torch.as_tensor(z)
        data = A.data - zt.reshape((nodes,) + (1,) * A.data.dim()) * B.data
        S = (tsp.DIA(data, A.offsets, A.shape) if cls is tsp.DIA
             else tsp.CSR(data, A.indices, A.row_ids, A.shape))
        per_node = S.matvec(torch.as_tensor(X)).numpy()
        mv = tsp.shifted_matvec(A, B, zt)(torch.as_tensor(X)).numpy()
        for i in range(nodes):
            np.testing.assert_allclose(shared[i], Ad @ X[i], atol=1e-12)
            np.testing.assert_allclose(per_node[i], (Ad - z[i] * Bd) @ X[i], atol=1e-12)
            np.testing.assert_allclose(mv[i], (Ad - z[i] * Bd) @ X[i], atol=1e-12)
        np.testing.assert_allclose(S.diagonal().numpy(),
                                   np.diag(Ad)[None] - z[:, None] * np.diag(Bd)[None],
                                   atol=1e-12)


@pytest.mark.parametrize("kind", ["csr", "dia", "dense", "none"])
def test_shifted_matvec_and_jacobi_match_jax(kind):
    rng = np.random.default_rng(5)
    n = 80
    L = sp.diags([np.full(n, 2.0) + 0.1j, -np.ones(n - 1), -np.ones(n - 1)],
                 [0, 1, -1], format="csr").astype(np.complex128)
    Md = sp.diags([np.full(n, 4 / 6), np.full(n - 1, 1 / 6), np.full(n - 1, 1 / 6)],
                  [0, 1, -1], format="csr").astype(np.complex128)
    zc = 3.0 + 0.5j
    X = _rand(rng, n, 3)
    if kind == "csr":
        At, Bt = tsp.CSR.from_scipy(L, device="cpu"), tsp.CSR.from_scipy(Md, device="cpu")
        Aj, Bj = jsp.CSR.from_scipy(L), jsp.CSR.from_scipy(Md)
    elif kind == "dia":
        At, Bt = tsp.as_operator(L, device="cpu"), tsp.as_operator(Md, device="cpu")
        Aj, Bj = jsp.as_operator(L), jsp.as_operator(Md)
        assert isinstance(At, tsp.DIA) and isinstance(Aj, jsp.DIA)
    elif kind == "dense":
        At = tsp.as_operator(L.toarray(), device="cpu")
        Bt = tsp.as_operator(Md.toarray(), device="cpu")
        Aj, Bj = jsp.as_operator(L.toarray()), jsp.as_operator(Md.toarray())
    else:
        At, Bt = tsp.as_operator(L, device="cpu"), None
        Aj, Bj = jsp.as_operator(L), None
    Bd = np.eye(n) if Bt is None else Md.toarray()
    zt = torch.tensor(zc, dtype=torch.complex128)
    got = tsp.shifted_matvec(At, Bt, zt)(torch.as_tensor(X)).numpy()
    want = jcx.to_numpy(jsp.shifted_matvec(Aj, Bj, jcx.as_cx(zc))(jcx.from_numpy(X)))
    np.testing.assert_allclose(got, want, atol=1e-12)
    np.testing.assert_allclose(got, (L.toarray() - zc * Bd) @ X, atol=1e-12)
    gotM = tsp.jacobi_preconditioner(At, Bt, zt)(torch.as_tensor(X)).numpy()
    wantM = jcx.to_numpy(jsp.jacobi_preconditioner(Aj, Bj, jcx.as_cx(zc))(jcx.from_numpy(X)))
    np.testing.assert_allclose(gotM, wantM, atol=1e-12)


def test_as_operator_selection_and_bell_stub():
    n = 200
    L = sp.diags([np.full(n, 2.0), -np.ones(n - 1), -np.ones(n - 1)],
                 [0, 1, -1], format="csr").astype(np.complex128)
    assert isinstance(tsp.as_operator(L, device="cpu"), tsp.DIA)
    R = sp.random(n, n, density=0.05, random_state=0).astype(np.complex128).tocsr()
    # off the band both packages pick BELL, at the same block size
    assert isinstance(tsp.as_operator(R, device="cpu"), tsp.BELL)
    assert isinstance(jsp.as_operator(R), jsp.BELL)
    assert tsp.as_operator(R, device="cpu").bs == jsp.as_operator(R).bs
    assert tsp.as_operator(None, device="cpu") is None
    op = tsp.as_operator(L, torch.float32, device="cpu")
    assert op.data.dtype == torch.complex64 and tsp.as_operator(op, device="cpu") is op


# the port's plain DIA product in complex64 against the Pallas kernel in
# interpret mode: both sum fp32 products of O(1) terms, atol 1e-4
@pytest.mark.parametrize("offs,n,m", [
    ((-1, 0, 1), 700, 16),
    ((-32, -1, 0, 1, 32), 512, 8),
    ((2, 5), 300, 16),
    ((-7, -3), 300, 16),
])
def test_dia_plain_matches_pallas_interpret(offs, n, m, monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)
    pk._dia_matvec_pallas_padded._clear_cache()
    rng = np.random.default_rng(7)
    diags = [_rand(rng, n - abs(o)) for o in offs]
    A = sp.diags(diags, offs, format="csr").astype(np.complex128)
    X = _rand(rng, n, m)
    want = jcx.to_numpy(pk.dia_matvec_pallas(jsp.DIA.from_scipy(A, jnp.float32),
                                             jcx.from_numpy(X, jnp.float32), bn=256))
    At = tsp.DIA.from_scipy(A, torch.float32, device="cpu")
    Xt = torch.as_tensor(X, dtype=torch.complex64)
    got = At.matvec(Xt)           # on the CPU the wrapper takes the plain version
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(dia_kernel.dia_matvec(At.data, At.offsets, Xt).numpy(),
                               got.numpy(), atol=0)
    np.testing.assert_allclose(got.numpy(), A @ X, rtol=0, atol=1e-3)


# the plain planes GEMM against the Pallas kernel in interpret mode:
# fp32 sums over K in different orders, atol 1e-3 sqrt(K) (the JAX test's)
@pytest.mark.parametrize("shape", [(256, 256, 256), (300, 130, 384)])
def test_cmatmul_planes_matches_pallas_interpret(shape, monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)
    pk._cmatmul_pallas_padded._clear_cache()
    m, k, n = shape
    rng = np.random.default_rng(5)
    a, b = _rand(rng, m, k), _rand(rng, k, n)
    want = jcx.to_numpy(pk.cmatmul_pallas(jcx.from_numpy(a, jnp.float32),
                                          jcx.from_numpy(b, jnp.float32),
                                          bm=128, bn=128, bk=128))
    at = torch.as_tensor(a, dtype=torch.complex64)
    bt = torch.as_tensor(b, dtype=torch.complex64)
    got = tcx._cmatmul_planes(at, bt)
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3 * np.sqrt(k))
    np.testing.assert_allclose(got.numpy(), a @ b, rtol=0, atol=1e-3 * np.sqrt(k))
    # the default backend is the library product; batch dims broadcast
    np.testing.assert_allclose(tcx.cmatmul(at, bt).numpy(), (at @ bt).numpy(), atol=0)
    batched = tcx._cmatmul_planes(at[None].expand(2, m, k), bt)
    np.testing.assert_allclose(batched[1].numpy(), got.numpy(), atol=1e-4)


def test_reorder_matches_jax():
    """The port's own copy of reorder.py makes the same decisions."""
    n = 120
    rng = np.random.default_rng(3)
    L = sp.diags([np.full(n, 2.0), -np.ones(n - 1), -np.ones(n - 1)],
                 [0, 1, -1], format="csr").astype(np.complex128)
    p = rng.permutation(n)
    S = L[p][:, p].tocsr()
    assert treorder.bandwidth(S) == jreorder.bandwidth(S) > 1
    np.testing.assert_array_equal(treorder.rcm_permutation(S), jreorder.rcm_permutation(S))
    perm, info = treorder.plan_reorder(S)
    permj, infoj = jreorder.plan_reorder(S)
    np.testing.assert_array_equal(perm, permj)
    assert info == infoj and info["bandwidth_after"] == 1
    assert treorder.plan_reorder(L)[0] is None          # already banded
    Sp, _ = treorder.permute_pencil(S, None, perm)
    assert treorder.bandwidth(Sp) == 1
