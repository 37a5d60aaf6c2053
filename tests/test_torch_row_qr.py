"""The port's row-reduced QR and mesh helpers on 4 gloo ranks.

`ops.qr`'s `psum_axis="row"` route (each rank its row block, the
reductions over the mesh bound by `parallel.mesh.bind_mesh`) against the
JAX package's own `psum_axis="row"` under `shard_map` on 4 of the
conftest's 8 CPU devices: Q gathered and R on every rank to 1e-12
relative (the two all-reduces add the blocks in another order).  Then the
mesh helpers (pytrees, a mesh in another rank order, the refusals) and
`rowsharded.row_operators` / `row_amg` against the JAX package's
unsharded CSR product and V-cycle.  Every returned tensor goes through
`np.asarray`, which refuses a tensor with the conjugate bit."""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.sharding import Mesh, PartitionSpec as P

from feast_tpu import cx as jcx
from feast_tpu.ops import amg as jamg
from feast_tpu.ops import qr as jqr
from feast_tpu.ops import sparse as jsp
from feast_tpu_torch.ops import qr as tqr

from _torch_ranks import Ranks, _host_tree, _tree

torch.set_num_threads(2)

WORLD = 4


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    r = Ranks(WORLD, str(tmp_path_factory.mktemp("ranks4")))
    yield r
    r.close()


def _rand(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _jax_rows(fn, a, n_out):
    """fn(CX block, psum_axis="row") under shard_map over 4 devices on a
    "row" axis: the row-sharded outputs gathered, the replicated ones as
    one copy."""
    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("row",))
    rows, rep = P("row", None), P(None, None)
    specs = (rows, rows, rep, rep)[:2 * n_out]

    def local(ar, ai):
        out = fn(jcx.CX(ar, ai), psum_axis="row")
        out = (out,) if isinstance(out, jcx.CX) else out
        return tuple(p for o in out for p in (o.re, o.im))

    f = jax.jit(shard_map(local, mesh=mesh, in_specs=(rows, rows), out_specs=specs))
    planes = f(np.ascontiguousarray(a.real), np.ascontiguousarray(a.imag))
    return [np.asarray(planes[2 * i]) + 1j * np.asarray(planes[2 * i + 1])
            for i in range(n_out)]


def _wide_range(n=64, m=8, seed=0):
    """Columns over 1e-200..1, and column 2 at 1e-150 in rank 0's rows
    only: that block's own max-abs is far below the column's."""
    a = _rand(np.random.default_rng(seed), n, m)
    a *= np.logspace(0, -200, m)[None, :]
    a[: n // WORLD, 2] *= 1e-150
    return a


def _gathered(outs, k=0):
    return np.concatenate([o[k] for o in outs])


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def test_colscale_unit_row_reduced_matches_jax(ranks4):
    a = _wide_range()
    got = _gathered(ranks4.run("row_reduced", a=a, fn="colscale_unit"))
    (want,) = _jax_rows(jqr.colscale_unit, a, 1)
    assert _rel(got, want) < 1e-12
    np.testing.assert_allclose(np.linalg.norm(got, axis=0), 1.0, rtol=1e-14)
    # the whole matrix, unsharded, is scaled the same way
    assert _rel(got, tqr.colscale_unit(torch.as_tensor(a)).numpy()) < 1e-12
    # rank 0's part of column 2 stays at 1e-150 of the column
    assert np.abs(got[: 64 // WORLD, 2]).max() < 1e-148


@pytest.mark.parametrize("method", ["cholqr2", "cholqr3"])
def test_orthonormalize_row_reduced_matches_jax(ranks4, method):
    a = _wide_range()
    got = _gathered(ranks4.run("row_reduced", a=a, fn="orthonormalize", method=method))
    (want,) = _jax_rows(lambda A, psum_axis: jqr.orthonormalize(
        A, method=method, psum_axis=psum_axis), a, 1)
    assert _rel(got, want) < 1e-12
    assert np.abs(got.conj().T @ got - np.eye(a.shape[1])).max() < 1e-13
    assert _rel(got, tqr.orthonormalize(torch.as_tensor(a), method).numpy()) < 1e-12


@pytest.mark.parametrize("fn", ["cholqr", "cholqr2", "cholqr3"])
def test_cholqr_row_reduced_matches_jax(ranks4, fn):
    """The shift uses the block's own row count in both packages."""
    a = _rand(np.random.default_rng(1), 64, 8)
    a[:, 3] *= 1e-4
    outs = ranks4.run("row_reduced", a=a, fn=fn)
    for o in outs[1:]:
        np.testing.assert_array_equal(o[1], outs[0][1])          # R on every rank
    Qj, Rj = _jax_rows(getattr(jqr, fn), a, 2)
    assert _rel(_gathered(outs), Qj) < 1e-12
    assert _rel(outs[0][1], Rj) < 1e-12
    assert _rel(_gathered(outs) @ outs[0][1], a) < 1e-13


def test_row_reduced_on_a_node_row_mesh_reduces_over_row_only(ranks4):
    """On a 2 x 2 ("node", "row") mesh each node group holds the whole
    matrix in two row blocks: Q is the unsharded one in both groups (a sum
    over all four ranks would scale it by 1/sqrt(2))."""
    a = _rand(np.random.default_rng(2), 48, 6)
    outs = ranks4.run("row_reduced", a=a, fn="orthonormalize", n_node=2)
    want = tqr.orthonormalize(torch.as_tensor(a)).numpy()
    for g in (outs[:2], outs[2:]):
        assert _rel(_gathered(g), want) < 1e-13


def test_psum_axis_outside_a_bound_mesh_raises():
    A = torch.ones(8, 2, dtype=torch.complex128)
    with pytest.raises(ValueError, match="names no dimension of a bound mesh"):
        tqr.cholqr2(A, psum_axis="row")
    with pytest.raises(ValueError, match="no row-reduced form"):
        tqr.orthonormalize(A, method="householder", psum_axis="row")


def test_mesh_refusals(ranks4):
    """devices that are not the whole group, each once, raise with that
    reason (a too-short list by the size rule); so does psum_axis where the
    bound meshes have no such dimension."""
    short, twice, off, twice_2d, unbound = ranks4.run("mesh_refusals")[0]
    assert "process group 4" in short
    for msg in (twice, off, twice_2d):
        assert "spans the whole process group" in msg
    assert "names no dimension of a bound mesh" in unbound


@pytest.mark.parametrize("devices", [None, [3, 1, 2, 0]])
def test_mesh_helpers(ranks4, devices):
    """In rank order and in a permutation: each rank's node block is the one
    at its mesh position, gather_nodes returns mesh order, replicate
    broadcasts the mesh's first rank into a new tensor (the rank's own is
    left as it was), the sums cover every rank."""
    outs = ranks4.run("mesh_helpers", devices=devices)
    order = list(range(WORLD)) if devices is None else devices
    x = np.arange(8.0).reshape(8, 1)
    total = sum(r + 0.5j for r in range(WORLD))
    for rank, o in enumerate(outs):
        pos = order.index(rank)
        assert (o["pos"], o["size"]) == (pos, WORLD)
        np.testing.assert_array_equal(o["shard_nodes"], x[2 * pos:2 * pos + 2])
        np.testing.assert_array_equal(o["replicate"], np.full((2, 3), order[0] + 0.5j))
        np.testing.assert_array_equal(o["left"], np.full((2, 3), rank + 0.5j))
        np.testing.assert_allclose(o["node_sum"], np.full((2, 3), total), rtol=1e-15)
        np.testing.assert_array_equal(o["all_reduce"], o["node_sum"])
        np.testing.assert_array_equal(o["gather_nodes"][:, 0],
                                      [r + 0.5j for r in order])


def _same_structure(got, want):
    """got has want's nested types and keys, None where want has None."""
    assert type(got) is type(want)
    if want is None:
        return
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _same_structure(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_structure(g, w)


def test_shard_nodes_and_replicate_keep_a_pytree(ranks4):
    """A dict of a tuple (a tensor and a list of a tensor and None) and a
    NamedTuple comes back as the same structure: shard_nodes gives each
    leaf's node block, replicate rank 0's leaves."""
    outs = ranks4.run("mesh_helpers")
    want0 = _host_tree(_tree(0))
    for rank, o in enumerate(outs):
        nodes, rep = o["tree_nodes"], o["tree_replicate"]
        _same_structure(nodes, want0)
        _same_structure(rep, want0)
        mine = _host_tree(_tree(rank))
        np.testing.assert_array_equal(nodes["a"][0], mine["a"][0][2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(nodes["a"][1][0],
                                      mine["a"][1][0][2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(nodes["b"].im, mine["b"].im[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(rep["b"].re, want0["b"].re)
        np.testing.assert_array_equal(rep["a"][1][0], want0["a"][1][0])


@pytest.mark.parametrize("devices", [None, [1, 0, 3, 2]])
def test_shard_rows_on_a_node_row_mesh(ranks4, devices):
    """shard_rows splits each leaf over "row" only (the node groups hold
    the same blocks), and all_gather over "row" puts them back in mesh
    order."""
    outs = ranks4.run("row_mesh_helpers", devices=devices)
    order = list(range(WORLD)) if devices is None else devices
    for rank, o in enumerate(outs):
        k = order.index(rank)
        assert o["coord"] == (k // 2, k % 2)
        mine = _host_tree(_tree(rank))
        _same_structure(o["tree_rows"], mine)
        rows = slice(4 * (k % 2), 4 * (k % 2) + 4)
        np.testing.assert_array_equal(o["tree_rows"]["b"].re, mine["b"].re[rows])
        np.testing.assert_array_equal(o["tree_rows"]["a"][1][0], mine["a"][1][0][rows])
        line = order[2 * (k // 2):2 * (k // 2) + 2]
        want = np.concatenate([_host_tree(_tree(r))["b"].re[4 * i:4 * i + 4]
                               for i, r in enumerate(line)])
        np.testing.assert_array_equal(o["gather_rows"], want)


def _grid_pencil(N):
    """2-D Laplacian stiffness and 9-point mass on an N x N grid."""
    T = sp.diags([-np.ones(N - 1), 2 * np.ones(N), -np.ones(N - 1)], [-1, 0, 1])
    M = sp.diags([np.ones(N - 1), 4 * np.ones(N), np.ones(N - 1)], [-1, 0, 1]) / 6
    I = sp.identity(N)
    return sp.csr_matrix(sp.kron(T, I) + sp.kron(I, T)), sp.csr_matrix(sp.kron(M, M))


def test_row_operators_match_jax_products(ranks4):
    """Each rank's RowBlocks of a 2-D pencil (n = 121, not a multiple of 4:
    the last block padded) give the whole products, against the JAX
    package's unsharded CSR product, to 1e-13 relative, on every rank."""
    K, M = _grid_pencil(11)
    X = _rand(np.random.default_rng(3), 121, 3)
    outs = ranks4.run("row_ops", A=K, B=M, X=X)
    wantK = jcx.to_numpy(jsp.CSR.from_scipy(K).matvec(jcx.from_numpy(X)))
    wantM = jcx.to_numpy(jsp.CSR.from_scipy(M).matvec(jcx.from_numpy(X)))
    for rank, o in enumerate(outs):
        assert (o["r0"], o["shape"]) == (31 * rank, (121, 121))
        assert _rel(o["AX"], wantK) < 1e-13 and _rel(o["BX"], wantM) < 1e-13
        np.testing.assert_array_equal(o["diag"], K.diagonal())


def test_row_amg_vcycle_matches_jax(ranks4):
    """One V-cycle of `row_amg`'s hierarchy (strength aggregation, row
    blocks on every level) against the JAX package's unsharded strength
    hierarchy at a complex shift: 1e-10 relative, the tolerance of the
    unsharded port against JAX (tests/test_torch_amg.py), whose levels take
    other sparse formats and so round differently; and against the port's
    own unsharded hierarchy to 1e-12."""
    from feast_tpu_torch.ops import amg as tamg

    K, M = _grid_pencil(12)
    X = _rand(np.random.default_rng(4), 144, 2)
    zc = 0.05 + 0.02j
    outs = ranks4.run("row_amg_apply", A=K, B=M, X=X, z=zc, max_coarse=30)
    hj = jamg.build_amg(K, M, aggregate="strength", max_coarse=30)
    want = jcx.to_numpy(jamg.shifted_preconditioner(hj, jcx.as_cx(zc))(jcx.from_numpy(X)))
    ht = tamg.build_amg(K, M, aggregate="strength", max_coarse=30, device="cpu")
    own = tamg.shifted_preconditioner(ht, torch.tensor(zc, dtype=torch.complex128))(
        torch.as_tensor(X)).numpy()
    for o in outs:
        np.testing.assert_array_equal(o, outs[0])
    assert _rel(outs[0], want) < 1e-10
    assert _rel(outs[0], own) < 1e-12
