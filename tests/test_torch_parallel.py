"""The port's node- and slice-parallel layer (feast_tpu_torch.parallel,
the drivers' mesh=) on gloo ranks, against the JAX package on the
conftest's 8-device CPU mesh and against the port's single-process run:
eigenvalues to 1e-12 (dense; the all-reduce sums the nodes in another
order than one process does) and 1e-10 (iterative), with the same
iteration counts.  The ranks are spawned once per module
(`_torch_ranks.Ranks`)."""

import jax
import numpy as np
import pytest
import torch

import feast_tpu as jt
import feast_tpu_torch as ft
from feast_tpu.parallel import node_mesh as jax_node_mesh

from _torch_ranks import Ranks

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    r = Ranks(4, str(tmp_path_factory.mktemp("ranks4")))
    yield r
    r.close()


@pytest.fixture(scope="module")
def ranks8(tmp_path_factory):
    r = Ranks(8, str(tmp_path_factory.mktemp("ranks8")))
    yield r
    r.close()


@pytest.fixture(scope="module")
def diag25():
    rng = np.random.default_rng(0)
    A = np.diag(np.arange(1.0, 26.0)).astype(np.complex128)
    X0 = rng.standard_normal((25, 5)) + 1j * rng.standard_normal((25, 5))
    return A, X0


def _inside(lam, inside):
    return np.sort_complex(np.asarray(lam)[np.asarray(inside)])


def _same_on_every_rank(outs, keys=("lam", "res", "inside")):
    for o in outs[1:]:
        for k in keys:
            np.testing.assert_array_equal(o[k], outs[0][k])
        assert o["n_iter"] == outs[0]["n_iter"]


def _against_jax(out, ref, tol=1e-12):
    lam_j, _, res_j = ref.filtered()
    got = _inside(out["lam"], out["inside"])
    assert len(got) == len(lam_j) and out["n_iter"] == ref.n_iter
    np.testing.assert_allclose(got, np.sort_complex(lam_j), atol=tol)
    assert out["res"][out["inside"]].max() < 1e-12


def test_feast_eight_ranks_match_jax_mesh(ranks8, diag25):
    A, X0 = diag25
    kw = dict(c=1.5 + 0j, r=2.0, nodes=8)
    outs = ranks8.run("dense_driver", driver="feast", A=A, X0=X0, **kw)
    _same_on_every_rank(outs)
    assert all(o["factor_batches"] == [1] for o in outs)     # one node a rank
    _against_jax(outs[0], jt.feast(A, X0, mesh=jax_node_mesh(8), **kw))
    single = ft.feast(A, X0, device="cpu", **kw)
    assert single.n_iter == outs[0]["n_iter"]
    np.testing.assert_allclose(outs[0]["lam"], single.lam.numpy(), atol=1e-12)


def test_gen_feast_four_ranks_match_jax_mesh(ranks4, diag25):
    A, X0 = diag25
    B = np.eye(25, dtype=np.complex128)
    kw = dict(c=1.5 + 0j, r=2.0, nodes=8)
    outs = ranks4.run("dense_driver", driver="gen_feast", A=A, B=B, X0=X0, **kw)
    _same_on_every_rank(outs)
    assert all(o["factor_batches"] == [2] for o in outs)
    _against_jax(outs[0], jt.gen_feast(A, B, X0, mesh=jax_node_mesh(4), **kw))


def test_feast_compiled_four_ranks_match_jax_mesh(ranks4, diag25):
    A, X0 = diag25
    kw = dict(c=1.5 + 0j, r=2.0, nodes=8)
    outs = ranks4.run("dense_driver", driver="feast_compiled", A=A, X0=X0, **kw)
    _same_on_every_rank(outs)
    _against_jax(outs[0], jt.feast_compiled(A, X0, mesh=jax_node_mesh(4), **kw))
    # the two-tier mixed-precision loop reduces over the ranks too
    mixed = ranks4.run("dense_driver", driver="feast_compiled", A=A, X0=X0,
                       mixed_prec=True, **kw)
    ref = ft.feast_compiled(A, X0, mixed_prec=True, device="cpu", **kw)
    assert mixed[0]["n_iter"] == ref.n_iter and mixed[0]["converged"]
    np.testing.assert_allclose(mixed[0]["lam"], ref.lam.numpy(), atol=1e-12)


@pytest.mark.parametrize("mixed", [False, True], ids=["full", "two_tier"])
def test_feast_compiled_steps_under_a_mesh_match_jax(ranks4, diag25, mixed):
    """feast_compiled(mesh=)'s sweep program run eagerly, the node
    all-reduce a step after each update (the graphs' route on the card),
    gives the same result on every rank, and the JAX mesh result on the
    same inputs: the same n_iter, eigenvalues to 1e-12 (1e-10 with the
    complex64 tier)."""
    A, X0 = diag25
    kw = dict(c=1.5 + 0j, r=2.0, nodes=8)
    outs = ranks4.run("compiled_steps", A=A, X0=X0, mixed_prec=mixed, **kw)
    _same_on_every_rank(outs, keys=("lam", "X", "res", "inside"))
    assert all(o["converged"] == outs[0]["converged"] for o in outs)
    assert outs[0]["converged"]
    _against_jax(outs[0], jt.feast_compiled(A, X0, mesh=jax_node_mesh(4), mixed_prec=mixed,
                                            **kw), tol=1e-10 if mixed else 1e-12)


def test_dual_gen_feast_four_ranks_match_single(ranks4, diag25):
    A, X0 = diag25
    B = np.eye(25, dtype=np.complex128)
    kw = dict(c=1.5 + 0j, r=2.0, nodes=8)
    outs = ranks4.run("dense_driver", driver="dual_gen_feast", A=A, B=B, X0=X0,
                      Xl0=X0.copy(), **kw)
    _same_on_every_rank(outs)
    ref = ft.dual_gen_feast(A, B, X0, X0.copy(), device="cpu", **kw)
    assert outs[0]["n_iter"] == ref.n_iter and outs[0]["converged"]
    np.testing.assert_allclose(outs[0]["lam"], ref.lam.numpy(), atol=1e-12)
    np.testing.assert_allclose(np.sort(_inside(outs[0]["lam"], outs[0]["inside"]).real),
                               [1.0, 2.0, 3.0], atol=1e-12)


def test_feast_iterative_four_ranks_match_jax_mesh(ranks4):
    import scipy.sparse as sp

    n, m0 = 300, 10
    diags, offs = [np.arange(1.0, n + 1.0)], [0]
    for k in range(1, 15):
        diags += [np.full(n - k, -0.1 / k)] * 2
        offs += [k, -k]
    A = sp.diags(diags, offs, format="csr").astype(np.complex128)
    w = np.sort(np.linalg.eigvalsh(A.toarray()).real)
    rng = np.random.default_rng(1)
    X0 = rng.standard_normal((n, m0)) + 1j * rng.standard_normal((n, m0))
    kw = dict(c=complex((w[148] + w[152]) / 2), r=float((w[152] - w[148]) * 0.7),
              nodes=8, iters=15, tol=1e-10, solve_tol=1e-11, solve_iters=400,
              spurious=1e-5)
    # skew: each rank's sparse products round differently, as atomics do
    # on a card; the ranks still agree (rank 0's Rayleigh-Ritz is broadcast)
    outs = ranks4.run("iterative", A=A, B=None, X0=X0, keep_warm=True, skew=True, **kw)
    _same_on_every_rank(outs)
    ref = jt.feast_iterative(A, None, X0, mesh=jax_node_mesh(4), **kw)
    good = outs[0]["inside"] & (outs[0]["res"] < 1e-10)
    lam_j, _, res_j = ref.filtered()
    assert outs[0]["converged"] and outs[0]["n_iter"] == ref.n_iter
    np.testing.assert_allclose(np.sort(outs[0]["lam"][good].real),
                               np.sort(lam_j[res_j < 1e-10].real), atol=1e-10)
    single = ft.feast_iterative(A, None, X0, device="cpu", keep_warm=True, **kw)
    np.testing.assert_allclose(outs[0]["lam"], single.lam.numpy(), atol=1e-10)
    assert outs[0]["warm"].shape == (8, n, m0)     # gathered back in node order
    np.testing.assert_allclose(outs[0]["warm"], single.warm.numpy(), atol=1e-8)


def test_nodes_not_divisible_by_ranks_raise(ranks4, diag25):
    A, X0 = diag25
    with pytest.raises(RuntimeError, match="not divisible"):
        ranks4.run("dense_driver", driver="feast", A=A, X0=X0, c=1.5, r=2.0, nodes=6)
    assert ranks4.run("world_info") == [(r, 4) for r in range(4)]   # the group lives on


def test_shard_nodes_places_two_nodes_per_rank(ranks4):
    blocks = ranks4.run("shard_nodes", N=8)
    for rank, b in enumerate(blocks):
        np.testing.assert_array_equal(b.ravel().real, [2 * rank, 2 * rank + 1])


def test_row_sharded_qr(ranks4):
    rng = np.random.default_rng(0)
    n, m = 512, 16
    a = rng.standard_normal((n, m)) + 1j * rng.standard_normal((n, m))
    outs = ranks4.run("row_qr", a=a)
    Q = np.concatenate([o[0] for o in outs])
    R = outs[0][1]
    for o in outs[1:]:
        np.testing.assert_array_equal(o[1], R)
    assert np.abs(Q.conj().T @ Q - np.eye(m)).max() < 1e-13
    assert np.abs(Q @ R - a).max() < 1e-13


def test_spectral_slices_match_jax():
    L = jt.problems.laplacian_1d(200)
    k_j, n_j = jt.parallel.spectral_slices(L, (0.0, 0.2), 2, nodes=8)
    k_t, n_t = ft.parallel.spectral_slices(L, (0.0, 0.2), 2, nodes=8, device="cpu")
    np.testing.assert_allclose(n_t, n_j, rtol=1e-10)
    for a, b in zip(k_t, k_j):
        np.testing.assert_allclose(np.asarray(a.nodes), np.asarray(b.nodes), atol=1e-15)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_feast_sliced_matches_jax(ranks4, k):
    """n = 200 over (0, 0.2) in 3 slices, one slice a case (each JAX slice
    compiles its own estimator and solve); the dedup across slices is held
    by the parallel test."""
    interval = tuple(np.linspace(0.0, 0.2, 4)[k:k + 2])
    L = jt.problems.laplacian_1d(200)
    kw = dict(nodes=8, iters=25, tol=1e-12)
    ref = jt.parallel.feast_sliced(L, interval, 1, **kw)
    outs = ranks4.run("sliced", A=L, interval=interval, n_slices=1, **kw)
    for o in outs[1:]:
        np.testing.assert_array_equal(o["lam"], outs[0]["lam"])
    out = outs[0]
    assert out["iters"] == [r.n_iter for r in ref.per_slice]
    np.testing.assert_allclose(out["counts"], ref.counts, rtol=1e-10)
    np.testing.assert_allclose(np.sort(out["lam"].real), np.sort(ref.lam.real), atol=1e-12)
    exact = 2.0 - 2.0 * np.cos(np.pi * np.arange(1, 201) / 201)
    exact = exact[(exact > interval[0]) & (exact < interval[1])]
    np.testing.assert_allclose(np.sort(out["lam"].real), exact, atol=1e-12)
    assert out["res"].max() < 1e-12


def test_feast_sliced_parallel_matches_feast_sliced(ranks4):
    L = jt.problems.laplacian_1d(120)
    kw = dict(nodes=8, iters=25, tol=1e-12)
    par = ranks4.run("sliced", A=L, interval=(0.0, 0.2), n_slices=4, parallel=True, **kw)
    for o in par[1:]:
        np.testing.assert_array_equal(o["lam"], par[0]["lam"])
    seq = ft.parallel.feast_sliced(L, (0.0, 0.2), 4, device="cpu", **kw)
    single = ft.parallel.feast_sliced_parallel(L, (0.0, 0.2), 4, device="cpu", **kw)
    np.testing.assert_array_equal(np.sort(par[0]["lam"].real), np.sort(single.lam.real))
    np.testing.assert_allclose(np.sort(par[0]["lam"].real), np.sort(seq.lam.real), atol=1e-9)
    assert par[0]["res"].max() < 1e-11
    exact = 2 - 2 * np.cos(np.arange(1, 121) * np.pi / 121)
    np.testing.assert_allclose(np.sort(par[0]["lam"].real), exact[exact < 0.2], atol=1e-9)


def test_feast_sliced_parallel_steps_on_a_slice_mesh(ranks4):
    """The sliced program run eagerly on each of 4 slice ranks (one slice
    a rank, no collective inside its loop) against the slices run one
    after the other in one process: the same sweeps and convergence per
    slice, the merged eigenvalues to 1e-12, on every rank."""
    H = _tie_problem(1)
    kw = dict(nodes=8, iters=30, tol=1e-10, m0=13, seed=1)
    par = ranks4.run("sliced", A=H, interval=(0.5, 40.5), n_slices=4, parallel=True,
                     steps=True, **kw)
    for o in par[1:]:
        np.testing.assert_array_equal(o["lam"], par[0]["lam"])
    single = ft.parallel.feast_sliced_parallel(H, (0.5, 40.5), 4, device="cpu", **kw)
    assert par[0]["iters"] == [r.n_iter for r in single.per_slice]
    assert par[0]["converged"] == [r.converged for r in single.per_slice]
    np.testing.assert_allclose(np.sort(par[0]["lam"].real), np.sort(single.lam.real),
                               rtol=1e-12, atol=0)
    w = np.linalg.eigvalsh(H)
    np.testing.assert_allclose(np.sort(par[0]["lam"].real), w[(w > 0.5) & (w < 40.5)],
                               atol=1e-10)


def _tie_problem(seed, n=40):
    """diag(1..n) + 0.05 (G + G^H) / 2, G complex Gaussian from `seed`."""
    G = np.random.default_rng(seed)
    G = G.standard_normal((n, n)) + 1j * G.standard_normal((n, n))
    return np.diag(np.arange(1.0, n + 1.0)) + 0.05 * (G + G.conj().T) / 2


def test_feast_sliced_parallel_matches_jax_where_a_slice_parks_a_spurious_value():
    """(10.5, 20.5) holds 10 eigenvalues; m0 = 13 leaves three columns for
    the outside, and the third falls between the eigenvalues near 9 and 22,
    at equal distance from the centre, whose filter values are equal: their
    mixture's Ritz value lies inside with a residual of the radius' order
    and no sweep separates them.  Both packages, in full precision on the
    same start block, run to the cap with the same spurious value; the JAX
    package returns it, the port merges the converged pairs only."""
    H = _tie_problem(1)
    kw = dict(nodes=8, iters=30, tol=1e-10, m0=13, seed=1)
    ref = jt.parallel.feast_sliced_parallel(H, (10.5, 20.5), 1, **kw)
    out = ft.parallel.feast_sliced_parallel(H, (10.5, 20.5), 1, device="cpu", **kw)
    (r_j,), (r_t,) = ref.per_slice, out.per_slice
    assert r_t.n_iter == r_j.n_iter == 31 and not r_t.converged and not r_j.converged
    lam_j, _, res_j = r_j.filtered()
    lam_t, _, res_t = r_t.filtered()
    assert len(lam_t) == len(lam_j) == 11
    np.testing.assert_allclose(np.sort_complex(lam_t), np.sort_complex(lam_j), atol=1e-10)
    np.testing.assert_allclose(np.sort(res_t)[-1], np.sort(res_j)[-1], rtol=1e-8)
    assert np.sort(res_j)[-1] > 1.0 and np.sort(res_j)[-2] < 1e-10
    w = np.linalg.eigvalsh(H)
    want = w[(w > 10.5) & (w < 20.5)]
    assert len(ref.lam) == len(want) + 1
    np.testing.assert_allclose(np.sort(out.lam.real), want, atol=1e-10)
    assert out.res.max() < 1e-10


def test_sliced_mixed_precision_matches_full_precision():
    """mixed_prec=True (complex64 factors, complex128 refinement; the panel
    kernel on the card) against the full-precision run the JAX package
    does (`test_feast_sliced_matches_jax`): the same counts to 1e-6, the
    same sweeps and eigenvalues to 1e-10, in both drivers."""
    L = jt.problems.laplacian_1d(120)
    kw = dict(nodes=8, iters=25, tol=1e-12, device="cpu")
    exact = 2 - 2 * np.cos(np.arange(1, 121) * np.pi / 121)
    for fn in (ft.parallel.feast_sliced_parallel, ft.parallel.feast_sliced):
        full = fn(L, (0.0, 0.2), 4, **kw)
        mixed = fn(L, (0.0, 0.2), 4, mixed_prec=True, **kw)
        np.testing.assert_allclose(mixed.counts, full.counts, rtol=1e-6)
        assert [r.n_iter for r in mixed.per_slice] == [r.n_iter for r in full.per_slice]
        assert all(r.converged for r in mixed.per_slice + full.per_slice)
        np.testing.assert_allclose(np.sort(mixed.lam.real), np.sort(full.lam.real), atol=1e-10)
        np.testing.assert_allclose(np.sort(full.lam.real), exact[exact < 0.2], atol=1e-10)
        assert mixed.res.max() < 1e-11


def test_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        ft.parallel.node_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        ft.parallel.node_row_mesh(2, 2, device_type="cpu")


def test_parallel_exports_match_jax():
    skip = {"largest_allgather_elems", "assert_no_large_allgather"}
    for name in jt.parallel.__dict__:
        if not name.startswith("_") and not isinstance(jt.parallel.__dict__[name], type(jax)):
            assert hasattr(ft.parallel, name), name
    for mod in ("mesh", "slicing", "rowsharded"):
        j, t = getattr(jt.parallel, mod), getattr(ft.parallel, mod)
        public = {n for n, v in vars(j).items() if not n.startswith("_") and callable(v)
                  and getattr(v, "__module__", "") == j.__name__}
        assert public - skip <= set(vars(t)), sorted(public - skip - set(vars(t)))
