"""`feast_sliced_parallel`'s stacked slices as one batched sweep program, on
the CPU: the batched building blocks give each matrix what it gets alone,
the batched steps read nothing on the host, the program run eagerly
(`_feast_sliced_parallel_steps`, which the public driver is on the CPU)
agrees with the JAX package's vmapped while_loop in full precision and,
with mixed_prec, which the JAX package's slicing drivers lack, with
scipy's eigh of the same pencil, and a cached program solves a new
interval of its shape.

On the card the same steps are captured as CUDA graphs
(`tests/test_torch_cuda.py`).  Tolerances: a batch of matrices goes through
batched matrix products whose sums may round apart from one matrix's, so
batched against alone is held to 1e-13 relative; against the JAX package
and scipy to 1e-10, as the other parity tests.
"""

import importlib
import time

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import feast_tpu as jt
import feast_tpu_torch as ft
from feast_tpu_torch.ops import qr as tqr

from test_torch_compiled_loop import _jordan, _rand, forced_mixed, no_host_reads  # noqa: F401
from test_torch_parallel import _tie_problem

tfeast = importlib.import_module("feast_tpu_torch.solvers.feast")
tsl = importlib.import_module("feast_tpu_torch.parallel.slicing")
teig = importlib.import_module("feast_tpu_torch.ops.eig")

torch.set_num_threads(2)


def _rel(a, b):
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-300))


def _hermitian(n=60, seed=0):
    """diag(1..n) + 0.05 (G + G^H) / 2 and B = I + 0.01 (H + H^H) / sqrt(n)."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    H = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    A = np.diag(np.arange(1.0, n + 1.0)) + 0.05 * (G + G.conj().T) / 2
    return A, np.eye(n) + 0.01 * (H + H.conj().T) / np.sqrt(n)


def test_batched_cholesky_and_orthonormalize_equal_each_matrix_alone():
    """Three blocks of very different scales, one rank-deficient: each gets
    its own breakdown floor and cap (a floor taken over the whole batch
    would couple them)."""
    rng = np.random.default_rng(3)
    Y = rng.standard_normal((3, 90, 12)) + 1j * rng.standard_normal((3, 90, 12))
    Y[0] *= 1e3
    Y[1] *= 1e-4
    Y[2, :, 7] = Y[2, :, 2]
    Y = torch.as_tensor(Y)
    G = Y.mH @ Y
    Lb, Qb = tqr.cholesky(G), tqr.orthonormalize(Y)
    for s in range(3):
        assert _rel(Lb[s], tqr.cholesky(G[s])) <= 1e-13
    # a rank-deficient block's basis amplifies rounding without bound: the
    # bases of the two full-rank blocks are held
    for s in range(2):
        Qs = tqr.orthonormalize(Y[s])
        assert float((Qb[s] - Qs).abs().max()) <= 1e-13
    # the rank-deficient block's pivot is floored: finite, like alone
    assert torch.isfinite(torch.view_as_real(Lb)).all()


@pytest.mark.parametrize("with_b", [False, True], ids=["std", "pencil"])
def test_batched_eig_flags_per_matrix(with_b):
    """`_eig_flagged` / `_gen_eig_flagged` on three matrices, the middle one
    with a 3 x 3 Jordan block: ok is [True, False, True], each matrix's
    values and vectors as alone (1e-13 relative) and its ok as alone."""
    n = 48
    A = np.stack([_rand(n, 4), _jordan(n, 2), _rand(n, 5)])
    if with_b:
        G = _rand(n, 9)
        B = np.eye(n) + 0.05 * (G + G.conj().T) / np.sqrt(n)
        A = B[None] @ A
        args = (torch.as_tensor(A), torch.as_tensor(np.stack([B] * 3)))
        fn = teig._gen_eig_flagged
    else:
        args = (torch.as_tensor(A),)
        fn = teig._eig_flagged
    lam, V, ok = fn(*args)
    assert ok.shape == (3,) and ok.tolist() == [True, False, True]
    for s in range(3):
        lam1, V1, ok1 = fn(*(a[s] for a in args))
        assert bool(ok1) == bool(ok[s])
        assert _rel(lam[s], lam1) <= 1e-13 and _rel(V[s], V1) <= 1e-13


def _program(A, B, m0=10, seed=0, mixed=True, iters=20):
    """A `_SlicedProgram` without graphs, loaded with three slices of
    (0.5, 12.5) and seeded start blocks."""
    n = A.shape[0]
    contours = [ft.circular_contour_trapezoidal(c, 2.0, 8) for c in (2.5, 6.5, 10.5)]
    dt = torch.complex128
    z = torch.stack([k.device_nodes(dt, "cpu") for k in contours])
    w = torch.stack([k.device_weights(dt, "cpu") for k in contours])
    rng = np.random.default_rng(seed)
    Q = torch.as_tensor(rng.standard_normal((3, n, m0)) + 1j * rng.standard_normal((3, n, m0)))
    At, Bt = torch.as_tensor(A), None if B is None else torch.as_tensor(B)
    prog = tsl._SlicedProgram(False, torch.device("cpu"), S=3, N=8, n=n,
                              solve_dtype=torch.complex64 if mixed else dt, tol=1e-10,
                              iters=iters, mixed_eig=teig._mixed_route(dt, m0, torch.device("cpu")))
    prog.factor(At, Bt, z)
    geom = torch.tensor([k.params for k in contours], dtype=torch.float64).T[..., None]
    prog.load(At, Bt, Q, z, w, geom.contiguous())
    return prog


@pytest.mark.parametrize("with_b", [False, True], ids=["std", "pencil"])
def test_batched_steps_read_nothing_on_the_host(no_host_reads, forced_mixed, with_b):
    """Both steps of a batched sweep, the flagged mixed eig included (the
    card's route), run with every host read patched to raise: the CPU's
    proxy for capture.  The status is (2, S)."""
    A, B = _hermitian()
    prog = _program(A, B if with_b else None)
    assert prog.mixed_eig
    prog.buf["it"].zero_()
    prog.buf["done"].zero_()
    no_host_reads.on = True
    for _ in range(2):
        out = prog._rr()
        prog._update()
    no_host_reads.on = False
    assert out["status"].shape == (2, 3) and out["status"].dtype == torch.int32
    assert prog.buf["it"].tolist() == [2, 2, 2]
    assert torch.isfinite(torch.view_as_real(prog.buf["Q"])).all()


def _slices_equal(a, b, tol=1e-10, rtol=0.0):
    """Per slice: the same n_iter and convergence, the inside eigenvalues
    within tol and their residuals within tol (plus rtol relative)."""
    assert len(a.per_slice) == len(b.per_slice)
    for x, y in zip(a.per_slice, b.per_slice):
        assert x.n_iter == int(y.n_iter) and x.converged == bool(y.converged)
        lx, _, rx = x.filtered()
        ly, _, ry = y.filtered()
        assert len(lx) == len(ly)
        ox, oy = np.argsort(lx.real), np.argsort(ly.real)
        np.testing.assert_allclose(lx[ox], ly[oy], rtol=0, atol=tol)
        np.testing.assert_allclose(rx[ox], ry[oy], rtol=rtol, atol=tol)


def _held_to_eigh(out, A, B, interval, tol=1e-10):
    """Where the JAX package has no counterpart: every slice converged, the
    merged eigenvalues scipy's of the pencil inside the interval to 1e-10,
    every residual below tol."""
    w = sla.eigh(A, B, eigvals_only=True)
    assert all(r.converged for r in out.per_slice)
    np.testing.assert_allclose(np.sort(out.lam.real), w[(w > interval[0]) & (w < interval[1])],
                               rtol=0, atol=1e-10)
    assert out.res.max() < tol


@pytest.mark.parametrize("mixed", [False, True], ids=["full", "mixed"])
@pytest.mark.parametrize("with_b", [False, True], ids=["std", "pencil"])
def test_steps_match_jax(mixed, with_b):
    """Full precision against the JAX package's `feast_sliced_parallel` on
    the same inputs; mixed_prec, which it lacks, against scipy's eigh."""
    A, B = _hermitian()
    kw = dict(nodes=8, iters=20, tol=1e-10)
    Bx = B if with_b else None
    steps = tsl._feast_sliced_parallel_steps(A, (0.5, 12.5), 3, Bx, mixed_prec=mixed,
                                             device="cpu", **kw)
    prog = next(iter(tfeast._PROGRAMS.values()))
    assert isinstance(prog, tsl._SlicedProgram) and not prog.graphs
    assert prog.sweeps == max(r.n_iter for r in steps.per_slice)
    tfeast.clear_graph_cache()
    _held_to_eigh(steps, A, Bx, (0.5, 12.5))
    if not mixed:
        _slices_equal(steps, jt.parallel.feast_sliced_parallel(A, (0.5, 12.5), 3, Bx, **kw))


@pytest.mark.parametrize("with_b", [False, True], ids=["std", "pencil"])
def test_steps_fall_back_per_slice(forced_mixed, monkeypatch, with_b):
    """With the card's mixed eig route and every guard forced to fail, each
    active slice reruns its Rayleigh-Ritz with the full eig in every sweep
    (JAX's lax.cond), one fallback per slice and sweep: the sweeps and
    results of the program without the mixed route, bit for bit, and
    scipy's eigenvalues."""
    def failing(flagged):
        return lambda *a: (lambda lam, V, ok: (lam, V, ok & False))(*flagged(*a))

    monkeypatch.setattr(teig, "_eig_flagged", failing(teig._eig_flagged))
    monkeypatch.setattr(teig, "_gen_eig_flagged", failing(teig._gen_eig_flagged))
    A, B = _hermitian()
    kw = dict(nodes=8, iters=20, tol=1e-10, mixed_prec=True, device="cpu")
    Bx = B if with_b else None
    steps = tsl._feast_sliced_parallel_steps(A, (0.5, 12.5), 3, Bx, **kw)
    prog = next(iter(tfeast._PROGRAMS.values()))
    assert prog.mixed_eig and prog.fallbacks == sum(r.n_iter for r in steps.per_slice)
    monkeypatch.undo()
    tfeast.clear_graph_cache()     # the route is no part of the program's key
    full = tsl._feast_sliced_parallel_steps(A, (0.5, 12.5), 3, Bx, **kw)
    assert not next(iter(tfeast._PROGRAMS.values())).mixed_eig
    tfeast.clear_graph_cache()
    _slices_equal(steps, full, tol=0)
    _held_to_eigh(steps, A, Bx, (0.5, 12.5))


def test_steps_match_jax_where_a_slice_runs_to_its_cap():
    """Two slices of the tie problem at m0 = 13: (0.5, 10.5) converges,
    (10.5, 20.5) parks its spurious value and runs to the cap (31 sweeps);
    the converged slice keeps its state while the other runs on.  Per
    slice the JAX package's sweeps and pairs, the spurious one too."""
    H = _tie_problem(1)
    kw = dict(nodes=8, iters=30, tol=1e-10, m0=13, seed=1)
    steps = tsl._feast_sliced_parallel_steps(H, (0.5, 20.5), 2, device="cpu", **kw)
    tfeast.clear_graph_cache()
    assert [r.converged for r in steps.per_slice] == [True, False]
    assert steps.per_slice[1].n_iter == 31 and steps.per_slice[0].n_iter < 31
    _slices_equal(steps, jt.parallel.feast_sliced_parallel(H, (0.5, 20.5), 2, **kw),
                  rtol=1e-8)
    w = np.linalg.eigvalsh(H)
    np.testing.assert_allclose(np.sort(steps.lam.real), w[(w > 0.5) & (w < 20.5)],
                               atol=1e-10)


def test_steps_match_jax_sliced_parallel():
    """Four slices of laplacian_1d(120) over (0, 0.2) against the JAX
    package's vmapped while_loop: the same sweeps per slice and the same
    eigenvalues to 1e-10 (the JAX program compiles for several seconds)."""
    L = jt.problems.laplacian_1d(120)
    kw = dict(nodes=8, iters=25, tol=1e-12)
    t0 = time.perf_counter()
    ref = jt.parallel.feast_sliced_parallel(L, (0.0, 0.2), 4, **kw)
    t1 = time.perf_counter()
    out = tsl._feast_sliced_parallel_steps(L, (0.0, 0.2), 4, device="cpu", **kw)
    tfeast.clear_graph_cache()
    print(f"JAX {t1 - t0:.1f} s, the port's steps {time.perf_counter() - t1:.1f} s")
    assert [r.n_iter for r in out.per_slice] == [int(r.n_iter) for r in ref.per_slice]
    np.testing.assert_allclose(np.sort(out.lam.real), np.sort(ref.lam.real), atol=1e-10)
    exact = 2 - 2 * np.cos(np.arange(1, 121) * np.pi / 121)
    np.testing.assert_allclose(np.sort(out.lam.real), exact[exact < 0.2], atol=1e-10)


def test_cached_program_solves_a_new_interval():
    """A second interval of the same shape (slices, m0, nodes) reuses the
    cached program and gets its own eigenvalues, a fresh program's bit for
    bit and scipy's: the circles, nodes and weights are buffer contents,
    nothing of them is baked into the steps."""
    A, _ = _hermitian()
    kw = dict(nodes=8, iters=20, tol=1e-10, m0=10, mixed_prec=True, device="cpu")
    tfeast.clear_graph_cache()
    first = tsl._feast_sliced_parallel_steps(A, (0.5, 12.5), 3, **kw)
    prog = next(iter(tfeast._PROGRAMS.values()))
    second = tsl._feast_sliced_parallel_steps(A, (20.5, 32.5), 3, **kw)
    assert len(tfeast._PROGRAMS) == 1 and next(iter(tfeast._PROGRAMS.values())) is prog
    assert np.all(second.lam.real > 20.5) and np.all(first.lam.real < 12.5)
    tfeast.clear_graph_cache()
    _slices_equal(second, tsl._feast_sliced_parallel_steps(A, (20.5, 32.5), 3, **kw), tol=0)
    _held_to_eigh(second, A, None, (20.5, 32.5))
    tfeast.clear_graph_cache()


def test_one_program_cache_for_both_drivers():
    """The card holds one program: a sliced call frees `feast_compiled`'s,
    and the reverse; `clear_graph_cache` frees either.  On the CPU the
    public driver caches its program without graphs and gives the steps'
    bits."""
    A, _ = _hermitian()
    rng = np.random.default_rng(0)
    X0 = rng.standard_normal((60, 8)) + 1j * rng.standard_normal((60, 8))
    kw = dict(nodes=8, iters=20, tol=1e-10, mixed_prec=True, device="cpu")
    tfeast.clear_graph_cache()
    res = ft.parallel.feast_sliced_parallel(A, (0.5, 12.5), 3, **kw)
    ((key, prog),) = tfeast._PROGRAMS.items()
    assert isinstance(prog, tsl._SlicedProgram) and not prog.graphs
    steps = tsl._feast_sliced_parallel_steps(A, (0.5, 12.5), 3, **kw)
    assert list(tfeast._PROGRAMS) == [key] and np.array_equal(res.lam, steps.lam)
    tfeast._feast_compiled_steps(A, X0, c=3.5, r=2.2, **kw)
    assert isinstance(next(iter(tfeast._PROGRAMS.values())), tfeast._SweepProgram)
    tsl._feast_sliced_parallel_steps(A, (0.5, 12.5), 3, **kw)
    assert len(tfeast._PROGRAMS) == 1
    assert isinstance(next(iter(tfeast._PROGRAMS.values())), tsl._SlicedProgram)
    tfeast._feast_compiled_steps(A, X0, c=3.5, r=2.2, **kw)
    assert isinstance(next(iter(tfeast._PROGRAMS.values())), tfeast._SweepProgram)
    ft.solvers.clear_graph_cache()
    assert tfeast._PROGRAMS == {}


def test_factor_goes_into_the_program_store():
    """The program factors the S x nodes matrices in its own store (no
    second copy): the LU the steps read is a view of it, and equals
    `_factor_scan`'s bit for bit."""
    A, B = _hermitian()
    prog = _program(A, B, mixed=True)
    store = prog.buf["store"]
    assert prog.buf["LUb"].data_ptr() == store.data_ptr()
    z = prog.buf["z"].reshape(-1)
    LU, perm, dinv = tfeast._factor_scan(torch.as_tensor(A), torch.as_tensor(B), z, True)
    assert torch.equal(prog.buf["LUb"], LU) and torch.equal(prog.buf["permb"], perm)
    assert torch.equal(prog.buf["invL"], dinv[0]) and torch.equal(prog.buf["invU"], dinv[1])


def test_factor_into_a_reused_padded_store(monkeypatch):
    """The card's zero-padded factor route (n not a multiple of 128, here
    forced on the CPU with the panel kernel's plain version): a store
    factored twice gives the second pencil's factor, equal to a fresh
    `_factor_scan`; the first factor leaves the padding zero."""
    tlu = importlib.import_module("feast_tpu_torch.ops.lu")
    monkeypatch.setattr(tlu, "_kernel_route", lambda dtype, device: dtype == torch.complex64)
    A, B = _hermitian(n=60)
    z = ft.circular_contour_trapezoidal(6.5, 2.0, 4).device_nodes(torch.complex128, "cpu")
    At, Bt = torch.as_tensor(A), torch.as_tensor(B)
    store = tlu.factor_buffer((4,), 60, torch.complex64, "cpu")
    assert store.shape == (4, 128, 128)
    tfeast._factor_into(store, At + 3.0, Bt, z)
    assert not store[:, 60:].any() and not store[:, :, 60:].any()
    LU, perm, dinv = tfeast._factor_into(store, At, Bt, z)
    ref = tfeast._factor_scan(At, Bt, z, True)
    assert torch.equal(LU, ref[0]) and torch.equal(perm, ref[1])
    assert all(torch.equal(a, b) for a, b in zip(dinv, ref[2]))


def test_program_factor_records_the_factor_spans():
    """The sliced program's factor records `_factor_scan`'s inner spans:
    forming, LU and the diagonal-block inverses of its S x nodes
    matrices, one each."""
    from feast_tpu_torch.utils import tracing

    A, B = _hermitian()
    tracing.clear()
    try:
        with tracing.recording():
            _program(A, B)
        recs = tracing.spans()
    finally:
        tracing.clear()
    assert sorted(r["name"] for r in recs) == ["feast.factor.diag_inv", "feast.factor.form",
                                               "feast.factor.lu"]
    (inv,) = [r for r in recs if r["name"] == "feast.factor.diag_inv"]
    assert inv["attrs"]["blocks"] == 3 * 8
