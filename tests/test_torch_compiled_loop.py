"""`feast_compiled`'s single-program loop on the CPU: the sweep steps read
nothing on the host, the eig guard's flag forms agree with the boolean
`eig` / `gen_eig` and with the JAX package's guard, the step driver matches
JAX's `feast_compiled` on the same inputs (eigenvalues and residuals to
1e-10, the same n_iter and convergence), a cached program reads each
solve's inputs, and the options outside the graphs' scope run the same
program eagerly.

On the card the steps are captured as CUDA graphs; here the same steps,
static buffers and cache run eagerly (`_feast_compiled_steps`, which the
public driver is on the CPU), and the patched Tensor methods stand for the
capture: a host read raises.
"""

import gc
import importlib
import inspect
import sys
import weakref
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import feast_tpu as jt
import feast_tpu_torch as ft
from feast_tpu import cx as jcx
from feast_tpu.ops import eig as jeig
from feast_tpu_torch import cx
from feast_tpu_torch.kernels import _build

tfeast = importlib.import_module("feast_tpu_torch.solvers.feast")
teig = importlib.import_module("feast_tpu_torch.ops.eig")
tlu = importlib.import_module("feast_tpu_torch.ops.lu")

torch.set_num_threads(2)

HOST_READS = ("__bool__", "__float__", "__int__", "__index__", "__complex__",
              "item", "tolist", "cpu", "numpy")


def _rand(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))


def _problem(n=40, m0=8, seed=0):
    """diag(1..n) + 0.05 complex noise, X0, and B = I + a small Hermitian
    perturbation."""
    rng = np.random.default_rng(seed)
    A = np.diag(np.arange(1.0, n + 1.0)).astype(np.complex128)
    A += 0.05 * (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    X0 = rng.standard_normal((n, m0)) + 1j * rng.standard_normal((n, m0))
    G = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    B = np.eye(n) + 0.01 * (G + G.conj().T) / np.sqrt(n)
    return A, X0, B


def _jordan(n=48, seed=2):
    """S J S^-1 with a 3 x 3 Jordan block at 11: a defective cluster."""
    J = np.diag(np.arange(1.0, n + 1.0)).astype(np.complex128)
    J[10, 10] = J[11, 11] = J[12, 12] = 11.0
    J[10, 11] = J[11, 12] = 1.0
    S = _rand(n, seed)
    return S @ J @ np.linalg.inv(S)


@pytest.fixture
def forced_mixed(monkeypatch):
    """The mixed eig route on the CPU (the card's route for complex128)."""
    monkeypatch.setattr(teig, "_mixed_route",
                        lambda dtype, n, device: (teig._EIG_MODE == "mixed"
                                                  and dtype == torch.complex128
                                                  and 2 <= n <= 128))


class _HostReads:
    """Tensor methods that read a value on the host raise while `forbid` is
    on; `allow()` lifts the ban around a stand-in for one kernel launch."""

    def __init__(self, monkeypatch):
        self.on = True
        for name in HOST_READS:
            orig = getattr(torch.Tensor, name)
            monkeypatch.setattr(torch.Tensor, name, self._guard(name, orig))

    def _guard(self, name, orig):
        def method(t, *a, **k):
            if self.on:
                raise AssertionError(f"host read: Tensor.{name}")
            return orig(t, *a, **k)
        return method

    def allow(self, fn):
        def run(*a, **k):
            self.on = False
            try:
                return fn(*a, **k)
            finally:
                self.on = True
        return run


@pytest.fixture
def no_host_reads(monkeypatch):
    """Forbid host reads; the complex64 Schur, one K2 launch on the card and
    the plain host-stepped iteration here, may read."""
    reads = _HostReads(monkeypatch)
    monkeypatch.setattr(teig, "_schur_vecs32", reads.allow(teig._schur_vecs32))
    monkeypatch.setattr(teig, "schur", reads.allow(teig.schur))
    reads.on = False
    yield reads
    reads.on = False


def _factor(A, B, z, mixed):
    return tfeast._factor_scan(A, B, z, mixed)


@pytest.mark.parametrize("with_b", [False, True], ids=["std", "pencil"])
def test_steps_read_nothing_on_the_host(no_host_reads, forced_mixed, with_b):
    """Both steps of both tiers, and the coarse stop rule, run on CPU tensors
    with every host read patched to raise: the CPU's proxy for capture."""
    A, X0, B = _problem()
    A, X0 = torch.as_tensor(A), torch.as_tensor(X0)
    B = torch.as_tensor(B) if with_b else None
    contour = ft.circular_contour_trapezoidal(3.5, 2.2, 8)
    z, w = contour.device_nodes(torch.complex128, "cpu"), contour.device_weights(
        torch.complex128, "cpu")
    LUb, permb, dinvb = _factor(A, B, z, True)
    f32 = torch.complex64
    A32, B32 = A.to(f32), None if B is None else B.to(f32)
    floor32 = tfeast._coarse_floor(A32)
    prev = torch.tensor(np.inf, dtype=torch.float64)
    kind, params = contour.kind, contour.params
    no_host_reads.on = True
    # the complex64 tier: Rayleigh-Ritz, the stop rule, the plain solves
    Qo, _, _, lam, X, R, _, inside, worst, ok = tfeast._rr_step(
        X0.to(f32), A32, B32, "cholqr2", kind, params, False)
    for it in (0, 1, 2):
        stop = tfeast._coarse_stop(worst, inside, prev, torch.tensor(it), floor32)
    Qc = tfeast._node_update_scan(LUb, permb, z.to(f32), w.to(f32), X, R, lam, None,
                                  A32, B32, refine=0, dinvb=dinvb)
    status = tfeast._status(stop, ok)
    # the complex128 tier, with the flagged mixed eig (the card's route)
    _, _, _, lam, X, R, res, inside, worst, ok = tfeast._rr_step(
        Qc.to(torch.complex128), A, B, "cholqr2", kind, params, True)
    done = inside.any() & (worst < 1e-10)
    Q = tfeast._node_update_scan(LUb, permb, z, w, X, R, lam, torch.complex64, A, B,
                                 dinvb=dinvb)
    status = tfeast._status(done, ok)
    no_host_reads.on = False
    assert Q.shape == X0.shape and torch.isfinite(torch.view_as_real(Q)).all()
    assert status.dtype == torch.int32 and status.shape == (2,)


def _jax_guard(A, lam, V, B=None):
    """The JAX package's acceptance of a mixed eig on the same (lam, V):
    the residual bound of feast_tpu/ops/eig.py:498-505 (:560-567 for a
    pencil) and `_indep_ok` (:434)."""
    n = A.shape[0]
    Aj, Vj, lj = jcx.from_numpy(A), jcx.from_numpy(V), jcx.from_numpy(lam)
    if B is None:
        R = jcx.cmatmul(Aj, Vj) - jcx.scale_cols(Vj, lj)
        scale = max(float(jcx.fro_norm(Aj)), 1.0)
    else:
        Bj = jcx.from_numpy(B)
        R = jcx.cmatmul(Aj, Vj) - jcx.scale_cols(jcx.cmatmul(Bj, Vj), lj)
        scale = max(float(jcx.fro_norm(Aj))
                    + float(np.max(np.asarray(jcx.cabs(lj)))) * float(jcx.fro_norm(Bj)), 1.0)
    ok = float(np.max(np.asarray(jcx.col_norms(R)))) <= 1e-12 * scale * float(n) ** 0.5
    return bool(ok and bool(jeig._indep_ok(Vj)))


@pytest.mark.parametrize("case", ["random1", "random2", "random3", "jordan"])
def test_eig_flag_form_matches_eig_and_jax(forced_mixed, case):
    """`_eig_flagged`'s ok is `eig`'s decision (mixed pair when true, the
    full path when false) and the JAX package's guard on the same V; the
    defective cluster fails it."""
    A = _jordan() if case == "jordan" else _rand(48, int(case[-1]))
    At = torch.as_tensor(A)
    lam, V, ok = teig._eig_flagged(At)
    assert ok.dim() == 0 and ok.dtype == torch.bool
    assert bool(ok) == (case != "jordan")
    w, Vw = teig.eig(At)
    want = (lam, V) if bool(ok) else teig._eig_full(At)
    assert torch.equal(w, want[0]) and torch.equal(Vw, want[1])
    assert _jax_guard(A, lam.numpy(), V.numpy()) == bool(ok)


@pytest.mark.parametrize("case", ["random4", "random5", "jordan"])
def test_gen_eig_flag_form_matches_gen_eig_and_jax(forced_mixed, case):
    """`_gen_eig_flagged` against `gen_eig`'s decision and JAX's pencil
    guard, B Hermitian positive definite."""
    A = _jordan(seed=6) if case == "jordan" else _rand(48, int(case[-1]))
    G = _rand(48, 9)
    B = np.eye(48) + 0.05 * (G + G.conj().T) / np.sqrt(48)
    At, Bt = torch.as_tensor(B @ A), torch.as_tensor(B)
    lam, V, ok = teig._gen_eig_flagged(At, Bt)
    assert bool(ok) == (case != "jordan")
    w, Vw = teig.gen_eig(At, Bt)
    want = (lam, V) if bool(ok) else teig._gen_eig_full(At, Bt)
    assert torch.equal(w, want[0]) and torch.equal(Vw, want[1])
    assert _jax_guard(B @ A, lam.numpy(), V.numpy(), B) == bool(ok)


def test_independence_flag_matches_jax():
    """Two equal unit columns fail `_indep_flag` as they fail JAX's
    `_indep_ok`; orthonormal ones pass both."""
    Q, _ = np.linalg.qr(_rand(12, 7)[:, :5])
    dup = Q.copy()
    dup[:, 3] = dup[:, 1]
    for V, want in ((Q, True), (dup, False)):
        got = teig._indep_flag(torch.as_tensor(V))
        assert got.dim() == 0 and bool(got) == want
        assert bool(jeig._indep_ok(jcx.from_numpy(V))) == want


def _same(a, b):
    return (a.n_iter == b.n_iter and a.converged == b.converged
            and all(torch.equal(x, y) for x, y in zip(a[:4], b[:4])))


def _contour(pkg, kind):
    return (pkg.circular_contour_trapezoidal(3.5, 2.2, 8) if kind == "circle"
            else pkg.elliptical_contour_trapezoidal(3.5, 2.2, 1.0, 8))


def _jax_run(contour="circle", with_b=True, mixed=True, two_tier=None, shift=0.0,
             pencil="lu"):
    """JAX's `feast_compiled` on `_problem()` (A shifted by shift I); a
    configuration compiles once in this module."""
    A, X0, B = _problem()
    return jt.feast_compiled(A + shift * np.eye(A.shape[0]), X0, _contour(jt, contour),
                             B=B if with_b else None, nodes=8, iters=20, tol=1e-10,
                             mixed_prec=mixed, two_tier=two_tier, pencil=pencil)


def _matches_jax(rt, rj):
    """The same n_iter and convergence; the inside eigenvalues and their
    residuals within 1e-10."""
    assert rt.n_iter == int(rj.n_iter) and rt.converged == bool(rj.converged)
    lt, _, rest = rt.filtered()
    lj, _, resj = rj.filtered()
    assert len(lt) == len(lj)
    ot, oj = np.argsort(lt.real), np.argsort(lj.real)
    np.testing.assert_allclose(lt[ot], lj[oj], rtol=0, atol=1e-10)
    np.testing.assert_allclose(rest[ot], resj[oj], rtol=0, atol=1e-10)


@pytest.mark.parametrize("contour", ["circle", "ellipse"])
@pytest.mark.parametrize("with_b", [False, True], ids=["std", "pencil"])
@pytest.mark.parametrize("mixed,two_tier", [(False, None), (True, False), (True, None)],
                         ids=["full", "mixed", "two_tier"])
def test_step_driver_matches_jax(mixed, two_tier, with_b, contour):
    A, X0, B = _problem()
    steps = tfeast._feast_compiled_steps(A, X0, _contour(ft, contour), nodes=8, iters=20,
                                         tol=1e-10, mixed_prec=mixed, two_tier=two_tier,
                                         B=B if with_b else None, device="cpu")
    assert steps.converged and int(steps.inside.sum()) == 4
    _matches_jax(steps, _jax_run(contour, with_b, mixed, two_tier))
    prog = next(iter(tfeast._PROGRAMS.values()))
    assert not prog.graphs
    if mixed and two_tier is None:
        assert "coarse_update" in prog.steps      # the coarse tier refined
    tfeast.clear_graph_cache()


@pytest.mark.parametrize("with_b", [False, True], ids=["std", "pencil"])
def test_step_driver_matches_jax_on_the_mixed_eig(forced_mixed, monkeypatch, with_b):
    """With the card's mixed eig route the driver's flag forms decide as
    `eig` does and match JAX; where every guard is forced to fail, every
    sweep takes the full eig and equals the program without the mixed
    route bit for bit."""
    A, X0, B = _problem()
    kw = dict(c=3.5, r=2.2, nodes=8, iters=20, tol=1e-10, mixed_prec=True,
              B=B if with_b else None, device="cpu")
    steps = tfeast._feast_compiled_steps(A, X0, **kw)
    assert next(iter(tfeast._PROGRAMS.values())).mixed_eig
    assert steps.converged
    _matches_jax(steps, _jax_run(with_b=with_b))

    def failing(flagged):
        return lambda *a: (lambda lam, V, ok: (lam, V, ok & False))(*flagged(*a))

    monkeypatch.setattr(teig, "_eig_flagged", failing(teig._eig_flagged))
    monkeypatch.setattr(teig, "_gen_eig_flagged", failing(teig._gen_eig_flagged))
    steps_fb = tfeast._feast_compiled_steps(A, X0, **kw)
    monkeypatch.undo()
    tfeast.clear_graph_cache()     # the route is no part of the program's key
    full = tfeast._feast_compiled_steps(A, X0, **kw)
    assert not next(iter(tfeast._PROGRAMS.values())).mixed_eig
    assert _same(steps_fb, full)
    _matches_jax(steps_fb, _jax_run(with_b=with_b))
    tfeast.clear_graph_cache()


def test_step_driver_matches_jax_on_a_pencil():
    n, m0 = 256, 16
    A, X0, B = _problem(n, m0)
    kw = dict(c=5.5 + 0j, r=5.2, nodes=16, iters=20, tol=1e-10, mixed_prec=True)
    rj = jt.feast_compiled(A, X0, B=B, **kw)
    rt = tfeast._feast_compiled_steps(A, X0, B=B, device="cpu", **kw)
    tfeast.clear_graph_cache()
    assert rj.converged and rt.converged
    assert abs(rt.n_iter - int(rj.n_iter)) <= 1
    lj, _, _ = rj.filtered()
    lt, Xt, rest = rt.filtered()
    assert len(lt) == len(lj) == 10
    np.testing.assert_allclose(np.sort_complex(lt), np.sort_complex(lj), rtol=0, atol=1e-10)
    assert rest.max() < 1e-10
    assert np.linalg.norm(A @ Xt - (B @ Xt) * lt[None, :], axis=0).max() < 1e-10


def test_cached_program_reads_new_values():
    """A second matrix of the same shape reuses the cached program and gets
    its own answer: a fresh program's bit for bit, and JAX's."""
    A, X0, B = _problem()
    kw = dict(c=3.5, r=2.2, nodes=8, iters=20, tol=1e-10, mixed_prec=True, B=B,
              device="cpu")
    tfeast.clear_graph_cache()
    first = tfeast._feast_compiled_steps(A, X0, **kw)
    prog = next(iter(tfeast._PROGRAMS.values()))
    A2 = A + 0.25 * np.eye(A.shape[0])
    second = tfeast._feast_compiled_steps(A2, X0, **kw)
    assert next(iter(tfeast._PROGRAMS.values())) is prog and len(tfeast._PROGRAMS) == 1
    assert not torch.equal(first.lam, second.lam)
    _matches_jax(second, _jax_run(shift=0.25))
    # the result does not alias the program's buffers
    lam = second.lam.clone()
    tfeast._feast_compiled_steps(A, X0, **kw)
    assert torch.equal(second.lam, lam)
    tfeast.clear_graph_cache()
    assert _same(second, tfeast._feast_compiled_steps(A2, X0, **kw))
    tfeast.clear_graph_cache()


def test_dropped_program_is_freed_at_once():
    """The cache drops a program without the cyclic collector: on the card a
    program collected later, in the middle of another capture, would
    destroy its graphs there and invalidate that capture."""
    A, X0, _ = _problem()
    tfeast._feast_compiled_steps(A, X0, c=3.5, r=2.2, nodes=8, mixed_prec=True,
                                 device="cpu")
    gc.disable()
    try:
        ref = weakref.ref(next(iter(tfeast._PROGRAMS.values())))
        tfeast.clear_graph_cache()
        assert ref() is None
    finally:
        gc.enable()


def test_cache_keeps_the_newest_signature_and_its_switches():
    A, X0, _ = _problem()
    kw = dict(c=3.5, r=2.2, nodes=8, iters=20, tol=1e-10, mixed_prec=True, device="cpu")
    tfeast._feast_compiled_steps(A, X0, **kw)
    key = next(iter(tfeast._PROGRAMS))
    tfeast._feast_compiled_steps(A, X0, ortho="cholqr3", **kw)
    assert len(tfeast._PROGRAMS) == 1 and next(iter(tfeast._PROGRAMS)) != key
    keys = set()
    for mod, setter, names in ((teig, teig.set_schur_backend, ("cuda", "torch")),
                               (teig, teig.set_eig_mode, ("mixed", "full")),
                               (cx, cx.set_gemm_backend, ("torch", "cuda")),
                               (tlu, tlu.set_panel_backend, ("pallas", "xla"))):
        for name in names:
            setter(name)
            try:
                keys.add(tfeast._program_key(torch.zeros(4, 4), None, torch.zeros(4, 2),
                                             torch.zeros(8), SimpleNamespace(
                                                 kind="circle", params=(0.0, 0.0, 1.0)),
                                             10, 1e-10, "cholqr2", True, True, "lu",
                                             True))
            finally:
                setter(names[0])
    assert len(keys) == 5
    tfeast.clear_graph_cache()
    assert tfeast._PROGRAMS == {}


@pytest.mark.parametrize("opts,graphs", [
    (dict(), True),
    (dict(device="cpu"), False),
    (dict(mesh=object()), True),
    (dict(pencil="qz"), False),
    (dict(pencil="hermitian"), False),
    (dict(m0=1), False),
    (dict(m0=129), False),
    (dict(eig_mode="full"), False),
    (dict(schur="torch"), False),
    (dict(sliced=True, m0=42), True),
    (dict(sliced=True, device="cpu"), False),
    (dict(sliced=True, mesh=object()), True),
    (dict(sliced=True, m0=129), False),
    (dict(sliced=True, eig_mode="full"), False),
    (dict(sliced=True, schur="torch"), False),
], ids=["headline", "cpu", "mesh", "qz", "hermitian", "m0_1", "m0_129", "eig_full",
        "schur_torch", "sliced", "sliced_cpu", "sliced_slice_mesh", "sliced_m0_129",
        "sliced_eig_full", "sliced_schur_torch"])
def test_scope_rule(opts, graphs):
    """Which options the graphs take on the card, and which run the steps
    eagerly, for `feast_compiled` and for `feast_sliced_parallel` (the same
    rule at pencil "lu").  A mesh is no reason to run them eagerly: the
    rule takes none (the node sum's all-reduce is captured; a "slice" mesh
    runs no collective inside the loop)."""
    sliced = importlib.import_module("feast_tpu_torch.parallel.slicing")
    assert sliced._graph_scope is tfeast._graph_scope
    assert list(inspect.signature(tfeast._graph_scope).parameters) == ["device", "m0",
                                                                        "pencil"]
    teig.set_eig_mode(opts.get("eig_mode", "mixed"))
    teig.set_schur_backend(opts.get("schur", "cuda"))
    try:
        why = tfeast._graph_scope(torch.device(opts.get("device", "cuda")),
                                  opts.get("m0", 48),
                                  "lu" if opts.get("sliced") else opts.get("pencil", "lu"))
    finally:
        teig.set_eig_mode("mixed")
        teig.set_schur_backend("cuda")
    assert (why is None) == graphs


def test_cpu_and_outside_options_run_the_eager_program():
    """On the CPU the public driver runs the sweep program eagerly, with the
    options outside the graphs' scope too: pencil "qz" (held to JAX's
    `feast_compiled(pencil="qz")`), "hermitian" (to scipy's eigh of the
    Hermitian pencil) and eig mode "full" (to JAX's default pencil)."""
    import scipy.linalg as sla

    A, X0, B = _problem()
    H = (A + A.conj().T) / 2
    kw = dict(c=3.5, r=2.2, nodes=8, iters=20, tol=1e-10, mixed_prec=True, B=B,
              device="cpu")
    cases = (("lu", A, {}, "mixed"), ("qz", A, dict(pencil="qz"), "mixed"),
             ("hermitian", H, dict(hermitian=True), "mixed"), ("lu", A, {}, "full"))
    keys = set()
    for pencil, M, opts, mode in cases:
        tfeast.clear_graph_cache()
        teig.set_eig_mode(mode)
        try:
            res = ft.feast_compiled(M, X0, **kw, **opts)
        finally:
            teig.set_eig_mode("mixed")
        ((key, prog),) = tfeast._PROGRAMS.items()
        keys.add(key)
        assert isinstance(prog, tfeast._SweepProgram) and not prog.graphs
        assert prog.pencil == pencil and not prog.mixed_eig
        assert prog.sweeps[0] > 0 and res.converged
        if pencil == "hermitian":
            w = sla.eigh(H, B, eigvals_only=True)
            lam, X, r = res.filtered()
            np.testing.assert_allclose(np.sort(lam.real), w[np.abs(w - 3.5) <= 2.2],
                                       rtol=0, atol=1e-10)
            assert np.abs(lam.imag).max() == 0 and r.max() < 1e-10
            assert np.linalg.norm(H @ X - (B @ X) * lam[None, :], axis=0).max() < 1e-10
        else:
            _matches_jax(res, _jax_run(pencil=pencil))
    assert len(keys) == len(cases)
    tfeast.clear_graph_cache()


def test_graph_launch_tally():
    """Inside `tally_launches` a wrapper's launch goes into the graph's
    tally; each replay adds the tally to the counter."""
    mod = SimpleNamespace(launches=0)
    sys.modules["_tally_probe"] = mod
    try:
        _build.count_launch("_tally_probe")
        with _build.tally_launches() as tally:
            _build.count_launch("_tally_probe")
            _build.count_launch("_tally_probe")
        assert mod.launches == 1 and tally == {"_tally_probe": 2}
        for _ in range(3):
            _build.add_launches(tally)
        assert mod.launches == 7
    finally:
        del sys.modules["_tally_probe"]
