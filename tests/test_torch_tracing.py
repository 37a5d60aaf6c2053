"""The solvers' spans (`feast_tpu_torch/utils/tracing.py`) on the CPU.

The span tree of `feast_compiled` (its sweep program's steps, run eagerly
here, with and without the complex64 tier) and of `nlfeast`, the per-tier sweep counts against the result's
n_iter, the Jacobi sweeps against a direct count, that spans off record
nothing and that no mode of recording changes a result, and that the
profiler alone turns spans on, its "span.<name>" ranges on the records'
clock.  Small sizes, torch and the port only."""

import collections
import importlib
import inspect

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import feast_tpu_torch as ft
from feast_tpu_torch import cx
from feast_tpu_torch.ops import svd as svdmod
from feast_tpu_torch.utils import tracing

fmod = importlib.import_module("feast_tpu_torch.solvers.feast")
nlmod = importlib.import_module("feast_tpu_torch.solvers.nlfeast")

DENSE_KW = dict(c=1.5, r=2.0, nodes=8, tol=1e-12, mixed_prec=True, device="cpu")
GUN_KW = dict(nodes=16, c=53.0, r=5.0, tol=1e-10, mixed_prec=True, store=False,
              device="cpu")


@pytest.fixture(autouse=True)
def fresh():
    tracing.clear()
    yield
    tracing.clear()


def dense_problem(n=25, m0=5):
    rng = np.random.default_rng(0)
    A = np.diag(np.arange(1.0, n + 1.0)).astype(complex)
    X0 = rng.standard_normal((n, m0)) + 1j * rng.standard_normal((n, m0))
    return A, X0


@pytest.fixture(scope="module")
def gun():
    T = ft.problems.gun_like(96, planted=8, cluster=(50.0, 56.0), device="cpu")
    rng = np.random.default_rng(3)
    return T, rng.standard_normal((96, 20)) + 1j * rng.standard_normal((96, 20))


def check_tree(recs, root: str) -> dict:
    """Every record's parent is recorded and shares its solve id; one root
    a solve, whose id is the solve id.  Returns {id: record}."""
    by_id = {r["id"]: r for r in recs}
    assert len(by_id) == len(recs)
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == [root]
    for r in recs:
        assert r["solve"] == roots[0]["id"]
        if r["parent"] is not None:
            parent = by_id[r["parent"]]
            assert parent["t0_ns"] <= r["t0_ns"] <= r["t1_ns"] <= parent["t1_ns"]
        assert r["host_s"] >= 0 and r["device_s"] is None   # no card here
    return by_id


def parent_name(by_id, r):
    return by_id[r["parent"]]["name"]


@pytest.mark.parametrize("two_tier", [True, False], ids=["two_tier", "one_tier"])
def test_feast_compiled_span_tree(two_tier):
    A, X0 = dense_problem()
    with tracing.recording():
        res = ft.feast_compiled(A, X0, two_tier=two_tier, **DENSE_KW)
    recs = tracing.spans()
    by_id = check_tree(recs, "feast.solve")
    names = collections.Counter(r["name"] for r in recs)
    tiers = collections.Counter(r["attrs"]["tier"] for r in recs if r["name"] == "feast.rr")
    assert res.converged
    assert res.n_iter == max(tiers["c64"] - 1, 0) + tiers["c128"]
    assert (tiers["c64"] >= 1) == two_tier and tiers["c128"] >= 1
    # the stopping sweep of each tier does no update
    assert names["feast.update"] == max(tiers["c64"] - 1, 0) + tiers["c128"] - 1
    assert (names["feast.factor"] == names["feast.factor.form"] == names["feast.factor.lu"]
            == names["feast.factor.diag_inv"] == 1)
    assert names["feast.loop"] == 1 and names["feast.eig_fallback"] == 0
    assert set(names) == {"feast.solve", "feast.factor", "feast.factor.form",
                          "feast.factor.lu", "feast.factor.diag_inv", "feast.loop",
                          "feast.rr", "feast.update"}
    for r in recs:
        want = {"feast.factor": "feast.solve", "feast.loop": "feast.solve",
                "feast.factor.form": "feast.factor", "feast.factor.lu": "feast.factor",
                "feast.factor.diag_inv": "feast.factor",
                "feast.rr": "feast.loop", "feast.update": "feast.loop"}.get(r["name"])
        if want:
            assert parent_name(by_id, r) == want, r["name"]


def test_feast_compiled_program_keeps_its_sweeps():
    """The sweep program's per-tier sweeps are the spans' tier counts."""
    A, X0 = dense_problem()
    fmod.clear_graph_cache()
    try:
        with tracing.recording():
            fmod._feast_compiled_steps(A, X0, **DENSE_KW)
        prog = next(iter(fmod._PROGRAMS.values()))
    finally:
        fmod.clear_graph_cache()
    tiers = collections.Counter(r["attrs"]["tier"] for r in tracing.spans()
                                if r["name"] == "feast.rr")
    assert (tiers["c64"], tiers["c128"]) == prog.sweeps


def test_each_call_is_its_own_solve():
    A, X0 = dense_problem()
    with tracing.recording():
        for _ in range(2):
            ft.feast_compiled(A, X0, **DENSE_KW)
    recs = tracing.spans()
    roots = [r for r in recs if r["name"] == "feast.solve"]
    assert len(roots) == 2 and roots[0]["id"] != roots[1]["id"]
    assert {r["solve"] for r in recs} == {r["id"] for r in roots}
    assert roots[0]["t1_ns"] <= roots[1]["t0_ns"]


def test_nlfeast_span_tree(gun):
    T, X0 = gun
    with tracing.recording():
        # a tolerance below reach: both passes run
        res = ft.nlfeast(T, X0, **dict(GUN_KW, tol=1e-18, iters=1))
    recs = tracing.spans()
    by_id = check_tree(recs, "nlfeast.solve")
    names = collections.Counter(r["name"] for r in recs)
    passes = res.n_iter + 1
    chunks = 16 // 4
    assert passes == 2
    assert names["nlfeast.extract"] == names["svd.jacobi"] == passes
    assert names["nlfeast.node_solve"] == chunks * passes
    # store=False factors every chunk again in every pass
    for name in ("nlfeast.factor", "nlfeast.factor.form", "nlfeast.factor.lu",
                 "nlfeast.factor.diag_inv"):
        assert names[name] == chunks * passes, name
    want = {"nlfeast.factor": "nlfeast.solve", "nlfeast.node_solve": "nlfeast.solve",
            "nlfeast.extract": "nlfeast.solve", "nlfeast.factor.form": "nlfeast.factor",
            "nlfeast.factor.lu": "nlfeast.factor", "nlfeast.factor.diag_inv": "nlfeast.factor",
            "svd.jacobi": "nlfeast.extract"}
    for r in recs:
        if r["parent"] is not None:
            assert parent_name(by_id, r) == want[r["name"]], r["name"]


def test_jacobi_sweeps_against_a_direct_count(monkeypatch):
    """A sweep is m - 1 rounds, each one `cdot_cols` of its column pairs."""
    calls = [0]
    real = cx.cdot_cols

    def counted(a, b):
        calls[0] += 1
        return real(a, b)

    monkeypatch.setattr(cx, "cdot_cols", counted)
    rng = np.random.default_rng(5)
    m = 12
    for n in (40, 12):
        A = torch.as_tensor(rng.standard_normal((n, m)) + 1j * rng.standard_normal((n, m)))
        calls[0] = 0
        tracing.clear()
        with tracing.recording():
            svdmod.svd(A)
        (rec,) = tracing.spans()
        assert rec["name"] == "svd.jacobi" and rec["parent"] is None
        assert rec["attrs"]["sweeps"] == calls[0] // (m - 1) >= 2
        assert calls[0] % (m - 1) == 0


def test_spans_off_record_nothing():
    assert not torch._C._autograd._profiler_enabled()
    assert tracing.span("a") is tracing.span("b", "cpu", tier="c64")
    with tracing.span("a") as s:
        s.set("k", 1)
    A, X0 = dense_problem()
    ft.feast_compiled(A, X0, **DENSE_KW)
    assert tracing.spans() == []


def test_span_handle_nesting_and_attributes():
    with tracing.recording():
        with tracing.span("outer", tier="c64") as outer:
            with tracing.span("inner") as inner:
                inner.set("sweeps", 3)
            outer.set("extra", "x")
        with pytest.raises(ValueError):
            with tracing.span("raises"):
                raise ValueError
    recs = {r["name"]: r for r in tracing.spans()}
    assert recs["outer"]["attrs"] == {"tier": "c64", "extra": "x"}
    assert recs["inner"]["attrs"] == {"sweeps": 3}
    assert recs["inner"]["parent"] == recs["outer"]["id"] == recs["inner"]["solve"]
    assert recs["raises"]["parent"] is None and recs["raises"]["host_s"] >= 0
    # a record read twice reads the same, until clear()
    assert tracing.spans() == tracing.spans()
    tracing.clear()
    assert tracing.spans() == []


def in_mode(mode: str, fn):
    """fn() with spans off, under `recording()`, or under a CPU profiler."""
    if mode == "off":
        return fn()
    if mode == "recording":
        with tracing.recording():
            return fn()
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


@pytest.mark.parametrize("solver", ["feast_compiled", "nlfeast"])
def test_results_equal_in_every_mode(solver, gun):
    if solver == "nlfeast":
        T, X0 = gun

        def run():
            return ft.nlfeast(T, X0, **GUN_KW)
    else:
        A, X0 = dense_problem()

        def run():
            return fmod._feast_compiled_steps(A, X0, **DENSE_KW)
    results, counts = [], []
    for mode in ("off", "recording", "profiler"):
        tracing.clear()
        results.append(in_mode(mode, run))
        counts.append(len(tracing.spans()))
    assert counts[0] == 0 and counts[1] == counts[2] > 0
    for res in results[1:]:
        assert res.n_iter == results[0].n_iter
        for a, b in zip(res[:4], results[0][:4]):
            assert torch.equal(a, b)


def test_profiler_alone_turns_spans_on_and_shares_their_clock():
    A, X0 = dense_problem()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ft.feast_compiled(A, X0, **DENSE_KW)
    recs = tracing.spans()
    assert {r["name"] for r in recs} >= {"feast.solve", "feast.factor", "feast.rr"}
    ranges = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("span."):
            ranges[e.name()[len("span."):]].append(e.start_ns())
    for r in recs:
        starts = ranges[r["name"]]
        assert starts, r["name"]
        # loose on a shared CPU; the card test holds 0.5 ms
        assert min(abs(s - r["t0_ns"]) for s in starts) < 5e6, r["name"]


def roots_of(recs) -> list:
    return [r["name"] for r in recs if r["parent"] is None]


@pytest.mark.parametrize("mode", ["recording", "trace", "profiler_after_off"])
def test_a_new_session_drops_the_last_ones_records(mode, tmp_path):
    """Two solves in two sessions: spans() holds the second one's only."""
    A, X0 = dense_problem()

    def solve():
        ft.feast_compiled(A, X0, **DENSE_KW)

    for _ in range(2):
        if mode == "recording":
            with tracing.recording():
                solve()
        elif mode == "trace":
            with tracing.trace(str(tmp_path)):
                solve()
        else:
            with profile(activities=[ProfilerActivity.CPU]):
                solve()
            solve()             # spans seen off: the session has ended
    recs = tracing.spans()
    assert roots_of(recs) == ["feast.solve"]
    check_tree(recs, "feast.solve")


def test_one_session_keeps_every_solve():
    """A recording() block inside a profiler session stays in it, as do
    several solves of one block."""
    A, X0 = dense_problem()
    with profile(activities=[ProfilerActivity.CPU]):
        ft.feast_compiled(A, X0, **DENSE_KW)
        with tracing.recording():
            ft.feast_compiled(A, X0, **DENSE_KW)
        ft.feast_compiled(A, X0, **DENSE_KW)
    assert roots_of(tracing.spans()) == ["feast.solve"] * 3


def test_spanned_functions_keep_their_names_and_signatures():
    for fn, params in ((fmod._factor_scan, ["A", "B", "z", "solve_f32"]),
                       (nlmod._factor_chunk, ["T", "z", "sl", "mixed"]),
                       (nlmod._extract, ["T", "Q0", "Q1", "contour", "scale"])):
        assert fn.__name__ == fn.__wrapped__.__name__
        assert list(inspect.signature(fn).parameters) == params
    assert inspect.signature(ft.nlfeast).parameters["device"].default == "cuda"


def test_spanned_reads_its_device_only_while_on():
    seen = []

    def where(x, at="cpu"):
        seen.append(at)
        return at

    @tracing.spanned("by_name", "at")
    def by_name(x, at="cpu"):
        return x + 1

    @tracing.spanned("by_call", where)
    def by_call(x, at="cpu"):
        return x + 1

    assert by_name(1) == by_call(1) == 2 and seen == [] and tracing.spans() == []
    with tracing.recording():
        assert by_name(1) == 2 and by_call(1, at=torch.device("cpu")) == 2
    assert [r["name"] for r in tracing.spans()] == ["by_name", "by_call"]
    assert seen == [torch.device("cpu")]


HOST_READS = ("__bool__", "__float__", "__int__", "__index__", "__complex__",
              "item", "tolist", "cpu", "numpy")


def test_moved_rows_resolve_without_a_synchronisation_inside_the_factor(monkeypatch):
    """On the kernel route (sent there on the CPU: complex64, zero-padded to
    256, the plain panel step and row swaps) the factor's LU span carries
    the row swaps' device count, still a tensor when the factor returns,
    with every host read and synchronisation patched to raise inside it;
    `spans()` resolves it to the rows the panels' permutations moved, and
    `gathered_rows` is sum over panels and matrices of n_pad - j; of the
    N trailing updates (one a matrix) the CPU's plain version ran all, the
    tensor-core kernel none."""
    from feast_tpu_torch.ops import lu as lumod
    from feast_tpu_torch.ops import row_swap

    monkeypatch.setattr(lumod, "_kernel_route", lambda dtype, device: dtype == torch.complex64)
    perms = []
    apply = row_swap.apply_panel_perm

    def recorded(A3, perm, j, b, moved=None):
        perms.append((j, perm.clone()))
        return apply(A3, perm, j, b, moved)

    monkeypatch.setattr(row_swap, "apply_panel_perm", recorded)
    n, N = 200, 4
    rng = np.random.default_rng(5)
    A = torch.as_tensor(rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    z = torch.as_tensor(rng.standard_normal(N) + 1j * rng.standard_normal(N))
    guarded = {}
    for name in HOST_READS:
        guarded[name] = getattr(torch.Tensor, name)

        def refuse(*a, _name=name, **k):
            raise AssertionError(f"host read inside the factor: Tensor.{_name}")
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: 1 / 0)
    with tracing.recording():
        with tracing.span("feast.solve"):
            fmod._factor_scan(A, None, z, True)
    for name, orig in guarded.items():
        monkeypatch.setattr(torch.Tensor, name, orig)
    lu_rec = [r for r in tracing._records if r.rec["name"] == "feast.factor.lu"]
    assert len(lu_rec) == 1 and isinstance(lu_rec[0].rec["attrs"]["moved_rows"], torch.Tensor)
    rec = next(r for r in tracing.spans() if r["name"] == "feast.factor.lu")
    want = sum(int((p[:, j:] != torch.arange(j, 256, dtype=p.dtype)).sum()) for j, p in perms)
    assert len(perms) == 2
    assert rec["attrs"] == {"moved_rows": want, "gathered_rows": N * (256 + 128),
                            "trail_updates": N, "trail_kernel_updates": 0}
    assert type(rec["attrs"]["moved_rows"]) is int and 0 < want <= 2 * 128 * 2 * N
