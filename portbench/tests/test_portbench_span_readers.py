"""The readers of the program's own spans (`program_spans.py` and the
metrics that read it) on hand-built records, and on the records of a small
traced run on the CPU."""

import time

import pytest

from feast_tpu_torch.utils import tracing
from portbench import harness, program_spans
from portbench import mix as mixmod
from portbench.harness import Run, load
from portbench.tests import tiny

_ids = iter(range(1, 10_000))


def rec(name, device_s=None, parent=None, solve=None, **attrs):
    i = next(_ids)
    return {"name": name, "id": i, "parent": parent, "solve": solve or i, "t0_ns": 0,
            "t1_ns": 0, "host_s": 0.0, "device_s": device_s, "attrs": attrs}


def dense_solve(factor=2.0, form=0.05, lu=1.5, loop=1.0, rr=(0.1, 0.1, 0.2, 0.2),
                update=(0.15, 0.2), fallback=()):
    """One dense solve's records: two coarse and two fine Rayleigh-Ritz
    steps (each tier's last stops its loop), so n_iter is 1 + 2 = 3."""
    root = rec("feast.solve", 3.5)
    s = root["id"]
    f = rec("feast.factor", factor, root["id"], s)
    lp = rec("feast.loop", loop, root["id"], s)
    out = [root, f, rec("feast.factor.form", form, f["id"], s),
           rec("feast.factor.lu", lu, f["id"], s), lp]
    for t, tier in zip(rr, ("c64", "c64", "c128", "c128")):
        out.append(rec("feast.rr", t, lp["id"], s, tier=tier))
    for t, tier in zip(update, ("c64", "c128")):
        out.append(rec("feast.update", t, lp["id"], s, tier=tier))
    out += [rec("feast.eig_fallback", t, lp["id"], s) for t in fallback]
    return out


def gun_solve(passes=2, chunks=4):
    root = rec("nlfeast.solve", 7.0)
    s = root["id"]
    out = [root]
    for p in range(passes):
        for _ in range(chunks):
            f = rec("nlfeast.factor", 0.3, root["id"], s)
            out += [f, rec("nlfeast.factor.form", 0.02, f["id"], s),
                    rec("nlfeast.factor.lu", 0.25, f["id"], s),
                    rec("nlfeast.node_solve", 0.1, root["id"], s)]
        e = rec("nlfeast.extract", 1.0, root["id"], s)
        out += [e, rec("svd.jacobi", 0.8, e["id"], s, sweeps=6 + 2 * p)]
    return out


def window(solves):
    run = Run({}, {}, {})
    run.outcomes = [{"n_iter": 3, "converged": True, "spans": {}}] * solves
    return run


def read(name, run):
    return load("metrics", name).read(run)


@pytest.fixture
def records(monkeypatch):
    """Hand the readers the records of `records.value`."""
    class Box:
        value = []
    monkeypatch.setattr(program_spans, "records", lambda: list(Box.value))
    return Box


DENSE = {"factor_span_s": 2.0, "form_s": 0.05, "lu_s": 1.5, "rr_s": 0.6, "update_s": 0.35,
         "coarse_sweeps": 2.0, "eig_fallbacks": 0.0,
         "loop_idle_pct": 100.0 * (1.0 - 0.95 / 1.0)}
GUN = {"factor_span_s": 8 * 0.3, "form_s": 8 * 0.02, "lu_s": 8 * 0.25,
       "node_solve_s": 8 * 0.1, "extract_span_s": 2.0, "jacobi_s": 1.6,
       "jacobi_sweeps": 7.0}


@pytest.mark.parametrize("name", sorted(DENSE))
def test_dense_readers(records, name):
    records.value = dense_solve() + dense_solve()
    assert read(name, window(2)) == pytest.approx(DENSE[name])


@pytest.mark.parametrize("name", sorted(GUN))
def test_gun_readers(records, name):
    records.value = gun_solve()
    got = read(name + ".nep" if name in ("factor_span_s", "form_s", "lu_s") else name,
               window(1))
    assert got == pytest.approx(GUN[name])


def test_eig_fallbacks_and_loop_idle_count_the_fallback(records):
    records.value = dense_solve(fallback=(0.05,)) + dense_solve()
    run = window(2)
    assert read("eig_fallbacks", run) == 0.5
    assert read("loop_idle_pct", run) == pytest.approx(100.0 * (1.0 - 1.95 / 2.0))


ALL = sorted(set(DENSE) | set(GUN))


@pytest.mark.parametrize("name", ALL)
def test_none_when_the_roots_are_not_the_solves(records, name):
    records.value = dense_solve() + gun_solve()
    assert read(name, window(3)) is None
    assert read(name, window(1)) is None
    records.value = [r for r in dense_solve() + gun_solve()
                     if r["name"] not in program_spans.ROOTS]
    assert read(name, window(0)) is None


@pytest.mark.parametrize("name", ALL)
def test_none_when_the_spans_are_absent(records, name):
    # a dense window has no NEP or Jacobi spans, a gun window no sweep loop;
    # the factor's readers read both
    if not (name in GUN and name in DENSE):
        records.value = dense_solve() if name in GUN else gun_solve()
        assert read(name, window(1)) is None
    records.value = [r for r in dense_solve() + gun_solve() if r["name"] in program_spans.ROOTS]
    assert read(name, window(2)) is None


@pytest.mark.parametrize("name", sorted(n for n in ALL if n.endswith(("_s", "_pct"))))
def test_none_without_device_time(records, name):
    """The CPU's spans have no device seconds."""
    records.value = [dict(r, device_s=None) for r in dense_solve() + gun_solve()]
    assert read(name, window(2)) is None


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    monkeypatch.delattr(tracing, "spans")
    assert program_spans.records() is None
    for name in ALL:
        assert read(name, window(1)) is None, name


@pytest.mark.parametrize("cell", ["dense", "gun"])
def test_traced_cpu_run_counts(cell, monkeypatch):
    """A whole run on the CPU with spans on in its window, as the profiler
    turns them on in a traced window on the card: the counters read the
    window's spans (no card, so no device seconds: the times read None),
    and each solve's sweeps per tier give its n_iter."""
    cfg, mix = (tiny.dense(), tiny.RESTART) if cell == "dense" else (tiny.gun(), tiny.COLD)
    drive = mixmod.drive

    def recorded(*a, **k):
        with tracing.recording():
            return drive(*a, **k)

    monkeypatch.setattr(mixmod, "drive", recorded)
    tracing.clear()
    try:
        _, run = harness.run_cell({"name": cell}, cfg, mix, 2**31 + 7, 0.0, True, "cpu",
                                  time.perf_counter())
        recs, solves = program_spans.window(run)
        values = {name: read(name, run) for name in ALL}
    finally:
        tracing.clear()
    assert solves == len(run.outcomes) >= 1
    if cell == "dense":
        roots = sorted(program_spans.part(recs, "solve"), key=lambda r: r["t0_ns"])
        rr = program_spans.part(recs, "rr")
        for root, out in zip(roots, run.outcomes):
            tiers = [r["attrs"]["tier"] for r in rr if r["solve"] == root["id"]]
            assert out["n_iter"] == max(tiers.count("c64") - 1, 0) + tiers.count("c128")
        c64 = sum(r["attrs"]["tier"] == "c64" for r in rr)
        assert values["coarse_sweeps"] == c64 / solves
        assert values["eig_fallbacks"] == 0.0
    else:
        jac = program_spans.named(recs, "svd.jacobi")
        assert len(jac) == sum(o["n_iter"] + 1 for o in run.outcomes)
        assert values["jacobi_sweeps"] == sum(r["attrs"]["sweeps"] for r in jac) / len(jac)
    counters = ("coarse_sweeps", "eig_fallbacks", "jacobi_sweeps")
    assert all(v is None for k, v in values.items() if k not in counters)
