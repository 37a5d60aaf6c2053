"""The four-rank dense cell (`dense20480.node4`): its entry
(`entries/feast_compiled_mesh.py`, `ranks.py`) run whole on the CPU over 4
gloo ranks at a small size, with faults planted in a worker; its readers
of the node sum (`node_sum_s`, `node_sum_roofline_pct`, `node_eff_pct`) on
hand-built span records; its entries in BENCHMARK.json."""

import importlib
import json
import os
import signal
import time

import pytest
import torch

from portbench import harness, ranks
from portbench import mix as mixmod
from portbench.harness import load
from portbench.tests.test_portbench_span_readers import (  # noqa: F401 (records is a fixture)
    dense_solve, read, rec, records, window)
from feast_tpu_torch.utils import tracing

CELL = "dense20480.node4"
COLD = {"start": "random", "variants": 1}
SEED = 2**31 + 16
NODE_METRICS = ("node_sum_s", "node_sum_roofline_pct", "node_eff_pct")


def tiny(n: int = 256) -> dict:
    """dense20480's file at n = 256 with 8 nodes, 2 a rank: the circle
    around the middle of the planted spectrum holds 8 eigenvalues, each
    half a spacing in."""
    cfg = harness.load_json(os.path.join(harness.HERE, "configs", "dense20480.json"))
    cfg.update(n=n, m0=12, c=[(n / 2 + 0.5) / n, 0.0], r=4.0 / n, nodes=8,
               warmup_solves=1, trace_solves=2,
               kernels={"k1": {"n": n, "panel": 128, "batch": 2},
                        "k2": {"n": 12, "batch": 1}})
    return cfg


def run(trace=False, metrics=()):
    return harness.run_cell({"name": CELL}, tiny(), COLD, SEED, 0.0, trace, "cpu",
                            time.perf_counter(), metrics)


@pytest.fixture
def entry():
    mod = load("entries", "feast_compiled_mesh")
    yield mod
    if mod.GROUP is not None:   # a run that raised left its ranks running
        with pytest.raises(RuntimeError):
            mod.release()


def zero_share(rank):
    """Worker hook: rank 1 hands the node sum zeros for its nodes' share."""
    if rank != 1:
        return
    fmod = importlib.import_module("feast_tpu_torch.solvers.feast")
    real = fmod._node_update_scan
    fmod._node_update_scan = lambda *a, **k: torch.zeros_like(real(*a, **k))


def test_sound_run_is_correct_and_loads_no_jax(entry):
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    metrics = harness.cell_metrics(bench, cell, True)
    tracing.clear()
    try:
        result, got = run(trace=True, metrics=metrics)
    finally:
        tracing.clear()
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert entry.GROUP is None and len(entry.REPORTS) == 3
    for rep in entry.REPORTS:
        tops = set(rep["modules"])
        assert "feast_tpu_torch" in tops and not tops & set(harness.FORBIDDEN)
    # the CPU's spans have no device seconds: the counters read, the times not
    assert result["metrics"]["sweeps.node4"]["value"] == pytest.approx(
        sum(o["n_iter"] for o in got.outcomes) / len(got.outcomes))
    assert not set(NODE_METRICS) & set(result["metrics"])


def test_zeroed_node_share_is_not_correct(entry, monkeypatch):
    monkeypatch.setattr(ranks, "WORKER_HOOK", f"{__name__}:zero_share")
    result, _ = run()
    assert not result["correct"], result["checks"]


def test_killed_worker_makes_the_run_raise(entry, monkeypatch):
    """A worker killed before the window's solve: rank 0's next collective
    raises (gloo) within the group's timeout, and no rank is left."""
    monkeypatch.setattr(ranks, "TIMEOUT_S", 30.0)
    step = mixmod.Sequence.step

    def killing(self, spans=None):
        if self.index == 1:
            os.kill(entry.GROUP.procs[1].pid, signal.SIGKILL)
            entry.GROUP.procs[1].join()
        return step(self, spans)

    monkeypatch.setattr(mixmod.Sequence, "step", killing)
    t0 = time.perf_counter()
    with pytest.raises(Exception):
        run()
    assert time.perf_counter() - t0 < 30.0 + 60.0
    procs = entry.GROUP.procs
    with pytest.raises(RuntimeError, match="died"):
        entry.release()
    assert not any(p.is_alive() for p in procs)


# ---------------------------------------------------------------------------
# the readers, on hand-built records
# ---------------------------------------------------------------------------

def node4_solve(sums=((0.01, "c64", 8), (0.02, "c128", 16)), p=4, n=1000, m0=10, **kw):
    """A dense solve's records with a `feast.node_sum` after each update:
    (device seconds, tier, bytes an entry) for each."""
    out = dense_solve(**kw)
    loop = next(r for r in out if r["name"] == "feast.loop")
    for t, tier, size in sums:
        out.append(rec("feast.node_sum", t, loop["id"], loop["solve"], tier=tier,
                       bytes=n * m0 * size, ranks=p))
    return out


def test_node_sum_readers(records):
    records.value = node4_solve() + node4_solve()
    run = window(2)
    assert read("node_sum_s", run) == pytest.approx(0.03)
    allreduce = load("roofline", "allreduce")
    bus = 2 * 3 / 4 * 1000 * 10 * (8 + 16)
    assert read("node_sum_roofline_pct", run) == pytest.approx(
        100 * bus / allreduce.PEAK_LINK_BYTES_PER_S / 0.03)
    # dense_solve: rr 0.6, update 0.35, factor 2.0 a solve
    R, W, S = 0.6, 2.35, 0.03
    assert read("node_eff_pct", run) == pytest.approx(100 * (R + 4 * W) / (4 * (R + W + S)))
    # the fallback's Rayleigh-Ritz is replicated work too
    records.value = node4_solve(fallback=(0.1,)) + node4_solve(fallback=(0.1,))
    assert read("node_eff_pct", window(2)) == pytest.approx(
        100 * (R + 0.1 + 4 * W) / (4 * (R + 0.1 + W + S)))


@pytest.mark.parametrize("name", NODE_METRICS)
def test_node_sum_readers_read_nothing_without_the_spans(records, name):
    """The parent commit's program, or a solve without a mesh, has no
    `feast.node_sum`; the CPU has no device seconds; a window whose roots
    are not its solves is read by no reader."""
    records.value = dense_solve() + dense_solve()
    assert read(name, window(2)) is None
    records.value = [dict(r, device_s=None) for r in node4_solve()]
    assert read(name, window(1)) is None
    records.value = node4_solve()
    assert read(name, window(2)) is None
    records.value = [dict(r, attrs={}) if r["name"] == "feast.node_sum" else r
                     for r in node4_solve()]
    assert read(name, window(1)) is None or name == "node_sum_s"


def test_node4_twins_read_the_base_readers():
    for base in ("lu_s", "rr_s", "update_s", "sweeps", "device_idle_pct",
                 "k1_roofline_pct"):
        assert load("metrics", base + ".node4") is load("metrics", base)


def test_allreduce_bound():
    allreduce = load("roofline", "allreduce")
    assert allreduce.launch(1000, 4) == (0, 1500.0)
    assert allreduce.launch(1000, 1)[1] == 0.0
    assert allreduce.bound_s(450e9, 2) == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# BENCHMARK.json
# ---------------------------------------------------------------------------

def test_the_cell_in_the_benchmark():
    """The four-card cell against the contract: at most a quarter of the
    cells, rounded down, ask for 4 cards, or one; it reports setup_s,
    solve_s and peak_gb and its per-layer metrics, each found by name."""
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    four = [w for w in cells.values() if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) and len(w["why"]) <= 200 for w in cells.values())
    assert len(four) <= max(1, len(cells) // 4)
    w = cells[CELL]
    assert w["chips"] == 4 and w["config"] == "dense20480" and w["traffic"] == "cold"
    conf = next(c for c in bench["configs"] if c["name"] == "dense20480")
    assert len(conf["source"]) <= 200 and conf["reduced"] == []
    cfg = harness.load_json(os.path.join(harness.ROOT, conf["file"]))
    assert cfg["entry"] == "feast_compiled_mesh" and cfg["ranks"] == 4
    assert cfg["nodes"] % cfg["ranks"] == 0
    assert cfg["kernels"]["k1"]["batch"] == cfg["nodes"] // cfg["ranks"]
    n = cfg["n"]
    inside = [j for j in range(1, n + 1) if abs(j / n - cfg["c"][0]) <= cfg["r"]]
    assert inside == list(range(10221, 10261))
    e2e = harness.cell_metrics(bench, w, False)
    assert {m["name"] for m in e2e} == {"setup_s", "solve_s", "peak_gb"}
    layer = {m["name"] for m in harness.cell_metrics(bench, w, True)}
    assert layer == set(NODE_METRICS) | {b + ".node4" for b in (
        "lu_s", "rr_s", "update_s", "sweeps", "device_idle_pct", "k1_roofline_pct")}
    assert len(json.dumps(bench)) < 64 * 1024
