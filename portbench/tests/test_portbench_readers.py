"""The roofline counts against hand-worked values, and every metric reader
against a synthetic run and a synthetic event list."""

import math

import pytest
from torch.autograd import DeviceType

from portbench import devtrace
from portbench.harness import Run, load
from portbench.tests import tiny


def test_k1_counts_by_hand():
    k1 = load("roofline", "k1")
    # n = 4, b = 2, j0 = 0: column 0: 3*4 + 6*3 + 8*3*1 = 54; column 1:
    # 3*3 + 6*2 = 21; the 2 x 2 unit-lower inverse: 8*1*1 = 8
    assert k1.panel_flops(4, 2, 0) == 83
    # j0 = 2: column 0: 3*2 + 6*1 + 8*1*1 = 20; column 1: 3*1 = 3; + 8
    assert k1.panel_flops(4, 2, 2) == 31
    # all 4 rows of the 2 columns read, rows >= 2 written, perm, 2 x 2 inverse
    assert k1.panel_bytes(4, 2, 2) == 4 * 2 * 8 + 2 * 2 * 8 + 4 * 4 + 2 * 2 * 8
    assert k1.launch(4, 2, 0, 3) == (3 * 83, 3 * k1.panel_bytes(4, 2, 0))
    assert k1.padded(9956, 128) == 9984


def test_k2_counts_by_hand():
    k2 = load("roofline", "k2")
    assert k2.launch(2, 1) == (800, 96)
    assert k2.launch(48, 3) == (3 * 100 * 48 ** 3, 3 * 3 * 48 * 48 * 8)


def test_bound_takes_the_slower_regime():
    peaks = load("roofline", "peaks")
    assert peaks.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 67e12) == pytest.approx(1.0)
    assert peaks.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)
    assert peaks.share_pct(1.0, 4.0) == 25.0
    assert peaks.share_pct(1.0, 0.0) is None


class E:
    def __init__(self, name, dev, start, dur, kind=None):
        self._n, self._d, self._s, self._u = name, dev, start, dur
        self._k = kind or ("kernel" if dev == DeviceType.CUDA else "cpu_op")

    def activity_type(self):
        return self._k

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u


CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def synthetic_events():
    return [E(devtrace.WINDOW, CPU, 0, 1000), E("span.factor", CPU, 0, 400),
            E("cudaLaunchKernel", CPU, 10, 5), E("cuLaunchKernelEx", CPU, 90, 5),
            E("panel_lu_cluster(float2*)", CUDA, 20, 100),
            E("panel_lu_cluster(float2*)", CUDA, 100, 100),
            E("cudaGraphLaunch", CPU, 300, 5),
            E("void schur_kernel<2, false>(float2 const*)", CUDA, 500, 50),
            E("aten::item", CPU, 560, 300),
            E(devtrace.WINDOW, CUDA, 20, 530, "gpu_user_annotation")]


def test_summarize_synthetic_events():
    s = devtrace.summarize(synthetic_events(), 2e-6)
    assert s["launch_calls"] == 3
    assert s["busy_s"] == pytest.approx(230e-9)       # [20, 200] and [500, 550]
    assert s["kernels"]["panel_lu_cluster(float2*)"] == [2, pytest.approx(200e-9)]
    assert s["ordered"]["panel_lu_cluster(float2*)"] == [1e-7, 1e-7]
    assert s["device_ops"][0][0] == "panel_lu_cluster(float2*)"
    gaps = dict(s["idle_gaps"])
    assert gaps["aten::item"] == pytest.approx(450e-9)     # [550, 1000]
    assert gaps["span.factor"] == pytest.approx(300e-9)    # [200, 500]
    assert gaps["cudaLaunchKernel"] == pytest.approx(20e-9)


def synthetic_run(events=True):
    cfg = tiny.dense(64)
    cfg["kernels"]["k1"]["panel"] = 32
    run = Run({"name": "x"}, cfg, tiny.COLD)
    run.setup_s = 12.5
    run.walls = [0.5] * 9 + [1.5]
    run.window_s = sum(run.walls)
    run.peak_bytes = 9.5e9
    run.outcomes = [{"n_iter": 4, "converged": True, "spans": {"factor": 0.1}}
                    for _ in range(9)]
    run.outcomes.append({"n_iter": 8, "converged": True,
                         "spans": {"factor": 0.3, "extract": 0.2}})
    if events:
        # one factor of n = 64 at b = 32: 2 launches of K1; one K2 launch
        ev = [E(devtrace.WINDOW, CPU, 0, 10_000), E("cudaGraphLaunch", CPU, 5, 1),
              E("panel_lu_cluster(x)", CUDA, 10, 1000), E("panel_lu_cluster(x)", CUDA, 2000, 3000),
              E("schur_kernel<1, false>(x)", CUDA, 6000, 1000)]
        run.events = devtrace.summarize(ev, 2e-5)
    return run


def read(name, run):
    return load("metrics", name).read(run)


def test_end_to_end_readers():
    run = synthetic_run()
    assert read("setup_s", run) == 12.5
    assert read("solve_s", run) == pytest.approx(6.0 / 10)
    assert read("solve_s.nep", run) == read("solve_s", run)
    assert read("peak_gb", run) == pytest.approx(9.5)
    run.outcomes = []
    assert read("solve_s", run) is None


def test_per_layer_readers():
    run = synthetic_run()
    assert read("sweeps", run) == pytest.approx(44 / 10)
    assert read("factor_s", run) == pytest.approx(1.2 / 10)
    assert read("extract_s", run) == pytest.approx(0.2 / 10)
    assert read("sweep_ms", run) == pytest.approx(1e3 * (6.0 - 1.2) / 44)
    assert read("launch_calls", run) == pytest.approx(1 / 10)
    # busy 1000 + 3000 + 1000 ns of the 2e-5 s wall
    assert read("device_idle_pct", run) == pytest.approx(100 * (1 - 5e-6 / 2e-5))
    k1, k2, peaks = (load("roofline", k) for k in ("k1", "k2", "peaks"))
    b0 = peaks.bound_s(*reversed(k1.launch(64, 32, 0, 8)))
    b1 = peaks.bound_s(*reversed(k1.launch(64, 32, 32, 8)))
    assert read("k1_roofline_pct", run) == pytest.approx(100 * (b0 + b1) / 4e-6)
    f, nb = k2.launch(12, 1)
    assert read("k2_roofline_pct", run) == pytest.approx(100 * peaks.bound_s(nb, f) / 1e-6)


def test_readers_find_nothing_without_their_source():
    run = synthetic_run(events=False)
    for o in run.outcomes:
        o["spans"] = {}
    for name in ("factor_s", "extract_s", "sweep_ms", "launch_calls", "device_idle_pct",
                 "k1_roofline_pct", "k2_roofline_pct"):
        assert read(name, run) is None, name
    # a K1 count that is no whole number of factors is not read
    run = synthetic_run()
    run.events["ordered"]["panel_lu_cluster(x)"].append(1e-6)
    assert read("k1_roofline_pct", run) is None
    assert not math.isnan(read("sweeps", run))
