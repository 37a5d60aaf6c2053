"""One run of one cell: set-up, warm-up, the window, the comparison.

`main` is what `run.py` calls once it has found the cards.  `run_cell`
does the work on any device, so the benchmark's own tests drive it on the
CPU at small sizes, with the program broken underneath.

A run:
  1. set-up: on the card, the port's kernels are built where the checkout
     lacks them (a checkout's first run; its seconds are reported apart as
     `build_s` and stay in `setup_s`, which holds compilation in a run
     that compiles); the configuration's problem generator makes the
     inputs from the seed (`problems/<problem>.py`); the port's entry
     builds its operators from them (`entries/<entry>.py`); the first
     `warmup_solves` solves of the mix run, the first of which captures
     the program's graphs.  `setup_s` ends here, measured from the
     process's start.
  2. the window: with --trace 0, solves back to back for `seconds`, no
     span, no profiler; with --trace 1, solves under the profiler, the
     configuration's spans wrapped, for `seconds` or `trace_solves`
     solves rounded up to whole cycles of the mix, whichever ends first.
  3. the card's peak is read, the program's state dropped.
  4. the plain reference judges every solve of the window (`judge.py`).
  5. no module of JAX or of the JAX package may be loaded by then.
  6. the result line: the cell's metrics, each from its reader
     (`metrics/<name>.py`), then the numbers compared beside their limits.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import time

from portbench import judge
from portbench import mix as mixmod

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "feast_tpu")


def load(kind: str, name: str):
    """The module `<kind>/<name>.py` of this folder, found by name.  A
    metric `<base>.<cells>` without a file of its own is read by
    `metrics/<base>.py`: the same quantity, split by the end-to-end metric
    its cells move."""
    path = os.path.join(HERE, kind, name + ".py")
    if kind == "metrics" and not os.path.isfile(path) and "." in name:
        return load(kind, name.split(".")[0])
    if not os.path.isfile(path):
        raise FileNotFoundError(f"portbench: no {kind} {name!r} ({path})")
    modname = f"portbench._{kind}_" + "".join(c if c.isalnum() else "_" for c in name)
    if modname not in sys.modules:
        spec = importlib.util.spec_from_file_location(modname, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[modname] = module
        spec.loader.exec_module(module)
    return sys.modules[modname]


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(bench: dict, cell: dict):
    """(configuration, mix) of a cell: the configuration's `file` and
    `traffic/<mix>.json`."""
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return (load_json(os.path.join(ROOT, conf["file"])),
            load_json(os.path.join(HERE, "traffic", cell["traffic"] + ".json")))


def cell_metrics(bench: dict, cell: dict, trace: bool) -> list:
    """The metric entries this cell reports in this kind of run."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell["name"] in m.get("workloads", [cell["name"]])]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, whole, is JAX's or the JAX
    package's (`feast_tpu_torch` is not `feast_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Run:
    """What one run recorded, as the metric readers see it."""

    def __init__(self, cell, config, mix):
        self.cell, self.config, self.mix = cell, config, mix
        self.setup_s = math.nan
        self.build_s = 0.0          # the kernels' nvcc build, where this run made it
        self.outcomes: list = []    # per solve: lam, X, converged, n_iter, instance, spans
        self.walls: list = []       # per solve, back to back over the window
        self.window_s = math.nan
        self.peak_bytes = 0
        self.events = None          # devtrace.summarize of the traced window
        self.reference_s = math.nan


def run_cell(cell, config, mix, seed, seconds, trace, device, t_start,
             metrics=(), platform=None):
    """Run the cell once on `device` ("cuda" or "cpu"); returns
    (the result line's dict, the `Run`).  `metrics`: the BENCHMARK.json entries to
    report.  `platform` ((name, kind, count)) describes the device."""
    import torch

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    run = Run(cell, config, mix)
    if cuda:
        from feast_tpu_torch.kernels import _build

        t_build = time.perf_counter()
        if _build.build():
            run.build_s = time.perf_counter() - t_build
    problem = mixmod.make(load("problems", config["problem"]), config, mix, seed, device)
    entry = load("entries", config["entry"])
    ops = [entry.operator(config, inst, device) for inst in problem["instances"]]
    seq = mixmod.Sequence(entry, config, mix, problem, ops, seed, device, sync)
    for _ in range(int(config["warmup_solves"])):
        seq.step()
    sync()
    run.setup_s = time.perf_counter() - t_start
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    if not trace:
        run.outcomes, run.walls, run.window_s = mixmod.drive(seq, seconds)
    else:
        from portbench import devtrace
        from portbench.spans import Spans

        most = mixmod.trace_solves(mix, config["trace_solves"])
        with Spans(config.get("spans", {}), sync) as spans:
            if cuda:
                (run.outcomes, run.walls, run.window_s), run.events = devtrace.traced(
                    torch, lambda: mixmod.drive(seq, seconds, most, spans))
            else:
                run.outcomes, run.walls, run.window_s = mixmod.drive(seq, seconds, most,
                                                                     spans)
    if cuda:
        run.peak_bytes = torch.cuda.max_memory_allocated()

    # the program's state goes before the reference runs
    del seq, ops
    entry.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    reference = load("reference", config["reference"])
    t_ref = time.perf_counter()
    numbers = judge.compare(reference, config, problem["instances"], run.outcomes, device)
    run.reference_s = time.perf_counter() - t_ref
    checks = judge.checks(numbers, config["limits"])
    correct = judge.passed(checks)

    values = {}
    for m in metrics:
        v = load("metrics", m["name"]).read(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    name, kind, count = platform or ("cpu", "cpu", 1)
    dev = {"platform": name, "kind": kind, "count": count,
           "memory_peak_bytes": int(run.peak_bytes)}
    result = {"correct": correct, "attempted": len(run.outcomes),
              "failed": sum(not o["converged"] for o in run.outcomes),
              "metrics": values, "device": dev}
    if run.events is not None:
        dev["busy_s"] = run.events["busy_s"]
        dev["window_s"] = run.events["wall_s"]
        result["breakdown"] = {"device_ops": run.events["device_ops"],
                               "idle_gaps": run.events["idle_gaps"]}
    result["build_s"] = run.build_s
    result["checks"] = {k: {"value": _num(c["value"]), "limit": c["limit"]}
                        for k, c in checks.items()}
    return result, run


def _num(v):
    """A JSON number, or the string "inf" / "nan" for what JSON lacks."""
    if isinstance(v, float) and not math.isfinite(v):
        return str(v)
    return v


def main(bench, cell, seed, seconds, trace, t_start) -> int:
    import torch

    config, mix = cell_files(bench, cell)
    platform = ("gpu", torch.cuda.get_device_name(0), int(cell["chips"]))
    result, run = run_cell(cell, config, mix, seed, seconds, trace, "cuda", t_start,
                           cell_metrics(bench, cell, trace), platform)
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    walls = sorted(run.walls)
    print(f"portbench: {cell['name']} seed {seed}: setup {run.setup_s:.3f} s "
          f"(of which the kernels' build {run.build_s:.3f} s), "
          f"{len(run.outcomes)} solves in {run.window_s:.3f} s, walls min "
          f"{walls[0]:.4f} median {walls[len(walls) // 2]:.4f} max {walls[-1]:.4f} s, "
          f"reference {run.reference_s:.3f} s, sweeps {[o['n_iter'] for o in run.outcomes]}",
          file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
