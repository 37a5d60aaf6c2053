"""The control of `correct`: the plain reference one precision down, put in
the program's place, has to come out as not correct.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3

For each seed it makes the cell's inputs as a run does, takes each
instance's answer from the reference's `control` (dense: the complex64
eig of A; gun: the Schur-complement reference in complex64) in place of
the port's solve, and judges it with the run's own comparison
(`judge.py`) against the configuration's limits.  It prints one JSON line
a seed with the numbers, and exits 0 only if every seed came out as not
correct.  The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_checks(config: dict, mix: dict, seed: int, device) -> dict:
    """{name: {"value", "limit"}} of the control on the seed's instances."""
    from portbench import judge
    from portbench import mix as mixmod
    from portbench.harness import load

    problem = mixmod.make(load("problems", config["problem"]), config, mix, seed, device)
    reference = load("reference", config["reference"])
    outcomes = []
    for k, inst in enumerate(problem["instances"]):
        lam, X = reference.control(reference.prepare(config, inst, device))
        outcomes.append({"instance": k, "lam": lam, "X": X, "converged": True,
                         "n_iter": 0})
    numbers = judge.compare(reference, config, problem["instances"], outcomes, device)
    return judge.checks(numbers, config["limits"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run the control of a cell's comparison.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = ap.parse_args(argv)

    import torch

    from portbench import harness, judge

    if not torch.cuda.is_available():
        print("control: torch.cuda is not available", file=sys.stderr)
        return 2
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    config, mix = harness.cell_files(bench, cell)
    all_failed = True
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        checks = control_checks(config, mix, seed, "cuda")
        correct = judge.passed(checks)
        all_failed &= not correct
        print(json.dumps({"workload": cell["name"], "seed": seed, "correct": correct,
                          "seconds": time.perf_counter() - t0,
                          "checks": {k: {"value": harness._num(c["value"]),
                                         "limit": c["limit"]}
                                     for k, c in checks.items()}}), flush=True)
    return 0 if all_failed else 1


if __name__ == "__main__":
    sys.path[0] = ROOT
    sys.exit(main())
