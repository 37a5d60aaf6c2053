"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds `BENCHMARK.json`, this folder
and `feast_tpu_torch/`.  It needs as many CUDA cards as the cell asks for
and exits with a code other than 0, printing no result, without them.
The last line on standard output is the result (`harness.run_cell`); the
last lines on standard error are the numbers compared, each beside its
limit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True, help="a cell's name in BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True,
                    help="length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0,
                    help="1: a traced window and the per-layer metrics")
    args = ap.parse_args(argv)

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        ap.error(f"no cell {args.workload!r} in BENCHMARK.json")

    import torch

    if not torch.cuda.is_available():
        print("portbench: torch.cuda is not available; the benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell asks for {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2

    from portbench import harness

    return harness.main(bench, cell, seed=args.seed, seconds=args.seconds,
                        trace=bool(args.trace), t_start=T_START)


if __name__ == "__main__":
    # this folder's modules are imported as the package `portbench` from the
    # checkout's root; the script's own folder leaves the path, so no file
    # here shadows a module of the standard library
    sys.path[0] = ROOT
    sys.exit(main())
