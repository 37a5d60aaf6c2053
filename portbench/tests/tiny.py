"""Small copies of the benchmark's configurations, for its own tests: the
cells' files with the sizes cut so that a run takes seconds on the CPU."""

import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLD = {"start": "random", "variants": 1}
RESTART = {"start": "previous", "variants": 2, "delta": 0.01}
DENSE = "dense10240"


def config(name: str) -> dict:
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)


def dense(n: int = 128) -> dict:
    """The planted spectrum j / n at n = 128, the circle around its middle
    holding 8 eigenvalues, each half a spacing in from the circle."""
    cfg = config(DENSE)
    cfg.update(n=n, m0=12, c=[(n / 2 + 0.5) / n, 0.0], r=4.0 / n, nodes=8,
               warmup_solves=1, trace_solves=2,
               kernels={"k1": {"n": n, "panel": 128, "batch": 8},
                        "k2": {"n": 12, "batch": 1}})
    return cfg


def gun(n: int = 320) -> dict:
    """The gun's structure at n = 320, 6 planted in (100, 110)."""
    cfg = config("gun9956")
    cfg.update(n=n, m0=16, planted=6, warmup_solves=1, trace_solves=1,
               kernels={"k1": {"n": n, "panel": 128, "batch": 4},
                        "k2": {"n": 16, "batch": 1}})
    return cfg
