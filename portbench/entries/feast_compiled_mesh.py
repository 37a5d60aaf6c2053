"""The dense path across cards: `feast_compiled(mesh=parallel.node_mesh(ranks))`.

FEAST's second level of parallelism (PFEAST L2 in the FEAST v4 user
guide): the contour nodes are spread over the ranks, each factors and
solves nodes / ranks of them, one all-reduce over "node" sums the moment
block, and every rank repeats the Rayleigh-Ritz.  On the card each rank
is one card and its sweeps are CUDA graphs, the all-reduce an NCCL graph
of its own.

The harness is one process, rank 0.  The first `operator()` starts the
other `ranks - 1` (`portbench/ranks.py`); each operator is broadcast in
place to every rank once; each `solve()` tells the workers to solve, then
solves on rank 0 with the mix's start, which the port broadcasts.
`release()` stops the ranks and prints each worker's peak memory on
standard error; it raises where a worker loaded JAX or the JAX package.

Configuration keys read: ranks, n, m0, c, r, nodes, iters, tol,
mixed_prec, warmup_solves.
"""

from __future__ import annotations

import sys

from portbench import ranks
from portbench.harness import FORBIDDEN, load

GROUP = None       # the running ranks.Group
REPORTS: list = []  # the workers' reports of the last release


def operator(config: dict, inst: dict, device):
    import torch

    global GROUP
    dev = torch.device(device)
    if GROUP is None:
        GROUP = ranks.Group(int(config["ranks"]), dev.type, config)
    A = torch.as_tensor(inst["A"], dtype=torch.complex128, device=dev).contiguous()
    return GROUP.place(A)


def solve(config: dict, A, X0, device):
    return GROUP.solve(config, A, X0, device)


def outcome(config: dict, res):
    return load("entries", "feast_compiled").outcome(config, res)


def release():
    """Stop every rank (dropping each one's sweep program first)."""
    global GROUP, REPORTS
    if GROUP is None:
        return
    group, GROUP = GROUP, None
    REPORTS = group.close()
    for rank, rep in enumerate(REPORTS, 1):
        print(f"portbench: rank {rank} peak {rep['peak_bytes'] / 1e9:.3f} GB "
              "(max_memory_allocated after its warm-up solves)", file=sys.stderr)
    found = sorted({m for rep in REPORTS for m in rep["modules"]} & set(FORBIDDEN))
    if found:
        raise RuntimeError(f"portbench: a worker loaded {found}")
