"""The one traffic generator: solve after solve, as a mix's file says.

A run solves the problem of its seed: the configuration's generator
(`problems/<problem>.py`) makes it, and `variants` nearby instances of it,
from the seed.  A mix (`traffic/<mix>.json`) holds parameters only:

  start     "random": every solve starts from a fresh Gaussian subspace
            drawn from (seed, solve index); "previous": every solve after
            the first starts from the previous solve's full Ritz vectors.
  variants  nearby instances of the problem that the solves go through in
            turn, and `delta`, the size of the step between them (read by
            the problem's generator).

Solve 0 starts from the generator's `first_start` where it gives one, else
from the random start of index 0.
"""

from __future__ import annotations

import time

import numpy as np


def rng(seed: int, *stream: int) -> np.random.Generator:
    """numpy's generator for (seed, *stream); any whole seed, negative too."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def random_start(seed: int, index: int, n: int, m0: int) -> np.ndarray:
    """Complex Gaussian (n, m0) start of solve `index`."""
    g = rng(seed, 0, index)
    return g.standard_normal((n, m0)) + 1j * g.standard_normal((n, m0))


def make(problem, config: dict, mix: dict, seed: int, device) -> dict:
    """The run's inputs: the `variants` instances of the seed's problem and
    the first start."""
    variants = int(mix["variants"])
    made = problem.make(config, seed, variants, float(mix.get("delta", 0.0)), device)
    if len(made["instances"]) != variants:
        raise ValueError(f"{len(made['instances'])} instances for {variants} variants")
    first = made.get("first_start")
    if first is None:
        first = random_start(seed, 0, int(config["n"]), int(config["m0"]))
    return {"instances": made["instances"], "first_start": first}


class Sequence:
    """The solves of one run, in order.  `step()` runs the next solve
    through the port's entry, synchronises, and returns its outcome on the
    host (`entry.outcome`) with the instance it solved."""

    def __init__(self, entry, config: dict, mix: dict, inputs: dict, ops: list,
                 seed: int, device, sync):
        if mix["start"] not in ("random", "previous"):
            raise ValueError(f"mix start {mix['start']!r}: 'random' or 'previous'")
        self.entry, self.config, self.mix = entry, config, mix
        self.inputs, self.ops = inputs, ops
        self.seed, self.device, self.sync = seed, device, sync
        self.index = 0
        self.prev = None

    def _start(self, i: int):
        if i == 0:
            return self.inputs["first_start"]
        if self.mix["start"] == "previous":
            return self.prev
        n, m0 = self.inputs["first_start"].shape
        return random_start(self.seed, i, n, m0)

    def step(self, spans=None) -> dict:
        i = self.index
        k = i % len(self.ops)
        X0 = self._start(i)
        if spans is not None:
            spans.begin()
        res = self.entry.solve(self.config, self.ops[k], X0, self.device)
        out, nxt = self.entry.outcome(self.config, res)
        self.sync()
        self.prev = nxt if self.mix["start"] == "previous" else None
        out["instance"] = k
        out["spans"] = spans.end() if spans is not None else {}
        self.index += 1
        return out


def trace_solves(mix: dict, least: int) -> int:
    """The traced window's solves: `least` rounded up to whole cycles of
    the variants, so that the per-layer metrics weigh every instance as the
    timed window does."""
    cycle = int(mix["variants"])
    return -(-int(least) // cycle) * cycle


def drive(seq: Sequence, seconds: float, max_solves: int = 0, spans=None):
    """Solves back to back until `seconds` have passed (the window runs
    whole solves, so it ends when the last one ends) or `max_solves` are
    done.  Returns (outcomes, walls, window seconds); a solve's wall runs
    from the end of the one before, so the walls add up to the window."""
    outcomes, walls = [], []
    t0 = last = time.perf_counter()
    while True:
        outcomes.append(seq.step(spans))
        now = time.perf_counter()
        walls.append(now - last)
        last = now
        if now - t0 >= seconds or (max_solves and len(outcomes) >= max_solves):
            break
    return outcomes, walls, last - t0
