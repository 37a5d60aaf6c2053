"""The program's own spans, as the per-layer readers see them.

The port records a span at each layer boundary of a solve while a torch
profiler records (`feast_tpu_torch/utils/tracing.py`): the traced window
runs under one, so after it `tracing.spans()` holds every span of the
window's solves, with the device seconds between each span's two CUDA
events.  A program without that recorder, or a window whose root spans
are not its solves, gives the readers nothing to read (None).

Spans of the solvers are named "<solver>.<part>" ("feast.factor",
"nlfeast.factor.lu"); a reader asks for the part, so one reader serves a
metric and its `.nep` twin.
"""

from __future__ import annotations

ROOTS = ("feast.solve", "nlfeast.solve")
SOLVERS = ("feast.", "nlfeast.")


def records():
    """The program's span records, or None where it has no recorder."""
    try:
        from feast_tpu_torch.utils import tracing
    except ImportError:
        return None
    spans = getattr(tracing, "spans", None)
    return None if spans is None else spans()


def window(run):
    """(records, solves): the records and the number of root spans, or
    None where there are no records or the roots are not the window's
    solves."""
    recs = records()
    if not recs:
        return None
    solves = sum(r["name"] in ROOTS for r in recs)
    if solves == 0 or solves != len(run.outcomes):
        return None
    return recs, solves


def part(recs, name: str) -> list:
    """The records of a solver's span `name` ("factor", "rr", ...)."""
    return [r for r in recs for p in SOLVERS if r["name"] == p + name]


def named(recs, name: str) -> list:
    """The records of the span `name`, whole ("svd.jacobi")."""
    return [r for r in recs if r["name"] == name]


def device_s(recs) -> float | None:
    """The device seconds of the records, or None where there are none or
    one has no device time."""
    if not recs or any(r["device_s"] is None for r in recs):
        return None
    return sum(r["device_s"] for r in recs)


def per_solve(run, pick) -> float | None:
    """The device seconds of the records `pick(records)` chooses, over the
    window's solves."""
    got = window(run)
    if got is None:
        return None
    recs, solves = got
    total = device_s(pick(recs))
    return None if total is None else total / solves
