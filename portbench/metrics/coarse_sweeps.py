"""coarse_sweeps (sweeps/solve, program counter): the complex64 tier's
sweeps (the `feast.rr` spans of tier "c64") over the traced window's
solves.  With the complex128 tier's, n_iter = max(c64 - 1, 0) + c128: the
sweep that stops the first tier does no update."""

from portbench import program_spans


def read(run):
    got = program_spans.window(run)
    if got is None:
        return None
    recs, solves = got
    rr = program_spans.part(recs, "rr")
    if not rr:
        return None
    return sum(r["attrs"].get("tier") == "c64" for r in rr) / solves
