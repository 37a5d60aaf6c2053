"""eig_fallbacks (reruns/solve, program counter): the Rayleigh-Ritz steps
run again with the full eig where the mixed eig's guard failed (the
`feast.eig_fallback` spans) over the traced window's solves.  Read where
the window has the sweep loop's spans (`feast.loop`), so 0 is a count."""

from portbench import program_spans


def read(run):
    got = program_spans.window(run)
    if got is None:
        return None
    recs, solves = got
    if not program_spans.part(recs, "loop"):
        return None
    return len(program_spans.part(recs, "eig_fallback")) / solves
