"""rr_s (s/solve, program span): the device seconds of the sweeps'
Rayleigh-Ritz steps, both tiers (`feast.rr`; with graphs, the replays),
over the traced window's solves."""

from portbench import program_spans


def read(run):
    return program_spans.per_solve(run, lambda recs: program_spans.part(recs, "rr"))
