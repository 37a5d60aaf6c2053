"""update_s (s/solve, program span): the device seconds of the sweeps'
node updates, both tiers (`feast.update`; with graphs, the replays), over
the traced window's solves."""

from portbench import program_spans


def read(run):
    return program_spans.per_solve(run, lambda recs: program_spans.part(recs, "update"))
