"""node_sum_s (s/solve, program span): the device seconds of the node sum
under a mesh (`feast.node_sum`: each update's all-reduce over "node", both
tiers) over the traced window's solves.  Read on rank 0, so it holds the
wait for the slowest rank too.  A program without the span reads nothing."""

from portbench import program_spans


def read(run):
    return program_spans.per_solve(run, lambda recs: program_spans.part(recs, "node_sum"))
