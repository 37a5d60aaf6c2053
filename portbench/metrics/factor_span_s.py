"""factor_span_s (s/solve, program span): the device seconds of the node
factor (`feast.factor`, `nlfeast.factor`: forming the node matrices, their
LU and the diagonal-block inverses) over the traced window's solves.  The
program's own twin of factor_s, read from CUDA events with no
synchronisation."""

from portbench import program_spans


def read(run):
    return program_spans.per_solve(run, lambda recs: program_spans.part(recs, "factor"))
