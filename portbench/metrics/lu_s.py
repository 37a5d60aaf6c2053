"""lu_s (s/solve, program span): the device seconds of the node matrices'
LU inside the factor (`feast.factor.lu`, `nlfeast.factor.lu`: K1 and the
blocked updates around it) over the traced window's solves."""

from portbench import program_spans


def read(run):
    return program_spans.per_solve(run, lambda recs: program_spans.part(recs, "factor.lu"))
