"""form_s (s/solve, program span): the device seconds of forming the node
matrices inside the factor over the traced window's solves: A - z_i B in
complex128 and the cast (`feast.factor.form`), or T evaluated at a chunk's
nodes (`nlfeast.factor.form`)."""

from portbench import program_spans


def read(run):
    return program_spans.per_solve(run, lambda recs: program_spans.part(recs, "factor.form"))
