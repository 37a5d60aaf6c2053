"""jacobi_s (s/solve, program span): the device seconds of the one-sided
Jacobi sweeps of the extraction's SVD (`svd.jacobi`) over the traced
window's solves."""

from portbench import program_spans


def read(run):
    return program_spans.per_solve(run, lambda recs: program_spans.named(recs, "svd.jacobi"))
