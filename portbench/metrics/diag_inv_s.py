"""diag_inv_s (s/solve, program span): the device seconds of the
diagonal-block inverses inside the factor (`feast.factor.diag_inv`,
`nlfeast.factor.diag_inv`: `lu_diag_inv`'s tile kernel and doubling on
the card's kernel route) over the traced window's solves; None for a
program without those spans."""

from portbench import program_spans


def read(run):
    return program_spans.per_solve(run, lambda recs: program_spans.part(recs, "factor.diag_inv"))
