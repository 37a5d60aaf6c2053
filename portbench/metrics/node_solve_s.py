"""node_solve_s (s/solve, program span): the device seconds of the NEP's
node solves (`nlfeast.node_solve`: a chunk's complex64 solves, its two
complex128 refinements and its filter terms) over the traced window's
solves."""

from portbench import program_spans


def read(run):
    return program_spans.per_solve(run, lambda recs: program_spans.part(recs, "node_solve"))
