"""extract_span_s (s/solve, program span): the device seconds of the NEP's
Beyn extraction (`nlfeast.extract`: the SVD, the small eig, the
residuals) over the traced window's solves.  The program's own twin of
extract_s."""

from portbench import program_spans


def read(run):
    return program_spans.per_solve(run, lambda recs: program_spans.part(recs, "extract"))
