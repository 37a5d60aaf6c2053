"""jacobi_sweeps (sweeps/extract, program counter): the mean of the
Jacobi sweeps an SVD of the extraction took (the `sweeps` of the
`svd.jacobi` spans) over the traced window."""

from portbench import program_spans


def read(run):
    got = program_spans.window(run)
    if got is None:
        return None
    jac = program_spans.named(got[0], "svd.jacobi")
    if not jac or any("sweeps" not in r["attrs"] for r in jac):
        return None
    return sum(r["attrs"]["sweeps"] for r in jac) / len(jac)
