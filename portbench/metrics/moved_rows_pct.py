"""moved_rows_pct (%, program span): the rows the factor's row swaps moved,
as a share of the rows a gather of every row at and below each panel
would rewrite: 100 * the sum of the `moved_rows` of the `*.factor.lu`
spans over the sum of their `gathered_rows`, over the traced window.  A
program whose factor does not count them reads nothing (None)."""

from portbench import program_spans

KEYS = ("moved_rows", "gathered_rows")


def read(run):
    got = program_spans.window(run)
    if got is None:
        return None
    lu = program_spans.part(got[0], "factor.lu")
    if not lu or any(k not in r["attrs"] for r in lu for k in KEYS):
        return None
    gathered = sum(r["attrs"]["gathered_rows"] for r in lu)
    if gathered <= 0:
        return None
    return 100.0 * sum(r["attrs"]["moved_rows"] for r in lu) / gathered
