"""The reader of the factor's row swap counts (`metrics/moved_rows_pct.py`)
on hand-built span records."""

import pytest

from portbench import program_spans
from portbench.tests.test_portbench_span_readers import (  # noqa: F401 (records is a fixture)
    dense_solve, gun_solve, read, records, window)


def counted(recs, moved=300, gathered=10_000):
    """`recs` with the row swaps' counts on every factor.lu span."""
    return [dict(r, attrs=dict(r["attrs"], moved_rows=moved, gathered_rows=gathered))
            if r["name"].endswith(".factor.lu") else r for r in recs]


@pytest.mark.parametrize("name,solves", [("moved_rows_pct", "dense"),
                                         ("moved_rows_pct.nep", "gun")])
def test_moved_rows_pct(records, name, solves):  # noqa: F811
    """100 * sum moved / sum gathered over the window's factor.lu spans (two
    dense solves, or the gun's eight chunk factors); None without the
    counts, where a span lacks one, or where the spans are missing."""
    make, n = (lambda: dense_solve() + dense_solve(), 2) if solves == "dense" else (gun_solve, 1)
    recs = make()
    lus = [i for i, r in enumerate(recs) if r["name"].endswith(".factor.lu")]
    recs = counted(recs)
    recs[lus[0]] = dict(recs[lus[0]], attrs={"moved_rows": 600, "gathered_rows": 20_000})
    records.value = recs
    moved = 300 * (len(lus) - 1) + 600
    gathered = 10_000 * (len(lus) - 1) + 20_000
    assert read(name, window(n)) == pytest.approx(100.0 * moved / gathered)
    records.value = make()                       # a program that does not count
    assert read(name, window(n)) is None
    recs = counted(make())
    recs[lus[-1]] = dict(recs[lus[-1]], attrs={"moved_rows": 5})
    records.value = recs
    assert read(name, window(n)) is None
    records.value = [r for r in counted(make()) if not r["name"].endswith(".factor.lu")]
    assert read(name, window(n)) is None
    records.value = [r for r in counted(make()) if r["name"] not in program_spans.ROOTS]
    assert read(name, window(0)) is None
