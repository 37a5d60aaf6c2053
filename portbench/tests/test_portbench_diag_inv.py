"""The reader of the factor's diagonal-block inverses
(`metrics/diag_inv_s.py`) on hand-built span records."""

import pytest

from portbench import program_spans
from portbench.tests.test_portbench_span_readers import (  # noqa: F401 (records is a fixture)
    dense_solve, gun_solve, read, rec, records, window)


def with_diag_inv(recs, seconds=0.01):
    """`recs` with a `*.factor.diag_inv` span under every factor span."""
    out = []
    for r in recs:
        out.append(r)
        if r["name"] in ("feast.factor", "nlfeast.factor"):
            out.append(rec(r["name"] + ".diag_inv", seconds, r["id"], r["solve"],
                           blocks=320, kernel_blocks=320))
    return out


@pytest.mark.parametrize("name,solves,want", [("diag_inv_s", "dense", 0.01),
                                              ("diag_inv_s.nep", "gun", 8 * 0.01),
                                              ("diag_inv_s.node4", "dense", 0.01)])
def test_diag_inv_s(records, name, solves, want):  # noqa: F811
    """Device seconds of the window's diag_inv spans over its solves (two
    dense solves of one factor each, or the gun's eight chunk factors);
    None where the program has no such span, where one lacks its device
    time, or where the roots are not the window's solves."""
    make, n = (lambda: dense_solve() + dense_solve(), 2) if solves == "dense" else (gun_solve, 1)
    records.value = with_diag_inv(make())
    assert read(name, window(n)) == pytest.approx(want)
    records.value = make()                       # the parent program: no such span
    assert read(name, window(n)) is None
    recs = with_diag_inv(make())
    last = max(i for i, r in enumerate(recs) if r["name"].endswith(".factor.diag_inv"))
    recs[last] = dict(recs[last], device_s=None)
    records.value = recs
    assert read(name, window(n)) is None
    records.value = [r for r in with_diag_inv(make()) if r["name"] not in program_spans.ROOTS]
    assert read(name, window(0)) is None
