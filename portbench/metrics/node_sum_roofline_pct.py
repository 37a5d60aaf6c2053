"""node_sum_roofline_pct (%, program span and the link's peak): the node
sums' summed bound over their summed device seconds in the traced window.
A `feast.node_sum` span carries its payload's `bytes` and the `ranks`; its
bound is the ring all-reduce's bus bytes over the link's peak per
direction (`roofline/allreduce.py`).  The span's seconds, on rank 0, hold
the wait for the slowest rank.  None without the spans."""

from portbench import program_spans
from portbench.harness import load


def read(run):
    got = program_spans.window(run)
    if got is None:
        return None
    sums = program_spans.part(got[0], "node_sum")
    seconds = program_spans.device_s(sums)
    if not seconds or any(k not in r["attrs"] for r in sums for k in ("bytes", "ranks")):
        return None
    allreduce = load("roofline", "allreduce")
    bound = sum(allreduce.bound_s(r["attrs"]["bytes"], r["attrs"]["ranks"]) for r in sums)
    return 100.0 * bound / seconds
