"""node_eff_pct (%, program span): the node-parallel efficiency of a solve
on p ranks, 100 (R + p W) / (p (R + W + S)) from the traced window's spans
on rank 0, each in device seconds per solve:

  R  the Rayleigh-Ritz, repeated on every rank (`feast.rr`,
     `feast.eig_fallback`)
  W  this rank's node work (`feast.factor`, `feast.update`)
  S  the node sum (`feast.node_sum`), the wait for the slowest rank in it
  p  the node sum's `ranks`

R + p W is the one-card time of the same work, which no card can run at
this size (it is derived, not measured); p (R + W + S) is the card time
the p ranks spend.  None without the node sum's spans."""

from portbench import program_spans


def read(run):
    got = program_spans.window(run)
    if got is None:
        return None
    recs, solves = got
    sums = program_spans.part(recs, "node_sum")
    if not sums or any("ranks" not in r["attrs"] for r in sums):
        return None
    p = sums[0]["attrs"]["ranks"]

    def seconds(*parts):
        return program_spans.device_s([r for name in parts
                                       for r in program_spans.part(recs, name)])

    R, W, S = seconds("rr", "eig_fallback"), seconds("factor", "update"), seconds("node_sum")
    if R is None or W is None or S is None:
        return None
    return 100.0 * (R + p * W) / (p * (R + W + S))
