"""factor_s (s/solve, program span): the mean, over the traced window's
solves, of the seconds inside the configuration's "factor" span
(synchronised at both ends; `spans.py`)."""


def read(run):
    got = [o["spans"]["factor"] for o in run.outcomes if "factor" in o["spans"]]
    if not got:
        return None
    return sum(got) / len(run.outcomes)
