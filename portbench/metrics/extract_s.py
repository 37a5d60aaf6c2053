"""extract_s (s/solve, program span): the mean, over the traced window's
solves, of the seconds inside the configuration's "extract" span (the
NEP's Beyn extraction; `spans.py`)."""


def read(run):
    got = [o["spans"]["extract"] for o in run.outcomes if "extract" in o["spans"]]
    if not got:
        return None
    return sum(got) / len(run.outcomes)
