"""sweeps (sweeps/solve, program counter): the mean of FeastResult.n_iter
over the traced window's solves."""


def read(run):
    if not run.outcomes:
        return None
    return sum(o["n_iter"] for o in run.outcomes) / len(run.outcomes)
