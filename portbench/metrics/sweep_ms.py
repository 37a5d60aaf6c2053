"""sweep_ms (ms/sweep, program span): over the traced window's solves, the
walls less the "factor" spans, over the sweeps (FeastResult.n_iter)."""


def read(run):
    pairs = [(w, o) for w, o in zip(run.walls, run.outcomes) if "factor" in o["spans"]]
    sweeps = sum(o["n_iter"] for _, o in pairs)
    if not pairs or sweeps == 0:
        return None
    return 1e3 * sum(w - o["spans"]["factor"] for w, o in pairs) / sweeps
