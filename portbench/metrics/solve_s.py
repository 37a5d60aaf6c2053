"""solve_s (s, host clock): the window's wall over the solves completed in
it.  The window runs whole solves, each synchronised at its end, and
holds everything between them (the next start's draw, the results read
back to the host)."""


def read(run):
    if not run.outcomes:
        return None
    return run.window_s / len(run.outcomes)
