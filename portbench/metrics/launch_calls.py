"""launch_calls (calls/solve, device trace): cudaLaunch*, cuLaunch* and
cudaGraphLaunch calls of the host in the traced window, per solve."""


def read(run):
    ev = run.events
    if ev is None or not run.outcomes or ev["launch_calls"] == 0:
        return None
    return ev["launch_calls"] / len(run.outcomes)
