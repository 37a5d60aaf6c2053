"""device_idle_pct (%, device trace): 100 (1 - busy / wall) over the traced
window, busy the union of the device operations' intervals
(`devtrace.summarize`).  Read under the profiler, which stretches the
host's part of a solve."""


def read(run):
    ev = run.events
    if ev is None or ev["wall_s"] <= 0 or ev["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - ev["busy_s"] / ev["wall_s"])
