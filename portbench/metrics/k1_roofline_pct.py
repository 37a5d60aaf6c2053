"""k1_roofline_pct (%, device trace): K1's summed bound over its summed
device time in the traced window.  Launch i of a factor works at
j0 = (i mod n / b) b; n, the panel width b and the batch come from the
configuration's `kernels.k1` (`roofline/k1.py`, peaks in
`roofline/peaks.py`)."""

from portbench.harness import load


def read(run):
    shape = run.config.get("kernels", {}).get("k1")
    if run.events is None or shape is None:
        return None
    k1, peaks = load("roofline", "k1"), load("roofline", "peaks")
    times = [t for name, ts in run.events["ordered"].items() if k1.KERNEL in name
             for t in ts]
    b = int(shape["panel"])
    n = k1.padded(int(shape["n"]), b)
    panels = n // b
    if not times or len(times) % panels:
        return None
    per_factor = 0.0
    for p in range(panels):
        flops, nbytes = k1.launch(n, b, p * b, int(shape["batch"]))
        per_factor += peaks.bound_s(nbytes, flops)
    return peaks.share_pct(per_factor * (len(times) // panels), sum(times))
