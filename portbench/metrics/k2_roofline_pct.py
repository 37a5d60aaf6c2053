"""k2_roofline_pct (%, device trace): K2's summed bound over its summed
device time in the traced window, each launch of `kernels.k2.batch`
matrices of size `kernels.k2.n` (`roofline/k2.py`)."""

from portbench.harness import load


def read(run):
    shape = run.config.get("kernels", {}).get("k2")
    if run.events is None or shape is None:
        return None
    k2, peaks = load("roofline", "k2"), load("roofline", "peaks")
    times = [t for name, ts in run.events["ordered"].items() if k2.KERNEL in name
             for t in ts]
    if not times:
        return None
    flops, nbytes = k2.launch(int(shape["n"]), int(shape["batch"]))
    return peaks.share_pct(len(times) * peaks.bound_s(nbytes, flops), sum(times))
