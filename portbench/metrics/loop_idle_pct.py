"""loop_idle_pct (%, program span): the sweep loop's idle share on CUDA
events, 100 (1 - busy / loop) over the traced window.  busy: the device
seconds of the sweeps' steps and eig fallbacks (`feast.rr`, `feast.update`,
`feast.eig_fallback`); loop: the device seconds of the loops that hold them
(`feast.loop`), from the stream reaching the loop's start marker, after the
factor, to its end marker.  What is left is the card waiting on the host:
the status reads, the launches, the host's own work between steps."""

from portbench import program_spans


def read(run):
    got = program_spans.window(run)
    if got is None:
        return None
    recs = got[0]
    loop = program_spans.device_s(program_spans.part(recs, "loop"))
    busy = program_spans.device_s([r for p in ("rr", "update", "eig_fallback")
                                   for r in program_spans.part(recs, p)])
    if not loop or busy is None:
        return None
    return 100.0 * (1.0 - busy / loop)
