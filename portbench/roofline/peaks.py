"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, no sparsity, at the full 700 W power limit), copied from
`chip_smoke.py` (PEAK_*, `bound_ms`).  A roofline share is stated against
these, with the card's power limit printed beside it."""

PEAK_BYTES_PER_S = 3.35e12   # HBM3
PEAK_FP32_FLOPS = 67e12      # float32 outside the tensor cores


def bound_s(nbytes: float, flops: float, peak_flops: float = PEAK_FP32_FLOPS) -> float:
    """The least time the card could take: the larger of bytes over the
    bandwidth and operations over the peak rate."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / peak_flops)


def share_pct(bounds_s: float, device_s: float):
    """100 x summed bound over summed device time; None without device time."""
    if device_s <= 0:
        return None
    return 100.0 * bounds_s / device_s
