"""The node sum's all-reduce (`parallel/mesh.py::node_sum_`, NCCL on the
card): the bytes a rank's link carries, and the link's peak.

A ring all-reduce of a payload of B bytes over p ranks is a
reduce-scatter and an all-gather: every rank sends, and receives,
2 (p - 1) / p B bytes (the "bus bytes" of NCCL's own tests,
nccl-tests doc/PERFORMANCE.md), so its least time is those bytes over the
link's peak in one direction.  Operations: (p - 1) / p of the payload's
real components added on each rank, under 1e-6 of the card's float32
peak for these payloads: not counted.

The peak: on the four-card H100 SXM machine `nvidia-smi nvlink --status`
reads 18 NVLink links a card at 26.562 GB/s each (`nvidia-smi topo -m`
does not run there), NVLink 4, whose published rate is 900 GB/s both
ways, 450 GB/s in each direction a card (NVIDIA's H100 data sheet).  A
PCIe Gen5 x16 link would give 64 GB/s, which the node sum's measured
rate passes.
"""

PEAK_LINK_BYTES_PER_S = 450e9   # NVLink 4, 18 links, one direction


def launch(nbytes: int, ranks: int):
    """(operations, bytes) of one all-reduce of `nbytes` over `ranks`:
    the operations are not counted (0), the bytes are a rank's bus bytes."""
    return 0, 2 * (ranks - 1) / ranks * nbytes


def bound_s(nbytes: int, ranks: int) -> float:
    """The least time of one all-reduce: its bus bytes over the link's peak."""
    return launch(nbytes, ranks)[1] / PEAK_LINK_BYTES_PER_S
