"""K1, the panel LU of the node factorizations (`csrc/panel_lu.cu`,
kernel `panel_lu_cluster`): the operations and bytes of one launch from
its shape.

Copied from `chip_smoke.py` (`panel_flops`, and the bytes of
`panel_timing`).  One launch factors the (batch, n, b) column panel at
row and column j0 of a batch of n x n complex64 matrices (n the padded
size the kernel walks, a multiple of b):

  operations  per matrix: for each of the b columns the pivot search
              (3 per row at and below the pivot), the multipliers (6 per
              row below) and the rank-one update of the panel's remaining
              columns (8 per complex multiply-add), then the inverse of
              the unit lower b x b block; float32 operations;
  bytes       per matrix: all n rows of the panel read once (the slab's
              maximum behind the zero-pivot floor), the rows at and below
              j0 written, the permutation (4 bytes a row) and the b x b
              inverse written.

A factor of an n x n batch is n / b launches, j0 = 0, b, 2b, ...
"""

from functools import lru_cache

KERNEL = "panel_lu_cluster"


@lru_cache(maxsize=None)
def panel_flops(n: int, b: int, j0: int) -> int:
    f = 0
    for k in range(b):
        below = n - (j0 + k) - 1
        f += 3 * (below + 1) + 6 * below + 8 * below * (b - k - 1)
    f += sum(8 * (b - l - 1) * (l + 1) for l in range(b - 1))
    return f


def panel_bytes(n: int, b: int, j0: int) -> int:
    return n * b * 8 + (n - j0) * b * 8 + n * 4 + b * b * 8


def padded(n: int, b: int) -> int:
    return -(-n // b) * b


def launch(n: int, b: int, j0: int, batch: int):
    """(operations, bytes) of one launch on a batch of `batch` matrices of
    padded size n."""
    return batch * panel_flops(n, b, j0), batch * panel_bytes(n, b, j0)
