"""K2, the complex Schur decomposition of the reduced eigenproblem
(`csrc/schur.cu`, kernel `schur_kernel`): the operations and bytes of one
launch from n alone.

Operations: the published count of the QR algorithm, Golub and Van Loan,
Matrix Computations (4th ed., section 7.5, its table of the work of
the practical QR algorithm): about 25 n^3 flops for the
Schur form T with its Schur vectors Z, counted for real arithmetic.  In
complex arithmetic each of those multiply-adds is a complex one, 8 real
operations in place of 2, so 100 n^3 float32 operations a matrix.  The
count does not depend on the sweeps the kernel itself takes, so a kernel
that needs fewer sweeps does the same counted work in less time.
Bytes: the n x n complex64 input read once, T and Z written once.
"""

KERNEL = "schur_kernel"


def launch(n: int, batch: int):
    """(operations, bytes) of one launch on `batch` matrices of size n."""
    return batch * 100 * n ** 3, batch * 3 * n * n * 8
