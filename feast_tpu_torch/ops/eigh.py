"""Hermitian eigendecomposition.

Counterpart of `feast_tpu/ops/eigh.py`.  The JAX package embeds a
Hermitian H = A + iB in the real symmetric [[A, -B], [B, A]] and picks n of
its 2n eigenvectors, repairing degenerate clusters by a pivoted
Gram-Schmidt, because the TPU has no complex dtype.  Torch has one, so the
port calls the complex `torch.linalg.eigh` (complex64 or complex128) on
the hermitized matrix.  Eigenvalues agree; inside a degenerate cluster
the two packages' eigenvectors span the same space but may differ by a
unitary, so compare values, residuals and cluster projectors, not columns.

Used by the Rayleigh-Ritz fast path of `pencil="hermitian"` and as a Gram
eigensolver.
"""

from __future__ import annotations

import torch


def eigh_cx(H: torch.Tensor):
    """Eigenvalues (ascending, real) and unitary eigenvectors of a
    Hermitian H: returns (w (n,), V (n, n)) with H V = V diag(w)."""
    return torch.linalg.eigh((H + H.mH) / 2)


def gram_eigh(A: torch.Tensor):
    """Eigendecomposition of the Hermitian Gram matrix A^H A."""
    return eigh_cx(A.mH @ A)
