"""Bandwidth-reduction reordering for unstructured sparse operators.

Own copy of `feast_tpu/ops/reorder.py` (numpy/scipy only, same logic).
The fast sparse products are structure-dependent: DIA needs few dense
diagonals, BELL wants nnz clustered into few blocks per block row.  A genuinely unstructured matrix, or a banded matrix under a
random row/column permutation, satisfies neither and falls to the
gather-bound CSR path.

An eigenproblem is permutation-invariant: (P A P^T) (P x) = lam (P B P^T)
(P x), so the fix is host-side bookkeeping: reverse Cuthill-McKee on the
symmetrized pattern of |A| (+|B|), solve the permuted problem on the
structured path, permute the eigenvectors back.

`feast_iterative(reorder="auto")` applies this transparently.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def bandwidth(A) -> int:
    """max |i - j| over stored nonzeros (host-side)."""
    import scipy.sparse as sp

    coo = sp.csr_matrix(A).tocoo()
    if coo.nnz == 0:
        return 0
    return int(np.abs(coo.row.astype(np.int64)
                      - coo.col.astype(np.int64)).max())


def rcm_permutation(A, B=None) -> np.ndarray:
    """Reverse Cuthill-McKee permutation on the symmetrized union pattern
    of A (and B).  Returns `perm` such that A[perm][:, perm] has (near-)
    minimal bandwidth; `np.argsort(perm)` is the inverse."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    P = sp.csr_matrix(abs(sp.csr_matrix(A)))
    if B is not None:
        P = P + sp.csr_matrix(abs(sp.csr_matrix(B)))
    P = (P + P.T).tocsr()
    return np.asarray(reverse_cuthill_mckee(P, symmetric_mode=True),
                      dtype=np.int64)


def permute_pencil(A, B, perm: np.ndarray):
    """Symmetric permutation of a pencil: (P A P^T, P B P^T)."""
    Ap = A[perm][:, perm].tocsr()
    Bp = None if B is None else B[perm][:, perm].tocsr()
    return Ap, Bp


def plan_reorder(A, B=None, *, min_gain: float = 0.5
                 ) -> Tuple[Optional[np.ndarray], dict]:
    """Decide whether RCM pays off.  Returns (perm or None, info dict).

    Applies when RCM shrinks the pattern bandwidth to <= min_gain of the
    original (a banded matrix in disguise, or any matrix whose fast-path
    storage cost drops accordingly).  Already-banded inputs (bandwidth
    unchanged) and patterns RCM cannot improve return perm=None."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    bw0 = bandwidth(A if B is None else abs(A) + abs(sp.csr_matrix(B)))
    perm = rcm_permutation(A, B)
    Ap = sp.csr_matrix(abs(A))[perm][:, perm]
    if B is not None:
        Ap = Ap + sp.csr_matrix(abs(sp.csr_matrix(B)))[perm][:, perm]
    bw1 = bandwidth(Ap)
    info = {"bandwidth_before": bw0, "bandwidth_after": bw1}
    if bw1 <= min_gain * max(bw0, 1):
        return perm, info
    return None, info


def aggregate_block_permutation(A, bs: int = 32, theta: float = 0.08,
                                levels: int = 10) -> np.ndarray:
    """Ordering that minimizes BELL's block count rather than bandwidth:
    greedy strength-graph aggregation (`amg._aggregate`) repeated until
    clusters reach about bs rows, the clusters laid out contiguously in the
    RCM order of the cluster graph.  Rows sharing a block then share
    neighbours, so each block row touches few column blocks."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    from .amg import _aggregate

    A = sp.csr_matrix(abs(sp.csr_matrix(A)))
    A = (A + A.T).tocsr()
    n = A.shape[0]
    label = np.arange(n)      # label[i]: the current cluster of row i
    G = A
    size = 1.0
    for _ in range(levels):
        if size >= bs:
            break
        agg, n_agg = _aggregate(G, theta)
        label = agg[label]
        # the cluster graph for the next round (pattern only)
        P = sp.csr_matrix((np.ones(G.shape[0]), (np.arange(G.shape[0]), agg)),
                          shape=(G.shape[0], n_agg))
        G = (P.T @ G @ P).tocsr()
        G.data[:] = 1.0
        size = n / n_agg
    corder = np.asarray(reverse_cuthill_mckee(G, symmetric_mode=True))
    crank = np.argsort(corder)
    return np.asarray(np.lexsort((np.arange(n), crank[label])), dtype=np.int64)
