"""Building blocks of the port: dense LU (with the panel kernel), QR, SVD,
eig (with the Schur kernel), Hermitian eigh, QZ, the complex64
matrix-product kernel, sparse operators (with the DIA kernel, and BELL),
Krylov solvers, AMG, fast diagonalization and reordering.

Importing the package binds the submodules the JAX package's `ops` binds:
`amg`, `eig`, `eigh`, `krylov`, `lu`, `qr`, `qz`, `sparse` and `svd`.  The
others (`cmatmul_kernel`, `dia_kernel`, `fastdiag`, `panel_lu`, `reorder`,
`schur_kernel`) are imported by name, as `ops.fastdiag` is in the JAX
package."""

from . import amg, eig, eigh, krylov, lu, qr, qz, sparse, svd
