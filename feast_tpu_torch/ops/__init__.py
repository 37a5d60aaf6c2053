"""Building blocks of the port: dense LU (with the panel kernel), QR, SVD,
eig (with the Schur kernel), Hermitian eigh, QZ, the complex64
matrix-product kernel, sparse operators (with the DIA kernel, and BELL),
Krylov solvers, AMG, fast diagonalization and reordering."""
