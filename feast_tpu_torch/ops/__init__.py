"""Building blocks of the port: dense LU (with the panel kernel), QR, SVD,
eig (with the Schur kernel), QZ, the complex64 matrix-product kernel,
sparse operators (with the DIA kernel), Krylov solvers, AMG and
reordering."""
