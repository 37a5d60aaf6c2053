"""Dense kernels of the port: LU (with the panel kernel), QR, eig (with the
Schur kernel)."""
