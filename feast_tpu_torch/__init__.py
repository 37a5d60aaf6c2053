"""feast_tpu_torch: the PyTorch / CUDA port of feast_tpu.

A second package beside the JAX one (`feast_tpu/`, the unchanged
reference).  It imports torch and never jax or feast_tpu.  It holds the
dense mixed-precision FEAST path (`feast`, `gen_feast`, `feast_compiled`,
with their LU, QR, SVD, eig and QZ building blocks), the sparse iterative
path (`feast_iterative`, `ifeast`: DIA / CSR operators, batched Krylov
solvers, the smoothed-aggregation AMG preconditioner), the nonlinear
solvers (`nlfeast`, `nlfeast_moments`, `nlfeast_it`, `beyn`, `block_ss`,
`companion`, the stochastic count `contour_estimate_eig` and the
experimental moment variants, on the NEP types of `nep` and the problem
gallery of `problems`), the Hermitian and two-sided dense drivers, the
fast-diagonalization preconditioner (`ops.fastdiag`) and the blocked-ELL
operator (`ops.sparse.BELL`), MatrixMarket input and slice checkpoints
(`io`), diagnostics and tracing (`utils`), the checkpointing orchestrator
(`orchestrate`: one refinement sweep per worker subprocess), the parallel
layer on `torch.distributed` (`parallel`: node, row and slice meshes, the
`mesh=` argument of every driver, spectral slicing and row-sharded sparse
FEAST), and four kernels written by
hand for Hopper (sm_90a) in `csrc/`: the panel LU of the complex64 node factorizations,
the one-launch complex Schur decomposition of the reduced eigenproblem,
the fp32-accurate complex64 matrix product behind
`cx.set_gemm_backend("cuda")`, and the complex64 DIA sparse product of the
AMG V-cycle.

Entry points take `device=` (default "cuda") and raise when CUDA is
requested but absent.  Importing the package turns TF32 off for CUDA
matmuls (see `_device`).
"""

from . import (_device, config, contour, cx, interop, io, nep, ops, problems,
               solvers, utils)
from . import orchestrate, parallel
from .contour import (Contour, circular_contour_gauss,
                      circular_contour_trapezoidal, custom_contour,
                      elliptical_contour_trapezoidal, in_contour,
                      rational_func, rectangular_contour_gauss,
                      rectangular_contour_trapezoidal, zolotarev_contour)
from .nep import CallableNEP, LinearPencilNEP, PolynomialNEP, SPMF
from .utils import convergence_info, print_convergence_info
from .solvers import (DualFeastResult, FeastResult, beyn, block_ss, companion,
                      contour_estimate_eig, dual_gen_feast, feast,
                      feast_compiled, feast_iterative, gen_feast, ifeast,
                      nlfeast, nlfeast_it, nlfeast_moments,
                      nlfeast_moments_all, nlfeast_moments_ss, nlfeast_rr)
