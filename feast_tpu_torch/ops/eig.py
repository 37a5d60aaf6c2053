"""Small dense complex eigensolvers: Schur by shifted QR, eigenvectors of
triangular factors, mixed-precision eig with inverse-iteration polish, and
the generalized (pencil) forms.

Counterpart of `feast_tpu/ops/eig.py` on native complex tensors.  The plain
Schur iteration here (Householder Hessenberg, single-shift QR sweeps with
the Wilkinson shift, deflation) has the JAX package's formulas; a
complex64 CUDA matrix with 2 <= n <= 128 takes the one-launch Hopper
kernel instead (`schur_kernel`), as f32 on the TPU takes the Pallas kernel.

Where the JAX package asks "is the backend the CPU" to pick between the
mixed and the full f64 eig (feast_tpu/ops/eig.py:393, :496, :560), the port
asks whether the tensor is on CUDA: the card takes the mixed path as the
TPU does, the CPU the full path as JAX on the CPU does.
"""

from __future__ import annotations

import math

import torch

from .. import cx
from . import lu as lumod


def _diag(x: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(x, dim1=-2, dim2=-1)


def hessenberg(A: torch.Tensor):
    """Reduce A (n, n) to upper Hessenberg H = Q^H A Q; returns (H, Q)."""
    n = A.shape[-1]
    A = A.clone()
    Q = torch.eye(n, dtype=A.dtype, device=A.device)
    for k in range(n - 2):
        x = A[k + 1:, k]
        normx = torch.sqrt(torch.sum(cx.abs2(x)))
        ph = cx.phase(x[0])
        v = x.clone()
        v[0] = v[0] + ph * normx
        vnorm2 = torch.sum(cx.abs2(v))
        beta = torch.where(vnorm2 > 0, 2.0 / torch.where(vnorm2 > 0, vnorm2, 1.0), 0.0)
        # left: A <- (I - beta v v^H) A
        w = v.conj() @ A[k + 1:, :]
        A[k + 1:, :] -= beta * torch.outer(v, w)
        # right: A <- A (I - beta v v^H), Q likewise
        u = A[:, k + 1:] @ v
        A[:, k + 1:] -= beta * torch.outer(u, v.conj())
        q = Q[:, k + 1:] @ v
        Q[:, k + 1:] -= beta * torch.outer(q, v.conj())
    return A, Q


def _givens(a: torch.Tensor, b: torch.Tensor):
    """Rotation G = [[c, s], [-conj(s), c]], c real, G [a; b] = [r; 0]."""
    na2 = cx.abs2(a)
    nb2 = cx.abs2(b)
    r2 = na2 + nb2
    b_zero = nb2 == 0
    r = torch.sqrt(torch.where(r2 > 0, r2, 1.0))
    c = torch.where(b_zero, 1.0, torch.sqrt(na2) / r)
    s = torch.where(b_zero, 0.0, cx.phase(a) * b.conj() / r)
    return c, s


def _qr_sweep(H: torch.Tensor, Z: torch.Tensor, k: int, sigma: torch.Tensor):
    """One explicit-shift QR sweep on the leading (k+1) block of Hessenberg
    H: H' = R Q + sigma I with H - sigma I = Q R.  Rotations with index >= k
    are the identity, so deflated trailing rows and columns stay as they
    are.  Z accumulates the unitary similarity."""
    n = H.shape[-1]
    idx = torch.arange(n, device=H.device)
    dsig = torch.where(idx <= k, sigma, 0.0)
    H = H - torch.diag(dsig)
    Z = Z.clone()
    cs = []
    # forward: eliminate the subdiagonal with row rotations
    for i in range(k):
        c, s = _givens(H[i, i], H[i + 1, i])
        top = H[i] * c + s * H[i + 1]
        bot = H[i + 1] * c - s.conj() * H[i]
        H[i], H[i + 1] = top, bot
        cs.append((c, s))
    # backward: right-multiply R and Z by G_0^H ... G_{k-1}^H
    for i, (c, s) in enumerate(cs):
        for M in (H, Z):
            ci, cj = M[:, i].clone(), M[:, i + 1].clone()
            M[:, i] = ci * c + s.conj() * cj
            M[:, i + 1] = cj * c - s * ci
    return H + torch.diag(dsig), Z


def _wilkinson_shift(H: torch.Tensor, k: int, stagnation: int):
    """Eigenvalue of the trailing active 2x2 closest to H[k, k]; the
    exceptional shift H[k,k] + 0.75 |H[k,k-1]| every 10 stalled sweeps."""
    a, b = H[k - 1, k - 1], H[k - 1, k]
    g, d = H[k, k - 1], H[k, k]
    if stagnation > 0 and stagnation % 10 == 0:
        return torch.complex(d.real + 0.75 * cx.cabs(g), d.imag)
    delta = (a - d) * 0.5
    bg = b * g
    t = cx.csqrt(delta * delta + bg)
    den1, den2 = delta + t, delta - t
    den = torch.where(cx.abs2(den1) >= cx.abs2(den2), den1, den2)
    small = cx.abs2(den) <= 0
    quot = cx.cdiv(bg, torch.where(small, torch.ones_like(den), den))
    return d - torch.where(small, torch.zeros_like(quot), quot)


_SCHUR_BACKEND = "cuda"


def set_schur_backend(name: str):
    """Select the f32 Schur on the card: "cuda" (the one-launch Hopper
    kernel, ops/schur_kernel.py) or "torch" (the plain iteration below).
    complex128, and every tensor on the CPU, always take the plain one."""
    global _SCHUR_BACKEND
    if name not in ("cuda", "torch"):
        raise ValueError(f"unknown schur backend {name!r}")
    _SCHUR_BACKEND = name


def _kernel_gate(A: torch.Tensor) -> bool:
    """Whether complex64 A (n, n), or a batch (..., n, n) in one launch,
    takes the Schur kernel."""
    n = A.shape[-1]
    return (_SCHUR_BACKEND == "cuda" and A.dtype == torch.complex64
            and A.is_cuda and 2 <= n <= 128)


def _pow2_exponent(A: torch.Tensor) -> int:
    """e such that 2^-e brings A's largest |re|, |im| into [1, 2), clamped
    to the normal exponents of A's real dtype (the prescale of
    csrc/schur.cu); 0 for a matrix with a non-finite entry."""
    amax = float(torch.max(torch.abs(torch.view_as_real(A))))
    if not math.isfinite(amax):
        return 0
    emax = int(math.log2(torch.finfo(cx.real_dtype(A.dtype)).max)) - 1
    e = math.frexp(amax)[1] - 1 if amax > 0 else -emax
    return min(max(e, -emax), emax)


def _schur_plain(A: torch.Tensor, max_sweeps_per_eig: int = 30):
    """Plain Schur iteration: returns (T, Z, (sweeps, sum of window sizes)).

    A is first scaled by the power of two that brings its largest entry
    into [1, 2), and T scaled back at the end, as the kernel does: every
    step is homogeneous in A, so in the normal range no bit changes, and
    entries of 1e-20 no longer square into the subnormals."""
    n = A.shape[-1]
    if n == 1:
        return A.clone(), torch.ones_like(A), (0, 0)
    e2 = _pow2_exponent(A)
    T, Z, stats = _schur_plain_scaled(A * 2.0 ** -e2, max_sweeps_per_eig)
    return T * 2.0 ** e2, Z, stats


def _schur_plain_scaled(A: torch.Tensor, max_sweeps_per_eig: int):
    n = A.shape[-1]
    H, Z = hessenberg(A)
    eps = torch.finfo(cx.real_dtype(A.dtype)).eps
    fnorm = cx.fro_norm(H)
    tolfb = eps * torch.where(fnorm > 0, fnorm, 1.0)
    sub_r = torch.arange(1, n, device=A.device)
    sub_c = torch.arange(n - 1, device=A.device)

    def deflate(H):
        dabs = cx.cabs(_diag(H))
        tol = eps * (dabs[:-1] + dabs[1:])
        tol = torch.where(tol > 0, tol, tolfb)
        sub = H[sub_r, sub_c]
        conv = cx.cabs(sub) <= tol
        H[sub_r, sub_c] = torch.where(conv, torch.zeros_like(sub), sub)
        return int(torch.max(torch.where(conv, 0, sub_c + 1)))

    k = deflate(H)
    it = stag = work = 0
    while k > 0 and it < max_sweeps_per_eig * n:
        sigma = _wilkinson_shift(H, k, stag)
        H, Z = _qr_sweep(H, Z, k, sigma)
        k_new = deflate(H)
        stag = 0 if k_new < k else stag + 1
        work += k
        k = k_new
        it += 1
    return torch.triu(H), Z, (it, work)


def schur(A: torch.Tensor, max_sweeps_per_eig: int = 30):
    """Complex Schur decomposition A = Z T Z^H; returns (T, Z)."""
    if _kernel_gate(A):
        from . import schur_kernel

        return schur_kernel.schur(A, max_sweeps_per_eig=max_sweeps_per_eig)
    T, Z, _ = _schur_plain(A, max_sweeps_per_eig)
    return T, Z


def tri_eigvecs(T: torch.Tensor) -> torch.Tensor:
    """Eigenvectors of upper-triangular T by back-substitution: column i
    solves (T - lam_i I) y = 0 with y_i = 1 and zeros below; |T_jj - lam_i|
    is floored at eps * max(||T||_F, 1)."""
    n = T.shape[-1]
    lam = _diag(T)
    eps = torch.finfo(cx.real_dtype(T.dtype)).eps
    smln = eps * torch.clamp(cx.fro_norm(T), min=1.0)
    Y = torch.eye(n, dtype=T.dtype, device=T.device)
    for j in range(n - 2, -1, -1):
        num = T[j, j + 1:] @ Y[j + 1:, j + 1:]
        den = T[j, j] - lam[j + 1:]
        den = torch.where(cx.cabs(den) < smln, smln.to(T.dtype), den)
        Y[j, j + 1:] = cx.cdiv(-num, den)
    return Y


def tri_unit_inv(Y: torch.Tensor) -> torch.Tensor:
    """Inverse of a unit upper-triangular Y: row j is e_j - Y[j, j+1:] X[j+1:]."""
    n = Y.shape[-1]
    X = torch.eye(n, dtype=Y.dtype, device=Y.device)
    for j in range(n - 2, -1, -1):
        X[j, j + 1:] = -(Y[j, j + 1:] @ X[j + 1:, j + 1:])
    return X


def _rq_refine(A, w, V, U, kappa_max: float = 1e4):
    """Two-sided Rayleigh quotients (u^H A v)/(u^H v); a pair whose
    condition number ||u|| ||v|| / |u^H v| exceeds kappa_max keeps w."""
    num = cx.cdot_cols(U, A @ V)
    den = cx.cdot_cols(U, V)
    dmag = cx.cabs(den)
    safe = dmag > 0
    kappa = cx.col_norms(U) * cx.col_norms(V) / torch.where(safe, dmag, 1.0)
    w_rq = cx.cdiv(num, torch.where(safe, den, torch.ones_like(den)))
    return torch.where(safe & (kappa < kappa_max), w_rq, w)


def _ii_polish(A: torch.Tensor, lam: torch.Tensor, V: torch.Tensor,
               steps: int = 2):
    """Batched inverse iteration with Rayleigh-quotient shifts.  Each step
    solves (A - lam_j I) y_j = v_j for all j at once through the plain
    blocked LU, whose zero-pivot guard keeps the exact-shift solve finite.
    A (..., n, n), lam (..., n), V (..., n, n)."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)

    def rq(V):
        return cx.cdot_cols(V, A @ V)

    for _ in range(steps):
        lam = rq(V)
        Sb = A[..., None, :, :] - lam[..., :, None, None] * eye
        Y = lumod.solve_batched(Sb, V.mT[..., :, :, None])
        V = cx.normalize_cols(Y[..., 0].mT)
    return rq(V), V


def _schur_vecs32(A: torch.Tensor, want_inv: bool = True):
    """(T, Z, Y, X = Y^-1) of A (..., n, n): one kernel launch for
    complex64 on the card (a batch in the same launch), the plain pieces
    elsewhere (any dtype, one matrix at a time)."""
    if _kernel_gate(A):
        from . import schur_kernel

        return schur_kernel.schur(A, want_y=True)
    if A.dim() == 2:
        return _schur_vecs_plain(A, want_inv)
    parts = [_schur_vecs_plain(M, want_inv) for M in A.reshape((-1,) + A.shape[-2:])]
    return tuple(None if p[0] is None else torch.stack(p).reshape(A.shape)
                 for p in zip(*parts))


def _schur_vecs_plain(A: torch.Tensor, want_inv: bool):
    T, Z = schur(A)
    Y = tri_eigvecs(T)
    return T, Z, Y, (tri_unit_inv(Y) if want_inv else None)


def eig_mixed(A: torch.Tensor, ii_steps: int = 2):
    """complex64 Schur seed + complex128 inverse-iteration polish, over
    leading batch dims (one Schur launch on the card for the batch)."""
    if A.dtype == torch.complex64:
        return eig(A)
    T32, Z32, Y32, _ = _schur_vecs32(A.to(torch.complex64))
    V = cx.normalize_cols(Z32 @ Y32).to(A.dtype)
    lam0 = _diag(T32).to(A.dtype)
    return _ii_polish(A, lam0, V, ii_steps)


def _indep_flag(V: torch.Tensor, floor: float = 1e-4) -> torch.Tensor:
    """Column-independence guard of the mixed eig, as a bool tensor of V's
    batch shape (0-d for one matrix): the pivots of the Cholesky factor of
    V^H V (unit columns) bound sigma_min(V) from above, and a pivot at or
    below `floor` rejects V."""
    from . import qr as qrmod

    d = _diag(qrmod.cholesky(cx.cgram(V))).real
    return torch.isfinite(d).all(-1) & (torch.amin(d, dim=-1) > floor)


def _indep_ok(V: torch.Tensor, floor: float = 1e-4) -> bool:
    """`_indep_flag` read on the host."""
    return bool(_indep_flag(V, floor))


_EIG_MODE = "mixed"


def set_eig_mode(name: str):
    """complex128 eig on the card: "mixed" (default: complex64 Schur seed
    plus complex128 inverse-iteration polish, guarded by a residual and
    independence check that falls back to the full path) or "full" (the
    complex128 Schur iteration).  The CPU always takes "full"."""
    global _EIG_MODE
    if name not in ("full", "mixed"):
        raise ValueError(f"unknown eig mode {name!r}")
    _EIG_MODE = name


def _mixed_gate(A: torch.Tensor) -> bool:
    return _mixed_route(A.dtype, A.shape[-1], A.device)


def _mixed_route(dtype: torch.dtype, n: int, device: torch.device) -> bool:
    """Whether `eig` / `gen_eig` of an (n, n) matrix of this dtype on this
    device take the guarded mixed path."""
    return (_EIG_MODE == "mixed" and dtype == torch.complex128
            and 2 <= n <= 128 and device.type == "cuda")


def _eig_full(A: torch.Tensor, refine_rq: bool = True):
    T, Z, Y, Yinv = _schur_vecs32(A, want_inv=refine_rq)
    w = _diag(T)
    V = Z @ Y
    if refine_rq:
        w = _rq_refine(A, w, V, Z @ Yinv.mH)
    return w, cx.normalize_cols(V)


def _eig_flagged(A: torch.Tensor):
    """The mixed path of `eig` with its acceptance decided on the device:
    (lam, V, ok), ok a bool tensor that holds where every residual column
    is within 1e-12 max(||A||_F, 1) sqrt(n) and V passes `_indep_flag`
    (feast_tpu/ops/eig.py:498-505).  Where ok is false the caller takes
    `_eig_full`, as `eig` does.  Nothing is read on the host but what the
    complex64 Schur seed reads (on the card: one K2 launch).  A batch
    (..., n, n) gives ok of shape (...): each matrix its own guard, as
    under the JAX package's vmap."""
    n = A.shape[-1]
    lam, V = eig_mixed(A, ii_steps=3)
    R = A @ V - cx.scale_cols(V, lam)
    scale = torch.clamp(cx.fro_norm(A), min=1.0)
    ok = torch.amax(cx.col_norms(R), dim=-1) <= 1e-12 * scale * math.sqrt(n)
    return lam, V, ok & _indep_flag(V)


def eig(A: torch.Tensor, refine_rq: bool = True):
    """Eigenvalues and unit right eigenvectors (w (n,), V (n, n)) of A.

    refine_rq polishes each value with a guarded two-sided Rayleigh
    quotient (left vectors from the unit-triangular Y inverse)."""
    if _mixed_gate(A):
        lam_m, V_m, ok = _eig_flagged(A)
        if bool(ok):
            return lam_m, V_m
    return _eig_full(A, refine_rq)


def _rq_refine_pencil(A, B, w, V, U, kappa_max: float = 1e4):
    """Two-sided pencil Rayleigh quotients (u^H A v)/(u^H B v), u a left
    pencil eigenvector; the kappa guard scaled by ||B||_F / sqrt(n)."""
    num = cx.cdot_cols(U, A @ V)
    den = cx.cdot_cols(U, B @ V)
    dmag = cx.cabs(den)
    safe = dmag > 0
    n = A.shape[-1]
    bscale = cx.fro_norm(B) / math.sqrt(n)
    kappa = (cx.col_norms(U) * cx.col_norms(V) * bscale
             / torch.where(safe, dmag, 1.0))
    w_rq = cx.cdiv(num, torch.where(safe, den, torch.ones_like(den)))
    return torch.where(safe & (kappa < kappa_max), w_rq, w)


def _gen_eig_flagged(A: torch.Tensor, B: torch.Tensor):
    """The mixed path of `gen_eig` with its acceptance decided on the
    device: (lam, V, ok), ok a bool tensor of the batch shape: every
    residual column within 1e-12 max(||A||_F + max|lam| ||B||_F, 1)
    sqrt(n), and V passing `_indep_flag`.  Where ok is false the caller
    takes `_gen_eig_full`."""
    n = A.shape[-1]
    lam, V = _gen_eig_mixed(A, B)
    R = A @ V - cx.scale_cols(B @ V, lam)
    scale = torch.clamp(cx.fro_norm(A) + torch.amax(cx.cabs(lam), dim=-1)
                        * cx.fro_norm(B), min=1.0)
    ok = torch.amax(cx.col_norms(R), dim=-1) <= 1e-12 * scale * math.sqrt(n)
    return lam, V, ok & _indep_flag(V)


def gen_eig(A: torch.Tensor, B: torch.Tensor, refine_rq: bool = True):
    """A x = lam B x for small dense pairs with B invertible, by the
    reduction B^{-1} A; returns (w, V) with A V ~= B V diag(w)."""
    if _mixed_gate(A):
        lam_m, V_m, ok = _gen_eig_flagged(A, B)
        if bool(ok):
            return lam_m, V_m
    return _gen_eig_full(A, B, refine_rq)


def _gen_eig_mixed(A: torch.Tensor, B: torch.Tensor, ii_steps: int = 3):
    """complex64 Schur seed of B^{-1} A + complex128 pencil inverse
    iteration with shifts (v^H A v)/(v^H B v), over leading batch dims."""
    LU, perm = lumod.lu_factor(B)
    C = lumod.lu_solve(LU, perm, A)
    T32, Z32, Y32, _ = _schur_vecs32(C.to(torch.complex64))
    V = cx.normalize_cols(Z32 @ Y32).to(A.dtype)

    def rq(V):
        num = cx.cdot_cols(V, A @ V)
        den = cx.cdot_cols(V, B @ V)
        safe = cx.cabs(den) > 0
        return cx.cdiv(num, torch.where(safe, den, torch.ones_like(den)))

    lam = rq(V)
    for _ in range(ii_steps):
        Sb = A[..., None, :, :] - lam[..., :, None, None] * B[..., None, :, :]
        Y = lumod.solve_batched(Sb, (B @ V).mT[..., :, :, None])
        V = cx.normalize_cols(Y[..., 0].mT)
        lam = rq(V)
    return lam, V


def _gen_eig_full(A: torch.Tensor, B: torch.Tensor, refine_rq: bool = True):
    LU, perm = lumod.lu_factor(B)
    C = lumod.lu_solve(LU, perm, A)
    if not refine_rq:
        return eig(C, refine_rq=False)
    T, Z = schur(C)
    w = _diag(T)
    Y = tri_eigvecs(T)
    V = Z @ Y
    Wc = Z @ tri_unit_inv(Y).mH           # left eigenvectors of C
    LUh, permh = lumod.lu_factor(B.mH)
    U = lumod.lu_solve(LUh, permh, Wc)    # left eigenvectors of the pencil
    w = _rq_refine_pencil(A, B, w, V, U)
    return w, cx.normalize_cols(V)


def eig_left(A: torch.Tensor):
    """Left eigenvectors, y^H A = lam y^H: the right eigenvectors of A^H
    with the eigenvalues conjugated.  Returns (w, Y)."""
    wbar, Y = eig(A.mH.resolve_conj())
    return torch.conj_physical(wbar), Y


def gen_eig_two_sided(A: torch.Tensor, B: torch.Tensor):
    """Right and left eigenvectors of the pencil (A, B): returns
    (w, V, (wl, W)) with A V = B V diag(w) and W the right eigenvectors of
    the adjoint pencil (A^H, B^H), whose values wl are conj(w) in another
    order."""
    LU, perm = lumod.lu_factor(B)
    w, V = eig(lumod.lu_solve(LU, perm, A))                    # B^-1 A
    LUh, permh = lumod.lu_factor(B.mH.resolve_conj())
    wl, W = eig(lumod.lu_solve(LUh, permh, A.mH.resolve_conj()))  # B^-H A^H
    return w, V, (wl, W)
