"""Blocked dense complex LU with partial pivoting, and triangular solves.

Counterpart of `feast_tpu/ops/lu.py` on native complex tensors.  Every
function takes leading batch dimensions (the contour-node axis of the
drivers), so the JAX package's `vmap`-ed forms are the same functions here.

Semantics kept from the JAX package:
  * right-looking blocked LU: an unblocked panel step per column with
    partial pivoting by argmax |.|^2 (lowest index wins ties), swaps
    composed into one row permutation, U12 by a unit-lower solve and the
    trailing update as one matmul;
  * an exact zero pivot is replaced by eps * max|panel| and inverted by
    Smith's reciprocal, so a singular shifted matrix (inverse iteration at
    an exact shift) gives large-but-finite results where LAPACK's getrf
    would return inf;
  * `lu_diag_inv` inverts the diagonal blocks of L and U so repeated
    solves become matmuls (`lu_solve(dinv=...)`).

Dispatch (`lu_factor(loop="auto")`): while the panel backend is "pallas"
(the default, `set_panel_backend`), every complex64 CUDA matrix is
factored by `panel_lu.lu_factor_panel`, whose panels are the hand-written
Hopper kernel (the JAX package's gate at feast_tpu/ops/lu.py:413-415 sends
f32 matrices with n % 128 == 0 to its Pallas panel kernel).  An n that is
not a multiple of 128 is zero-padded to the next multiple, factored, and
cropped (`factor_buffer`, `lu_factor_inplace`).  Everything else (CPU
tensors, complex128, and every matrix under the "xla" backend) takes the
plain blocked path below, as the JAX package does on the CPU.
"""

from __future__ import annotations

import torch

from .. import cx


def _flat(x: torch.Tensor, core: int):
    """Reshape leading batch dims of `x` into one; returns (x3, batch)."""
    batch = x.shape[:-core]
    return x.reshape((-1,) + tuple(x.shape[-core:])), batch


def _swap_rows(P: torch.Tensor, k: int, p: torch.Tensor):
    """Swap row k with row p[b] of each batch matrix P (B, m, w), in place."""
    rowk = P[:, k, :].clone()
    idx = p[:, None, None].expand(-1, 1, P.shape[-1])
    P[:, k, :] = torch.gather(P, 1, idx)[:, 0, :]
    P.scatter_(1, idx, rowk[:, None, :])


def _panel_lu(P: torch.Tensor):
    """Unblocked LU with partial pivoting of (B, m, b) panels, m >= b.

    Returns (P_factored, swaps) with swaps[:, k] the local row swapped with
    row k at step k.  L (unit diagonal) below, U on and above."""
    P = P.clone()
    Bsz, m, b = P.shape
    rdt = cx.real_dtype(P.dtype)
    rows = torch.arange(m, device=P.device)
    fi = torch.finfo(rdt)
    # zero-pivot substitute scaled to the panel (LAPACK safe-minimum style)
    pscale = torch.sqrt(torch.amax(cx.abs2(P), dim=(-2, -1)))
    tiny = fi.eps * torch.clamp(pscale, min=fi.tiny ** 0.5)
    swaps = torch.zeros((Bsz, b), dtype=torch.int64, device=P.device)
    for k in range(min(b, m)):
        mag = torch.where(rows >= k, cx.abs2(P[:, :, k]), -1.0)
        p = torch.argmax(mag, dim=1)
        swaps[:, k] = p
        _swap_rows(P, k, p)
        piv = P[:, k, k]
        piv = torch.where(cx.abs2(piv) > 0, piv, tiny.to(P.dtype))
        inv = cx.creciprocal(piv)
        mult = P[:, k + 1:, k] * inv[:, None]
        P[:, k + 1:, k] = mult
        P[:, k + 1:, k + 1:] -= mult[:, :, None] * P[:, k, None, k + 1:]
    return P, swaps


def _swaps_to_perm(swaps: torch.Tensor, m: int) -> torch.Tensor:
    """Compose sequential row swaps (B, b) into permutations (B, m)."""
    Bsz = swaps.shape[0]
    perm = torch.arange(m, device=swaps.device).repeat(Bsz, 1)
    for k in range(swaps.shape[1]):
        p = swaps[:, k:k + 1]
        pk = perm[:, k:k + 1].clone()
        perm[:, k:k + 1] = torch.gather(perm, 1, p)
        perm.scatter_(1, p, pk)
    return perm


def _unit_lower_solve_small(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve L X = B with L (..., b, b) unit lower triangular."""
    X = B.clone()
    for i in range(1, L.shape[-1]):
        X[..., i, :] -= (L[..., i, None, :i] @ X[..., :i, :])[..., 0, :]
    return X


def _upper_solve_small(U: torch.Tensor, B: torch.Tensor, tiny=None) -> torch.Tensor:
    """Solve U X = B with U (..., b, b) upper triangular; a zero diagonal
    entry is replaced by eps * max|U| (per matrix), or by `tiny` (U's batch
    shape) where given."""
    X = B.clone()
    b = U.shape[-1]
    if tiny is None:
        fi = torch.finfo(cx.real_dtype(U.dtype))
        uscale = torch.sqrt(torch.amax(cx.abs2(U), dim=(-2, -1)))
        tiny = (fi.eps * torch.clamp(uscale, min=fi.tiny ** 0.5)).to(U.dtype)
    for i in range(b - 1, -1, -1):
        rhs = X[..., i, :]
        if i + 1 < b:
            rhs = rhs - (U[..., i, None, i + 1:] @ X[..., i + 1:, :])[..., 0, :]
        d = U[..., i, i]
        d = torch.where(cx.abs2(d) > 0, d, tiny)
        X[..., i, :] = cx.cdiv(rhs, d[..., None])
    return X


def _pad_identity(LU: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Extend (..., n, n) to (..., n_pad, n_pad) with an identity block."""
    n = LU.shape[-1]
    if n_pad == n:
        return LU
    out = torch.zeros(LU.shape[:-2] + (n_pad, n_pad), dtype=LU.dtype,
                      device=LU.device)
    out[..., :n, :n] = LU
    idx = torch.arange(n, n_pad, device=LU.device)
    out[..., idx, idx] = 1.0
    return out


def lu_diag_inv(LU: torch.Tensor, block: int, span=None):
    """Inverses of the (block, block) diagonal blocks of L (unit lower) and
    U, each (..., nblocks, block, block) over blocks padded with an
    identity extension.  Multiplying by them turns every diagonal-block
    substitution of a repeated `lu_solve` into one matmul.

    On the kernel route of K1 (`_kernel_route`: complex64 on the card under
    the "pallas" panel backend) with a block of 64 * 2^k, the 64 x 64
    diagonal tiles are inverted by the kernel `csrc/diag_inv.cu` and joined
    by log2(block / 64) levels of batched products (`diag_inv`): a few dozen
    launches, no synchronisation.  Everything else (the CPU, complex128, the
    "xla" backend, other blocks) takes the row-by-row substitution of
    `lu_diag_inv_plain`.  Both replace a zero diagonal entry of U by
    eps * max(sqrt(max |U|^2 over its block's upper triangle), sqrt(tiny)).

    span: a `utils.tracing` span handle around the call, or None; while it
    records it gets `blocks`, the diagonal blocks inverted (matrices times
    blocks a matrix), and `kernel_blocks`, those of them on the kernel
    route."""
    from . import diag_inv

    kernel = _kernel_route(LU.dtype, LU.device) and diag_inv.kernel_block(block)
    if span is not None and span.active:
        n = LU.shape[-1]
        blocks = LU.numel() // (n * n) * -(-n // block)
        span.set("blocks", blocks)
        span.set("kernel_blocks", blocks if kernel else 0)
    if kernel:
        return diag_inv.doubling(*diag_inv.tiles(LU, block))
    return lu_diag_inv_plain(LU, block)


def lu_diag_inv_plain(LU: torch.Tensor, block: int):
    """`lu_diag_inv` by the JAX package's row-by-row substitution, on every
    route: the kernel route's plain version."""
    n = LU.shape[-1]
    # the last block takes an identity extension up to `block`; only the
    # diagonal blocks are copied
    D = torch.stack([_pad_identity(LU[..., j:j + block, j:j + block], block)
                     for j in range(0, n, block)], dim=-3)
    eye = torch.eye(block, dtype=LU.dtype, device=LU.device)
    Ld = torch.tril(D, -1) + eye
    Ud = torch.triu(D)
    eyes = eye.expand(D.shape).clone()
    return _unit_lower_solve_small(Ld, eyes), _upper_solve_small(Ud, eyes)


def _auto_block(n: int) -> int:
    """Panel width of the JAX package: 64 up to n=512, 128 above."""
    return 64 if n <= 512 else 128


def _solve_block(n: int) -> int:
    """The diagonal-block size of the drivers' repeated solves
    (`lu_diag_inv`): 512 above n = 4096, else the panel width."""
    return 512 if n > 4096 else _auto_block(n)


# The panel route of complex64 CUDA factors under loop="auto", the JAX
# package's switch (feast_tpu/ops/lu.py:376): "pallas" takes the panel
# kernel, "xla" the plain blocked loop.
_PANEL_BACKEND = "pallas"


def set_panel_backend(name: str):
    """Select the panel route of `lu_factor(loop="auto")` for complex64
    matrices on the card, as the JAX package's switch of the same name:
      "pallas": the hand-written panel kernel (K1, csrc/panel_lu.cu) through
                `panel_lu.lu_factor_panel`, one launch per 128-column panel
                (the default);
      "xla":    the plain blocked loop of `lu_factor` on the card, with no
                K1 launch.
    Every driver's factor goes through that "auto" route, so "xla" takes
    K1 out of all of them.  CPU tensors and complex128 take the plain loop
    under either name."""
    global _PANEL_BACKEND
    if name not in ("xla", "pallas"):
        raise ValueError(f"unknown panel backend {name!r}")
    _PANEL_BACKEND = name


def _kernel_route(dtype: torch.dtype, device: torch.device) -> bool:
    """Whether loop="auto" sends a factor of this dtype and device to K1."""
    return (_PANEL_BACKEND == "pallas" and dtype == torch.complex64
            and device.type == "cuda")


def factor_buffer(batch, n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """A zeroed (*batch, n_pad, n_pad) buffer to fill in its leading n x n
    block and factor with `lu_factor_inplace`: n_pad is n rounded up to a
    multiple of 128 on the kernel route (complex64 on CUDA under the
    "pallas" backend), n elsewhere.  Writing the matrices straight into it
    spares a second copy of them."""
    device = torch.device(device)
    n_pad = -(-n // 128) * 128 if _kernel_route(dtype, device) else n
    return torch.zeros(tuple(batch) + (n_pad, n_pad), dtype=dtype, device=device)


def lu_factor_inplace(buf: torch.Tensor, n: int, span=None):
    """Factor a `factor_buffer` whose leading n x n blocks hold the
    matrices; returns (LU, perm) of those, LU a view of `buf`.

    span: a `utils.tracing` span handle around the call, or None.  On the
    kernel route, while spans record, it gets `moved_rows`, the rows the
    row swaps moved (a device count, resolved by `tracing.spans()`),
    `gathered_rows`, the rows a gather of every row >= j a panel would
    rewrite (sum over panels and matrices of n_pad - j), `trail_updates`,
    the trailing updates (panels but the last, times matrices), and
    `trail_kernel_updates`, those the tensor-core kernel ran
    (`cmatmul_kernel.acc_launches`, times matrices).

    The route is the one `factor_buffer` chose, read from the buffer's
    shape, so a backend switched in between changes nothing: a padded
    buffer goes to the panel kernel (K1), an unpadded one whose n is not a
    multiple of 128 to the plain loop; at n % 128 == 0, where both routes
    take the same shape, the route of `lu_factor(loop="auto")`.

    On the kernel route `buf` is factored in place at its padded size and
    cropped to the leading n x n block and the first n entries of perm.
    The padding is zeros, not an identity extension:
      * every pivot stays in A's rows: the pad rows are zero in A's columns
        and stay zero (their multipliers are 0), and a tie, an all-zero
        column included, goes to the lowest index, which is row k itself;
      * A's rows stay zero in the pad columns, so no pad entry reaches the
        leading block, and its factor is the factor of A;
      * the zero-pivot floor eps * max|slab| keeps its value, since zeros
        do not change a slab's largest entry (an identity extension would
        raise it to 1 for a matrix with entries below 1);
      * the pad columns end with zero pivots, replaced by that floor, and
        zero multipliers: they touch nothing of A.
    Elsewhere `buf` is n x n and takes `lu_factor`'s plain path, in place
    too: the store is never held twice."""
    if buf.shape[-1] != n or (n % 128 == 0 and _kernel_route(buf.dtype, buf.device)):
        from . import cmatmul_kernel, panel_lu

        moved = None
        traced = span is not None and span.active
        if traced:
            n_pad, block = buf.shape[-1], 128
            matrices = buf.numel() // (n_pad * n_pad)
            moved = torch.zeros((), dtype=torch.int64, device=buf.device)
            span.set("moved_rows", moved)
            span.set("gathered_rows",
                     matrices * sum(n_pad - j for j in range(0, n_pad, block)))
            kernel_updates = cmatmul_kernel.acc_launches
        LU, perm = panel_lu.lu_factor_panel(buf, inplace=True, moved=moved)
        if traced:
            span.set("trail_updates", matrices * (n_pad // block - 1))
            span.set("trail_kernel_updates",
                     matrices * (cmatmul_kernel.acc_launches - kernel_updates))
        return LU[..., :n, :n], perm[..., :n]
    return _lu_factor_plain(buf, _auto_block(n), inplace=True)


def _check_kernel_input(A: torch.Tensor):
    """Readable errors for an explicit loop="pallas" the kernel cannot take
    (the JAX package's checks, feast_tpu/ops/pallas_lu.py:247-262)."""
    if A.dtype != torch.complex64:
        raise ValueError(
            f"lu_factor(loop='pallas') needs complex64 matrices (got {A.dtype}); "
            "the panel kernel is complex64-only: use loop='auto' for the "
            "dtype-gated choice")
    if A.device.type != "cuda":
        raise ValueError(
            f"lu_factor(loop='pallas') needs a CUDA tensor (got {A.device}); "
            "the panel kernel runs on the card only: use loop='auto', or "
            "panel_lu.lu_factor_panel(A, panel=panel_lu.panel_factor_plain) "
            "for its plain version")


def lu_factor(A: torch.Tensor, block: int = 0, loop: str = "auto"):
    """Blocked LU with partial pivoting: P A = L U, over leading batch dims.

    Returns (LU, perm): L (unit diagonal) and U packed in LU, and perm the
    row permutation as an index vector (`lu_solve` uses B[perm]).

    loop, the JAX package's names:
      "unrolled": the plain blocked loop, panels of `block` columns (0: 64
                  up to n = 512, 128 above);
      "fori":     the same loop with the JAX "fori" default of 512-column
                  panels (the port's loop is one shape for both);
      "pallas":   the panel kernel (K1), explicitly: complex64 on CUDA
                  only, else ValueError; panels of `block` (default 128)
                  columns when n is a multiple of 128, and of 128 on the
                  zero-padded matrix otherwise (`lu_factor_inplace`);
      "auto":     "pallas" for complex64 on CUDA while the panel backend is
                  "pallas" (`set_panel_backend`), else "unrolled"."""
    n = A.shape[-1]
    if A.shape[-2] != n:
        raise ValueError(f"lu_factor expects square matrices, got {tuple(A.shape)}")
    if loop == "pallas":
        _check_kernel_input(A)
    if loop == "pallas" or (loop == "auto" and _kernel_route(A.dtype, A.device)):
        from . import panel_lu

        if n % 128 == 0:
            return panel_lu.lu_factor_panel(A, block=block or 128)
        buf = torch.zeros(A.shape[:-2] + (-(-n // 128) * 128,) * 2,
                          dtype=A.dtype, device=A.device)
        buf[..., :n, :n] = A
        return lu_factor_inplace(buf, n)
    if loop in ("auto", "unrolled"):
        return _lu_factor_plain(A, block or _auto_block(n))
    if loop == "fori":
        return _lu_factor_plain(A, block or 512)
    raise ValueError(f"unknown lu_factor loop {loop!r}; "
                     "expected 'auto', 'unrolled', 'fori' or 'pallas'")


# The plain loop's row gathers and trailing updates run over chunks of the
# batch of at most this many bytes of matrices, so that their temporaries
# stay a fraction of a large store (the stacked slices' 64 node matrices
# of n = 4096: 8.6 GB in complex64); every batch of one solve's nodes at
# the sizes the other drivers run fits one chunk.
_CHUNK_BYTES = 4 << 30


def batch_chunks(A3: torch.Tensor):
    """Slices of the leading batch axis of (B, m, n) in chunks of at most
    `_CHUNK_BYTES` (at least one matrix each)."""
    step = max(1, _CHUNK_BYTES // (A3.shape[-2] * A3.shape[-1] * A3.element_size()))
    return [slice(c, c + step) for c in range(0, A3.shape[0], step)]


def _lu_factor_plain(A: torch.Tensor, block: int, inplace: bool = False):
    """The plain blocked loop of `lu_factor`, panels of `block` columns;
    inplace factors a contiguous A itself."""
    n = A.shape[-1]
    if inplace and not A.is_contiguous():
        raise ValueError("an in-place factor needs a contiguous tensor")
    A3, batch = _flat(A, 2)
    A3 = A3 if inplace else A3.clone()
    Bsz = A3.shape[0]
    perm = torch.arange(n, device=A.device).repeat(Bsz, 1)
    for j in range(0, n, block):
        b = min(block, n - j)
        panel, swaps = _panel_lu(A3[:, j:, j:j + b])
        sub_perm = _swaps_to_perm(swaps, n - j)
        perm[:, j:] = torch.gather(perm[:, j:], 1, sub_perm)
        for c in batch_chunks(A3):
            Ac, pc, idx = A3[c], panel[c], sub_perm[c, :, None]
            # apply the panel's row permutation to the off-panel columns
            if j > 0:
                Ac[:, j:, :j] = torch.gather(Ac[:, j:, :j], 1,
                                             idx.expand(-1, -1, j))
            right = None
            if j + b < n:
                right = torch.gather(Ac[:, j:, j + b:], 1,
                                     idx.expand(-1, -1, n - j - b))
            Ac[:, j:, j:j + b] = pc
            if right is not None:
                U12 = _unit_lower_solve_small(pc[:, :b, :b], right[:, :b])
                Ac[:, j:j + b, j + b:] = U12
                # the trailing update in place: one (n - j - b)^2 temporary
                # per matrix, not three
                Ac[:, j + b:, j + b:] = right[:, b:]
                del right
                Ac[:, j + b:, j + b:].sub_(cx.cmatmul(pc[:, b:, :b], U12))
    return A3.reshape(batch + (n, n)), perm.reshape(batch + (n,))


def lu_solve(LU: torch.Tensor, perm: torch.Tensor, B: torch.Tensor,
             block: int = 0, loop: str = "auto", dinv=None) -> torch.Tensor:
    """Solve A X = B from (LU, perm) of `lu_factor`; B is (..., n, k) and
    broadcasts against the factors' batch dims.

    loop: "auto" or "unrolled" (blocks of 64 up to n = 512, 128 above) or
    "fori" (the JAX default of 512); the port has one blocked solve for
    all three.  dinv: optional (invL, invU) from `lu_diag_inv` — each
    diagonal-block substitution becomes a matmul; the block size is then
    taken from it."""
    if loop not in ("auto", "unrolled", "fori"):
        raise ValueError(f"unknown lu_solve loop {loop!r}; "
                         "expected 'auto', 'unrolled' or 'fori'")
    n = LU.shape[-1]
    if dinv is not None:
        block = dinv[0].shape[-1]
    block = block or (512 if loop == "fori" else _auto_block(n))
    batch = torch.broadcast_shapes(LU.shape[:-2], B.shape[:-2])
    B = B.expand(batch + B.shape[-2:])
    idx = perm.expand(batch + (n,))[..., None].expand(batch + (n, B.shape[-1]))
    X = torch.gather(B, -2, idx)
    starts = list(range(0, n, block))
    for j in starts:                      # forward: L Y = P B (unit lower)
        b = min(block, n - j)
        Xj = X[..., j:j + b, :]
        if j > 0:
            Xj = Xj - cx.cmatmul(LU[..., j:j + b, :j], X[..., :j, :])
        if dinv is not None:
            Xd = cx.cmatmul(dinv[0][..., j // block, :b, :b], Xj)
        else:
            Xd = _unit_lower_solve_small(LU[..., j:j + b, j:j + b], Xj)
        X[..., j:j + b, :] = Xd
    for j in reversed(starts):            # backward: U X = Y
        b = min(block, n - j)
        Xj = X[..., j:j + b, :]
        if j + b < n:
            Xj = Xj - cx.cmatmul(LU[..., j:j + b, j + b:], X[..., j + b:, :])
        if dinv is not None:
            Xd = cx.cmatmul(dinv[1][..., j // block, :b, :b], Xj)
        else:
            Xd = _upper_solve_small(LU[..., j:j + b, j:j + b], Xj)
        X[..., j:j + b, :] = Xd
    return X


def solve(A: torch.Tensor, B: torch.Tensor, block: int = 0) -> torch.Tensor:
    """One-shot dense solve A X = B (factor + solve), batched."""
    LU, perm = lu_factor(A, block=block)
    return lu_solve(LU, perm, B, block=block)


# The JAX package's vmapped forms: the functions above batch natively.
lu_factor_batched = lu_factor
lu_solve_batched = lu_solve
solve_batched = solve
