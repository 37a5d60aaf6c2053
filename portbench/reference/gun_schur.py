"""Plain reference of the gun configurations: the NEP's eigenvalues exactly,
from the structure of the benchmark's own parts.

In the basis Q of K = Q diag(d) Q^T the problem is

    T~(z) = Q^T T(z) Q = D - z I + U~ F(z) V~,
    U~ = Q^T [U1 U2],  V~ = [V1; V2] Q,  F(z) = diag(f1(z) I, f2(z) I),

a diagonal plus a term of rank 2 rk.  Split the coordinates into the
planted cluster P (the first `planted` entries of d) and the rest R, whose
d lie far outside the contour.  T~_RR(z) is then invertible inside the
contour, and z is an eigenvalue there exactly when the Schur complement

    S(z) = T~_PP - T~_PR T~_RR^-1 T~_RP = M(z) - z I,
    M(z) = D_P + U~_P F (I + G F)^-1 V~_P,  G(z) = V~_R (D_R - z)^-1 U~_R,

(Woodbury) is singular: a planted-size nonlinear problem.  G(z) is summed
from its Taylor series about the contour's centre c, whose ratio is at
most 2 r / min(d_R - c).  Each eigenvalue is the fixed point z = mu(z) of
one eigenvalue branch of M, followed from M(c) by the overlap of its
eigenvector; M varies slowly (|M'| ~ ||W|| |f'|), so the iteration
contracts fast.  Its vector is Q [y; -T~_RR^-1 T~_RP y], y the branch's
eigenvector.

A returned pair is held to the configuration's tolerance as `nlfeast`
defines it: ||T(lam) x|| / ||T(lam)||_F for unit x, formed here in
complex128 from the parts (Householder products and the low-rank factors)
and the parts' Gram matrix.  The control is this reference in complex64.

This file imports numpy only: nothing of the port.
"""

from __future__ import annotations

import math

import numpy as np

ITERS = 60


def _isqrt(z, s):
    return 1j * np.sqrt(np.asarray(z) - s * s)


def _reflect(vs, X, transpose: bool):
    """Q X (transpose False: P1 first) or Q^T X (P4 first), Q = P4 P3 P2 P1."""
    for v in (reversed(vs) if transpose else vs):
        X = X - 2.0 * np.outer(v, v @ X) if X.ndim == 2 else X - 2.0 * v * (v @ X)
    return X


class Context:
    def __init__(self, config: dict, inst: dict, dtype=np.float64):
        cdt = np.complex128 if dtype == np.float64 else np.complex64
        self.dtype, self.cdtype = dtype, cdt
        self.c = complex(*config["c"])
        self.r = float(config["r"])
        p = int(inst["planted"])
        d = inst["d"].astype(dtype)
        vs = inst["vs"].astype(dtype)
        U = np.concatenate(inst["U"], axis=1).astype(dtype)
        V = np.concatenate(inst["V"], axis=0).astype(dtype)
        self.inst, self.p, self.d, self.vs = inst, p, d, vs
        self.rk = inst["U"][0].shape[1]
        self.s = inst["s"]
        self.Ut = _reflect(vs, U, transpose=True)            # Q^T U
        self.Vt = _reflect(vs, V.T, transpose=True).T        # V Q
        dR = d[p:]
        gap = float(dR.min()) - self.c.real
        ratio = 2.0 * self.r / gap
        if ratio >= 0.5:
            raise ValueError(f"gun reference: the rest of d starts {gap} from the centre")
        terms = int(math.ceil(math.log(1e-18) / math.log(ratio)))
        inv = 1.0 / (inst["d"][p:] - self.c.real)           # float64: no overflow
        self.Gk = [(self.Vt[:, p:] * (inv ** (k + 1)).astype(dtype)[None, :]) @ self.Ut[p:]
                   for k in range(terms)]
        self._ref = self._gram = None

    def fvec(self, z):
        f1, f2 = _isqrt(z, self.s[0]), _isqrt(z, self.s[1])
        return np.concatenate([np.full(self.rk, f1), np.full(self.rk, f2)]).astype(self.cdtype)

    def G(self, z):
        t = np.asarray(z - self.c, dtype=self.cdtype)
        out = np.zeros_like(self.Gk[0], dtype=self.cdtype)
        for Gk in reversed(self.Gk):             # Horner
            out = out * t + Gk
        return out

    def M(self, z):
        f = self.fvec(z)
        p = self.p
        eye = np.eye(f.shape[0], dtype=self.cdtype)
        Y = np.linalg.solve(eye + self.G(z) * f[None, :], self.Vt[:, :p].astype(self.cdtype))
        return np.diag(self.d[:p]).astype(self.cdtype) + self.Ut[:p] @ (f[:, None] * Y)

    def solve(self):
        """(eigenvalues, Schur-complement null vectors y) of every branch."""
        if self._ref is not None:
            return self._ref
        mu, Y = np.linalg.eig(self.M(self.c))
        tol = 64 * np.finfo(self.dtype).eps * (abs(self.c) + self.r)
        lams, ys = [], []
        for k in range(len(mu)):
            z, y = mu[k], Y[:, k] / np.linalg.norm(Y[:, k])
            for _ in range(ITERS):
                mus, Ys = np.linalg.eig(self.M(z))
                Ys = Ys / np.linalg.norm(Ys, axis=0)
                j = int(np.argmax(np.abs(Ys.conj().T @ y)))
                z_new, y = mus[j], Ys[:, j]
                done = abs(z_new - z) <= tol
                z = z_new
                if done:
                    break
            else:
                raise RuntimeError(f"gun reference: branch {k} did not settle ({z})")
            lams.append(z)
            ys.append(y)
        lams = np.array(lams)
        gaps = np.abs(lams[:, None] - lams[None, :]) + np.diag(np.full(len(lams), np.inf))
        if self.dtype == np.float64 and gaps.min() < 1e3 * tol:
            raise RuntimeError("gun reference: two branches met at one eigenvalue")
        self._ref = (lams, np.stack(ys, axis=1))
        return self._ref

    def vectors(self, lam, Y):
        """Unit x = Q [y; -T~_RR^-1 T~_RP y] of each eigenvalue."""
        p = self.p
        X = np.zeros((self.d.shape[0], len(lam)), dtype=self.cdtype)
        for k, z in enumerate(lam):
            f = self.fvec(z)
            y = Y[:, k]
            b = self.Ut[p:] @ (f * (self.Vt[:, :p] @ y))              # T~_RP y
            dinv = 1.0 / (self.d[p:] - z)
            eye = np.eye(f.shape[0], dtype=self.cdtype)
            t = dinv * b
            corr = np.linalg.solve(eye + f[:, None] * self.G(z), f * (self.Vt[:, p:] @ t))
            xR = -(t - dinv * (self.Ut[p:] @ corr))
            x = _reflect(self.vs, np.concatenate([y, xR]), transpose=False)
            X[:, k] = x / np.linalg.norm(x)
        return X


def prepare(config: dict, inst: dict, device=None) -> Context:
    return Context(config, inst)


def eigenvalues(ctx: Context) -> np.ndarray:
    lam = ctx.solve()[0]
    return lam[np.abs(lam - ctx.c) <= ctx.r]


def _gram(ctx: Context) -> np.ndarray:
    """<A_j, A_k>_F of (K, I, W1, W2), from the parts, in float64."""
    if ctx._gram is None:
        ctx._gram = _gram_of(ctx.inst)
    return ctx._gram


def _gram_of(inst: dict) -> np.ndarray:
    d = inst["d"]
    n = d.shape[0]
    U, V = inst["U"], inst["V"]
    Ut = [_reflect(inst["vs"], u, transpose=True) for u in U]
    Vt = [_reflect(inst["vs"], v.T, transpose=True).T for v in V]
    G = np.empty((4, 4))
    G[0, 0], G[0, 1], G[1, 1] = d @ d, d.sum(), n
    for j in range(2):
        G[0, 2 + j] = np.einsum("i,ia,ai->", d, Ut[j], Vt[j])
        G[1, 2 + j] = np.trace(V[j] @ U[j])
        for k in range(2):
            G[2 + j, 2 + k] = np.trace((U[j].T @ U[k]) @ (V[k] @ V[j].T))
    return np.triu(G) + np.triu(G, 1).T


def residuals(ctx: Context, lam: np.ndarray, X: np.ndarray) -> np.ndarray:
    inst = ctx.inst
    X = np.asarray(X, dtype=np.complex128)
    X = X / np.linalg.norm(X, axis=0)
    lam = np.asarray(lam, dtype=np.complex128)
    f1, f2 = _isqrt(lam, inst["s"][0]), _isqrt(lam, inst["s"][1])
    KX = _reflect(inst["vs"], inst["d"][:, None] * _reflect(inst["vs"], X, transpose=True),
                  transpose=False)
    W = [U @ (V @ X) for U, V in zip(inst["U"], inst["V"])]
    R = KX - X * lam + W[0] * f1 + W[1] * f2
    co = np.stack([np.ones_like(lam), -lam, f1, f2])
    fro = np.sqrt(np.einsum("jm,jk,km->m", co.conj(), _gram(ctx), co).real)
    return np.linalg.norm(R, axis=0) / fro


def control(ctx: Context):
    """(lam, X) inside the contour from this reference in complex64."""
    low = Context({"c": [ctx.c.real, ctx.c.imag], "r": ctx.r}, ctx.inst, np.float32)
    lam, Y = low.solve()
    keep = np.abs(lam - ctx.c) <= ctx.r
    return (lam[keep].astype(np.complex128),
            low.vectors(lam[keep], Y[:, keep]).astype(np.complex128))
