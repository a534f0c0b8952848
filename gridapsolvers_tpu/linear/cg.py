"""Preconditioned Conjugate Gradient.

Redesign of the reference's CGSolver
(src/LinearSolvers/Krylov/CGSolvers.jl:10-23,73-138): the iteration is a
lax.while_loop over a pytree carry so the whole preconditioned solve
(including a nested GMG preconditioner) compiles into one XLA program.
Supports:
  - flexible CG (Polak-Ribière beta, reference CGSolvers.jl:93-100),
  - Lanczos diagnostics: the (alpha, beta) histories that define the Lanczos
    tridiagonal for condition-number estimation
    (reference Krylov/KrylovUtils.jl:58-90), post-processed on host by
    `condition_estimate`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from ..interfaces import (
    LinearSolver,
    SolverStats,
    SolverTolerances,
    init_history,
    make_stats,
)
from ..utils import pytrees as pt


@dataclasses.dataclass(frozen=True)
class CGSolver(LinearSolver):
    Pl: Optional[LinearSolver] = None
    maxiter: int = 1000
    atol: float = 1e-12
    rtol: float = 1e-8
    flexible: bool = False
    lanczos: bool = False
    # live per-iteration residual printing from inside the compiled loop
    # (reference ConvergenceLog verbose=HIGH); name labels the output
    verbose: bool = False
    name: str = "CG"
    depth: int = 0

    @property
    def tols(self) -> SolverTolerances:
        return SolverTolerances(self.maxiter, self.atol, self.rtol)

    def setup(self, A, x=None):
        pl_state = self.Pl.setup(A, x) if self.Pl is not None else None
        return {"A": A, "Pl": pl_state}

    def update(self, state, A, x=None):
        pl_state = (
            self.Pl.update(state["Pl"], A, x) if self.Pl is not None else None
        )
        return {"A": A, "Pl": pl_state}

    def solve(self, state, b, x0=None):
        A = state["A"]
        tols = self.tols

        def precond(r):
            if self.Pl is None:
                return r
            return self.Pl.apply(state["Pl"], r)

        x = pt.zeros_like(b) if x0 is None else x0
        r = pt.sub(b, A.matvec(x))
        z = precond(r)
        p = z
        gamma = pt.dot(r, z)
        rnorm0 = pt.norm(r)
        hist = init_history(tols.maxiter, rnorm0)
        alphas = jnp.zeros((tols.maxiter,), rnorm0.dtype)
        betas = jnp.zeros((tols.maxiter,), rnorm0.dtype)

        def cond_fn(carry):
            it, x, r, z, p, gamma, rnorm, hist, alphas, betas = carry
            return ~tols.finished(it, rnorm, rnorm0)

        def body_fn(carry):
            it, x, r, z, p, gamma, rnorm, hist, alphas, betas = carry
            w = A.matvec(p)
            pw = pt.dot(p, w)
            alpha = gamma / pw
            x = pt.axpy(alpha, p, x)
            r_new = pt.axpy(-alpha, w, r)
            z_new = precond(r_new)
            if self.flexible:
                # Polak-Ribière: beta = z_new · (r_new - r) / gamma
                gamma_new = pt.dot(r_new, z_new)
                beta = (gamma_new - pt.dot(z_new, r)) / gamma
            else:
                gamma_new = pt.dot(r_new, z_new)
                beta = gamma_new / gamma
            p = pt.axpy(beta, p, z_new)
            rnorm = pt.norm(r_new)
            hist = hist.at[it + 1].set(rnorm)
            if self.verbose:
                from ..interfaces.logs import live_print

                live_print(self.name, self.depth)(it + 1, rnorm)
            alphas = alphas.at[it].set(alpha)
            betas = betas.at[it].set(beta)
            return (it + 1, x, r_new, z_new, p, gamma_new, rnorm, hist,
                    alphas, betas)

        carry = (jnp.asarray(0), x, r, z, p, gamma, rnorm0, hist, alphas, betas)
        it, x, r, z, p, gamma, rnorm, hist, alphas, betas = jax.lax.while_loop(
            cond_fn, body_fn, carry
        )
        extra = {"alphas": alphas, "betas": betas} if self.lanczos else None
        stats = make_stats(tols, it, rnorm, rnorm0, hist)
        stats.extra = extra
        return x, stats


def condition_estimate(stats: SolverStats) -> float:
    """Condition-number estimate from the CG Lanczos tridiagonal
    (host-side; reference KrylovUtils.jl:58-90 builds SymTridiagonal(δ, γ)
    and takes extreme eigenvalues)."""
    import numpy as np
    import scipy.linalg as sla

    assert stats.extra is not None, "run CGSolver(lanczos=True)"
    k = int(stats.niter)
    alphas = np.asarray(stats.extra["alphas"])[:k]
    betas = np.asarray(stats.extra["betas"])[:k]
    if k == 0:
        return 1.0
    # Lanczos tridiagonal from CG coefficients:
    # delta_1 = 1/alpha_1 ; delta_j = 1/alpha_j + beta_{j-1}/alpha_{j-1}
    # gamma_j = sqrt(beta_j)/alpha_j
    delta = np.empty(k)
    delta[0] = 1.0 / alphas[0]
    for j in range(1, k):
        delta[j] = 1.0 / alphas[j] + betas[j - 1] / alphas[j - 1]
    off = np.sqrt(np.maximum(betas[: k - 1], 0.0)) / alphas[: k - 1]
    ev = sla.eigh_tridiagonal(delta, off, eigvals_only=True)
    ev = ev[ev > 0]
    return float(ev.max() / ev.min()) if len(ev) else 1.0
