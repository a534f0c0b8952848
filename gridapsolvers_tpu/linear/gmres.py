"""GMRES and FGMRES.

Redesign of the reference's GMRESSolver / FGMRESSolver
(src/LinearSolvers/Krylov/GMRESSolvers.jl:16-29,132-210;
Krylov/FGMRESSolvers.jl:17-30,130-199):

- The reference grows its Krylov basis dynamically (`expand_krylov_caches!`,
  GMRESSolvers.jl:76-92). Dynamic shapes defeat XLA, so we use a fixed
  restart length m with iteration masking (SURVEY.md §7 stage 2 prescribes
  exactly this substitution).
- Orthogonalization is block classical Gram-Schmidt with one
  re-orthogonalization pass (CGS2): all basis dots are computed as ONE
  contraction against the stacked basis (an (m+1, n) x (n,) matvec at full
  f32 precision), instead of the reference's sequential modified
  Gram-Schmidt loop (GMRESSolvers.jl:164-170), which would launch one
  reduction per basis vector. CGS2 has the same stability class as MGS.
- Givens-rotation QR of the Hessenberg column and the final triangular solve
  are O(m^2) scalar work done in masked fori_loops (negligible vs matvecs).

FGMRES additionally stores the preconditioned basis Z[j] so the right
preconditioner may change between iterations (required when GMG or an inner
Krylov solver is the preconditioner) — reference FGMRESSolvers.jl:58-70.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from ..interfaces import (
    LinearSolver,
    SolverTolerances,
    init_history,
    make_stats,
)
from ..utils import pytrees as pt
from .krylov_utils import (
    basis_combine,
    basis_get,
    basis_set,
    basis_zeros,
    givens,
    krylov_residual,
)

tree_map = jax.tree_util.tree_map


def _basis_dots(basis, w):
    """dots[k] = <V[k], w> for all k, leafwise contraction (one matmul per
    leaf)."""
    leaves_b = jax.tree_util.tree_leaves(basis)
    leaves_w = jax.tree_util.tree_leaves(w)
    total = None
    for lb, lw in zip(leaves_b, leaves_w):
        d = jnp.matmul(
            lb.reshape(lb.shape[0], -1), lw.reshape(-1), precision="highest"
        )
        total = d if total is None else total + d
    return total


@dataclasses.dataclass(frozen=True)
class GMRESSolver(LinearSolver):
    """Restarted GMRES with optional left/right preconditioning."""

    m: int = 30
    Pl: Optional[LinearSolver] = None
    Pr: Optional[LinearSolver] = None
    maxiter: int = 1000
    atol: float = 1e-12
    rtol: float = 1e-8
    reorth: bool = True
    flexible: bool = False  # store Z basis (FGMRES behavior)
    # live per-iteration residual printing from inside the compiled loop
    # (reference ConvergenceLog verbose=HIGH, ConvergenceLogs.jl:101-150);
    # trace-time gate: zero cost when False
    verbose: bool = False
    name: str = "GMRES"
    depth: int = 0

    @property
    def tols(self) -> SolverTolerances:
        return SolverTolerances(self.maxiter, self.atol, self.rtol)

    def setup(self, A, x=None):
        state = {"A": A}
        state["Pl"] = self.Pl.setup(A, x) if self.Pl is not None else None
        state["Pr"] = self.Pr.setup(A, x) if self.Pr is not None else None
        return state

    def update(self, state, A, x=None):
        new = {"A": A}
        new["Pl"] = (
            self.Pl.update(state["Pl"], A, x) if self.Pl is not None else None
        )
        new["Pr"] = (
            self.Pr.update(state["Pr"], A, x) if self.Pr is not None else None
        )
        return new

    def _cycle(self, state, b, x, it0, rnorm0, hist):
        """One restart cycle. Returns (x, it, rnorm, hist)."""
        A = state["A"]
        m = self.m
        tols = self.tols

        def Pl_apply(v):
            return self.Pl.apply(state["Pl"], v) if self.Pl else v

        def Pr_apply(v):
            return self.Pr.apply(state["Pr"], v) if self.Pr else v

        r = krylov_residual(A, Pl_apply, x, b)
        beta = pt.norm(r)
        dt = beta.dtype

        V = basis_zeros(b, m + 1)
        safe_beta = jnp.where(beta > 0, beta, 1.0)
        V = basis_set(V, 0, pt.scale(1.0 / safe_beta, r))
        Z = basis_zeros(b, m) if self.flexible else None
        H = jnp.zeros((m + 1, m), dt)
        cs = jnp.zeros((m,), dt)
        sn = jnp.zeros((m,), dt)
        g = jnp.zeros((m + 1,), dt).at[0].set(beta)

        def cond_fn(c):
            j, it, V, Z, H, cs, sn, g, hist = c
            rnorm = jnp.abs(g[j])
            return (j < m) & ~tols.finished(it, rnorm, rnorm0)

        def body_fn(c):
            j, it, V, Z, H, cs, sn, g, hist = c
            vj = basis_get(V, j)
            zj = Pr_apply(vj)
            if self.flexible:
                Z = basis_set(Z, j, zj)
            w = Pl_apply(A.matvec(zj))

            mask = (jnp.arange(m + 1) <= j).astype(dt)
            dots = _basis_dots(V, w) * mask
            w = pt.sub(w, basis_combine(V, dots))
            hcol = dots
            if self.reorth:
                dots2 = _basis_dots(V, w) * mask
                w = pt.sub(w, basis_combine(V, dots2))
                hcol = hcol + dots2

            hj1 = pt.norm(w)
            safe = jnp.where(hj1 > 0, hj1, 1.0)
            V = basis_set(V, j + 1, pt.scale(1.0 / safe, w))

            # apply previous Givens rotations to the new column
            def rot(k, hc):
                hk = jax.lax.dynamic_slice(hc, (k,), (2,))
                c_k, s_k = cs[k], sn[k]
                new = jnp.stack(
                    [c_k * hk[0] + s_k * hk[1], -s_k * hk[0] + c_k * hk[1]]
                )
                upd = jnp.where(k < j, new, hk)
                return jax.lax.dynamic_update_slice(hc, upd, (k,))

            hcol = jax.lax.fori_loop(0, m, rot, hcol)
            hjj = hcol[j]
            c_new, s_new = givens(hjj, hj1)
            hcol = hcol.at[j].set(c_new * hjj + s_new * hj1)
            cs = cs.at[j].set(c_new)
            sn = sn.at[j].set(s_new)
            gj = g[j]
            g = g.at[j + 1].set(-s_new * gj).at[j].set(c_new * gj)
            H = H.at[:, j].set(hcol)
            hist = hist.at[it + 1].set(jnp.abs(g[j + 1]))
            if self.verbose:
                from ..interfaces.logs import live_print

                live_print(self.name, self.depth)(it + 1, jnp.abs(g[j + 1]))
            return (j + 1, it + 1, V, Z, H, cs, sn, g, hist)

        j0 = jnp.asarray(0)
        j, it, V, Z, H, cs, sn, g, hist = jax.lax.while_loop(
            cond_fn, body_fn, (j0, it0, V, Z, H, cs, sn, g, hist)
        )

        # back substitution on the j x j triangular system R y = g
        def back(kk, y):
            k = m - 1 - kk
            num = g[k] - jnp.dot(H[k, :], y, precision="highest")
            diag = H[k, k]
            val = jnp.where(
                (k < j) & (jnp.abs(diag) > 0), num / jnp.where(diag == 0, 1.0, diag), 0.0
            )
            return y.at[k].set(val)

        y = jax.lax.fori_loop(0, m, back, jnp.zeros((m,), dt))

        if self.flexible:
            dx = basis_combine(Z, y, nvec=j)
        else:
            dx = Pr_apply(basis_combine(V, jnp.append(y, 0.0), nvec=j))
        x = pt.add(x, dx)
        rnorm = jnp.abs(g[j])
        return x, it, rnorm, hist

    def solve(self, state, b, x0=None):
        A = state["A"]
        tols = self.tols

        def Pl_apply(v):
            return self.Pl.apply(state["Pl"], v) if self.Pl else v

        x = pt.zeros_like(b) if x0 is None else x0
        r0 = krylov_residual(A, Pl_apply, x, b)
        rnorm0 = pt.norm(r0)
        hist = init_history(tols.maxiter, rnorm0)

        def cond_fn(c):
            x, it, rnorm, hist = c
            return ~tols.finished(it, rnorm, rnorm0)

        def body_fn(c):
            x, it, rnorm, hist = c
            return self._cycle(state, b, x, it, rnorm0, hist)

        x, it, rnorm, hist = jax.lax.while_loop(
            cond_fn, body_fn, (x, jnp.asarray(0), rnorm0, hist)
        )
        return x, make_stats(tols, it, rnorm, rnorm0, hist)


def FGMRESSolver(
    m: int = 30,
    Pr: Optional[LinearSolver] = None,
    Pl: Optional[LinearSolver] = None,
    **kw,
) -> GMRESSolver:
    """Flexible GMRES: right preconditioner may change per iteration
    (reference FGMRESSolvers.jl:17-30). Implemented as GMRES storing the
    preconditioned basis Z."""
    return GMRESSolver(m=m, Pl=Pl, Pr=Pr, flexible=True, **kw)


@dataclasses.dataclass(frozen=True)
class AdaptiveGMRESSolver(LinearSolver):
    """Restarted GMRES with basis GROWTH on stagnation — the static-shape
    analog of the reference's `expand_krylov_caches!`
    (src/LinearSolvers/Krylov/GMRESSolvers.jl:76-92), which doubles its
    Krylov caches whenever the iteration hits the allocated basis size
    without converging.

    XLA cannot grow arrays inside a compiled loop, so growth happens at
    the HOST level: run one restart cycle of fixed-m GMRES as its own
    compiled program; if the cycle's residual reduction is worse than
    `stall_factor`, double m (a recompile at the new static shape — paid
    once per distinct m, cached by jit) and continue from the current
    iterate. Restarted GMRES provably stagnates on strongly non-normal
    systems (e.g. shift/circulant operators need a basis of size ~n);
    growth restores convergence exactly as the reference's dynamic
    expansion does.

    Host-driven by design (like the reference's growth path): do not nest
    it inside jit — use fixed-m GMRESSolver there."""

    m: int = 10
    m_max: int = 160
    Pl: Optional[LinearSolver] = None
    Pr: Optional[LinearSolver] = None
    maxiter: int = 1000
    atol: float = 1e-12
    rtol: float = 1e-8
    reorth: bool = True
    flexible: bool = False
    stall_factor: float = 0.9  # grow unless cycle shrinks r by >=10%
    verbose: bool = False
    name: str = "AdaptiveGMRES"
    depth: int = 0

    def _inner(self, m, maxiter):
        return GMRESSolver(
            m=m, Pl=self.Pl, Pr=self.Pr, maxiter=maxiter,
            atol=self.atol, rtol=self.rtol, reorth=self.reorth,
            flexible=self.flexible, verbose=self.verbose,
            name=self.name, depth=self.depth,
        )

    @property
    def tols(self) -> SolverTolerances:
        return SolverTolerances(self.maxiter, self.atol, self.rtol)

    def setup(self, A, x=None):
        state = {"A": A}
        state["Pl"] = self.Pl.setup(A, x) if self.Pl is not None else None
        state["Pr"] = self.Pr.setup(A, x) if self.Pr is not None else None
        return state

    def update(self, state, A, x=None):
        new = {"A": A}
        new["Pl"] = (
            self.Pl.update(state["Pl"], A, x) if self.Pl is not None else None
        )
        new["Pr"] = (
            self.Pr.update(state["Pr"], A, x) if self.Pr is not None else None
        )
        return new

    def solve(self, state, b, x0=None):
        import numpy as np

        x = pt.zeros_like(b) if x0 is None else x0
        m = self.m
        total_it = 0
        r0norm = None
        hist_all = [  # assembled on host; device arrays per cycle
        ]
        rnorm = None
        while total_it < self.maxiter:
            # one restart cycle (maxiter=m) as its own compiled program
            inner = self._inner(m, m)
            x, stats = inner.solve(state, b, x)
            niter = int(stats.niter)
            res = np.asarray(stats.residuals)
            if r0norm is None:
                r0norm = float(res[0])
                hist_all.append(r0norm)
            prev = rnorm if rnorm is not None else r0norm
            hist_all.extend(res[1 : niter + 1].tolist())
            rnorm = float(res[min(niter, len(res) - 1)])
            total_it += max(niter, 1)
            if rnorm <= max(self.atol, self.rtol * r0norm):
                break
            if rnorm > self.stall_factor * prev and m < self.m_max:
                m = min(2 * m, self.m_max)  # expand_krylov_caches! analog
        hist = np.full(self.maxiter + 1, np.nan)
        hist[: min(len(hist_all), self.maxiter + 1)] = hist_all[
            : self.maxiter + 1
        ]
        return x, make_stats(
            self.tols,
            jnp.asarray(min(total_it, self.maxiter)),
            jnp.asarray(rnorm),
            jnp.asarray(r0norm),
            jnp.asarray(hist),
        )
