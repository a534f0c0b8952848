"""Geometric multigrid (GMG) — the centerpiece solver.

Redesign of the reference's GMGLinearSolvers.jl (649 LoC):

- `GMGSolver` == GMGLinearSolverFromMatrices (reference :8-20): per-level
  matrices + transfer operators + smoothers + coarsest solver, with
  cycle ∈ {v, w, f} (reference gmg_v/w/f_cycle!, :468-610) and
  mode ∈ {preconditioner, solver} (reference :612-645).
- `matrices_fn` hook == GMGLinearSolverFromWeakform's nonlinear path
  (reference :78-94,260-297): on setup/update the current iterate is
  restricted down the hierarchy (solution-mode transfers — reference
  gmg_project_solutions!, :299-334) and level operators are reassembled.

Architectural divergence from the reference (SURVEY.md §7): levels are NOT
on shrinking MPI subcommunicators — every device participates in every
level with re-sharded (or replicated) data, so cycles have no `with_level`
membership guards and the whole V-cycle compiles into one XLA program.
The level recursion is Python-unrolled over the static level count.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

import jax
import jax.numpy as jnp

from ..interfaces import (
    LinearSolver,
    Smoother,
    SolverTolerances,
    init_history,
    make_stats,
)
from ..utils import pytrees as pt
from .direct import DenseLUSolver
from .smoothers import JacobiSolver, RichardsonSmoother


def _tree_cast(tree, dtype):
    """Cast every floating leaf of a pytree (operators, states, masks)."""
    def cast(l):
        if hasattr(l, "dtype") and jnp.issubdtype(l.dtype, jnp.floating):
            return l.astype(dtype)
        return l

    return jax.tree_util.tree_map(cast, tree)


def _per_level(spec, nlevels):
    """Broadcast a single smoother/solver spec to a per-level list."""
    if isinstance(spec, (list, tuple)):
        assert len(spec) == nlevels, f"need {nlevels} smoothers, got {len(spec)}"
        return list(spec)
    return [spec] * nlevels


@dataclasses.dataclass(frozen=True)
class GMGSolver(LinearSolver):
    """Multigrid preconditioner/solver from per-level operators.

    coarse_ops      : operators for levels 1..L-1 (finest level 0 operator
                      comes from setup(A)); alternatively provide
                      `matrices_fn`.
    prolongations   : [L-1] ops, level l+1 -> l
    restrictions    : [L-1] ops, level l -> l+1 (residual mode)
    smoother        : Smoother or per-level list (used pre+post unless
                      post_smoother given) — reference pre/post smoothers
    coarsest_solver : solver for the coarsest level
    matrices_fn     : optional (A, x) -> list of L operators, for
                      solution-dependent (Newton) reassembly; overrides
                      coarse_ops.
    solution_restrictions : [L-1] solution-mode restriction ops used to
                      project the Newton iterate to coarser levels before
                      `matrices_fn` per-level assembly (reference
                      primal_restrictions / gmg_project_solutions!).
    """

    coarse_ops: Optional[tuple] = None
    prolongations: tuple = ()
    restrictions: tuple = ()
    smoother: Union[Smoother, Sequence[Smoother]] = None
    post_smoother: Optional[Union[Smoother, Sequence[Smoother]]] = None
    coarsest_solver: LinearSolver = dataclasses.field(
        default_factory=DenseLUSolver
    )
    cycle: str = "v"
    mode: str = "preconditioner"
    ncycles: int = 1
    maxiter: int = 100
    atol: float = 1e-12
    rtol: float = 1e-8
    matrices_fn: Optional[Callable] = None
    solution_restrictions: Optional[tuple] = None
    # Mixed precision: run the whole cycle in a reduced dtype
    # (e.g. jnp.bfloat16 — half the HBM traffic, the bandwidth-bound
    # regime's free 2x) while the outer Krylov iterates in full precision.
    # A reduced-precision preconditioner varies slightly between
    # applications: pair with CGSolver(flexible=True) or FGMRES.
    compute_dtype: Optional[object] = None
    # mixed=True (with compute_dtype set): the standard mixed-precision
    # MG recipe — ONLY the smoother applications run in compute_dtype
    # (bf16 operator/smoother-state copies; the d+1 M-applies + d inner
    # matvecs per Chebyshev sweep are where the HBM traffic is), while
    # residual updates, corrections, transfers and the coarse solve stay
    # in full precision: the smoother's returned residual is discarded
    # and r is recomputed as r - A_f32 dx. The all-compute_dtype variant
    # (mixed=False) halves ALL traffic but bf16-perturbs the residual
    # recursion itself — measured to break alpha-robust augmented
    # convergence (DESIGN round-4 bf16 A/B); mixed keeps iteration
    # counts at the f32 preconditioner's.
    mixed: bool = False

    def __post_init__(self):
        if self.smoother is None:
            object.__setattr__(
                self, "smoother", RichardsonSmoother(JacobiSolver(), 2, 0.67)
            )
        assert self.cycle in ("v", "w", "f")
        assert self.mode in ("preconditioner", "solver")

    @property
    def tols(self) -> SolverTolerances:
        return SolverTolerances(self.maxiter, self.atol, self.rtol)

    @property
    def num_levels(self) -> int:
        return len(self.prolongations) + 1

    def _level_mats(self, A, x):
        if self.matrices_fn is not None:
            return list(self.matrices_fn(A, x))
        assert self.coarse_ops is not None, "need coarse_ops or matrices_fn"
        return [A] + list(self.coarse_ops)

    def _smoothers(self):
        L = self.num_levels
        pre = _per_level(self.smoother, L - 1)
        post = _per_level(
            self.post_smoother if self.post_smoother is not None else self.smoother,
            L - 1,
        )
        return pre, post

    def project_solutions(self, x):
        """Restrict the current iterate to every level (reference
        gmg_project_solutions!, GMGLinearSolvers.jl:299-334)."""
        if x is None or self.solution_restrictions is None:
            return [x] + [None] * (self.num_levels - 1)
        xs = [x]
        for R in self.solution_restrictions:
            xs.append(R.matvec(xs[-1]))
        return xs

    def setup(self, A, x=None):
        mats = self._level_mats(A, x)
        pre, post = self._smoothers()
        xs = self.project_solutions(x)
        pre_states = [s.setup(m, xl) for s, m, xl in zip(pre, mats, xs)]
        post_states = [s.setup(m, xl) for s, m, xl in zip(post, mats, xs)]
        coarse_state = self.coarsest_solver.setup(mats[-1], xs[-1])
        # transfers live in the STATE (they are pytrees holding mask
        # arrays): captured via self they would become giant HLO constants
        # in every jitted solve
        state = {
            "mats": mats,
            "pre": pre_states,
            "post": post_states,
            "coarse": coarse_state,
            "P": tuple(self.prolongations),
            "R": tuple(self.restrictions),
        }
        if self.compute_dtype is not None:
            if self.mixed:
                # bf16 twins of ONLY the smoother states (each holds its
                # own operator refs); the rest of the cycle stays f32
                state["pre16"] = _tree_cast(
                    state["pre"], self.compute_dtype
                )
                state["post16"] = _tree_cast(
                    state["post"], self.compute_dtype
                )
            else:
                # factorizations above ran in full precision; the stored
                # cycle state (operators, smoother data, transfers,
                # coarse inverse) is cast down for reduced-precision
                # application
                state = _tree_cast(state, self.compute_dtype)
        return state

    def update(self, state, A, x=None):
        """Re-setup for a new fine matrix / Newton iterate (reference
        numerical_setup!, GMGLinearSolvers.jl:260-297)."""
        mats = self._level_mats(A, x)
        pre, post = self._smoothers()
        xs = self.project_solutions(x)
        pre_states = [
            s.update(st, m, xl)
            for s, st, m, xl in zip(pre, state["pre"], mats, xs)
        ]
        post_states = [
            s.update(st, m, xl)
            for s, st, m, xl in zip(post, state["post"], mats, xs)
        ]
        coarse_state = self.coarsest_solver.update(
            state["coarse"], mats[-1], xs[-1]
        )
        # transfer operators carrying their own operator-dependent state
        # (PatchProlongation/PatchRestriction) re-extract at the new level
        # operators — the reference's update_transfer_operator! on the
        # nonlinear path (PatchTransferOperators.jl:118-151). update()
        # runs inside the device Newton loop (lax.while_loop), whose
        # carried state pytree structure must match the setup-time state
        # exactly.
        P_new = tuple(
            p.update(mr) if hasattr(p, "update") else p
            for p, mr in zip(state["P"], mats[:-1])
        )
        R_new = tuple(
            r.update(mr) if hasattr(r, "update") else r
            for r, mr in zip(state["R"], mats[:-1])
        )
        new = {
            "mats": mats,
            "pre": pre_states,
            "post": post_states,
            "coarse": coarse_state,
            "P": P_new,
            "R": R_new,
        }
        if self.compute_dtype is not None:
            if self.mixed:
                new["pre16"] = _tree_cast(new["pre"], self.compute_dtype)
                new["post16"] = _tree_cast(
                    new["post"], self.compute_dtype
                )
            else:
                new = _tree_cast(new, self.compute_dtype)
        return new

    # -- cycles ------------------------------------------------------------

    def _cycle(self, state, lev: int, x, r, kind: str):
        """One multigrid cycle at level `lev`, improving x and keeping the
        residual r consistent (the (x, r) smoothing contract). Mirrors
        gmg_v_cycle!/w/f (GMGLinearSolvers.jl:468-610)."""
        L = self.num_levels
        mats = state["mats"]
        if lev == L - 1:
            dx = self.coarsest_solver.apply(state["coarse"], r)
            x = pt.add(x, dx)
            r = pt.sub(r, mats[lev].matvec(dx))
            return x, r

        pre, post = self._smoothers()
        mixed = self.mixed and self.compute_dtype is not None

        def do_smooth(sm, st16, st, x, r):
            if not mixed:
                return sm.smooth(st, x, r)
            # bf16 smoother APPLICATION only: take the correction dx from
            # the reduced-precision sweep (run at x=0 against the f32
            # residual cast down), recompute the residual in f32 — the
            # smoother's own bf16 residual recursion is discarded
            out_dtype = jax.tree_util.tree_leaves(r)[0].dtype
            r16 = _tree_cast(r, self.compute_dtype)
            dx16, _ = sm.smooth(st16, pt.zeros_like(r16), r16)
            dx = _tree_cast(dx16, out_dtype)
            x = pt.add(x, dx)
            r = pt.sub(r, mats[lev].matvec(dx))
            return x, r

        x, r = do_smooth(
            pre[lev], state.get("pre16", state["pre"])[lev],
            state["pre"][lev], x, r,
        )

        sub_kinds = {"v": ("v",), "w": ("w", "w"), "f": ("f", "v")}[kind]
        for sk in sub_kinds:
            rH = state["R"][lev].matvec(r)
            xH0 = pt.zeros_like(rH)
            dxH, _ = self._cycle(state, lev + 1, xH0, rH, sk)
            dx = state["P"][lev].matvec(dxH)
            x = pt.add(x, dx)
            r = pt.sub(r, mats[lev].matvec(dx))

        x, r = do_smooth(
            post[lev], state.get("post16", state["post"])[lev],
            state["post"][lev], x, r,
        )
        return x, r

    # -- solver protocol ---------------------------------------------------

    def smooth(self, state, x, r):
        """GMG itself honors the smoothing contract, so it can serve as a
        smoother inside an outer method."""
        for _ in range(self.ncycles):
            x, r = self._cycle(state, 0, x, r, self.cycle)
        return x, r

    def apply(self, state, r):
        if self.compute_dtype is not None and not self.mixed:
            out_dtype = jax.tree_util.tree_leaves(r)[0].dtype
            r_lo = _tree_cast(r, self.compute_dtype)
            x = pt.zeros_like(r_lo)
            x, _ = self.smooth(state, x, r_lo)
            return _tree_cast(x, out_dtype)
        x = pt.zeros_like(r)
        x, _ = self.smooth(state, x, r)
        return x

    def solve(self, state, b, x0=None):
        A = state["mats"][0]
        if self.mode == "preconditioner":
            x = pt.zeros_like(b) if x0 is None else x0
            r = pt.sub(b, A.matvec(x))
            x, r = self.smooth(state, x, r)
            return x, None

        tols = self.tols
        x = pt.zeros_like(b) if x0 is None else x0
        r = pt.sub(b, A.matvec(x))
        rnorm0 = pt.norm(r)
        hist = init_history(tols.maxiter, rnorm0)

        def cond_fn(c):
            it, x, r, rnorm, hist = c
            return ~tols.finished(it, rnorm, rnorm0)

        def body_fn(c):
            it, x, r, rnorm, hist = c
            x, r = self._cycle(state, 0, x, r, self.cycle)
            rnorm = pt.norm(r)
            hist = hist.at[it + 1].set(rnorm)
            return (it + 1, x, r, rnorm, hist)

        it, x, r, rnorm, hist = jax.lax.while_loop(
            cond_fn, body_fn, (jnp.asarray(0), x, r, rnorm0, hist)
        )
        return x, make_stats(tols, it, rnorm, rnorm0, hist)


def gmg_from_hierarchy(
    hierarchy,
    assemble: Callable,
    smoother=None,
    coarsest_solver: Optional[LinearSolver] = None,
    cycle: str = "v",
    mode: str = "preconditioner",
    dtype=jnp.float64,
    **kw,
) -> GMGSolver:
    """Convenience constructor: geometric GMG on a structured-grid
    hierarchy with rediscretized level operators (the
    GMGLinearSolverFromWeakform linear path, GMGLinearSolvers.jl:125-158).

    assemble(mesh) -> operator for that level (finest included; the finest
    assembled operator is replaced by the A passed to setup()).
    """
    from ..multilevel.transfer import setup_transfer_operators

    prolongs, restricts = setup_transfer_operators(hierarchy, dtype=dtype)
    coarse_ops = tuple(assemble(m) for m in hierarchy.meshes[1:])
    return GMGSolver(
        coarse_ops=coarse_ops,
        prolongations=tuple(prolongs),
        restrictions=tuple(restricts),
        smoother=smoother,
        coarsest_solver=coarsest_solver or DenseLUSolver(),
        cycle=cycle,
        mode=mode,
        **kw,
    )
