"""Stokes driver: FGMRES + upper block-triangular preconditioner with
velocity GMG and pressure mass CG — the reference's headline configuration
(test/Applications/StokesGMG.jl:79-166)."""
from __future__ import annotations

from typing import Tuple

from ..blocks import BlockTriangularSolver, MatrixBlock
from ..fem.stokes import stokes_problem, velocity_gmg
from ..linear import CGSolver, FGMRESSolver, JacobiSolver


def stokes_solver(
    ncells: Tuple[int, int],
    num_levels: int = 3,
    nu: float = 1.0,
    rtol: float = 1e-9,
    maxiter: int = 120,
    graddiv_alpha: float = 0.0,
    bc: str = "mms",
    engine: str = "block",
):
    """Build the problem and its FGMRES solver; returns (prob, solver).
    `solve_stokes` runs them; callers that time setup, compile and solve
    separately call this.

    graddiv_alpha > 0 selects the reference's augmented-Lagrangian
    configuration (StokesGMG.jl:105-160): Q2/P1disc, grad-div stabilized
    velocity block with patch-smoothed, patch-prolongated GMG, and the
    -(1/alpha) Mp pressure block — FGMRES converges in ~10 iterations
    independent of alpha and h.

    bc='cavity' solves the reference's actual lid-driven-cavity problem
    (u = (1,0,..) on the top-face interior, StokesGMG.jl:69-76,93-96);
    errors vs the manufactured solution are then not reported.

    engine='flat' (augmented configuration only) stores the velocity
    operators field-blocked as ELL and materializes the Vanka patch
    solves into one SpMV (fem/stokes.py)."""
    import dataclasses

    prob = stokes_problem(
        ncells, nu=nu, graddiv_alpha=graddiv_alpha, bc=bc, engine=engine
    )
    if graddiv_alpha > 0.0:
        gmg = velocity_gmg(
            ncells, num_levels=num_levels, nu=nu,
            graddiv_alpha=graddiv_alpha, engine=engine,
        )
        Mp_pc = dataclasses.replace(
            prob.Mp, values=prob.Mp.values * (-1.0 / graddiv_alpha)
        )
        coeffs = ((1.0, 1.0), (0.0, 1.0))
    else:
        gmg = velocity_gmg(ncells, num_levels=num_levels, nu=nu, ncycles=2)
        Mp_pc, coeffs = prob.Mp, None
    P = BlockTriangularSolver(
        solvers=(gmg, CGSolver(Pl=JacobiSolver(), rtol=1e-8, maxiter=50)),
        blocks=((None, None), (None, MatrixBlock(Mp_pc))),
        coeffs=coeffs,
        half="upper",
    )
    return prob, FGMRESSolver(m=40, Pr=P, rtol=rtol, maxiter=maxiter)


def solve_stokes(
    ncells: Tuple[int, int],
    num_levels: int = 3,
    nu: float = 1.0,
    rtol: float = 1e-9,
    maxiter: int = 120,
    graddiv_alpha: float = 0.0,
    bc: str = "mms",
    engine: str = "block",
):
    """Solve the Stokes problem; see `stokes_solver` for the options."""
    prob, solver = stokes_solver(
        ncells, num_levels, nu, rtol, maxiter, graddiv_alpha, bc, engine
    )
    state = solver.setup(prob.A)
    x, stats = solver.solve(state, prob.b)
    u, p = x
    info = {"residual": prob.residual_norm(x), "problem": prob}
    if prob.u_exact is not None:
        info["velocity_error"] = prob.velocity_error(u)
        info["pressure_error"] = prob.pressure_error(p)
    return x, stats, info
