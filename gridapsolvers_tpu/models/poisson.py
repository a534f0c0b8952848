"""Poisson driver: GMG-preconditioned CG on a structured grid.

Mirrors the reference's Poisson GMG test driver
(test/LinearSolvers/GMGTests.jl poisson suite): build the hierarchy,
rediscretize per level, V-cycle-preconditioned CG to rtol.
"""
from __future__ import annotations

from typing import Tuple

from ..fem import poisson_problem
from ..fem.assembly import eliminate_dirichlet, laplacian
from ..linear import CGSolver, ChebyshevSmoother, DenseInverseSolver
from ..linear.gmg import gmg_from_hierarchy
from ..multilevel import cartesian_hierarchy


def poisson_solver(
    ncells: Tuple[int, ...],
    num_levels: int = 3,
    rtol: float = 1e-8,
    maxiter: int = 30,
    cycle: str = "v",
    exact: str = "linear",
    dtype=None,
):
    """Build the problem and its GMG-CG solver; returns (prob, solver).
    `solve_poisson` runs them; callers that time setup, compile and
    solve separately call this."""
    import numpy as np

    dtype = dtype or np.float64
    prob = poisson_problem(ncells, exact=exact, dtype=dtype)
    hierarchy = cartesian_hierarchy(ncells, num_levels)

    def assemble(mesh):
        return eliminate_dirichlet(
            laplacian(mesh, dtype), mesh.boundary_vertex_mask()
        )

    gmg = gmg_from_hierarchy(
        hierarchy,
        assemble,
        smoother=ChebyshevSmoother(degree=3),
        coarsest_solver=DenseInverseSolver(),
        cycle=cycle,
    )
    return prob, CGSolver(Pl=gmg, rtol=rtol, maxiter=maxiter)


def solve_poisson(
    ncells: Tuple[int, ...],
    num_levels: int = 3,
    rtol: float = 1e-8,
    maxiter: int = 30,
    cycle: str = "v",
    exact: str = "linear",
    dtype=None,
):
    prob, solver = poisson_solver(
        ncells, num_levels, rtol, maxiter, cycle, exact, dtype
    )
    state = solver.setup(prob.A)
    x, stats = solver.solve(state, prob.b)
    return x, stats, {"l2_error": float(prob.l2_error(x)), "problem": prob}
