"""Application drivers (the reference's test/Applications + docs examples).

Each driver builds a model problem, composes the recommended solver stack,
solves, and returns (solution, stats, diagnostics). They double as usage
documentation, mirroring docs/examples.jl in the reference.
"""
from .poisson import poisson_solver, solve_poisson  # noqa: F401
from .darcy import solve_darcy  # noqa: F401
from .stokes import solve_stokes, stokes_solver  # noqa: F401
from .navier_stokes import solve_navier_stokes  # noqa: F401
from .elasticity import solve_elasticity  # noqa: F401
