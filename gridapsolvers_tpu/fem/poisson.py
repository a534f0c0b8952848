"""Poisson model problems with manufactured solutions.

Mirrors the test systems the reference builds in
test/LinearSolvers/KrylovTests.jl:14-26 and GMGTests.jl (poisson suite):
-Δu = f on a box with Dirichlet boundary, exact polynomial/trig solution,
L2 error check against the reference tolerances (BASELINE.md).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..algebra.stencil import StencilMatrix
from .assembly import eliminate_dirichlet, laplacian, mass
from .mesh import CartesianMesh


@dataclasses.dataclass
class PoissonProblem:
    """Assembled Dirichlet Poisson system on a structured grid."""

    mesh: CartesianMesh
    A: StencilMatrix          # constrained operator (identity on boundary)
    A_full: StencilMatrix     # unconstrained operator (for lifting/errors)
    M: StencilMatrix          # mass matrix (L2 norms)
    b: jnp.ndarray
    u_exact: jnp.ndarray
    dirichlet_mask: np.ndarray

    @property
    def n(self) -> int:
        return self.A.n

    def l2_error(self, u: jnp.ndarray) -> jnp.ndarray:
        """||u - u_exact||_L2 via the consistent mass matrix (matches the
        reference's `sqrt(sum(∫(e·e)dΩ))`, KrylovTests.jl:22-25)."""
        e = u - self.u_exact
        return jnp.sqrt(jnp.vdot(e, self.M.matvec(e)))

    def residual_norm(self, u: jnp.ndarray) -> jnp.ndarray:
        r = self.b - self.A.matvec(u)
        return jnp.sqrt(jnp.vdot(r, r))


def default_exact(dim: int) -> Tuple[Callable, Callable]:
    """Manufactured solution and forcing.

    Like the reference's `u(x) = x[1] + x[2]` (exactly representable in the
    FE space, so the discrete solution reproduces it to solver tolerance —
    KrylovTests.jl:16) we default to a low-order polynomial; pass trig=True
    problems for convergence studies.
    """

    def u(xs):
        return sum(xs)

    def f(xs):
        return np.zeros_like(xs[0])

    return u, f


def trig_exact(dim: int):
    ks = [1.0, 2.0, 3.0][:dim]

    def u(xs):
        out = np.ones_like(xs[0])
        for k, x in zip(ks, xs):
            out = out * np.sin(np.pi * k * x)
        return out

    def f(xs):
        return (np.pi ** 2) * sum(k ** 2 for k in ks) * u(xs)

    return u, f


def poisson_problem(
    ncells: Tuple[int, ...],
    domain: Optional[Tuple[float, ...]] = None,
    exact: str = "linear",
    dtype=np.float64,
) -> PoissonProblem:
    """Build the full Dirichlet Poisson system with manufactured solution."""
    dim = len(ncells)
    if domain is None:
        domain = tuple(x for _ in range(dim) for x in (0.0, 1.0))
    mesh = CartesianMesh(tuple(ncells), domain)
    u_fn, f_fn = trig_exact(dim) if exact == "trig" else default_exact(dim)

    coords = mesh.vertex_coords()
    xs = [coords[:, d] for d in range(dim)]
    u_ex = np.asarray(u_fn(xs), dtype=dtype)
    f_nodal = np.asarray(f_fn(xs), dtype=dtype)

    A_full = laplacian(mesh, dtype)
    M = mass(mesh, dtype)
    mask = mesh.boundary_vertex_mask()

    # RHS assembled entirely on host (NumPy): no eager per-op device
    # dispatch during setup
    b_load = M.matvec_host(f_nodal)
    A = eliminate_dirichlet(A_full, mask)
    maskf = mask.reshape(-1)
    xg = np.where(maskf, u_ex, 0.0)
    b = b_load - A_full.matvec_host(xg)
    b = np.where(maskf, u_ex, b).astype(dtype)

    return PoissonProblem(
        mesh=mesh,
        A=A,
        A_full=A_full,
        M=M,
        b=b,
        u_exact=u_ex,
        dirichlet_mask=mask,
    )
