"""Dense direct solvers (LU / Cholesky).

Replacement for the reference's external sparse direct backends
(MUMPS/Pardiso/UMFPACK — SURVEY.md §2.9): GMG keeps coarse systems small by
construction, so the coarse solve is a dense factorization on device.
`MatrixSolver` / `IdentitySolver` wrapper semantics from the reference are
also here.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl

from ..interfaces import LinearSolver


def _dense(A):
    return A.todense() if hasattr(A, "todense") else jnp.asarray(A)


def _ravel(r):
    """Flatten a pytree vector to 1D (tuple/block vectors -> dense solve)."""
    leaves = jax.tree_util.tree_leaves(r)
    if len(leaves) == 1 and leaves[0].ndim == 1:
        return leaves[0], None
    flat = jnp.concatenate([jnp.ravel(l) for l in leaves])
    return flat, r


def _unravel(flat, template):
    if template is None:
        return flat
    leaves, treedef = jax.tree_util.tree_flatten(template)
    out, off = [], 0
    for l in leaves:
        out.append(flat[off : off + l.size].reshape(l.shape))
        off += l.size
    return jax.tree_util.tree_unflatten(treedef, out)


@dataclasses.dataclass(frozen=True)
class DenseLUSolver(LinearSolver):
    """Direct solve via dense LU (reference LUSolver() usage for coarse
    grids, e.g. test/LinearSolvers/GMGTests.jl)."""

    def setup(self, A, x=None):
        lu, piv = jsl.lu_factor(_dense(A))
        return {"lu": lu, "piv": piv}

    def apply(self, state, r):
        flat, template = _ravel(r)
        z = jsl.lu_solve((state["lu"], state["piv"]), flat)
        return _unravel(z, template)

    def solve(self, state, b, x0=None):
        return self.apply(state, b), None


@dataclasses.dataclass(frozen=True)
class DenseCholeskySolver(LinearSolver):
    """Direct solve via dense Cholesky (SPD systems)."""

    def setup(self, A, x=None):
        c = jsl.cho_factor(_dense(A))
        return {"c": c}

    def apply(self, state, r):
        flat, template = _ravel(r)
        z = jsl.cho_solve(state["c"], flat)
        return _unravel(z, template)

    def solve(self, state, b, x0=None):
        return self.apply(state, b), None


@dataclasses.dataclass(frozen=True)
class DenseInverseSolver(LinearSolver):
    """Direct solve via the precomputed explicit inverse: apply is ONE
    matrix-vector product (at full f32 precision) instead of two
    sequential triangular solves. The multigrid coarse system is small and
    well-conditioned by construction, so the explicit inverse is
    numerically safe. Whether the product beats the triangular solves on
    the H100 is not measured."""

    def setup(self, A, x=None):
        D = _dense(A)
        inv = jnp.linalg.inv(D)
        return {"inv": inv}

    def apply(self, state, r):
        flat, template = _ravel(r)
        z = jnp.matmul(state["inv"], flat, precision="highest")
        return _unravel(z, template)

    def solve(self, state, b, x0=None):
        return self.apply(state, b), None


@dataclasses.dataclass(frozen=True)
class MatrixSolver(LinearSolver):
    """Solve with a fixed external matrix regardless of the passed A
    (reference MatrixSolvers.jl:2-8,20-37)."""

    M: object  # operator
    solver: LinearSolver = dataclasses.field(default_factory=DenseLUSolver)

    def setup(self, A, x=None):
        return self.solver.setup(self.M, x)

    def apply(self, state, r):
        return self.solver.apply(state, r)

    def solve(self, state, b, x0=None):
        return self.solver.solve(state, b, x0)
