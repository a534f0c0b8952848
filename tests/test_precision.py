"""Every f32 product on the solver path asks for full f32 precision.

On GPUs XLA may run an f32 dot at DEFAULT precision in TF32 (about three
decimal digits). The lowered StableHLO of the solver paths must carry
`precision = [HIGHEST, HIGHEST]` on every dot_general, so the product
is computed in f32 on any backend."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gridapsolvers_tpu.fem import poisson_problem


def _dot_lines(lowered):
    return [l for l in lowered.as_text().splitlines() if "dot_general" in l]


def _gmres_solve():
    from gridapsolvers_tpu.algebra.convert import to_scipy
    from gridapsolvers_tpu.algebra.ell import ell_from_scipy
    from gridapsolvers_tpu.linear import FGMRESSolver

    prob = poisson_problem((6, 6), dtype=np.float32)
    A = ell_from_scipy(to_scipy(prob.A), dtype=np.float32)
    solver = FGMRESSolver(m=8, rtol=1e-6, maxiter=8)
    state = solver.setup(A)
    return jax.jit(solver.solve).lower(state, jnp.asarray(prob.b))


def _dense_inverse_apply():
    from gridapsolvers_tpu.linear import DenseInverseSolver

    A = poisson_problem((4, 4, 4), dtype=np.float32).A
    solver = DenseInverseSolver()
    state = solver.setup(A)
    return jax.jit(solver.apply).lower(
        state, jnp.ones(A.shape[0], jnp.float32)
    )


def _patch_solve():
    from gridapsolvers_tpu.patches import PatchSolver, vertex_star_patches

    prob = poisson_problem((6, 6), dtype=np.float32)
    topo = vertex_star_patches(prob.A.grid_shape, ~prob.dirichlet_mask)
    sm = PatchSolver(topo, omega=0.6, weighting="overlap")
    state = sm.setup(prob.A)
    return jax.jit(sm.apply).lower(state, jnp.asarray(prob.b))


@pytest.mark.parametrize(
    "build", [_gmres_solve, _dense_inverse_apply, _patch_solve],
    ids=["gmres_orthogonalisation", "dense_inverse_apply",
         "batched_patch_solve"],
)
def test_solver_dots_lower_at_highest_precision(build):
    lines = _dot_lines(build())
    assert lines, "no dot_general in the lowered program"
    for line in lines:
        assert "precision = [HIGHEST, HIGHEST]" in line, line
