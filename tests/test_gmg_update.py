"""Values-only refresh of ELL level operators through `update`
(the reference's numerical_setup!, GMGLinearSolvers.jl:260-297).

The per-Newton nonlinear reassembly must stay jit-traceable inside the
device Newton loop: GMGSolver.update and FGMRESSolver.update take the
new Jacobian's ELL values, keep the pytree structure of the setup-time
state, and act exactly as a fresh setup at the new iterate."""
import numpy as np

import jax
import jax.numpy as jnp

from gridapsolvers_tpu.fem.navier_stokes import (
    navier_stokes_problem,
    ns_velocity_gmg,
)
from gridapsolvers_tpu.linear import FGMRESSolver, RichardsonSmoother
from gridapsolvers_tpu.patches import VankaSolver
from gridapsolvers_tpu.utils import pytrees as pt


def _structure(tree):
    return jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda _: 0, tree)
    )


def _rel(a, b):
    return float(pt.norm(pt.sub(a, b)) / pt.norm(b))


def test_ns_gmg_augmented_update_matches_setup():
    """Augmented configuration (grad-div patch transfers, Vanka
    smoothers): the jitted update at a new iterate refreshes the patch
    TRANSFER operators too, keeps the state structure, and applies like
    a fresh setup at that iterate."""
    nc, alpha = 8, 100.0
    prob = navier_stokes_problem(
        (nc, nc), nu=1.0, graddiv_alpha=alpha, dtype=np.float32
    )
    gmg = ns_velocity_gmg(
        (nc, nc), 2, nu=1.0, graddiv_alpha=alpha, ncycles=1,
        dtype=np.float32,
    )
    x0 = prob.zero_guess()
    st0 = gmg.setup(prob.jacobian(x0).blocks[0][0], x0[0])
    x1 = jax.tree_util.tree_map(lambda a: a + 0.03, x0)
    A1 = prob.jacobian(x1).blocks[0][0]
    st1 = jax.jit(gmg.update)(st0, A1, x1[0])
    assert _structure(st1) == _structure(st0)
    r = jax.tree_util.tree_map(jnp.ones_like, prob.residual(x0)[0])
    z_fresh = gmg.apply(gmg.setup(A1, x1[0]), r)
    assert _rel(gmg.apply(st1, r), z_fresh) < 1e-5


def test_ns_gmg_levels_update_matches_setup():
    """Batched-Vanka NS GMG: every level's ELL operator is refreshed by
    the jitted update (the coarse levels are re-assembled at the
    injected iterate) and the cycle matches the eager update."""
    nc = 8
    prob = navier_stokes_problem((nc, nc), nu=1.0, dtype=np.float32)
    gmg = ns_velocity_gmg(
        (nc, nc), 2, nu=1.0,
        smoother=RichardsonSmoother(
            VankaSolver(omega=1.0, seed_field=-1), niter=1, omega=0.8
        ),
        ncycles=2, dtype=np.float32,
    )
    x0 = prob.zero_guess()
    st0 = gmg.setup(prob.jacobian(x0).blocks[0][0], x0[0])
    x1 = jax.tree_util.tree_map(lambda a: a + 0.05, x0)
    A1 = prob.jacobian(x1).blocks[0][0]
    st1 = jax.jit(gmg.update)(st0, A1, x1[0])
    assert _structure(st1) == _structure(st0)
    for m0, m1 in zip(st0["mats"], st1["mats"]):
        assert not np.allclose(
            np.asarray(jax.tree_util.tree_leaves(m0)[0]),
            np.asarray(jax.tree_util.tree_leaves(m1)[0]),
        )
    r = jax.tree_util.tree_map(jnp.ones_like, prob.residual(x0)[0])
    z_eager = gmg.apply(gmg.update(st0, A1, x1[0]), r)
    assert _rel(gmg.apply(st1, r), z_eager) < 1e-5


def test_fgmres_update_refreshes_system_operator():
    """FGMRES keeps the composite system operator in its state; the
    jitted update swaps in the new Jacobian with the same structure and
    solves like a fresh setup."""
    prob = navier_stokes_problem((8, 8), nu=1.0, dtype=np.float32)
    x0 = prob.zero_guess()
    A0 = prob.jacobian(x0)
    f = FGMRESSolver(m=15, rtol=1e-6, maxiter=15)
    st0 = f.setup(A0, x0)
    assert st0["A"] is A0
    x1 = jax.tree_util.tree_map(lambda a: a + 0.05, x0)
    A1 = prob.jacobian(x1)
    st1 = jax.jit(f.update)(st0, A1, x1)
    assert _structure(st1["A"]) == _structure(st0["A"])
    v = jax.tree_util.tree_map(jnp.ones_like, prob.residual(x0))
    assert _rel(st1["A"].matvec(v), A1.matvec(v)) < 1e-6
    b = prob.residual(x1)
    x_up, s_up = f.solve(st1, b)
    x_new, s_new = f.solve(f.setup(A1, x1), b)
    assert int(s_up.niter) == int(s_new.niter)
    assert _rel(x_up, x_new) < 1e-4
