"""Field-blocked ELL operator wrapper + materialized Vanka smoother
(algebra/flat.py, patches/materialized.py): exact equivalence with the
block/batched paths."""
import numpy as np

import jax
import jax.numpy as jnp

from gridapsolvers_tpu.algebra.flat import flat_kernel_operator
from gridapsolvers_tpu.fem.stokes import (
    graddiv_velocity_block,
    stokes_problem,
    velocity_vanka_smoother,
)
from gridapsolvers_tpu.fem.mesh import CartesianMesh


def _mesh(nc):
    return CartesianMesh((nc, nc), (0.0, 1.0, 0.0, 1.0))


def test_flat_operator_matches_block_matvec():
    K = graddiv_velocity_block(_mesh(8), 1.0, 1e3, banded=True)
    F = flat_kernel_operator(K)
    rng = np.random.default_rng(0)
    n = K.block(0, 0).shape[0]
    x = tuple(jnp.asarray(rng.normal(size=n)) for _ in range(2))
    y_blk = K.matvec(x)
    y_flat = F.matvec(x)
    for a, b in zip(y_blk, y_flat):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-12)
    for a, b in zip(F.diag(), K.diag()):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-12)


def test_materialized_vanka_matches_batched():
    """The assembled M_vanka SpMV reproduces the batched gather/solve/
    scatter Vanka apply exactly (same linear map)."""
    from gridapsolvers_tpu.patches.materialized import (
        MaterializedVankaSmoother,
    )

    mesh = _mesh(8)
    K = graddiv_velocity_block(mesh, 1.0, 1e3, banded=True)
    vanka = velocity_vanka_smoother(mesh, omega=0.7)
    mat = MaterializedVankaSmoother(
        topo=vanka.topo, omega=0.7, weighting=vanka.weighting,
    )
    vst = vanka.setup(K)
    mst = mat.setup(K)
    rng = np.random.default_rng(1)
    n = K.block(0, 0).shape[0]
    r = tuple(jnp.asarray(rng.normal(size=n)) for _ in range(2))
    z_b = vanka.apply(vst, r)
    z_m = mat.apply(mst, r)
    for a, b in zip(z_b, z_m):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-11)
    # smoothing contract parity
    x0 = tuple(jnp.zeros_like(v) for v in r)
    xb, rb = vanka.smooth(vst, x0, r)
    xm, rm = mat.smooth(mst, x0, r)
    for a, b in zip(jax.tree_util.tree_leaves((xb, rb)),
                    jax.tree_util.tree_leaves((xm, rm))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-11)


def test_materialized_vanka_traceable_refresh():
    """update() is a pure device computation (jit-traceable): new
    batched inverses -> static segment-sum -> values-only block refresh,
    matching a from-scratch host setup at the new operator, with
    pytree-structure invariance (device-Newton-loop carry)."""
    from gridapsolvers_tpu.patches.materialized import (
        MaterializedVankaSmoother,
    )

    mesh = _mesh(8)
    K1 = graddiv_velocity_block(mesh, 1.0, 1e3, banded=True)
    K2 = graddiv_velocity_block(mesh, 2.5, 1e3, banded=True)
    vanka = velocity_vanka_smoother(mesh, omega=0.7)
    mat = MaterializedVankaSmoother(
        topo=vanka.topo, omega=0.7, weighting=vanka.weighting,
    )
    st1 = mat.setup(K1)
    st2 = jax.jit(mat.update)(st1, K2)
    fresh = mat.setup(K2)
    rng = np.random.default_rng(2)
    n = K1.block(0, 0).shape[0]
    r = tuple(jnp.asarray(rng.normal(size=n)) for _ in range(2))
    z_u = mat.apply(st2, r)
    z_f = mat.apply(fresh, r)
    for a, b in zip(z_u, z_f):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-11)
    tm = lambda t: jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda _: 0, t["Mv"])
    )
    assert tm(st1) == tm(st2)
    # and the refreshed map still equals the batched Vanka at K2
    z_b = vanka.apply(vanka.setup(K2), r)
    for a, b in zip(z_b, z_u):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-11)


def test_materialized_vanka_overlap_weighting_matches_batched():
    """Default (overlap-weighted) seed-field topology: materialized ==
    batched, at setup AND after traceable refresh (w_coo row scaling).
    Guards the default-weighting mismatch that silently broke the NS
    Newton flagship (unit vs VankaSolver's overlap default)."""
    from gridapsolvers_tpu.fem.navier_stokes import navier_stokes_problem
    from gridapsolvers_tpu.patches.materialized import (
        MaterializedVankaSmoother,
    )
    from gridapsolvers_tpu.patches.vanka import VankaSolver

    prob = navier_stokes_problem((8, 8), nu=1.0, dtype=np.float32)
    x0 = prob.zero_guess()
    A1 = prob.jacobian(x0).blocks[0][0]
    x1 = jax.tree_util.tree_map(lambda a: a + 0.05, x0)
    A2 = prob.jacobian(x1).blocks[0][0]
    v = VankaSolver(omega=1.0, seed_field=-1)
    m = MaterializedVankaSmoother(omega=1.0, seed_field=-1)
    assert m.weighting == v.weighting  # defaults aligned
    vst = v.setup(A1)
    mst = m.setup(A1)
    rng = np.random.default_rng(3)
    n = A1.blocks[0][0].shape[0]
    r = tuple(
        jnp.asarray(rng.normal(size=n).astype(np.float32)) for _ in range(2)
    )
    for a, b in zip(v.apply(vst, r), m.apply(mst, r)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-5, atol=2e-6
        )
    mst2 = jax.jit(m.update)(mst, A2)
    for a, b in zip(v.apply(v.update(vst, A2), r), m.apply(mst2, r)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-5, atol=2e-6
        )


def test_flat_engine_flagship_iteration_parity():
    """The flat-engine augmented Stokes flagship reproduces the block
    engine's FGMRES iteration count and solution."""
    import dataclasses as dc

    from gridapsolvers_tpu.blocks import BlockTriangularSolver, MatrixBlock
    from gridapsolvers_tpu.fem.stokes import velocity_gmg
    from gridapsolvers_tpu.linear import CGSolver, FGMRESSolver, JacobiSolver

    alpha = 1e3
    results = {}
    for engine in ("block", "flat"):
        prob = stokes_problem((8, 8), graddiv_alpha=alpha, engine=engine)
        gmg = velocity_gmg((8, 8), 2, graddiv_alpha=alpha, engine=engine)
        Mp = dc.replace(prob.Mp, values=prob.Mp.values * (-1.0 / alpha))
        prec = BlockTriangularSolver(
            solvers=(gmg, CGSolver(Pl=JacobiSolver(), rtol=1e-8,
                                   maxiter=40)),
            blocks=((None, None), (None, MatrixBlock(Mp))),
            coeffs=((1.0, 1.0), (0.0, 1.0)),
            half="upper",
        )
        solver = FGMRESSolver(m=20, Pr=prec, rtol=1e-9, maxiter=30)
        st = solver.setup(prob.A)
        x, stats = jax.jit(solver.solve)(st, prob.b)
        results[engine] = (int(stats.niter), prob.residual_norm(x), x)
    assert results["block"][0] == results["flat"][0], results
    assert results["flat"][1] < 1e-7
    for a, b in zip(jax.tree_util.tree_leaves(results["block"][2]),
                    jax.tree_util.tree_leaves(results["flat"][2])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-8)
