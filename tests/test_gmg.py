"""GMG tests — mirrors the reference's GMGTests sweep
(test/LinearSolvers/GMGTests.jl:386-414): {2D,3D} Poisson x {V,W,F} cycles x
smoothers, GMG-preconditioned CG converging within the reference budget
(maxiter 20 to rtol 1e-6, GMGTests.jl:120-122) and transfer-operator
consistency (DistributedGridTransferOperatorsTests.jl:34-80).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gridapsolvers_tpu.fem import CartesianMesh, poisson_problem
from gridapsolvers_tpu.fem.assembly import eliminate_dirichlet, laplacian
from gridapsolvers_tpu.linear import (
    CGSolver,
    ChebyshevSmoother,
    DenseLUSolver,
    JacobiSolver,
    RichardsonSmoother,
)
from gridapsolvers_tpu.linear.gmg import GMGSolver, gmg_from_hierarchy
from gridapsolvers_tpu.multilevel import (
    cartesian_hierarchy,
    setup_transfer_operators,
)


def _assemble_dirichlet(mesh):
    return eliminate_dirichlet(laplacian(mesh), mesh.boundary_vertex_mask())


def _poisson_hierarchy(ncells, nlevels):
    prob = poisson_problem(ncells)
    hierarchy = cartesian_hierarchy(ncells, nlevels)
    return prob, hierarchy


def test_transfer_roundtrip_2d():
    """P then R-injection reproduces the coarse vector; R_residual = P^T."""
    hierarchy = cartesian_hierarchy((8, 8), 2)
    P, R = setup_transfer_operators(hierarchy, with_masks=False)
    p, r = P[0], R[0]
    nc = np.prod(hierarchy[1].vertex_shape)
    nf = np.prod(hierarchy[0].vertex_shape)
    rng = np.random.default_rng(0)
    xc = jnp.asarray(rng.normal(size=nc))
    xf = jnp.asarray(rng.normal(size=nf))
    # adjointness: <P xc, xf> == <xc, R xf>
    lhs = float(jnp.vdot(p.matvec(xc), xf))
    rhs = float(jnp.vdot(xc, r.matvec(xf)))
    assert abs(lhs - rhs) < 1e-11
    # interpolation reproduces linear functions exactly (interior)
    coords_c = hierarchy[1].vertex_coords()
    coords_f = hierarchy[0].vertex_coords()
    lin_c = jnp.asarray(coords_c[:, 0] + 2 * coords_c[:, 1])
    lin_f = jnp.asarray(coords_f[:, 0] + 2 * coords_f[:, 1])
    np.testing.assert_allclose(p.matvec(lin_c), lin_f, atol=1e-12)


@pytest.mark.parametrize("cycle", ["v", "w", "f"])
def test_gmg_cg_2d(cycle):
    """GMG-preconditioned CG within the reference iteration budget."""
    prob, hierarchy = _poisson_hierarchy((32, 32), 3)
    gmg = gmg_from_hierarchy(
        hierarchy,
        _assemble_dirichlet,
        smoother=RichardsonSmoother(JacobiSolver(), niter=2, omega=0.67),
        cycle=cycle,
    )
    solver = CGSolver(Pl=gmg, rtol=1e-6, maxiter=20)
    state = solver.setup(prob.A)
    x, stats = solver.solve(state, prob.b)
    assert stats.converged(), f"flag={int(stats.flag)}"
    assert int(stats.niter) <= 20
    assert float(prob.l2_error(x)) < 1e-5


def test_gmg_cg_3d_chebyshev():
    """BASELINE.json config 2: 3D Poisson, GMG V-cycle CG, Chebyshev."""
    prob, hierarchy = _poisson_hierarchy((16, 16, 16), 3)
    gmg = gmg_from_hierarchy(
        hierarchy, _assemble_dirichlet, smoother=ChebyshevSmoother(degree=3)
    )
    solver = CGSolver(Pl=gmg, rtol=1e-6, maxiter=20)
    state = solver.setup(prob.A)
    x, stats = solver.solve(state, prob.b)
    assert stats.converged()
    assert int(stats.niter) <= 20
    assert float(prob.l2_error(x)) < 1e-5


def test_gmg_solver_mode():
    """GMG as a standalone solver (mode=:solver, reference
    GMGLinearSolvers.jl:612-645)."""
    prob, hierarchy = _poisson_hierarchy((32, 32), 3)
    gmg = gmg_from_hierarchy(
        hierarchy,
        _assemble_dirichlet,
        smoother=RichardsonSmoother(JacobiSolver(), niter=3, omega=0.67),
        mode="solver",
        rtol=1e-8,
        maxiter=30,
    )
    state = gmg.setup(prob.A)
    x, stats = gmg.solve(state, prob.b)
    assert stats.converged()
    assert float(prob.l2_error(x)) < 1e-6
    # V-cycle convergence factor well below 1
    res = np.asarray(jax.device_get(stats.residuals))
    n = int(stats.niter)
    factors = res[1 : n + 1] / res[:n]
    assert np.nanmax(factors) < 0.35


def test_gmg_iterations_mesh_independent():
    """The defining property of multigrid: iteration counts stay ~constant
    as the mesh is refined (reference weak-scaling claim, BASELINE.md)."""
    iters = []
    for n, L in ((16, 2), (32, 3), (64, 4)):
        prob, hierarchy = _poisson_hierarchy((n, n), L)
        gmg = gmg_from_hierarchy(
            hierarchy,
            _assemble_dirichlet,
            smoother=RichardsonSmoother(JacobiSolver(), niter=2, omega=0.67),
        )
        solver = CGSolver(Pl=gmg, rtol=1e-8, maxiter=30)
        state = solver.setup(prob.A)
        _, stats = solver.solve(state, prob.b)
        assert stats.converged()
        iters.append(int(stats.niter))
    assert max(iters) - min(iters) <= 3, iters


def test_gmg_jit_whole_solve():
    prob, hierarchy = _poisson_hierarchy((16, 16), 2)
    gmg = gmg_from_hierarchy(
        hierarchy,
        _assemble_dirichlet,
        smoother=ChebyshevSmoother(degree=3),
    )
    solver = CGSolver(Pl=gmg, rtol=1e-8, maxiter=30)
    state = solver.setup(prob.A)
    solve = jax.jit(lambda st, b: solver.solve(st, b)[0])
    x = solve(state, prob.b)
    assert float(prob.l2_error(x)) < 1e-6


def test_gmg_bf16_mixed_precision():
    """Mixed precision: the whole V-cycle runs in bfloat16
    (half the HBM traffic) under a flexible-CG outer iteration in f32.
    Converges to f32-appropriate tolerance with a modest iteration
    penalty."""
    import jax.numpy as jnp

    prob = poisson_problem((12, 12, 12), dtype=np.float32)
    hierarchy = cartesian_hierarchy((12, 12, 12), 3)

    def asm(mesh):
        from gridapsolvers_tpu.fem.assembly import laplacian_const

        return laplacian_const(mesh, np.float32)

    from gridapsolvers_tpu.linear.gmg import gmg_from_hierarchy as _gfh

    gmg = _gfh(
        hierarchy,
        asm,
        smoother=ChebyshevSmoother(degree=3, eig_method="gershgorin"),
        dtype=jnp.float32,
        compute_dtype=jnp.bfloat16,
    )
    solver = CGSolver(Pl=gmg, rtol=1e-5, maxiter=30, flexible=True)
    A32 = asm(prob.mesh)
    state = solver.setup(A32)
    b = jnp.asarray(prob.b, jnp.float32)
    x, stats = solver.solve(state, b)
    assert stats.converged(), int(stats.niter)
    assert int(stats.niter) <= 15
    assert float(prob.l2_error(x.astype(jnp.float64))) < 1e-3


def test_transfer_slices_impl_matches_conv():
    """The shifted-slice transfers equal the Q1 FE embedding P built on
    the host by scipy, and its transpose R = P^T."""
    from gridapsolvers_tpu.multilevel.transfer import (
        StructuredProlongation,
        StructuredRestriction,
        fe_grid_interpolation,
    )

    for shape_c, shape_f in (((5, 7), (9, 13)), ((3, 4, 5), (5, 7, 9))):
        rng = np.random.default_rng(0)
        xc = rng.normal(size=np.prod(shape_c))
        xf = rng.normal(size=np.prod(shape_f))
        P = fe_grid_interpolation([n - 1 for n in shape_c], order=1)
        Ps = StructuredProlongation(shape_f, shape_c)
        np.testing.assert_allclose(
            np.asarray(Ps.matvec(jnp.asarray(xc))), P @ xc, atol=1e-13
        )
        Rs = StructuredRestriction(shape_f, shape_c)
        np.testing.assert_allclose(
            np.asarray(Rs.matvec(jnp.asarray(xf))), P.T @ xf, atol=1e-13
        )


def test_hierarchy_from_coarse_and_matrices():
    """Coarse-seed hierarchy construction + compute_hierarchy_matrices
    (reference ModelHierarchies.jl:127-146 refinement direction,
    FESpaceHierarchies.jl:141-174)."""
    from gridapsolvers_tpu.multilevel import (
        compute_hierarchy_matrices,
        hierarchy_from_coarse,
    )

    h = hierarchy_from_coarse((4, 4), num_levels=3)
    assert [m.ncells for m in h.meshes] == [(16, 16), (8, 8), (4, 4)]
    mats = compute_hierarchy_matrices(h, _assemble_dirichlet)
    assert len(mats) == 3
    assert mats[0].n == 17 * 17
    # and GMG built on it converges
    prob = poisson_problem((16, 16))
    gmg = GMGSolver(
        coarse_ops=tuple(mats[1:]),
        prolongations=tuple(setup_transfer_operators(h)[0]),
        restrictions=tuple(setup_transfer_operators(h)[1]),
        smoother=ChebyshevSmoother(degree=3),
        coarsest_solver=DenseLUSolver(),
    )
    solver = CGSolver(Pl=gmg, rtol=1e-8, maxiter=25)
    st = solver.setup(prob.A)
    x, stats = solver.solve(st, prob.b)
    assert stats.converged()
    assert float(prob.l2_error(x)) < 1e-6


def test_gmg_mixed_precision_smoother():
    """mixed=True (bf16 smoother application, f32 residual/correction/
    coarse): iteration count within +1 of the f32 preconditioner under
    flexible CG, converged true residual. (The all-compute_dtype variant
    and the augmented grad-div case are measured close-outs — bf16
    anywhere in the alpha=1e3 smoothing path breaks alpha-robustness.)"""
    import jax

    from gridapsolvers_tpu.fem import poisson_problem
    from gridapsolvers_tpu.fem.assembly import laplacian_const
    from gridapsolvers_tpu.linear import (
        CGSolver,
        ChebyshevSmoother,
        DenseInverseSolver,
    )
    from gridapsolvers_tpu.linear.gmg import gmg_from_hierarchy
    from gridapsolvers_tpu.multilevel import cartesian_hierarchy

    nc = 16
    prob = poisson_problem((nc,) * 3, dtype=np.float32)
    h = cartesian_hierarchy((nc,) * 3, 3)
    A = laplacian_const(prob.mesh, np.float32)
    b = jnp.asarray(np.asarray(prob.b, np.float32))
    iters = {}
    for name, kw in (
        ("f32", {}),
        ("mixed", dict(compute_dtype=jnp.bfloat16, mixed=True)),
    ):
        gmg = gmg_from_hierarchy(
            h, lambda m: laplacian_const(m, np.float32),
            smoother=ChebyshevSmoother(degree=4, eig_method="gershgorin"),
            coarsest_solver=DenseInverseSolver(), dtype=jnp.float32, **kw,
        )
        solver = CGSolver(Pl=gmg, rtol=1e-5, maxiter=40, flexible=True)
        st = solver.setup(A)
        x, stats = jax.jit(solver.solve)(st, b)
        rn = jnp.linalg.norm((A.matvec(x) - b).ravel())
        rn = float(rn / jnp.linalg.norm(b.ravel()))
        iters[name] = int(stats.niter)
        assert rn < 2e-5, (name, rn)
    assert iters["mixed"] <= iters["f32"] + 1, iters
