"""Smoothed-aggregation AMG tests (PETSc GAMG parity: coarse solves and
elasticity with rigid-body near-nullspace)."""
import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from gridapsolvers_tpu.fem import poisson_problem
from gridapsolvers_tpu.fem.elasticity import elasticity_problem
from gridapsolvers_tpu.interfaces import rigid_body_modes
from gridapsolvers_tpu.linear import CGSolver
from gridapsolvers_tpu.linear.amg import AMGSolver


def test_amg_cg_poisson():
    """CG + AMG on 2D Poisson: mesh-independent-ish iterations without any
    geometric hierarchy."""
    iters = []
    for n in (16, 32):
        prob = poisson_problem((n, n))
        amg = AMGSolver(coarse_size=100)
        solver = CGSolver(Pl=amg, rtol=1e-8, maxiter=60)
        state = solver.setup(prob.A)
        x, stats = solver.solve(state, prob.b)
        assert stats.converged()
        assert float(prob.l2_error(x)) < 1e-6
        iters.append(int(stats.niter))
    assert iters[1] <= iters[0] + 8, iters


def test_amg_hierarchy_shrinks():
    prob = poisson_problem((64, 64))
    amg = AMGSolver(coarse_size=50)
    state = amg.setup(prob.A)
    sizes = [m.shape[0] for m in state["mats"]]
    assert len(sizes) >= 3
    assert all(sizes[i + 1] < sizes[i] for i in range(len(sizes) - 1))
    # ~8x target coarsening per level keeps Galerkin fill bounded
    assert sizes[1] <= sizes[0] // 4
    assert sizes[-1] <= 150


def test_amg_elasticity_rigid_body_candidates():
    """AMG with rigid-body near-nullspace candidates on clamped elasticity
    (the PETScElasticitySolver recipe, ElasticitySolvers.jl:83-108)."""
    prob = elasticity_problem((12, 12))
    coords = prob.mesh.vertex_coords()
    ns = rigid_body_modes(jnp.asarray(coords))
    n = coords.shape[0]
    # modes are node-major (n, d); system is component-major blocks
    cand = np.stack(
        [
            np.concatenate(
                [np.asarray(q).reshape(n, 2)[:, 0],
                 np.asarray(q).reshape(n, 2)[:, 1]]
            )
            for q in ns.vectors
        ],
        axis=1,
    )
    amg = AMGSolver(coarse_size=80, near_nullspace=cand)
    solver = CGSolver(Pl=amg, rtol=1e-8, maxiter=80)
    state = solver.setup(prob.A)
    x, stats = solver.solve(state, prob.b)
    assert stats.converged()
    assert prob.residual_norm(x) < 1e-6


def test_amg_large_scale_and_update():
    """Vectorized setup handles >=1e5 dofs in seconds; pattern-reusing
    update() reproduces a fresh setup's convergence (VERDICT round-2
    item 8; reference GAMG coarse-solver usage,
    joss_paper/scalability/src/utils.jl:14-33)."""
    import time

    import jax.numpy as jnp

    from gridapsolvers_tpu.fem import poisson_problem
    from gridapsolvers_tpu.linear import CGSolver
    from gridapsolvers_tpu.linear.amg import AMGSolver

    prob = poisson_problem((340, 340))  # 116k dofs
    t0 = time.perf_counter()
    amg = AMGSolver(coarse_size=300)
    st = amg.setup(prob.A)
    dt = time.perf_counter() - t0
    assert dt < 60.0, f"AMG setup too slow: {dt:.1f}s"
    solver = CGSolver(Pl=amg, rtol=1e-8, maxiter=60)
    cst = solver.setup(prob.A)
    x, stats = solver.solve(cst, prob.b)
    assert stats.converged()
    assert float(prob.l2_error(x)) < 1e-5

    # update with scaled values: same aggregation, same convergence
    t0 = time.perf_counter()
    st2 = amg.update(st, prob.A)
    dt_upd = time.perf_counter() - t0
    assert dt_upd < dt  # pattern reuse must beat full setup
    z1 = amg.apply(st, prob.b)
    z2 = amg.apply(st2, prob.b)
    import numpy as np

    np.testing.assert_allclose(
        np.asarray(z1), np.asarray(z2), rtol=1e-10, atol=1e-12
    )


def test_amg_as_gmg_coarse_solver():
    """AMG as the GMG coarsest-level solver (the reference's scalability
    configuration: GMG fine levels + GAMG coarse solve)."""
    from gridapsolvers_tpu.fem import poisson_problem
    from gridapsolvers_tpu.fem.assembly import eliminate_dirichlet, laplacian
    from gridapsolvers_tpu.linear import CGSolver, ChebyshevSmoother
    from gridapsolvers_tpu.linear.amg import AMGSolver
    from gridapsolvers_tpu.linear.gmg import gmg_from_hierarchy
    from gridapsolvers_tpu.multilevel import cartesian_hierarchy

    prob = poisson_problem((64, 64))
    hier = cartesian_hierarchy((64, 64), 2)  # coarse level still 33^2

    def assemble(mesh):
        return eliminate_dirichlet(laplacian(mesh), mesh.boundary_vertex_mask())

    gmg = gmg_from_hierarchy(
        hier,
        assemble,
        smoother=ChebyshevSmoother(degree=3),
        coarsest_solver=AMGSolver(coarse_size=100, ncycles=2),
    )
    solver = CGSolver(Pl=gmg, rtol=1e-8, maxiter=40)
    st = solver.setup(prob.A)
    x, stats = solver.solve(st, prob.b)
    assert stats.converged()
    assert float(prob.l2_error(x)) < 1e-5


def test_dist_amg_matches_serial():
    """Distributed AMG (row-sharded levels, replicated tail — the parallel
    GAMG analog): same iteration count and solution as the serial AMG on
    the same system, driven end to end on the 8-device mesh."""
    import jax
    from gridapsolvers_tpu.algebra.convert import to_scipy
    from gridapsolvers_tpu.linear.amg import DistAMGSolver
    from gridapsolvers_tpu.parallel import device_mesh
    from gridapsolvers_tpu.parallel.dist_ell import (
        shard_csr,
        shard_vector,
        unshard_vector,
    )

    mesh = device_mesh(8)
    prob = poisson_problem((63, 63))
    S = to_scipy(prob.A)
    n = S.shape[0]
    b = np.random.default_rng(5).normal(size=n)

    amg = AMGSolver(coarse_size=100)
    solver = CGSolver(Pl=amg, rtol=1e-8, maxiter=80)
    st = solver.setup(prob.A)
    x_s, stats_s = solver.solve(st, jnp.asarray(b)[: prob.A.n])
    assert int(stats_s.niter) > 5

    Ad = shard_csr(S, mesh, identity_pad=True)
    damg = DistAMGSolver(coarse_size=100, mesh=mesh, min_sharded_rows=64)
    dsolver = CGSolver(Pl=damg, rtol=1e-8, maxiter=80)
    std = dsolver.setup(Ad)
    # the fine level must actually be sharded, the tail replicated
    mats = std["Pl"]["mats"]
    assert type(mats[0]).__name__ == "DistGraphELL", type(mats[0])
    assert type(mats[-1]).__name__ == "ELLMatrix", type(mats[-1])
    bd = shard_vector(b, mesh)
    x_d, stats_d = jax.jit(lambda s, v: dsolver.solve(s, v))(std, bd)

    assert abs(int(stats_d.niter) - int(stats_s.niter)) <= 2, (
        int(stats_d.niter),
        int(stats_s.niter),
    )
    np.testing.assert_allclose(
        unshard_vector(x_d, n), np.asarray(x_s), atol=1e-6
    )


def test_amg_levels_and_transfers_are_ell():
    """Every non-coarsest level operator and every transfer of an f32
    system is an f32 ELL matrix whose matvec matches its scipy twin, and
    the V-cycle preconditions CG to convergence."""
    from gridapsolvers_tpu.algebra.ell import ELLMatrix, ell_from_scipy
    from gridapsolvers_tpu.algebra.ell import ell_to_scipy
    from gridapsolvers_tpu.fem import assembly2 as asm2
    from gridapsolvers_tpu.fem.mesh import CartesianMesh

    mesh = CartesianMesh(ncells=(24, 24), domain=(0, 1, 0, 1))
    mask = asm2.boundary_node_mask(mesh, 1)
    K = asm2.dirichlet_square(
        asm2.assemble_bilinear(mesh, 1, "stiffness"), mask
    )
    A = ell_from_scipy(K, dtype=np.float32)
    rng = np.random.default_rng(3)
    b = jnp.asarray(rng.normal(size=A.shape[0]).astype(np.float32)) * (
        ~np.asarray(mask)
    )

    amg = AMGSolver(coarse_size=60)
    st = amg.setup(A)
    ops = list(st["mats"][:-1]) + list(st["P"]) + list(st["R"])
    assert len(st["P"]) >= 1
    for m in ops:
        assert isinstance(m, ELLMatrix) and m.dtype == jnp.float32
        x = rng.normal(size=m.shape[1]).astype(np.float32)
        y_ref = ell_to_scipy(m).astype(np.float64) @ x.astype(np.float64)
        np.testing.assert_allclose(
            np.asarray(m.matvec(jnp.asarray(x))), y_ref,
            rtol=1e-5, atol=1e-5 * np.abs(y_ref).max(),
        )
    s = CGSolver(Pl=amg, rtol=1e-6, maxiter=60)
    _, stats = s.solve(s.setup(A), b)
    assert stats.converged()


def test_amg_finest_level_keeps_stencil_operator():
    """A structured (StencilMatrix) system keeps the ORIGINAL operator as
    the finest cycle level — the banded lowering reads no column
    indices. Numerics must be unchanged vs the all-ELL packing."""
    from gridapsolvers_tpu.algebra.convert import to_scipy
    from gridapsolvers_tpu.algebra.ell import ELLMatrix, ell_from_scipy
    from gridapsolvers_tpu.algebra.stencil import StencilMatrix
    from gridapsolvers_tpu.models.poisson import poisson_problem

    prob = poisson_problem((10, 10, 10), dtype=np.float32)
    assert isinstance(prob.A, StencilMatrix)
    rng = np.random.default_rng(5)
    b = jnp.asarray(rng.normal(size=prob.A.shape[0]).astype(np.float32))

    amg = AMGSolver(coarse_size=60)
    st_s = amg.setup(prob.A)
    A_ell = ell_from_scipy(to_scipy(prob.A), dtype=np.float32)
    st_e = amg.setup(A_ell)
    assert st_s["mats"][0] is prob.A
    assert isinstance(st_e["mats"][0], ELLMatrix)
    z_s = amg.apply(st_s, b)
    z_e = amg.apply(st_e, b)
    np.testing.assert_allclose(
        np.asarray(z_s), np.asarray(z_e), rtol=2e-5, atol=2e-5
    )
    # update() keeps the (new) stencil operator too
    A2 = dataclasses.replace(prob.A, bands=prob.A.bands * 1.5)
    st_s2 = amg.update(st_s, A2)
    assert st_s2["mats"][0] is A2


def test_rowcap_symmetric_and_rowsum():
    """_rowcap on a symmetric square matrix: output stays EXACTLY
    symmetric (pattern intersected with its transpose), row sums are
    preserved (dropped mass lumped onto the diagonal), and widths are
    bounded by cap+1; transfers (keep_diag=False) preserve row sums via
    largest-entry lumping."""
    import scipy.sparse as sp

    from gridapsolvers_tpu.linear.amg import _rowcap

    rng = np.random.default_rng(3)
    n = 200
    B = sp.random(n, n, density=0.12, random_state=7, format="csr")
    S = (B + B.T).tocsr()
    S = (S + sp.diags(np.full(n, 2.0))).tocsr()
    out = _rowcap(S, cap=8, keep_diag=True)
    assert abs(out - out.T).max() < 1e-13  # exact symmetry
    np.testing.assert_allclose(
        np.asarray(out.sum(axis=1)).ravel(),
        np.asarray(S.sum(axis=1)).ravel(),
        rtol=1e-12, atol=1e-12,
    )
    assert np.diff(out.indptr).max() <= 9  # cap + diagonal

    P = sp.random(n, 40, density=0.3, random_state=11, format="csr")
    outP = _rowcap(P, cap=5, keep_diag=False)
    assert np.diff(outP.indptr).max() <= 5
    np.testing.assert_allclose(
        np.asarray(outP.sum(axis=1)).ravel(),
        np.asarray(P.sum(axis=1)).ravel(),
        rtol=1e-12, atol=1e-12,
    )


def test_strength_rescue_keeps_3d_q1_connected():
    """The 3D Q1 hex Laplacian has every off-diagonal at 1/16 of
    sqrt(a_ii a_jj) — below the standard theta=0.08 — and the bare Vanek
    criterion returns an EMPTY strength graph (the round-4 OOM root
    cause). The per-row strongest-edge rescue must keep it connected and
    the aggregation near its target ratio."""
    from gridapsolvers_tpu.algebra.convert import to_scipy
    from gridapsolvers_tpu.fem import poisson_problem
    from gridapsolvers_tpu.linear.amg import (
        _aggregate_target,
        _strength_graph,
    )

    prob = poisson_problem((12, 12, 12), dtype=np.float32)
    S = to_scipy(prob.A).tocsr()
    C = _strength_graph(S, 0.08)
    assert C.nnz > 0.5 * S.nnz  # rescue kept the isotropic stencil
    W = S.copy().tocsr()
    W.setdiag(0)
    W.eliminate_zeros()
    W.data = np.abs(W.data)
    agg = _aggregate_target(C, W, 8.0)
    sizes = np.bincount(agg)
    ratio = S.shape[0] / len(sizes)
    assert ratio > 5.0, ratio          # near-target coarsening
    assert sizes.max() <= 32, sizes.max()  # no mega-aggregates
