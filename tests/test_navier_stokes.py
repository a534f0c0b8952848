"""Navier-Stokes + Newton tests — mirrors the reference's
test/Applications/NavierStokes.jl and NonlinearSolversTests.jl: Newton with
a block-preconditioned FGMRES inner solver, nonlinear blocks refreshed per
iterate, and Picard->Newton continuation."""
import numpy as np
import pytest

import jax.numpy as jnp

from gridapsolvers_tpu.blocks import (
    BlockTriangularSolver,
    MatrixBlock,
    NonlinearSystemBlock,
)
from gridapsolvers_tpu.fem.navier_stokes import navier_stokes_problem
from gridapsolvers_tpu.linear import (
    CGSolver,
    DenseLUSolver,
    FGMRESSolver,
    JacobiSolver,
)
from gridapsolvers_tpu.nonlinear import (
    ContinuationOperator,
    ContinuationSwitch,
    NewtonSolver,
)


@pytest.fixture(scope="module")
def ns8():
    return navier_stokes_problem((8, 8), nu=1.0)


def _newton(prob, maxiter=15):
    P = BlockTriangularSolver(
        solvers=(
            DenseLUSolver(),
            CGSolver(Pl=JacobiSolver(), rtol=1e-10, maxiter=60),
        ),
        blocks=(
            (NonlinearSystemBlock(), None),
            (None, MatrixBlock(prob.Mp)),
        ),
        half="upper",
    )
    fgmres = FGMRESSolver(m=40, Pr=P, rtol=1e-10, maxiter=120)
    return NewtonSolver(fgmres, maxiter=maxiter, rtol=1e-9, atol=1e-11)


def test_residual_at_exact_solution_is_small(ns8):
    """Interpolated exact solution nearly solves the discrete system."""
    x = (
        tuple(jnp.asarray(u) for u in ns8.u_exact),
        jnp.asarray(ns8.p_exact),
    )
    r = x and ns8.residual(x)
    from gridapsolvers_tpu.utils import pytrees as pt

    rn = float(pt.norm(r))
    fn = float(pt.norm(ns8.f))
    assert rn < 0.5 * max(fn, 1e-12)


def test_newton_converges(ns8):
    solver = _newton(ns8)
    x, stats = solver.solve(ns8, ns8.zero_guess())
    assert stats.converged(), np.asarray(stats.residuals)
    # Newton quadratic-ish: few iterations at nu=1
    assert int(stats.niter) <= 8
    u, p = x
    assert ns8.velocity_error(u) < 5e-4


def test_newton_jacobian_consistency(ns8):
    """Directional derivative check: R(x+eps d) - R(x) ~ eps J d."""
    from gridapsolvers_tpu.utils import pytrees as pt

    rng = np.random.default_rng(0)
    x = (
        tuple(jnp.asarray(rng.normal(size=ns8.n_u) * 0.1) for _ in range(2)),
        jnp.asarray(rng.normal(size=ns8.Mp.shape[0]) * 0.1),
    )
    d = (
        tuple(jnp.asarray(rng.normal(size=ns8.n_u)) for _ in range(2)),
        jnp.asarray(rng.normal(size=ns8.Mp.shape[0])),
    )
    # central difference is exact (up to roundoff) for the quadratic
    # convection nonlinearity
    eps = 1e-5
    rp = ns8.residual(pt.axpy(eps, d, x))
    rm = ns8.residual(pt.axpy(-eps, d, x))
    fd = pt.scale(1.0 / (2 * eps), pt.sub(rp, rm))
    Jd = ns8.jacobian(x).matvec(d)
    num = float(pt.norm(pt.sub(fd, Jd)))
    den = float(pt.norm(Jd))
    assert num / den < 1e-8


def test_picard_newton_continuation(ns8):
    """Picard for 2 jacobians, then Newton (reference
    ContinuationFEOperators usage)."""

    class PicardOp:
        def residual(self, x):
            return ns8.residual(x)

        def jacobian(self, x):
            return ns8.picard_jacobian(x)

    op = ContinuationOperator(PicardOp(), ns8, ContinuationSwitch(niter=2))
    solver = _newton(ns8, maxiter=20)
    x, stats = solver.solve(op, ns8.zero_guess())
    assert stats.converged()
    u, p = x
    assert ns8.velocity_error(u) < 5e-4


def test_newton_with_nonlinear_gmg():
    """Newton + FGMRES with the nonlinear-GMG velocity preconditioner:
    level Jacobians reassembled at each Newton iterate (reference
    NavierStokesGMG.jl:132-176 + GMGLinearSolvers nonlinear path)."""
    from gridapsolvers_tpu.fem.navier_stokes import ns_velocity_gmg

    prob = navier_stokes_problem((8, 8), nu=1.0)
    gmg = ns_velocity_gmg((8, 8), num_levels=2, nu=1.0, ncycles=2)
    P = BlockTriangularSolver(
        solvers=(
            gmg,
            CGSolver(Pl=JacobiSolver(), rtol=1e-10, maxiter=60),
        ),
        blocks=(
            (NonlinearSystemBlock(), None),
            (None, MatrixBlock(prob.Mp)),
        ),
        half="upper",
    )
    fgmres = FGMRESSolver(m=40, Pr=P, rtol=1e-10, maxiter=200)
    newton = NewtonSolver(fgmres, maxiter=15, rtol=1e-9)
    x, stats = newton.solve(prob, prob.zero_guess())
    assert stats.converged(), np.asarray(stats.residuals)
    u, p = x
    assert prob.velocity_error(u) < 5e-4


def test_newton_gmg_with_vanka_patch_smoother():
    """Config 4 (BASELINE.json): Newton + FGMRES with PATCH-based smoothers
    inside the velocity GMG (Vanka patches over the coupled velocity
    components, matrix-extracted and refreshed per Newton iterate)."""
    from gridapsolvers_tpu.fem.navier_stokes import ns_velocity_gmg
    from gridapsolvers_tpu.linear import RichardsonSmoother
    from gridapsolvers_tpu.patches import VankaSolver

    prob = navier_stokes_problem((8, 8), nu=1.0)
    patch_smoother = RichardsonSmoother(
        VankaSolver(omega=1.0, seed_field=-1), niter=1, omega=0.8
    )
    gmg = ns_velocity_gmg(
        (8, 8), num_levels=2, nu=1.0, smoother=patch_smoother, ncycles=2
    )
    P = BlockTriangularSolver(
        solvers=(
            gmg,
            CGSolver(Pl=JacobiSolver(), rtol=1e-10, maxiter=60),
        ),
        blocks=(
            (NonlinearSystemBlock(), None),
            (None, MatrixBlock(prob.Mp)),
        ),
        half="upper",
    )
    fgmres = FGMRESSolver(m=40, Pr=P, rtol=1e-10, maxiter=200)
    newton = NewtonSolver(fgmres, maxiter=15, rtol=1e-9)
    x, stats = newton.solve(prob, prob.zero_guess())
    assert stats.converged(), np.asarray(stats.residuals)
    u, p = x
    assert prob.velocity_error(u) < 5e-4


def test_newton_graddiv_augmented_gmg():
    """The reference's NavierStokesGMG configuration
    (NavierStokesGMG.jl:108-170): augmented-Lagrangian NS (grad-div
    alpha=1e3, P1disc pressure), Newton with FGMRES + block-triangular
    [nonlinear patch-smoothed velocity GMG, -(1/alpha) Mp]. The per-level
    Jacobians (lap + convection + graddiv) are reassembled at each Newton
    iterate and the Vanka patch smoothers re-extract from them (the
    nonlinear patch-smoother path)."""
    import dataclasses

    from gridapsolvers_tpu.fem.navier_stokes import ns_velocity_gmg

    alpha = 1.0e3
    prob = navier_stokes_problem((8, 8), nu=1.0, graddiv_alpha=alpha)
    gmg = ns_velocity_gmg((8, 8), num_levels=2, nu=1.0, graddiv_alpha=alpha)
    Mp_scaled = dataclasses.replace(
        prob.Mp, values=prob.Mp.values * (-1.0 / alpha)
    )
    P = BlockTriangularSolver(
        solvers=(
            gmg,
            CGSolver(Pl=JacobiSolver(), rtol=1e-10, maxiter=60),
        ),
        blocks=((NonlinearSystemBlock(), None), (None, MatrixBlock(Mp_scaled))),
        coeffs=((1.0, 1.0), (0.0, 1.0)),
        half="upper",
    )
    fgmres = FGMRESSolver(m=20, Pr=P, rtol=1e-10, maxiter=40)
    newton = NewtonSolver(fgmres, maxiter=12, rtol=1e-9, atol=1e-11)
    x, stats = newton.solve(prob, prob.zero_guess())
    assert stats.converged()
    assert int(stats.niter) <= 4  # quadratic from zero guess at nu=1
    u, p = x
    assert prob.velocity_error(u) < 5e-4


def test_newton_device_loop_matches_host():
    """loop='device': the whole Newton iteration (inner FGMRES, residual,
    Jacobian reassembly, preconditioner update) traces into ONE jit
    program (lax.while_loop) and reproduces the host-driven loop: zero
    per-step host syncs."""
    prob = navier_stokes_problem((8, 8), nu=1.0)
    host = _newton(prob)
    dev = NewtonSolver(
        host.linear, maxiter=host.maxiter, rtol=host.rtol,
        atol=host.atol, loop="device",
    )
    import warnings

    x_h, st_h = host.solve(prob, prob.zero_guess())
    with warnings.catch_warnings():
        # a fallback warning means the device loop did NOT trace — fail
        warnings.simplefilter("error")
        x_d, st_d = dev.solve(prob, prob.zero_guess())
    assert int(st_d.niter) == int(st_h.niter)
    assert st_d.converged()
    from gridapsolvers_tpu.utils import pytrees as pt

    rel = float(pt.norm(pt.sub(x_d, x_h))) / max(float(pt.norm(x_h)), 1e-12)
    assert rel < 1e-6


def test_newton_device_loop_config4_gmg_vanka():
    """Device-loop Newton through the full BASELINE config-4 stack
    (FGMRES + block-triangular nonlinear patch-smoothed velocity GMG):
    the per-iterate GMG level reassembly and Vanka re-extraction must
    trace inside the lax.while_loop body."""
    from gridapsolvers_tpu.fem.navier_stokes import ns_velocity_gmg
    from gridapsolvers_tpu.linear import RichardsonSmoother
    from gridapsolvers_tpu.patches import VankaSolver

    prob = navier_stokes_problem((8, 8), nu=1.0)
    patch_smoother = RichardsonSmoother(
        VankaSolver(omega=1.0, seed_field=-1), niter=1, omega=0.8
    )
    gmg = ns_velocity_gmg(
        (8, 8), num_levels=2, nu=1.0, smoother=patch_smoother, ncycles=2
    )
    P = BlockTriangularSolver(
        solvers=(
            gmg,
            CGSolver(Pl=JacobiSolver(), rtol=1e-10, maxiter=60),
        ),
        blocks=(
            (NonlinearSystemBlock(), None),
            (None, MatrixBlock(prob.Mp)),
        ),
        half="upper",
    )
    fgmres = FGMRESSolver(m=40, Pr=P, rtol=1e-10, maxiter=200)
    import warnings

    newton = NewtonSolver(fgmres, maxiter=15, rtol=1e-9, loop="device")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        x, stats = newton.solve(prob, prob.zero_guess())
    assert stats.converged(), np.asarray(stats.residuals)
    u, p = x
    assert prob.velocity_error(u) < 5e-4


def test_cavity_jacobian_consistency():
    """Lid-driven-cavity NS (reference NavierStokesGMG.jl:101-106): the
    masked Jacobian must be the exact derivative of the row-masked-only
    cavity residual along free-dof directions, plain AND augmented."""
    from gridapsolvers_tpu.utils import pytrees as pt

    rng = np.random.default_rng(0)
    for alpha in (0.0, 100.0):
        prob = navier_stokes_problem(
            (8, 8), nu=0.1, graddiv_alpha=alpha, bc="cavity"
        )
        u0, p0 = prob.initial_guess()
        du = tuple(
            jnp.asarray(rng.normal(size=prob.n_u)) * prob.free_u
            for _ in range(2)
        )
        dp = jnp.asarray(rng.normal(size=p0.shape))
        x = (tuple(u + 0.3 * d for u, d in zip(u0, du)), 0.1 * dp)
        Jd = prob.jacobian(x).matvec((du, dp))
        eps = 1e-6
        rp = prob.residual(
            (tuple(u + eps * d for u, d in zip(x[0], du)), x[1] + eps * dp)
        )
        rm = prob.residual(
            (tuple(u - eps * d for u, d in zip(x[0], du)), x[1] - eps * dp)
        )
        fd = pt.axpy(1.0 / (2 * eps), rp, pt.scale(-1.0 / (2 * eps), rm))
        err = pt.norm(pt.axpy(-1.0, Jd, fd)) / pt.norm(Jd)
        assert float(err) < 1e-6, (alpha, float(err))
        # BC-consistent guess: constrained rows carry exactly zero residual
        r0 = prob.residual((u0, p0))
        bdry = 1.0 - np.asarray(prob.free_u)
        for c in range(2):
            assert float(jnp.max(jnp.abs(r0[0][c] * bdry))) == 0.0


def test_cavity_newton_re10_gmg():
    """Reference config (NavierStokesGMG.jl:106: Re = 10): lid-driven
    cavity from a zero start takes >= 4 genuine Newton steps (BC
    enforcement + convection), converges, and produces the clockwise
    primary vortex (u_x < 0 under the lid center)."""
    from gridapsolvers_tpu.fem.navier_stokes import ns_velocity_gmg
    from gridapsolvers_tpu.linear import RichardsonSmoother
    from gridapsolvers_tpu.patches import VankaSolver

    nc, nu = 16, 0.1
    prob = navier_stokes_problem((nc, nc), nu=nu, bc="cavity")
    sm = RichardsonSmoother(
        VankaSolver(omega=1.0, seed_field=-1), niter=1, omega=0.8
    )
    gmg = ns_velocity_gmg(
        (nc, nc), num_levels=3, nu=nu, smoother=sm, ncycles=2, bc="cavity"
    )
    P = BlockTriangularSolver(
        solvers=(
            gmg,
            CGSolver(Pl=JacobiSolver(), rtol=1e-6, maxiter=30),
        ),
        blocks=(
            (NonlinearSystemBlock(), None),
            (None, MatrixBlock(prob.Mp)),
        ),
        half="upper",
    )
    fgmres = FGMRESSolver(m=40, Pr=P, rtol=1e-8, maxiter=100)
    newton = NewtonSolver(fgmres, maxiter=20, rtol=1e-8, atol=1e-10)
    x, stats = newton.solve(prob, prob.zero_guess())
    assert int(stats.niter) >= 4
    assert int(stats.flag) in (1, 2), np.asarray(stats.residuals)
    gs = (2 * nc + 1, 2 * nc + 1)
    ux = np.asarray(x[0][0]).reshape(gs)
    assert ux[nc, nc] < -0.05
