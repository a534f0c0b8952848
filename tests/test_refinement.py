"""Two-float refinement: error-free transforms + the Newton endgame that
pushes the f32 alpha-scaled residual floor toward reference f64
tolerances (KrylovTests.jl:25,67; VERDICT r04 item 9)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

F32_DRIVER = r"""
import jax, warnings, json
jax.config.update("jax_platforms", "cpu")   # true f32 (no test x64)
import numpy as np
import jax.numpy as jnp
import dataclasses as dc
from gridapsolvers_tpu.fem.navier_stokes import (
    navier_stokes_problem, ns_velocity_gmg)
from gridapsolvers_tpu.blocks import (
    BlockTriangularSolver, MatrixBlock, NonlinearSystemBlock)
from gridapsolvers_tpu.linear import CGSolver, FGMRESSolver, JacobiSolver
from gridapsolvers_tpu.nonlinear import NewtonSolver
from gridapsolvers_tpu.nonlinear.refinement import NewtonRefinement

nc, nu, alpha = 24, 0.1, 1e3
prob = navier_stokes_problem((nc, nc), nu=nu, dtype=np.float32,
                             graddiv_alpha=alpha, bc="cavity")
gmg = ns_velocity_gmg((nc, nc), num_levels=2, nu=nu, graddiv_alpha=alpha,
                      dtype=np.float32, bc="cavity", cheby_degree=4)
Mp = dc.replace(prob.Mp, values=prob.Mp.values * np.float32(-1.0 / alpha))
P = BlockTriangularSolver(
    solvers=(gmg, CGSolver(Pl=JacobiSolver(), rtol=1e-6, maxiter=30)),
    blocks=((NonlinearSystemBlock(), None), (None, MatrixBlock(Mp))),
    coeffs=((1.0, 1.0), (0.0, 1.0)), half="upper")
fg = FGMRESSolver(m=20, Pr=P, rtol=1e-8, maxiter=60)
newton = NewtonSolver(fg, maxiter=12, rtol=1e-6, atol=3e-3, loop="device")
warnings.simplefilter("ignore")
fn, dyn, ls, x0 = newton.prepare(prob, prob.zero_guess())
xf, it, flag, hist = fn(dyn, ls, x0)
h = np.asarray(hist); h = h[~np.isnan(h)]
x_hi, x_lo, rnorms = NewtonRefinement(fg, niter=3).refine(prob, xf, ls)
print("REFINE_RESULT " + json.dumps(
    {"rmax": float(h.max()), "floor": float(h[-1]), "rnorms": rnorms}))
"""


def test_error_free_transforms():
    from gridapsolvers_tpu.utils.compensated import (
        comp_ell_matvec,
        two_prod,
        two_sum,
    )

    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.normal(size=512).astype(np.float32))
    b = jnp.asarray(rng.normal(size=512).astype(np.float32))
    s, e = two_sum(a, b)
    exact = np.asarray(a, np.float64) + np.asarray(b, np.float64)
    assert np.max(np.abs(
        np.asarray(s, np.float64) + np.asarray(e, np.float64) - exact
    )) == 0.0
    p, e = two_prod(a, b)
    exactp = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    assert np.max(np.abs(
        np.asarray(p, np.float64) + np.asarray(e, np.float64) - exactp
    )) < 1e-12

    # alpha-scaled cancelling rows: the exact configuration that sets the
    # f32 residual floor of the augmented formulations
    n, K, alpha = 2048, 16, 1e3
    cols = rng.integers(0, n, size=(n, K)).astype(np.int32)
    vals = (rng.normal(size=(n, K)) * alpha)
    vals[:, -1] = -vals[:, :-1].sum(1) + 1e-4 * rng.normal(size=n)
    vals = vals.astype(np.float32)
    x = rng.normal(size=n).astype(np.float32)
    y64 = (vals.astype(np.float64) * x.astype(np.float64)[cols]).sum(1)
    hi, lo = comp_ell_matvec(
        jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(x)
    )
    y_df = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    y_pl = np.asarray(
        jnp.sum(jnp.asarray(vals) * jnp.asarray(x)[jnp.asarray(cols)],
                axis=1, dtype=jnp.float32),
        np.float64,
    )
    err_pl = np.abs(y_pl - y64).max()
    err_df = np.abs(y_df - y64).max()
    assert err_df < 1e-4 * err_pl, (err_df, err_pl)


@pytest.mark.skipif(
    os.environ.get("SKIP_SUBPROC") == "1",
    reason="subprocess drivers disabled",
)
def test_two_float_newton_refinement_f32():
    """After the f32 device-Newton plateau on the augmented cavity NS
    (alpha = 1e3), 3 two-float refinement steps must take the
    compensated residual below rtol 1e-6 x the alpha-scaled r_max —
    i.e. remove the f32 iterate-representation floor entirely (measured
    ~3e4x reduction at nc=32)."""
    r = subprocess.run(
        [sys.executable, "-c", F32_DRIVER],
        capture_output=True, text=True, timeout=800,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-1500:])
    line = [ln for ln in r.stdout.splitlines()
            if ln.startswith("REFINE_RESULT ")]
    assert line, r.stdout[-1500:]
    res = json.loads(line[-1].split(" ", 1)[1])
    target = 1e-6 * res["rmax"]
    assert res["rnorms"][-1] < target, res
    assert res["rnorms"][-1] < 0.01 * res["rnorms"][0], res


def test_linear_iterative_refinement_f32_poisson():
    """Linear refinement (double-f32 iterate + compensated banded
    residual) on f32 3D Poisson: the f64-TRUE relative residual of the
    f32-stored system drops from the plain f32 floor (~2e-7) to ~1e-15
    — the reference's f64 CI tolerance regime (KrylovTests.jl:25,67)
    reached on f32-only arithmetic."""
    driver = r"""
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np, jax.numpy as jnp, json
import dataclasses as dc
from gridapsolvers_tpu.fem import poisson_problem
from gridapsolvers_tpu.fem.assembly import eliminate_dirichlet, laplacian
from gridapsolvers_tpu.linear import (
    CGSolver, ChebyshevSmoother, DenseInverseSolver)
from gridapsolvers_tpu.linear.gmg import gmg_from_hierarchy
from gridapsolvers_tpu.linear.refinement import IterativeRefinementSolver
from gridapsolvers_tpu.multilevel import cartesian_hierarchy

nc = 24
prob = poisson_problem((nc,)*3, dtype=np.float32)
A = prob.A
h = cartesian_hierarchy((nc,)*3, 3)
gmg = gmg_from_hierarchy(
    h, lambda m: eliminate_dirichlet(
        laplacian(m, np.float32), m.boundary_vertex_mask()),
    smoother=ChebyshevSmoother(degree=4, eig_method="gershgorin"),
    coarsest_solver=DenseInverseSolver(), dtype=jnp.float32)
cg = CGSolver(Pl=gmg, rtol=1e-6, maxiter=40)
b = jnp.asarray(np.asarray(prob.b, np.float32))
st = cg.setup(A)
x32, _ = jax.jit(cg.solve)(st, b)
A64 = dc.replace(A, bands=jnp.asarray(np.asarray(A.bands, np.float64)))
def resid64(xh, xl=None):
    x = np.asarray(xh, np.float64) + (
        np.asarray(xl, np.float64) if xl is not None else 0.0)
    r = np.asarray(b, np.float64) - A64.matvec_host(x)
    return float(np.linalg.norm(r)
                 / np.linalg.norm(np.asarray(b, np.float64)))
ref = IterativeRefinementSolver(cg, niter=2)
(xh, xl), _ = ref.solve(ref.setup(A), b)
print("LINREF_RESULT " + json.dumps(
    {"plain": resid64(x32), "refined": resid64(xh, xl)}))
"""
    r = subprocess.run(
        [sys.executable, "-c", driver],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-1500:])
    line = [ln for ln in r.stdout.splitlines()
            if ln.startswith("LINREF_RESULT ")]
    res = json.loads(line[-1].split(" ", 1)[1])
    assert res["refined"] < 1e-10, res
    assert res["refined"] < 1e-2 * res["plain"], res
