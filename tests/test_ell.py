"""Padded-ELL SpMV (algebra/ell.py) against scipy on the sparsity
patterns the solvers produce: Q2 stiffness, random bands, an arrow
matrix, unstructured scatter, and the rectangular aggregate transfers of
AMG; plus ELL as a smoother's level operator."""
import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from gridapsolvers_tpu.algebra.ell import ell_from_scipy


def _q2_stiffness(nc):
    from gridapsolvers_tpu.fem import assembly2 as asm
    from gridapsolvers_tpu.fem.mesh import CartesianMesh

    mesh = CartesianMesh((nc, nc), (0.0, 1.0, 0.0, 1.0))
    mask = asm.boundary_node_mask(mesh, 2)
    return asm.dirichlet_square(
        asm.assemble_bilinear(mesh, 2, "stiffness"), mask
    )


def _check_matvec(S, A, seed, rtol=1e-12):
    x = np.random.default_rng(seed).normal(size=S.shape[1])
    np.testing.assert_allclose(
        np.asarray(A.matvec(jnp.asarray(x))), S @ x, rtol=rtol, atol=rtol
    )


def test_ell_matches_scipy_q2():
    S = _q2_stiffness(12)
    A = ell_from_scipy(S, dtype=np.float64)
    _check_matvec(S, A, 0)
    np.testing.assert_allclose(np.asarray(A.diag()), S.diagonal(), rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(A.abs_row_sum()),
        np.asarray(abs(S).sum(axis=1)).ravel(),
        rtol=1e-12,
    )


def test_ell_random_banded():
    rng = np.random.default_rng(1)
    n = 2500
    rows, cols, vals = [], [], []
    for r in range(n):
        cs = np.unique(np.clip(r + rng.integers(-300, 300, 7), 0, n - 1))
        rows += [r] * len(cs)
        cols += list(cs)
        vals += list(rng.normal(size=len(cs)))
    S = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    _check_matvec(S, ell_from_scipy(S), 2, rtol=1e-11)


def test_ell_arrow_matrix():
    """Last column dense: one far column per row."""
    n = 4096
    S = (
        sp.eye(n, format="csr")
        + sp.coo_matrix(
            (np.ones(n), (np.arange(n), np.full(n, n - 1))), shape=(n, n)
        ).tocsr()
    )
    _check_matvec(S, ell_from_scipy(S, dtype=np.float64), 3)


def test_ell_unstructured_scatter():
    """Random far columns: no band structure at all."""
    rng = np.random.default_rng(4)
    n = 4096
    S = (
        sp.eye(n, format="csr")
        + sp.coo_matrix(
            (np.ones(n), (np.arange(n), rng.permutation(n))), shape=(n, n)
        ).tocsr()
    )
    _check_matvec(S, ell_from_scipy(S, dtype=np.float64), 5)


def test_ell_as_smoother_operator():
    """Drops into the Richardson-Jacobi smoother as a level operator
    (diag + matvec contract)."""
    from gridapsolvers_tpu.linear import CGSolver, JacobiSolver
    from gridapsolvers_tpu.linear.smoothers import RichardsonSmoother

    S = _q2_stiffness(10)
    A = ell_from_scipy(S, dtype=np.float64)
    b = np.random.default_rng(2).normal(size=S.shape[0])
    solver = CGSolver(
        Pl=RichardsonSmoother(JacobiSolver(), 2, 0.67),
        rtol=1e-10,
        maxiter=500,
    )
    x, stats = solver.solve(solver.setup(A), jnp.asarray(b))
    r = b - S @ np.asarray(x)
    assert np.linalg.norm(r) < 1e-8 * np.linalg.norm(b)


def _aggregate_pair(nf, nc, seed):
    """Prolongation-like sparse (nf, nc) matrix with col ~ row*nc/nf
    (the AMG smoothed-aggregation shape, non-integer ratio allowed)."""
    rng = np.random.default_rng(seed)
    agg = np.minimum((np.arange(nf) * nc) // nf, nc - 1)
    rows, cols, vals = [], [], []
    for r in range(nf):
        cs = np.unique(np.clip(agg[r] + rng.integers(-2, 3, 3), 0, nc - 1))
        rows += [r] * len(cs)
        cols += list(cs)
        vals += list(rng.normal(size=len(cs)))
    P = sp.coo_matrix((vals, (rows, cols)), shape=(nf, nc)).tocsr()
    return P, P.T.tocsr()


@pytest.mark.parametrize("nf,nc", [(4400, 1100), (9000, 1054)])
def test_ell_rect_prolongation_and_restriction(nf, nc):
    """Rectangular transfers (integer and non-integer coarsening ratios):
    prolongation and its transpose as ELL both match scipy."""
    P, R = _aggregate_pair(nf, nc, seed=nf)
    KP = ell_from_scipy(P, dtype=np.float64)
    KR = ell_from_scipy(R, dtype=np.float64)
    assert KP.shape == P.shape and KR.shape == R.shape
    _check_matvec(P, KP, 7)
    _check_matvec(R, KR, 8)
