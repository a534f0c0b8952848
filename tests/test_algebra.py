"""Sparse-format correctness vs scipy (SURVEY.md §7 stage 1 validation)."""
import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from gridapsolvers_tpu.algebra import (
    BlockOperator,
    DenseMatrix,
    ELLMatrix,
    StencilMatrix,
    ell_from_coo,
    ell_to_scipy,
)
from gridapsolvers_tpu.fem import CartesianMesh, laplacian, mass


def random_coo(n, density=0.08, seed=0):
    rng = np.random.default_rng(seed)
    nnz = int(n * n * density)
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.normal(size=nnz)
    # ensure a nonzero diagonal
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    vals = np.concatenate([vals, np.full(n, 4.0)])
    return rows, cols, vals


def test_ell_matvec_vs_scipy():
    n = 73
    rows, cols, vals = random_coo(n)
    A = ell_from_coo(n, n, rows, cols, vals)
    S = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    x = np.random.default_rng(1).normal(size=n)
    np.testing.assert_allclose(A.matvec(jnp.asarray(x)), S @ x, rtol=1e-12)
    np.testing.assert_allclose(A.matvec_t(jnp.asarray(x)), S.T @ x, rtol=1e-12)
    np.testing.assert_allclose(A.diag(), S.diagonal(), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(A.todense()), S.toarray(), atol=1e-12)


def test_ell_roundtrip_scipy():
    n = 40
    rows, cols, vals = random_coo(n, seed=3)
    A = ell_from_coo(n, n, rows, cols, vals)
    S1 = ell_to_scipy(A)
    S2 = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    assert abs(S1 - S2).max() < 1e-12


@pytest.mark.parametrize("ncells", [(8,), (8, 6), (4, 5, 3)])
def test_stencil_laplacian_vs_ell(ncells):
    mesh = CartesianMesh(ncells, tuple(x for _ in ncells for x in (0.0, 1.0)))
    A = laplacian(mesh)
    A_ell = A.to_ell()
    x = np.random.default_rng(2).normal(size=A.n)
    np.testing.assert_allclose(
        A.matvec(jnp.asarray(x)), A_ell.matvec(jnp.asarray(x)), rtol=1e-11,
        atol=1e-12,
    )
    np.testing.assert_allclose(A.diag(), A_ell.diag(), rtol=1e-12)
    # symmetry
    D = np.asarray(A.todense())
    np.testing.assert_allclose(D, D.T, atol=1e-12)


def test_stencil_laplacian_exact_1d():
    # 1D P1 stiffness: tridiag(-1, 2, -1)/h on interior
    mesh = CartesianMesh((4,), (0.0, 1.0))
    h = 0.25
    D = np.asarray(laplacian(mesh).todense())
    expect = (
        np.diag([1, 2, 2, 2, 1]) + np.diag([-1] * 4, 1) + np.diag([-1] * 4, -1)
    ) / h
    np.testing.assert_allclose(D, expect, rtol=1e-12)


def test_mass_matrix_integrates_one():
    mesh = CartesianMesh((6, 5), (0.0, 2.0, 0.0, 3.0))
    M = mass(mesh)
    ones = jnp.ones(M.n)
    vol = float(jnp.vdot(ones, M.matvec(ones)))
    assert abs(vol - 6.0) < 1e-12  # area of [0,2]x[0,3]


def test_block_operator_matvec():
    n1, n2 = 11, 7
    rng = np.random.default_rng(5)
    A11 = DenseMatrix(jnp.asarray(rng.normal(size=(n1, n1))))
    A12 = DenseMatrix(jnp.asarray(rng.normal(size=(n1, n2))))
    A21 = DenseMatrix(jnp.asarray(rng.normal(size=(n2, n1))))
    B = BlockOperator(((A11, A12), (A21, None)))
    x = (jnp.asarray(rng.normal(size=n1)), jnp.asarray(rng.normal(size=n2)))
    y = B.matvec(x)
    np.testing.assert_allclose(y[0], A11.A @ x[0] + A12.A @ x[1], rtol=1e-12)
    np.testing.assert_allclose(y[1], A21.A @ x[0], rtol=1e-12)


def test_stencil_from_scipy_q2():
    """scipy -> banded StencilMatrix on the Q2 node grid (the conversion
    that puts the Stokes velocity blocks on the gather-free SpMV path).
    Matvec/diag must match scipy exactly, 2D and 3D, incl. Dirichlet
    identity rows and a periodic axis."""
    from gridapsolvers_tpu.algebra.stencil import stencil_from_scipy
    from gridapsolvers_tpu.fem import assembly2 as asm
    from gridapsolvers_tpu.fem.assembly import laplacian

    rng = np.random.default_rng(3)
    for nc in ((6, 9), (4, 5, 3)):
        mesh = CartesianMesh(nc, tuple(x for _ in nc for x in (0.0, 1.0)))
        m = asm.boundary_node_mask(mesh, 2)
        Kc = asm.dirichlet_square(
            asm.assemble_bilinear(mesh, 2, "stiffness"), m
        )
        St = stencil_from_scipy(Kc, asm.node_grid_shape(mesh, 2))
        assert len(St.offsets) == 5 ** len(nc)
        x = rng.normal(size=Kc.shape[0])
        np.testing.assert_allclose(
            np.asarray(St.matvec(jnp.asarray(x))), Kc @ x, atol=1e-12
        )
        np.testing.assert_allclose(
            np.asarray(St.diag()), Kc.diagonal(), atol=1e-13
        )
    # periodic axis: wraparound offsets take the minimal image
    pmesh = CartesianMesh((8, 6), (0.0, 1.0, 0.0, 1.0), periodic=(True, False))
    Ap = laplacian(pmesh)
    from gridapsolvers_tpu.algebra.convert import to_scipy

    Sp = to_scipy(Ap).tocsr()
    St = stencil_from_scipy(Sp, Ap.grid_shape, periodic=(True, False))
    x = rng.normal(size=Sp.shape[0])
    np.testing.assert_allclose(
        np.asarray(St.matvec(jnp.asarray(x))), Sp @ x, atol=1e-12
    )


def test_dirichlet_square_matches_lil_reference():
    """The vectorized symmetric Dirichlet elimination equals the plain
    LIL row/column zeroing it replaced: same pattern (explicit zeros of
    free rows kept, constrained rows reduced to their unit diagonal) and
    same values."""
    import numpy as np
    import scipy.sparse as sp

    from gridapsolvers_tpu.fem import assembly2 as asm
    from gridapsolvers_tpu.fem.mesh import CartesianMesh

    def reference(S, mask):
        S = S.tolil()
        idx = np.where(mask)[0]
        S[idx, :] = 0.0
        S[:, idx] = 0.0
        S[idx, idx] = 1.0
        return S.tocsr()

    m2 = CartesianMesh((12, 12), (0, 1, 0, 1))
    m3 = CartesianMesh((4, 5, 3), (0, 1, 0, 1, 0, 1))
    R = sp.random(300, 300, density=0.05, random_state=1, format="csr")
    R.data[::7] = 0.0
    cases = [
        (asm.assemble_bilinear(m2, 2, "stiffness"),
         asm.boundary_node_mask(m2, 2)),
        (asm.assemble_bilinear(m3, 1, "stiffness"),
         asm.boundary_node_mask(m3, 1)),
        (R, np.random.default_rng(0).random(300) < 0.2),
    ]
    for S, mask in cases:
        a = reference(S.copy(), mask)
        b = asm.dirichlet_square(S.copy(), mask)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.data, b.data)
