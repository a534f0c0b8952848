"""Grid transfer operators (prolongation / restriction).

Redesign of the reference's DistributedGridTransferOperator
(src/MultilevelTools/GridTransferOperators.jl:161-217,391-584): on structured
vertex grids with factor-2 refinement, Q1 interpolation is EXACTLY a
transposed strided convolution with the tensor-product kernel
[1/2, 1, 1/2]^(⊗d), applied one axis at a time as shifted slices
(plain elementwise work that XLA fuses) instead of the reference's
generic FE interpolation + mass-solve machinery.

Modes (reference :interpolation / :dual_projection / :projection):
- Prolongation (solution mode)  = interpolation: P = per-axis linear
  interpolation.
- Restriction (residual mode)   = dual: R = P^T = per-axis full
  weighting. For geometric rediscretized level matrices this is the
  standard full-weighting restriction; it coincides with the reference's
  dual-projection up to the mass scaling it applies (GMG convergence is
  invariant to that scaling when the coarse operator is rediscretized).
- Restriction (solution mode, for nonlinear GMG state projection) =
  injection at coincident vertices (reference :dof_mask /
  RefinementTools.restrict_dofs!).

Dirichlet masks: transfers act on full grids (constrained dofs kept with
identity rows, fem/assembly.py); correction transfers zero constrained
entries on the way in and out, which is the algebraic equivalent of the
reference's restriction to free dofs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.mesh import CartesianMesh


def _expand_dim(cur: jnp.ndarray, d: int, periodic: bool = False) -> jnp.ndarray:
    """One-dimensional factor-2 linear interpolation along axis d:
    (n,) -> (2n-1,) with even = values, odd = midpoint averages — or
    (n,) -> (2n,) wrapping the last midpoint when periodic. Pure
    stack/reshape/slice, which fuses as plain elementwise work."""
    n = cur.shape[d]
    nxt = jax.lax.slice_in_dim(cur, 1, n, axis=d)
    last = (
        jax.lax.slice_in_dim(cur, 0, 1, axis=d)
        if periodic
        else jax.lax.slice_in_dim(cur, n - 1, n, axis=d)
    )
    nxt = jnp.concatenate([nxt, last], axis=d)
    odd = 0.5 * (cur + nxt)
    inter = jnp.stack([cur, odd], axis=d + 1)
    shape = cur.shape[:d] + (2 * n,) + cur.shape[d + 1 :]
    inter = inter.reshape(shape)
    if periodic:
        return inter
    return jax.lax.slice_in_dim(inter, 0, 2 * n - 1, axis=d)


def _reduce_dim(x: jnp.ndarray, d: int, periodic: bool = False) -> jnp.ndarray:
    """Transpose of _expand_dim: (2n-1,) -> (n,) full weighting
    z_i = x_{2i} + 0.5 x_{2i-1} + 0.5 x_{2i+1}; periodic wraps the last
    midpoint's right contribution onto z_0."""
    n2 = x.shape[d]
    n = (n2 + 1) // 2
    # pad to even length 2n so the (n, 2) reshape splits [even | odd]
    # (no-op when the input length is already even, e.g. padded shards or
    # periodic axes)
    pad = [(0, 0)] * x.ndim
    pad[d] = (0, 2 * n - n2)
    xp = jnp.pad(x, pad)
    shape = x.shape[:d] + (n, 2) + x.shape[d + 1 :]
    xp = xp.reshape(shape)
    even = jax.lax.index_in_dim(xp, 0, axis=d + 1, keepdims=False)
    odd = jax.lax.index_in_dim(xp, 1, axis=d + 1, keepdims=False)
    # odd contributes to its left (i) and right (i+1) coarse neighbors
    odd_sh = jax.lax.slice_in_dim(odd, 0, n - 1, axis=d)
    head = (
        jax.lax.slice_in_dim(odd, n - 1, n, axis=d)
        if periodic
        else jnp.zeros_like(jax.lax.slice_in_dim(odd, 0, 1, axis=d))
    )
    odd_right = jnp.concatenate([head, odd_sh], axis=d)
    return even + 0.5 * odd + 0.5 * odd_right


def prolong_slices(xc: jnp.ndarray, factors=None, periodic=None) -> jnp.ndarray:
    out = xc
    for d in range(xc.ndim):
        if factors is not None and factors[d] == 1:
            continue
        out = _expand_dim(out, d, bool(periodic and periodic[d]))
    return out


def restrict_slices(xf: jnp.ndarray, factors=None, periodic=None) -> jnp.ndarray:
    out = xf
    for d in range(xf.ndim):
        if factors is not None and factors[d] == 1:
            continue
        out = _reduce_dim(out, d, bool(periodic and periodic[d]))
    return out


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class StructuredProlongation:
    """P: coarse vertex grid -> fine vertex grid (factor-2), Q1 interpolation.

    mask_fine: optional (fine flat) {0,1} array zeroing constrained dofs of
    the correction (1 = free dof).
    """

    fine_shape: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    coarse_shape: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    mask_fine: Optional[jnp.ndarray] = None
    grid_vectors: bool = dataclasses.field(
        default=False, metadata=dict(static=True)
    )
    # per-axis refinement factors in {1, 2} (anisotropic nrefs) and
    # periodic-wrap flags; None = all-2 / none-periodic
    factors: Optional[Tuple[int, ...]] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )
    periodic: Optional[Tuple[bool, ...]] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )

    def matvec(self, xc: jnp.ndarray) -> jnp.ndarray:
        y = prolong_slices(
            xc.reshape(self.coarse_shape), self.factors, self.periodic
        )
        if self.mask_fine is not None:
            y = y * self.mask_fine.reshape(self.fine_shape)
        return y if self.grid_vectors else y.reshape(-1)

    @property
    def shape(self):
        return (int(np.prod(self.fine_shape)), int(np.prod(self.coarse_shape)))


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class StructuredRestriction:
    """R = P^T (full weighting) for residuals, or injection for solutions.

    mode: 'residual' (dual/full-weighting) | 'solution' (injection).
    mask_coarse zeros constrained coarse dofs (1 = free).
    """

    fine_shape: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    coarse_shape: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    mode: str = dataclasses.field(default="residual", metadata=dict(static=True))
    mask_coarse: Optional[jnp.ndarray] = None
    mask_fine: Optional[jnp.ndarray] = None
    grid_vectors: bool = dataclasses.field(
        default=False, metadata=dict(static=True)
    )
    factors: Optional[Tuple[int, ...]] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )
    periodic: Optional[Tuple[bool, ...]] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )

    def matvec(self, xf: jnp.ndarray) -> jnp.ndarray:
        xf = xf.reshape(self.fine_shape)
        if self.mask_fine is not None:
            xf = xf * self.mask_fine.reshape(self.fine_shape)
        if self.mode == "solution":
            # injection: take coincident vertices (stride = factor)
            fac = self.factors or (2,) * len(self.fine_shape)
            y = xf[tuple(slice(0, None, f) for f in fac)]
        else:
            y = restrict_slices(xf, self.factors, self.periodic)
        if self.mask_coarse is not None:
            y = y * self.mask_coarse.reshape(self.coarse_shape)
        return y if self.grid_vectors else y.reshape(-1)

    @property
    def shape(self):
        return (int(np.prod(self.coarse_shape)), int(np.prod(self.fine_shape)))


def free_mask(mesh: CartesianMesh, dtype=jnp.float64) -> jnp.ndarray:
    """{0,1} flat mask of free (non-Dirichlet-boundary) vertex dofs."""
    m = mesh.boundary_vertex_mask()
    return jnp.asarray((~m).astype(np.float64).reshape(-1)).astype(dtype)


def setup_transfer_operators(
    hierarchy,
    with_masks: bool = True,
    dtype=jnp.float64,
):
    """Build (prolongations, restrictions) for all level pairs
    (reference GridTransferOperators.jl:350-380 setup_transfer_operators).

    prolongations[l] : level l+1 (coarse) -> level l (fine)
    restrictions[l]  : level l (fine) -> level l+1 (coarse), residual mode
    """
    meshes = hierarchy.meshes
    prolongations, restrictions = [], []
    for l in range(len(meshes) - 1):
        fine, coarse = meshes[l], meshes[l + 1]
        mf = free_mask(fine, dtype) if with_masks else None
        mc = free_mask(coarse, dtype) if with_masks else None
        factors = tuple(
            nf // nc for nf, nc in zip(fine.ncells, coarse.ncells)
        )
        per = tuple(fine.periodic)
        kw = {}
        if any(f != 2 for f in factors) or any(per):
            kw = dict(factors=factors, periodic=per)
        prolongations.append(
            StructuredProlongation(
                fine.vertex_shape, coarse.vertex_shape, mf, **kw
            )
        )
        restrictions.append(
            StructuredRestriction(
                fine.vertex_shape, coarse.vertex_shape, "residual", mc, mf,
                **kw,
            )
        )
    return prolongations, restrictions


# ---------------------------------------------------------------------------
# exact FE-embedding transfers (nested spaces, any order)
# ---------------------------------------------------------------------------


def fe_interpolation_1d(n_coarse_cells: int, order: int = 2):
    """1D nodal FE embedding matrix of the order-p Lagrange space on n
    uniform cells into the space on 2n cells: (2pn+1, pn+1) sparse.

    EXACT for nested refinement — with R = Pᵀ the rediscretized coarse
    operator equals the Galerkin product RAP on free dofs, which is what
    guarantees two-level convergence for strongly anisotropic energies
    (e.g. the grad-div augmented velocity block, where the linear
    node-grid transfer's O(h²) embedding error is amplified by alpha)."""
    import scipy.sparse as sp

    n, p = n_coarse_cells, order
    mc, mf = p * n + 1, 2 * p * n + 1
    nodes = np.linspace(0.0, 1.0, p + 1)
    L = np.zeros((2 * p + 1, p + 1))
    for r in range(2 * p + 1):
        xi = r / (2.0 * p)
        for k in range(p + 1):
            w = 1.0
            for j in range(p + 1):
                if j != k:
                    w *= (xi - nodes[j]) / (nodes[k] - nodes[j])
            L[r, k] = w
    rows, cols, vals = [], [], []
    for i in range(n):
        for r in range(0 if i == 0 else 1, 2 * p + 1):
            f = 2 * p * i + r
            for k in range(p + 1):
                if L[r, k] != 0.0:
                    rows.append(f)
                    cols.append(p * i + k)
                    vals.append(L[r, k])
    return sp.coo_matrix((vals, (rows, cols)), shape=(mf, mc)).tocsr()


def fe_grid_interpolation(coarse_ncells, order: int = 2):
    """Tensor-product FE embedding on a Cartesian grid (C-order node
    numbering): kron of the per-axis 1D embeddings."""
    import scipy.sparse as sp

    P = None
    for n in coarse_ncells:
        P1 = fe_interpolation_1d(int(n), order)
        P = P1 if P is None else sp.kron(P, P1, format="csr")
    return P.tocsr()


def fe_transfer_pair(coarse_ncells, order, mask_f=None, mask_c=None):
    """(prolongation, restriction) as ELLMatrix operators: P the exact FE
    embedding with Dirichlet rows/cols zeroed, R = Pᵀ (residual mode)."""
    from ..algebra.ell import ell_from_scipy
    from ..fem import assembly2 as _asm

    P = fe_grid_interpolation(coarse_ncells, order)
    if mask_f is not None:
        P = _asm.zero_rows(P, mask_f)
    if mask_c is not None:
        P = _asm.zero_columns(P, mask_c)
    P.eliminate_zeros()
    R = P.T.tocsr()
    return ell_from_scipy(P), ell_from_scipy(R)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TensorTransfer:
    """Separable (Kronecker) grid transfer as per-axis DENSE contractions.

    The FE embedding on a Cartesian grid is kron(P1d_0, ..., P1d_{D-1})
    (`fe_grid_interpolation`), and the Dirichlet masking is diagonal on
    both sides, so  P_masked = diag(m_out) · kron(...) · diag(m_in).
    The matvec is then D tensordots with tiny dense (m_f, m_c) factors
    (full f32 precision) instead of the gathers of the rectangular ELL
    lowering.

    mats[d]: (out_d, in_d) dense factor for axis d. mask_in / mask_out:
    optional flat {0,1} arrays (free-dof masks). Works as prolongation
    (mats = P1d) or restriction (mats = P1dᵀ, masks swapped).
    """

    mats: Tuple[jnp.ndarray, ...]
    in_shape: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    out_shape: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    mask_in: Optional[jnp.ndarray] = None
    mask_out: Optional[jnp.ndarray] = None

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        if self.mask_in is not None:
            x = x.reshape(-1) * self.mask_in.reshape(-1)
        y = x.reshape(self.in_shape)
        for d, M in enumerate(self.mats):
            y = jnp.moveaxis(
                jnp.tensordot(
                    M.astype(y.dtype), y, axes=([1], [d]), precision="highest"
                ),
                0,
                d,
            )
        y = y.reshape(-1)
        if self.mask_out is not None:
            y = y * self.mask_out.reshape(-1)
        return y

    @property
    def shape(self):
        return (
            int(np.prod(self.out_shape)),
            int(np.prod(self.in_shape)),
        )


def fe_transfer_pair_dense(coarse_ncells, order, mask_f=None, mask_c=None):
    """`fe_transfer_pair` with the separable dense lowering (TensorTransfer):
    numerically identical P / R = Pᵀ, per-axis dense contractions instead of
    rectangular ELL gathers. masks are Dirichlet masks (True = constrained),
    matching fe_transfer_pair's zero_rows/zero_columns convention."""
    p1ds = [
        jnp.asarray(fe_interpolation_1d(int(n), order).toarray())
        for n in coarse_ncells
    ]
    cshape = tuple(order * int(n) + 1 for n in coarse_ncells)
    fshape = tuple(2 * order * int(n) + 1 for n in coarse_ncells)
    mf = None if mask_f is None else jnp.asarray(
        (~np.asarray(mask_f).reshape(-1)).astype(np.float64)
    )
    mc = None if mask_c is None else jnp.asarray(
        (~np.asarray(mask_c).reshape(-1)).astype(np.float64)
    )
    P = TensorTransfer(
        mats=tuple(p1ds), in_shape=cshape, out_shape=fshape,
        mask_in=mc, mask_out=mf,
    )
    R = TensorTransfer(
        mats=tuple(m.T for m in p1ds), in_shape=fshape, out_shape=cshape,
        mask_in=mf, mask_out=mc,
    )
    return P, R
