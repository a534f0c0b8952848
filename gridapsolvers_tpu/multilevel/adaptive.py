"""Adaptive (locally refined) hierarchies + composite-grid solves.

Analog of the reference's octree AMR extension
(ext/GridapP4estExt/GridapP4estExt.jl:25-39 P4estCartesianModelHierarchy,
backed by p4est's adaptive octrees with hanging-node constraints resolved
by Gridap's FESpace machinery). p4est's pointer-chased octree leaves and
per-node constraint tables are the opposite of what XLA wants, so the
design here is BLOCK-STRUCTURED AMR (Berger-Colella style): each level
refines ONE nested cell-aligned BOX of its parent by factor 2. Every
level is a dense uniform Cartesian grid with static shapes — refinement
changes only box bounds (slice offsets), never array structure.

The composite FE space is the standard hanging-node-constrained one:
coarse Q1 elements outside each box, fine Q1 elements inside, fine
interface dofs slaved to Q1 interpolation of the parent. Its Galerkin
operator is assembled EXACTLY, as a sum of per-level uniform stencils:

    A_comp = sum_l  E_l^T A_l E_l

where A_l is the level-l stencil assembled only over level-l cells NOT
covered by the child box (a per-cell indicator coefficient — one
`assemble_q1_stencil_var` call), and E_l extends a composite vector to
the level-l grid by filling the interface ring from the parent via Q1
interpolation (`prolong_slices` on the box slice; its exact transpose is
`restrict_slices`). The result is symmetric positive definite, so the
composite problem is solved by ordinary CG on pytree block vectors —
no defect-correction iteration, no constraint tables, no gathers.

Refinement is driven by a second-difference smoothness estimator and a
bounding-box marker, closing the estimate -> mark -> adapt loop the
reference delegates to p4est.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.assembly import q1_element_matrices, assemble_q1_stencil_var
from ..fem.mesh import CartesianMesh
from .transfer import prolong_slices, restrict_slices


@dataclasses.dataclass(frozen=True)
class AdaptiveLevel:
    """One level of a box hierarchy. `lo`/`hi` are the refined box in the
    PARENT level's cell indices ([lo, hi) per axis); None for the base."""

    mesh: CartesianMesh
    lo: Optional[Tuple[int, ...]] = None
    hi: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass
class AdaptiveHierarchy:
    """Levels coarsest-first: levels[0] is the full-domain base mesh."""

    levels: List[AdaptiveLevel]

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def __getitem__(self, l: int) -> AdaptiveLevel:
        return self.levels[l]

    def refine_box(
        self, lo: Sequence[int], hi: Sequence[int]
    ) -> "AdaptiveHierarchy":
        """Append a level refining cells [lo, hi) of the current finest
        level by 2 (the p4est `refine!` analog, box-granular)."""
        parent = self.levels[-1].mesh
        lo, hi = tuple(int(x) for x in lo), tuple(int(x) for x in hi)
        assert all(
            0 <= a < b <= n for a, b, n in zip(lo, hi, parent.ncells)
        ), (lo, hi, parent.ncells)
        h = parent.h
        dom = tuple(
            x
            for d in range(parent.dim)
            for x in (
                parent.domain[2 * d] + lo[d] * h[d],
                parent.domain[2 * d] + hi[d] * h[d],
            )
        )
        mesh = CartesianMesh(tuple(2 * (b - a) for a, b in zip(lo, hi)), dom)
        return AdaptiveHierarchy(self.levels + [AdaptiveLevel(mesh, lo, hi)])


def adaptive_hierarchy(base_mesh: CartesianMesh) -> AdaptiveHierarchy:
    return AdaptiveHierarchy([AdaptiveLevel(base_mesh)])


# ---------------------------------------------------------------- estimator


def estimate_cells(u: jnp.ndarray, mesh: CartesianMesh) -> jnp.ndarray:
    """Per-cell smoothness indicator: magnitude of the undivided second
    difference of u (≈ h² |∂²u|, the leading Q1 interpolation-error term),
    averaged onto cells. Cheap, jittable, and the standard driver for
    gradient-type AMR marking."""
    ug = u.reshape(mesh.vertex_shape)
    est = jnp.zeros_like(ug)
    for d in range(mesh.dim):
        dd = jnp.abs(jnp.diff(ug, n=2, axis=d))
        pad = [(0, 0)] * mesh.dim
        pad[d] = (1, 1)
        est = est + jnp.pad(dd, pad)
    # vertex -> cell: average the 2^d corners
    for d in range(mesh.dim):
        lo = [slice(None)] * mesh.dim
        hi = [slice(None)] * mesh.dim
        lo[d], hi[d] = slice(0, -1), slice(1, None)
        est = 0.5 * (est[tuple(lo)] + est[tuple(hi)])
    return est


def mark_box(
    est: np.ndarray, theta: float = 0.5, pad: int = 1, align: int = 2
):
    """Bounding box (in cell indices) of cells with est > theta * max(est),
    padded by `pad` cells and aligned to `align`."""
    est = np.asarray(est)
    marked = est > theta * est.max()
    lo, hi = [], []
    for d in range(est.ndim):
        axes = tuple(k for k in range(est.ndim) if k != d)
        line = marked.any(axis=axes)
        idx = np.nonzero(line)[0]
        a = max(int(idx[0]) - pad, 0)
        b = min(int(idx[-1]) + 1 + pad, est.shape[d])
        a = (a // align) * align
        b = min(-(-b // align) * align, est.shape[d])
        lo.append(a)
        hi.append(b)
    return tuple(lo), tuple(hi)


# ------------------------------------------------- composite Galerkin system


def _box_vertex_slice(lev: AdaptiveLevel):
    return tuple(slice(a, b + 1) for a, b in zip(lev.lo, lev.hi))


def _ring_mask(shape) -> np.ndarray:
    m = np.zeros(shape, dtype=bool)
    for d in range(len(shape)):
        idx = [slice(None)] * len(shape)
        idx[d] = 0
        m[tuple(idx)] = True
        idx[d] = shape[d] - 1
        m[tuple(idx)] = True
    return m


def _covered_interior_mask(shape, lev: AdaptiveLevel) -> np.ndarray:
    """Vertices of the PARENT grid strictly inside the child box (their
    composite values live on the child level; pinned to 0 here)."""
    m = np.zeros(shape, dtype=bool)
    m[tuple(slice(a + 1, b) for a, b in zip(lev.lo, lev.hi))] = True
    return m


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class CompositeOperator:
    """Exact composite-grid (hanging-node constrained) Galerkin operator
    on a box hierarchy; acts on tuples of per-level grid vectors.

    ops[l]   : level-l stencil assembled over UNCOVERED level-l cells only
               (child-box cells excluded via the indicator coefficient)
    active[l]: 1.0 on composite dofs of level l, 0.0 on pinned dofs
               (interface-ring slaves, covered interiors, Dirichlet)
    boxes    : static (lo, hi) per level > 0

    matvec = sum_l E_l^T A_l E_l + identity on pinned dofs: E_l fills the
    level-l interface ring from the parent by Q1 interpolation
    (`prolong_slices` of the parent's box slice); its transpose scatters
    ring residuals back with `restrict_slices`. SPD by construction.
    """

    ops: Tuple
    active: Tuple
    boxes: Tuple = dataclasses.field(metadata=dict(static=True))
    shapes: Tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def grid_shape(self):  # leading-level shape (solver introspection)
        return self.shapes[0]

    def _extend(self, u):
        """Per-level full grids: ring rows replaced by parent interp."""
        L = len(self.ops)
        full = [u[0].reshape(self.shapes[0])]
        for l in range(1, L):
            lo, hi = self.boxes[l]
            sl = tuple(slice(a, b + 1) for a, b in zip(lo, hi))
            g = prolong_slices(full[l - 1][sl])
            ug = u[l].reshape(self.shapes[l])
            ring = jnp.asarray(_ring_mask(self.shapes[l]))
            full.append(jnp.where(ring, g, ug))
        return full

    def matvec(self, u):
        L = len(self.ops)
        full = self._extend(u)
        ys = [self.ops[l].matvec(full[l].reshape(-1)) for l in range(L)]
        out = [None] * L
        for l in range(L - 1, -1, -1):
            yg = ys[l].reshape(self.shapes[l])
            if l + 1 < L:
                # transpose coupling: child ring residual -> parent
                ring_c = jnp.asarray(_ring_mask(self.shapes[l + 1]))
                rc = jnp.where(ring_c, ys[l + 1].reshape(self.shapes[l + 1]), 0.0)
                back = restrict_slices(rc)
                lo, hi = self.boxes[l + 1]
                sl = tuple(slice(a, b + 1) for a, b in zip(lo, hi))
                yg = yg.at[sl].add(back)
            a = self.active[l].reshape(self.shapes[l])
            ug = u[l].reshape(self.shapes[l])
            out[l] = (a * yg + (1.0 - a) * ug).reshape(-1)
        return tuple(out)

    def diag(self):
        """Jacobi-grade composite diagonal (exact on non-interface dofs;
        the parent-interface coupling term uses the injected child
        diagonal, a benign approximation for preconditioning)."""
        L = len(self.ops)
        ds = [
            jnp.asarray(self.ops[l].diag()).reshape(self.shapes[l])
            for l in range(L)
        ]
        out = []
        for l in range(L):
            d = ds[l]
            if l + 1 < L:
                ring_c = jnp.asarray(_ring_mask(self.shapes[l + 1]))
                rc = jnp.where(ring_c, ds[l + 1], 0.0)
                # coincident (even-index) child ring nodes inject onto
                # parent box-face nodes with unit interpolation weight
                inj = rc[
                    tuple(slice(None, None, 2) for _ in self.shapes[l + 1])
                ]
                lo, hi = self.boxes[l + 1]
                sl = tuple(slice(a, b + 1) for a, b in zip(lo, hi))
                d = d.at[sl].add(inj)
            a = self.active[l].reshape(self.shapes[l])
            out.append((a * d + (1.0 - a)).reshape(-1))
        return tuple(out)

    @property
    def n(self):
        return sum(int(np.prod(s)) for s in self.shapes)


def composite_system(
    hier: AdaptiveHierarchy,
    f: Callable[[np.ndarray], np.ndarray],
    kappa: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    dtype=np.float64,
):
    """Assemble the composite Poisson system -div(kappa grad u) = f with
    homogeneous Dirichlet on the true domain boundary.

    Returns (CompositeOperator, rhs tuple). Each level contributes its
    UNCOVERED cells to both stiffness and mass (indicator-weighted
    `assemble_q1_stencil_var`); child interface-ring loads transfer to the
    parent through the same transpose interpolation as the operator."""
    L = hier.num_levels
    ops, actives, rhs_own, boxes, shapes = [], [], [], [(None, None)], []
    for l, lev in enumerate(hier.levels):
        mesh = lev.mesh
        Ke, Me = q1_element_matrices(mesh.h)
        ind = np.ones(mesh.ncells, dtype=dtype)
        if l + 1 < L:
            nxt = hier[l + 1]
            ind[tuple(slice(a, b) for a, b in zip(nxt.lo, nxt.hi))] = 0.0
            boxes.append((nxt.lo, nxt.hi))
        kap = (
            ind
            if kappa is None
            else ind * kappa(_cell_centers(mesh)).reshape(mesh.ncells)
        )
        A = assemble_q1_stencil_var(mesh, Ke, kap, dtype)
        M = assemble_q1_stencil_var(mesh, Me, ind, dtype)
        shape = mesh.vertex_shape
        pin = np.zeros(shape, dtype=bool)
        if l == 0:
            pin |= mesh.boundary_vertex_mask()
        else:
            pin |= _ring_mask(shape)
        if l + 1 < L:
            pin |= _covered_interior_mask(shape, hier[l + 1])
        active = (~pin).astype(dtype)
        # NO row/column elimination: ring COLUMNS must stay intact — the
        # interpolated parent data flows through them into active rows
        # (matvec masks pinned ROWS out and pins their values by identity;
        # covered-interior rows/cols are already zero via the indicator,
        # and pinned VALUES stay 0 because rhs is masked and CG preserves
        # the invariant). Level-0 Dirichlet columns read 0-valued dofs, so
        # homogeneous BCs are exact.
        ops.append(A)
        actives.append(jnp.asarray(active))
        b = M.matvec(jnp.asarray(f(mesh.vertex_coords()).reshape(-1)))
        rhs_own.append(b.reshape(shape))
        shapes.append(shape)

    # ring loads cascade to parents (finest first)
    rhs = [np.array(np.asarray(r)) for r in rhs_own]
    for l in range(L - 1, 0, -1):
        ring = _ring_mask(shapes[l])
        rc = np.where(ring, rhs[l], 0.0)
        back = np.asarray(restrict_slices(jnp.asarray(rc)))
        lev = hier[l]
        sl = _box_vertex_slice(lev)
        rhs[l - 1][sl] += back
    out_rhs = tuple(
        (jnp.asarray(rhs[l]) * actives[l]).reshape(-1) for l in range(L)
    )
    op = CompositeOperator(
        ops=tuple(ops),
        active=tuple(actives),
        boxes=tuple(boxes),
        shapes=tuple(shapes),
    )
    return op, out_rhs


def _cell_centers(mesh: CartesianMesh) -> np.ndarray:
    axes = [
        mesh.domain[2 * d] + (np.arange(n) + 0.5) * mesh.h[d]
        for d, n in enumerate(mesh.ncells)
    ]
    grids = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.reshape(-1) for g in grids], axis=1)


def composite_solve(
    hier: AdaptiveHierarchy,
    f,
    kappa=None,
    rtol: float = 1e-10,
    maxiter: int = 2000,
):
    """CG on the composite SPD system; returns per-level grids with slave
    ring values reconstructed (interpolated from the parent)."""
    from ..linear import CGSolver, JacobiSolver

    op, b = composite_system(hier, f, kappa)
    solver = CGSolver(Pl=JacobiSolver(), rtol=rtol, maxiter=maxiter)
    st = solver.setup(op)
    x, stats = solver.solve(st, b)
    full = op._extend(x)
    return [u for u in full], stats


def composite_on_finest(hier: AdaptiveHierarchy, us):
    """The composite FE function sampled on the UNIFORMLY refined base
    grid (base refined 2^(L-1)): Q1-prolong the running field level by
    level and overlay each box's own field at its global position. On
    uncovered coarse cells Q1 prolongation is exact, so this IS the
    composite function's fine-grid interpolant."""
    L = hier.num_levels
    u = us[0].reshape(hier[0].mesh.vertex_shape)
    mesh = hier[0].mesh
    offset = tuple(0 for _ in range(mesh.dim))
    for l in range(1, L):
        lev = hier[l]
        u = prolong_slices(u)
        mesh = mesh.refine(2)
        offset = tuple(2 * (o + a) for o, a in zip(offset, lev.lo))
        sl = tuple(
            slice(o, o + n) for o, n in zip(offset, lev.mesh.vertex_shape)
        )
        u = u.at[sl].set(us[l].reshape(lev.mesh.vertex_shape))
    return u, mesh


def adaptive_solve(
    base_mesh: CartesianMesh,
    f,
    kappa=None,
    num_levels: int = 2,
    theta: float = 0.25,
    rtol: float = 1e-10,
):
    """Full AMR driver: solve -> estimate -> mark -> refine-box -> re-solve,
    adding one nested level per round (the estimate/mark/adapt loop the
    reference runs through p4est's `adapt!`)."""
    hier = adaptive_hierarchy(base_mesh)
    us, _ = composite_solve(hier, f, kappa, rtol=rtol)
    for _ in range(num_levels - 1):
        est = estimate_cells(us[-1].reshape(-1), hier.levels[-1].mesh)
        lo, hi = mark_box(np.asarray(est), theta=theta)
        hier = hier.refine_box(lo, hi)
        us, _ = composite_solve(hier, f, kappa, rtol=rtol)
    return hier, us
