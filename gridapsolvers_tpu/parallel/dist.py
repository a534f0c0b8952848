"""Distributed (sharded) operators and problems.

The replacement for the reference's PartitionedArrays layer
(PVector/PSparseMatrix + consistent!/assemble! ghost exchange, SURVEY.md
§2.8-2.9), designed per the scaling-book recipe: pick a mesh, annotate
shardings, let XLA insert collectives.

- Vectors are GRID-shaped arrays sharded over the leading grid axis
  (NamedSharding P('p')) — a row-block partition like the reference's, but
  the "ghost exchange" is implicit: XLA's SPMD partitioner converts the
  stencil matvec's shifted slices and the transfer convs into neighbor
  halo exchanges (ppermute/collective-permute on ICI), overlapped with
  local compute by the scheduler.
- dots/norms on sharded leaves lower to psum — the reference's
  MPI_Allreduce inside PartitionedArrays norms.
- Coarse GMG levels re-shard to replicated below a size cutoff: the
  restriction's output sharding constraint makes XLA insert the gather —
  this is the analog of the reference's RedistributionOperator +
  subcommunicator shrinkage (GridTransferOperators.jl:106-157), except all
  devices stay in the computation (no `with_level` masking needed).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..algebra.stencil import StencilMatrix
from .mesh import replicated


def pad0(n: int, nprocs: int) -> int:
    """Padded size of a sharded grid axis: next multiple of nprocs. Vertex
    grids have 2^k+1 rows — never divisible — so the distributed path pads
    sharded axes with identity rows (decoupled dofs pinned at zero). Static
    padding is the idiomatic answer: aligned equal shards, no
    uneven-sharding bookkeeping."""
    return ((n + nprocs - 1) // nprocs) * nprocs


def _procs_tuple(procs, ndim: int):
    """Normalize a per-axis device-count spec: int means leading axis only
    (the 1-D mesh layout); a tuple gives the count per grid axis (the
    reference's D-dimensional np_per_level, ModelHierarchies.jl:82)."""
    if isinstance(procs, int):
        return (procs,) + (1,) * (ndim - 1)
    procs = tuple(procs)
    assert len(procs) <= ndim
    return procs + (1,) * (ndim - len(procs))


def padded_shape_nd(grid_shape, procs) -> Tuple[int, ...]:
    pr = _procs_tuple(procs, len(grid_shape))
    return tuple(pad0(n, p) for n, p in zip(grid_shape, pr))


def pad_stencil(
    A: StencilMatrix, procs, target_shape=None
) -> StencilMatrix:
    """Pad every sharded grid axis to a multiple of its device count: zero
    bands on pad rows except a unit diagonal (identity rows -> pad dofs
    stay zero). target_shape overrides the default next-multiple padding
    (nested level pads for aligned halo transfers)."""
    shape_p = (
        tuple(target_shape)
        if target_shape is not None
        else padded_shape_nd(A.grid_shape, procs)
    )
    if shape_p == tuple(A.grid_shape):
        return A
    per = A.periodic or tuple(False for _ in A.grid_shape)
    for d, (n, np_) in enumerate(zip(A.grid_shape, shape_p)):
        if np_ > n and per[d]:
            raise ValueError(
                f"periodic axis {d} ({n} dofs) cannot be zero-padded for "
                f"sharding — the wraparound would cross the pad rows; "
                f"choose a grid size divisible by the device count "
                f"(periodic axes have exactly ncells dofs, so powers of "
                f"two work)"
            )
    bands = np.asarray(A.bands)
    pad_widths = [(0, 0)] + [
        (0, np_ - n) for n, np_ in zip(A.grid_shape, shape_p)
    ]
    bands = np.pad(bands, pad_widths)
    center = A.offsets.index(tuple(0 for _ in A.grid_shape))
    # unit diagonal on the whole pad region (any axis in its pad range)
    in_pad = np.zeros(shape_p, dtype=bool)
    for d, (n, np_) in enumerate(zip(A.grid_shape, shape_p)):
        if np_ > n:
            idx = [slice(None)] * len(shape_p)
            idx[d] = slice(n, np_)
            in_pad[tuple(idx)] = True
    bands[center][in_pad] = 1.0
    return StencilMatrix(
        bands, A.offsets, shape_p, A.grid_vectors, A.periodic
    )


def pad_grid_vector(
    x: jnp.ndarray, grid_shape, procs, target_shape=None
) -> jnp.ndarray:
    xg = jnp.asarray(x).reshape(grid_shape)
    shape_p = (
        tuple(target_shape)
        if target_shape is not None
        else padded_shape_nd(grid_shape, procs)
    )
    if shape_p == tuple(grid_shape):
        return xg
    pw = [(0, np_ - n) for n, np_ in zip(grid_shape, shape_p)]
    return jnp.pad(xg, pw)


def unpad_grid_vector(xg: jnp.ndarray, grid_shape) -> jnp.ndarray:
    return xg[tuple(slice(0, n) for n in grid_shape)]


def _axes_tuple(mesh: Mesh, axis) -> Tuple[str, ...]:
    """Normalize the mesh-axis spec: a string names one axis (1-D layout);
    None takes every mesh axis in order (multi-axis domain partition)."""
    if axis is None:
        return tuple(mesh.axis_names)
    if isinstance(axis, str):
        return (axis,)
    return tuple(axis)


def _grid_pspec(mesh: Mesh, ndim: int, axes: Tuple[str, ...]) -> P:
    return P(*axes, *([None] * (ndim - len(axes))))


def shard_stencil(
    A: StencilMatrix, mesh: Mesh, axis="p", pad: bool = True
) -> StencilMatrix:
    """Shard a stencil operator's bands over the leading grid axes (one
    mesh axis per grid axis, in order) and switch it to grid-shaped
    vectors. Pads the sharded axes to the device counts if needed."""
    axes = _axes_tuple(mesh, axis)
    if pad:
        A = pad_stencil(A, tuple(mesh.shape[a] for a in axes))
    ndim = len(A.grid_shape)
    sh = NamedSharding(mesh, P(None, *_grid_pspec(mesh, ndim, axes)))
    bands = jax.device_put(A.bands, sh)
    return StencilMatrix(
        bands, A.offsets, A.grid_shape, grid_vectors=True,
        periodic=A.periodic,
    )


def replicate_stencil(A: StencilMatrix, mesh: Mesh) -> StencilMatrix:
    bands = jax.device_put(A.bands, replicated(mesh))
    return StencilMatrix(
        bands, A.offsets, A.grid_shape, grid_vectors=True,
        periodic=A.periodic,
    )


def shard_grid_vector(
    x: jnp.ndarray,
    mesh: Mesh,
    grid_shape: Tuple[int, ...],
    axis="p",
    pad: bool = True,
    target_shape=None,
) -> jnp.ndarray:
    """target_shape: explicit padded grid shape (pass the operator's
    `.grid_shape` when it was built with nested level pads)."""
    axes = _axes_tuple(mesh, axis)
    xg = jnp.asarray(x).reshape(grid_shape)
    if pad:
        xg = pad_grid_vector(
            xg, grid_shape, tuple(mesh.shape[a] for a in axes),
            target_shape=target_shape,
        )
    sh = NamedSharding(mesh, _grid_pspec(mesh, len(grid_shape), axes))
    return jax.device_put(xg, sh)


def _fit0(y: jnp.ndarray, target) -> jnp.ndarray:
    """Slice or zero-pad every axis to the target shape (int = leading
    axis only, for backward compatibility)."""
    if isinstance(target, int):
        target = (target,) + y.shape[1:]
    if tuple(y.shape) == tuple(target):
        return y
    y = y[tuple(slice(0, min(n, t)) for n, t in zip(y.shape, target))]
    pw = [(0, max(t - n, 0)) for n, t in zip(y.shape, target)]
    return jnp.pad(y, pw)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DistProlongation:
    """Factor-2 Q1 interpolation between PADDED sharded grids: conv over the
    padded coarse grid, then slice/pad the leading axis to the padded fine
    size. Pad rows carry zeros (identity dofs) so the conv's spill into the
    pad region is inert; masks zero any leakage at the real/pad seam."""

    fine_shape: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    coarse_shape: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    mask_fine: Optional[jnp.ndarray] = None
    periodic: Optional[Tuple[bool, ...]] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )

    def matvec(self, xc: jnp.ndarray) -> jnp.ndarray:
        from ..multilevel.transfer import prolong_slices

        y = _fit0(
            prolong_slices(xc, periodic=self.periodic), self.fine_shape
        )
        if self.mask_fine is not None:
            y = y * self.mask_fine
        return y


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DistRestriction:
    """Full-weighting restriction between PADDED sharded grids (transpose of
    DistProlongation on the real region)."""

    fine_shape: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    coarse_shape: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    mask_coarse: Optional[jnp.ndarray] = None
    mask_fine: Optional[jnp.ndarray] = None
    periodic: Optional[Tuple[bool, ...]] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )

    def matvec(self, xf: jnp.ndarray) -> jnp.ndarray:
        from ..multilevel.transfer import restrict_slices

        if self.mask_fine is not None:
            xf = xf * self.mask_fine
        y = _fit0(
            restrict_slices(xf, periodic=self.periodic), self.coarse_shape
        )
        if self.mask_coarse is not None:
            y = y * self.mask_coarse
        return y


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Resharded:
    """Wrap an operator so its output is constrained to a target sharding —
    the grid-transfer redistribution stage (reference
    GridTransferOperators.jl:316-347 appends a redistribute! after the
    transfer; here it is one sharding constraint and XLA emits the moves)."""

    op: object
    out_spec: P = dataclasses.field(metadata=dict(static=True))
    mesh: Mesh = dataclasses.field(metadata=dict(static=True))

    def matvec(self, x):
        y = self.op.matvec(x)
        return jax.lax.with_sharding_constraint(
            y, NamedSharding(self.mesh, self.out_spec)
        )


def grid_spec(ndim: int, shard: bool, axis="p") -> P:
    if not shard:
        return P()
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    return P(*axes, *([None] * (ndim - len(axes))))


def distributed_poisson_gmg(
    hierarchy,
    mesh: Mesh,
    smoother=None,
    min_sharded_rows: Optional[int] = None,
    axis="p",
    dtype=jnp.float64,
    halo_exchange: bool = True,
    ca_smoother: bool = True,
    **kw,
):
    """Distributed GMG for Poisson on a device mesh: fine levels sharded,
    coarse levels replicated once the per-device row count drops below
    `min_sharded_rows` (default: 2 rows of each sharded grid axis per
    device). `axis` may be one mesh-axis name (1-D slab partition), a
    tuple of names, or None = all mesh axes (D-dimensional box partition,
    the reference's np_per_level tuples, ModelHierarchies.jl:82).
    Returns (gmg_solver, A_fine_sharded).

    halo_exchange=True wraps sharded level operators with the explicit
    shard_map halo matvec (parallel/halo.py): ONE neighbor exchange per
    SpMV instead of one collective-permute per band shift — measured
    273 -> ~40 loop-body permutes per GMG-CG iteration at 8 devices —
    with the interior contribution data-independent of the permutes
    (overlappable halo exchange, the BASELINE north star).
    """
    from ..fem.assembly import eliminate_dirichlet, laplacian
    from ..linear.gmg import GMGSolver
    from ..linear.smoothers import ChebyshevSmoother
    from .halo import HaloStencilMatrix

    axes = _axes_tuple(mesh, axis)
    ndim = hierarchy[0].dim
    procs = tuple(mesh.shape[a] for a in axes)
    min_rows = min_sharded_rows if min_sharded_rows is not None else 2

    def is_sharded(mesh_lev) -> bool:
        vs = mesh_lev.vertex_shape
        return all(vs[d] >= min_rows * p for d, p in enumerate(procs))

    sharded_flags = [is_sharded(m) for m in hierarchy.meshes]
    any_periodic0 = any(
        tuple(hierarchy[0].periodic)[: len(axes)]
    ) if any(hierarchy[0].periodic) else False
    # NESTED level pads (slab partition): fine shard = 2 x coarse shard
    # along the sharded axis, so factor-2 transfers between sharded
    # levels are ONE neighbor halo row instead of the misaligned-shard
    # all-gathers the auto-partitioner emits (COMMS_r04: 14 all-gathers
    # / 414 KB per GMG-CG iteration; now 2 small ones at the
    # sharded->replicated seam)
    nested0 = {}
    use_nested = (
        halo_exchange and len(axes) == 1 and not any_periodic0
        and any(sharded_flags) and procs[0] > 1
    )
    if use_nested:
        lc = max(i for i, s in enumerate(sharded_flags) if s)
        assert all(sharded_flags[: lc + 1]), "sharded prefix not contiguous"
        p0 = procs[0]
        m0 = pad0(hierarchy.meshes[lc].vertex_shape[0], p0) // p0
        for l in range(lc + 1):
            nested0[l] = p0 * m0 * (2 ** (lc - l))

    def padded_shape(lev):
        m = hierarchy.meshes[lev]
        base = padded_shape_nd(m.vertex_shape, procs)
        if lev in nested0:
            return (nested0[lev],) + base[1:]
        return base

    def padded_free_mask(lev):
        m = hierarchy.meshes[lev]
        free = (~m.boundary_vertex_mask()).astype(np.dtype(dtype))
        shape_p = padded_shape(lev)
        pw = [(0, np_ - n) for n, np_ in zip(free.shape, shape_p)]
        return jnp.asarray(np.pad(free, pw))

    ops = []
    for lev, m in enumerate(hierarchy.meshes):
        A = eliminate_dirichlet(
            laplacian(m, np.dtype(dtype)), m.boundary_vertex_mask()
        )
        A = pad_stencil(A, procs, target_shape=padded_shape(lev))
        ndim_b = len(A.grid_shape)
        if is_sharded(m):
            sh = NamedSharding(mesh, P(None, *_grid_pspec(mesh, ndim_b, axes)))
        else:
            sh = replicated(mesh)
        bands = jax.device_put(A.bands, sh)
        op = StencilMatrix(
            bands, A.offsets, A.grid_shape, grid_vectors=True,
            periodic=A.periodic,
        )
        if halo_exchange and is_sharded(m) and max(procs) > 1 and not any(
            (A.periodic or ())[: len(axes)]
        ):
            op = HaloStencilMatrix(op, mesh, axes)
        ops.append(op)

    from .halo import (
        HaloChebyshevSmoother,
        HaloProlongation,
        HaloRestriction,
        HaloStencilMatrix,
    )

    # communication-avoiding smoothing (one depth-W exchange per
    # Chebyshev sweep): substitute per level where the operator rides
    # the halo matvec and the local shard height covers the ghost depth
    if (
        ca_smoother
        and isinstance(smoother, ChebyshevSmoother)
        and len(axes) == 1
    ):
        ca = HaloChebyshevSmoother(
            degree=smoother.degree, ratio=smoother.ratio,
            safety=smoother.safety, lanczos_iters=smoother.lanczos_iters,
            eig_method=smoother.eig_method,
        )
        per_level = []
        for op in ops:
            ok = isinstance(op, HaloStencilMatrix)
            if ok:
                reach = max(abs(o[0]) for o in op.offsets)
                m_loc = op.grid_shape[0] // procs[0]
                ok = m_loc >= smoother.degree * reach
            per_level.append(ca if ok else smoother)
        smoother = per_level[:-1] if len(per_level) > 1 else per_level

    prolongs, restricts = [], []
    for l in range(hierarchy.num_levels - 1):
        fine, coarse = hierarchy[l], hierarchy[l + 1]
        per = tuple(fine.periodic) if any(fine.periodic) else None
        mf = padded_free_mask(l)
        mc = padded_free_mask(l + 1)
        if use_nested and l in nested0 and (l + 1) in nested0:
            # both levels sharded + nested: one-halo-row transfers
            prolongs.append(HaloProlongation(
                padded_shape(l), padded_shape(l + 1), mesh, axes, mf, per
            ))
            restricts.append(HaloRestriction(
                padded_shape(l), padded_shape(l + 1), mesh, axes, mc, mf,
                per,
            ))
            continue
        Pop = DistProlongation(
            padded_shape(l), padded_shape(l + 1), mf, per
        )
        Rop = DistRestriction(
            padded_shape(l), padded_shape(l + 1), mc, mf, per
        )
        prolongs.append(
            Resharded(Pop, grid_spec(ndim, is_sharded(fine), axes), mesh)
        )
        restricts.append(
            Resharded(Rop, grid_spec(ndim, is_sharded(coarse), axes), mesh)
        )

    gmg = GMGSolver(
        coarse_ops=tuple(ops[1:]),
        prolongations=tuple(prolongs),
        restrictions=tuple(restricts),
        smoother=smoother or ChebyshevSmoother(degree=3),
        **kw,
    )
    return gmg, ops[0]
