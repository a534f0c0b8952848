"""Box-partitioned general-sparsity operators over MULTI-AXIS device meshes.

Extends `parallel/dist_ell.py` (1-D contiguous-window row sharding) to
D-dimensional box partitions — the reference's per-level processor boxes
(`np_per_level::Vector{NTuple{D}}`, src/MultilevelTools/ModelHierarchies.jl:82,
and the 3,072-core weak-scaling grids of joss_paper/scalability/preparejobs.jl:
80-105). Dofs of a structured grid are assigned to shards by axis-aligned
boxes; ghost values move along a STATIC neighbor-offset graph, one
`lax.ppermute` over the flattened device axes per offset — the sparse
ExchangeGraph of the reference (src/SolverInterfaces/PAExtras.jl:84-97),
never an all-to-all.

Design points:
  * each shard's column space is  [ own box (m_in) | ghost slab per offset ]
    with setup-time int32 gather tables, so SpMV is ppermutes + one fused
    gather-reduce (no dynamic shapes, no per-neighbor control flow);
  * send tables are themselves sharded arrays (`P(axes, None)`) — every
    device runs the same program on its own table, pure SPMD;
  * the adjoint (`matvec_t`) reverses each ppermute and scatter-adds the
    slab contributions back onto the owner: the reference's `assemble!`
    ghost->owner reduction;
  * boundary shards receive zeros from ppermute (XLA's CollectivePermute
    semantics), so no edge-case masking is needed: padding slots point at
    own-window column 0 with value 0.

Rectangular operators (grid transfers) are supported by giving rows and
columns DIFFERENT partitions of the same device grid: direction offsets
then connect row-shard coordinates to column-owner coordinates.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


# ---------------------------------------------------------------------------
# box partitions of structured dof grids
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BoxPartition:
    """Assignment of a structured dof grid's entries to a device grid.

    The first `len(mesh_shape)` grid axes are split into near-equal
    contiguous chunks (np.array_split sizes); trailing axes (e.g. vector
    components) stay whole on every shard. Within a shard, dofs are laid
    out lexicographically in a PADDED local box of shape `box_shape`, so
    every shard has the same static local size `m`.

    owner[i] : flat shard id of global (C-order) dof i
    slot[i]  : position of dof i inside its shard's padded local box
    """

    shape: Tuple[int, ...]
    mesh_shape: Tuple[int, ...]
    box_shape: Tuple[int, ...]
    owner: np.ndarray
    slot: np.ndarray

    @property
    def n(self) -> int:
        return int(np.prod(self.shape))

    @property
    def n_shards(self) -> int:
        return int(np.prod(self.mesh_shape))

    @property
    def m(self) -> int:
        return int(np.prod(self.box_shape))

    @property
    def n_pad(self) -> int:
        return self.n_shards * self.m

    def padded_index(self) -> np.ndarray:
        """Global dof i -> row in the shard-major padded layout."""
        return self.owner.astype(np.int64) * self.m + self.slot


def box_partition(
    shape: Sequence[int], mesh_shape: Sequence[int]
) -> BoxPartition:
    """Partition a dof grid `shape` over a device grid `mesh_shape`.

    len(mesh_shape) <= len(shape); trailing dof axes are unsplit.
    """
    shape = tuple(int(s) for s in shape)
    mesh_shape = tuple(int(p) for p in mesh_shape)
    D, Dm = len(shape), len(mesh_shape)
    assert Dm <= D, (shape, mesh_shape)
    assert all(p >= 1 for p in mesh_shape)
    assert all(shape[d] >= mesh_shape[d] for d in range(Dm)), (
        "fewer grid points than devices along an axis"
    )

    axis_owner, axis_slot, box_dims = [], [], []
    for d in range(Dm):
        sizes = [len(c) for c in np.array_split(np.arange(shape[d]), mesh_shape[d])]
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        own = np.repeat(np.arange(mesh_shape[d]), sizes)
        axis_owner.append(own)
        axis_slot.append(np.arange(shape[d]) - starts[own])
        box_dims.append(max(sizes))
    box_shape = tuple(box_dims) + shape[Dm:]

    coords = np.unravel_index(np.arange(int(np.prod(shape))), shape)
    owner = np.ravel_multi_index(
        tuple(axis_owner[d][coords[d]] for d in range(Dm)), mesh_shape
    )
    slot = np.ravel_multi_index(
        tuple(axis_slot[d][coords[d]] for d in range(Dm))
        + tuple(coords[d] for d in range(Dm, D)),
        box_shape,
    )
    return BoxPartition(
        shape=shape,
        mesh_shape=mesh_shape,
        box_shape=box_shape,
        owner=owner.astype(np.int32),
        slot=slot.astype(np.int32),
    )


# ---------------------------------------------------------------------------
# the operator
# ---------------------------------------------------------------------------


def contiguous_partition(n: int, n_shards: int) -> BoxPartition:
    """Balanced contiguous 1-D partition of n UNSTRUCTURED dofs (sizes
    n/P rounded): the row partition for algebraic (AMG) levels, where no
    dof grid exists. Equal blocks when P | n (padded_index == identity,
    interoperating with `dist_ell.shard_vector` layouts)."""
    owner = np.minimum(np.arange(n) * n_shards // n, n_shards - 1)
    counts = np.bincount(owner, minlength=n_shards)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(n) - starts[owner]
    return BoxPartition(
        shape=(n,),
        mesh_shape=(n_shards,),
        box_shape=(int(counts.max()),),
        owner=owner.astype(np.int32),
        slot=slot.astype(np.int32),
    )


def scipy_in_part_order(S, part_rows=None, part_cols=None):
    """Re-index a scipy matrix into shard-padded partition order on either
    side (rows/cols left in global order where no partition is given) —
    the glue between partition-ordered sharded levels and replicated
    (global-order) tail levels of a solver hierarchy."""
    import scipy.sparse as sp

    C = S.tocoo()
    rows = part_rows.padded_index()[C.row] if part_rows is not None else C.row
    cols = part_cols.padded_index()[C.col] if part_cols is not None else C.col
    shape = (
        part_rows.n_pad if part_rows is not None else S.shape[0],
        part_cols.n_pad if part_cols is not None else S.shape[1],
    )
    return sp.coo_matrix((C.data, (rows, cols)), shape=shape).tocsr()


def _neighbor_perm(
    mesh_shape: Tuple[int, ...], delta: Tuple[int, ...]
) -> Tuple[Tuple[int, int], ...]:
    """ppermute pairs delivering each shard u's buffer to shard u - delta
    (the receiver t = u - delta requested ghosts from its neighbor at
    t + delta). Flat ids are row-major over the mesh axes — matching
    ppermute's flattening of a tuple of axis names."""
    pairs = []
    for u in np.ndindex(*mesh_shape):
        t = tuple(a - b for a, b in zip(u, delta))
        if all(0 <= c < s for c, s in zip(t, mesh_shape)):
            pairs.append(
                (
                    int(np.ravel_multi_index(u, mesh_shape)),
                    int(np.ravel_multi_index(t, mesh_shape)),
                )
            )
    return tuple(pairs)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DistGraphELL:
    """Row-sharded padded-ELL matrix over a multi-axis device mesh with a
    static neighbor-exchange graph.

    values    : (n_shards * m_out, K)  sharded P(axes, None)
    cols_loc  : same shape int32, indices into the extended column window
                [ own (m_in) | ghost slab dirs[0] | ghost slab dirs[1] | … ]
    send_tbls : per direction, (n_shards, W_d) int32 sharded P(axes, None);
                row u = local col indices shard u sends to shard u - dirs[d]
    dirs      : static tuple of mesh-coordinate offsets (receiver -> owner)
    """

    values: jnp.ndarray
    cols_loc: jnp.ndarray
    send_tbls: Tuple[jnp.ndarray, ...]
    n_cols: int = dataclasses.field(metadata=dict(static=True))
    m_in: int = dataclasses.field(metadata=dict(static=True))
    dirs: Tuple[Tuple[int, ...], ...] = dataclasses.field(
        metadata=dict(static=True)
    )
    mesh: Mesh = dataclasses.field(metadata=dict(static=True))
    axes: Tuple[str, ...] = dataclasses.field(metadata=dict(static=True))

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.values.shape[0], self.n_cols)

    @property
    def n_rows(self) -> int:
        return self.values.shape[0]

    @property
    def dtype(self):
        return self.values.dtype

    def _mesh_shape(self) -> Tuple[int, ...]:
        return tuple(self.mesh.shape[a] for a in self.axes)

    def _perms(self):
        ms = self._mesh_shape()
        return [_neighbor_perm(ms, d) for d in self.dirs]

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        axes, perms = self.axes, self._perms()

        def f(vals, cols, xl, *tbls):
            slabs = [xl]
            for tbl, perm in zip(tbls, perms):
                slabs.append(jax.lax.ppermute(xl[tbl[0]], axes, perm))
            xe = jnp.concatenate(slabs) if len(slabs) > 1 else xl
            return jnp.sum(vals * xe[cols], axis=1)

        return jax.shard_map(
            f,
            mesh=self.mesh,
            in_specs=(P(axes, None), P(axes, None), P(axes))
            + tuple(P(axes, None) for _ in self.send_tbls),
            out_specs=P(axes),
        )(self.values, self.cols_loc, x, *self.send_tbls)

    def matvec_t(self, y: jnp.ndarray) -> jnp.ndarray:
        """Adjoint SpMV: scatter-add into the extended window, then fold
        every ghost slab back onto its owner (`assemble!`)."""
        axes, m_in = self.axes, self.m_in
        perms_rev = [
            tuple((dst, src) for src, dst in perm) for perm in self._perms()
        ]
        widths = [int(t.shape[1]) for t in self.send_tbls]

        def f(vals, cols, yl, *tbls):
            L = m_in + sum(widths)
            ze = jnp.zeros((L,), vals.dtype).at[cols.reshape(-1)].add(
                (vals * yl[:, None]).reshape(-1)
            )
            own = ze[:m_in]
            off = m_in
            for tbl, w, perm in zip(tbls, widths, perms_rev):
                back = jax.lax.ppermute(ze[off : off + w], axes, perm)
                own = own.at[tbl[0]].add(back)
                off += w
            return own

        return jax.shard_map(
            f,
            mesh=self.mesh,
            in_specs=(P(axes, None), P(axes, None), P(axes))
            + tuple(P(axes, None) for _ in self.send_tbls),
            out_specs=P(axes),
        )(self.values, self.cols_loc, y, *self.send_tbls)

    def diag(self) -> jnp.ndarray:
        """Diagonal — requires identical row/column partitions (own window
        leads the extended window, so diagonal entries have col == row
        local index)."""
        assert self.n_rows == self.n_cols, "diag needs a square partition"
        axes = self.axes

        def f(vals, cols):
            m = vals.shape[0]
            rows = jax.lax.broadcasted_iota(jnp.int32, (m, 1), 0)
            return jnp.sum(jnp.where(cols == rows, vals, 0.0), axis=1)

        return jax.shard_map(
            f,
            mesh=self.mesh,
            in_specs=(P(axes, None), P(axes, None)),
            out_specs=P(axes),
        )(self.values, self.cols_loc)

    def abs_row_sum(self) -> jnp.ndarray:
        axes = self.axes
        return jax.shard_map(
            lambda v: jnp.sum(jnp.abs(v), axis=1),
            mesh=self.mesh,
            in_specs=(P(axes, None),),
            out_specs=P(axes),
        )(self.values)

    def astype(self, dtype) -> "DistGraphELL":
        return dataclasses.replace(self, values=self.values.astype(dtype))


# ---------------------------------------------------------------------------
# host-side constructors
# ---------------------------------------------------------------------------


def shard_csr_nd(
    S,
    part_rows: BoxPartition,
    mesh: Mesh,
    part_cols: Optional[BoxPartition] = None,
    axes: Optional[Sequence[str]] = None,
    identity_pad: bool = False,
    row_width: Optional[int] = None,
    dtype=None,
) -> DistGraphELL:
    """scipy CSR + box partition(s) -> DistGraphELL.

    part_cols defaults to part_rows (square operators). identity_pad gives
    padding rows/slots a unit diagonal (square partitions only) so padded
    systems stay SPD-compatible and pad dofs decouple at zero.
    """
    import scipy.sparse  # noqa: F401  (documents the expected input)

    S = S.tocsr().copy()
    S.sum_duplicates()
    S.sort_indices()
    part_cols = part_cols or part_rows
    n_r, n_c = S.shape
    assert n_r <= part_rows.n and n_c <= part_cols.n, (
        (n_r, n_c),
        (part_rows.n, part_cols.n),
    )
    if axes is None:
        axes = tuple(mesh.axis_names)
    axes = tuple(axes)
    mesh_shape = tuple(mesh.shape[a] for a in axes)
    assert mesh_shape == part_rows.mesh_shape == part_cols.mesh_shape, (
        mesh_shape,
        part_rows.mesh_shape,
        part_cols.mesh_shape,
    )
    n_shards = part_rows.n_shards
    m_out, m_in = part_rows.m, part_cols.m

    counts = np.diff(S.indptr)
    K = max(int(counts.max()) if counts.size else 1, 1)
    if row_width is not None:
        assert row_width >= K
        K = row_width

    vals = np.zeros((n_shards * m_out, K), dtype=dtype or S.dtype)
    cols_loc = np.zeros((n_shards * m_out, K), dtype=np.int32)

    r_glob = np.repeat(np.arange(n_r), counts)
    c_glob = S.indices.astype(np.int64)
    pr = part_rows.padded_index()[:n_r][r_glob]
    slot_in_row = np.arange(S.nnz) - np.repeat(S.indptr[:-1], counts)
    vals[pr, slot_in_row] = S.data

    row_shard = part_rows.owner[r_glob].astype(np.int64)
    col_shard = part_cols.owner[c_glob].astype(np.int64)
    col_slot = part_cols.slot[c_glob].astype(np.int64)
    own = col_shard == row_shard
    cols_loc[pr[own], slot_in_row[own]] = col_slot[own]

    # ghost entries: group by mesh-coordinate offset (owner - receiver)
    send_tbls = []
    dirs = []
    g = ~own
    if g.any():
        rc = np.array(np.unravel_index(row_shard[g], mesh_shape)).T
        cc = np.array(np.unravel_index(col_shard[g], mesh_shape)).T
        delta = cc - rc
        dkey, dinv = np.unique(delta, axis=0, return_inverse=True)
        gpr, gslot = pr[g], slot_in_row[g]
        gt, gc = row_shard[g], c_glob[g]
        off = m_in
        for di in range(len(dkey)):
            d = tuple(int(x) for x in dkey[di])
            sel = dinv == di
            t, c = gt[sel], gc[sel]
            # unique requested (receiver, col) pairs; np.unique sorts, so
            # slab positions group by receiver and order by global col
            key = t * part_cols.n + c
            uk, inv = np.unique(key, return_inverse=True)
            ut = (uk // part_cols.n).astype(np.int64)
            uc = uk % part_cols.n
            grp_start = np.searchsorted(ut, np.arange(n_shards), side="left")
            pos = np.arange(len(uk)) - grp_start[ut]
            W = int(np.bincount(ut, minlength=n_shards).max())
            tbl = np.zeros((n_shards, W), dtype=np.int32)
            u_send = np.ravel_multi_index(
                tuple(
                    np.unravel_index(ut, mesh_shape)[a] + d[a]
                    for a in range(len(mesh_shape))
                ),
                mesh_shape,
            )
            tbl[u_send, pos] = part_cols.slot[uc]
            cols_loc[gpr[sel], gslot[sel]] = off + pos[inv]
            dirs.append(d)
            send_tbls.append(tbl)
            off += W

    if identity_pad:
        assert part_rows.m == part_cols.m and part_rows.n_pad == part_cols.n_pad
        used = np.zeros(n_shards * m_out, dtype=bool)
        used[part_rows.padded_index()[:n_r]] = True
        pad_rows = np.nonzero(~used)[0]
        vals[pad_rows, 0] = 1.0
        cols_loc[pad_rows, 0] = pad_rows % m_out

    sh2 = NamedSharding(mesh, P(axes, None))
    return DistGraphELL(
        values=jax.device_put(jnp.asarray(vals), sh2),
        cols_loc=jax.device_put(jnp.asarray(cols_loc), sh2),
        send_tbls=tuple(
            jax.device_put(jnp.asarray(t), sh2) for t in send_tbls
        ),
        n_cols=part_cols.n_pad,
        m_in=m_in,
        dirs=tuple(dirs),
        mesh=mesh,
        axes=axes,
    )


def dense_padded_nd(S, part: BoxPartition, identity_pad: bool = True):
    """scipy matrix -> dense array in the shard-padded box ordering.

    The replicated coarsest-level operator of a box-sharded GMG hierarchy
    (the reference re-shards coarse levels onto subcommunicators,
    ModelHierarchies.jl; here the coarse system is replicated and solved
    with one dense product — see linear/direct.DenseInverseSolver). Padding
    slots get a unit diagonal so the padded system stays invertible."""
    n = S.shape[0]
    assert S.shape[1] == n, "dense coarse embedding needs a square operator"
    D = np.zeros((part.n_pad, part.n_pad), dtype=S.dtype)
    pidx = part.padded_index()[:n]
    D[np.ix_(pidx, pidx)] = np.asarray(S.todense())
    if identity_pad:
        used = np.zeros(part.n_pad, dtype=bool)
        used[pidx] = True
        pad = np.nonzero(~used)[0]
        D[pad, pad] = 1.0
    return D


def shard_vector_nd(
    x, part: BoxPartition, mesh: Mesh, axes: Optional[Sequence[str]] = None
) -> jnp.ndarray:
    """Host vector (length <= part.n) -> padded box-ordered device vector."""
    x = np.asarray(x)
    axes = tuple(axes) if axes is not None else tuple(mesh.axis_names)
    xp = np.zeros(part.n_pad, dtype=x.dtype)
    xp[part.padded_index()[: x.shape[0]]] = x
    return jax.device_put(jnp.asarray(xp), NamedSharding(mesh, P(axes)))


def unshard_vector_nd(xd, part: BoxPartition, n: Optional[int] = None):
    """Padded box-ordered device vector -> host vector in global order."""
    xp = np.asarray(jax.device_get(xd))
    n = part.n if n is None else n
    return xp[part.padded_index()[:n]]


def _host_fetch(a) -> np.ndarray:
    """Device array -> host numpy, multi-process-safe: a global array
    whose shards live in other OS processes cannot be np.asarray'd
    directly; gather the sharded axis across processes instead. Host
    consumers of DistGraphELL metadata (window/global-cols tables, patch
    extraction) go through this."""
    try:
        return np.asarray(a)
    except RuntimeError:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(a, tiled=True))


def window_to_global_nd(A: DistGraphELL) -> np.ndarray:
    """(n_shards, window) host table: extended-window position -> global
    padded column id, per shard. Positions a boundary shard never receives
    map to that shard's own column 0 (their slab is zero-fill)."""
    mesh_shape = tuple(A.mesh.shape[a] for a in A.axes)
    n_shards = int(np.prod(mesh_shape))
    m_in = A.m_in
    glob = np.zeros(
        (n_shards, m_in + sum(int(t.shape[1]) for t in A.send_tbls)),
        dtype=np.int64,
    )
    for s in range(n_shards):
        glob[s, :m_in] = s * m_in + np.arange(m_in)
    off = m_in
    for d, tbl in zip(A.dirs, A.send_tbls):
        tbl = _host_fetch(tbl)
        W = tbl.shape[1]
        for t in range(n_shards):
            tc = np.array(np.unravel_index(t, mesh_shape)) + np.array(d)
            if not all(0 <= c < s for c, s in zip(tc, mesh_shape)):
                continue  # boundary shard: slab is zero-fill, never used
            u = int(np.ravel_multi_index(tuple(tc), mesh_shape))
            glob[t, off : off + W] = u * m_in + tbl[u]
        off += W
    return glob


def global_cols_nd(A: DistGraphELL) -> np.ndarray:
    """(n_rows, K) host table of GLOBAL padded column ids matching the
    value-array slot layout (the coordinate system patch extractors and
    validation views share)."""
    mesh_shape = tuple(A.mesh.shape[a] for a in A.axes)
    n_shards = int(np.prod(mesh_shape))
    n_rows = A.values.shape[0]
    m_out = n_rows // n_shards
    glob = window_to_global_nd(A)
    shard = np.repeat(np.arange(n_shards), m_out)
    return glob[shard[:, None], _host_fetch(A.cols_loc)]


def dist_to_scipy_nd(A: DistGraphELL):
    """Host-side validation view (padded sizes, shard-major box order)."""
    import scipy.sparse as sp

    vals = _host_fetch(A.values)
    n_rows, K = vals.shape
    cols = global_cols_nd(A)
    rows = np.repeat(np.arange(n_rows), K)
    keep = vals.reshape(-1) != 0
    M = sp.coo_matrix(
        (vals.reshape(-1)[keep], (rows[keep], cols.reshape(-1)[keep])),
        shape=(n_rows, A.n_cols),
    )
    return M.tocsr()


def redistribute_vector_nd(
    xd,
    part_from: BoxPartition,
    part_to: BoxPartition,
    mesh_to: Mesh,
    axes: Optional[Sequence[str]] = None,
) -> jnp.ndarray:
    """Move a box-ordered sharded vector onto a DIFFERENT box partition —
    possibly over another device mesh with another device count (the
    reference's RedistributionOperator / redistribute!,
    src/MultilevelTools/DistributedGridTransferOperators.jl redist stage
    and GridapP4est redistribution). Lowering: one static
    permutation gather under the target sharding; XLA emits the
    collectives (device_put moves data device-to-device, no host trip).

    Pad slots of the target partition are zero-filled.
    """
    assert part_from.shape == part_to.shape, (
        part_from.shape,
        part_to.shape,
    )
    axes = tuple(axes) if axes is not None else tuple(mesh_to.axis_names)
    # perm[j] = from-position of the global dof living at to-position j
    perm = np.zeros(part_to.n_pad, dtype=np.int64)
    valid = np.zeros(part_to.n_pad, dtype=bool)
    perm[part_to.padded_index()] = part_from.padded_index()
    valid[part_to.padded_index()] = True
    # land the source on the target mesh first (different meshes cannot
    # mix inside one computation), then permute under the out-sharding
    x_rep = jax.device_put(xd, NamedSharding(mesh_to, P()))
    out_sh = NamedSharding(mesh_to, P(axes))

    @jax.jit
    def _permute(x):
        y = jnp.where(jnp.asarray(valid), x[jnp.asarray(perm)], 0.0)
        return jax.lax.with_sharding_constraint(y, out_sh)

    return _permute(x_rep)
