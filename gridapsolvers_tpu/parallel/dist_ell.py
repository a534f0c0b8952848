"""Row-sharded general-sparsity operators (distributed ELL) + halo exchange.

The analog of the reference's PSparseMatrix/PVector layer for
UNSTRUCTURED sparsity (SURVEY.md §2.8-2.9; reference PAExtras.jl ghost
machinery): rows are partitioned in equal contiguous blocks over a 1-D
device axis, and each shard's column indices are pre-localized into an
extended window

    [ left halo (hl) | own rows (m) | right halo (hr) ]

so SpMV is two `lax.ppermute` halo pushes + a purely local gather-reduce
(the reference's `consistent!` then local mul). The adjoint path
(`matvec_t`) scatter-adds into the extended window and pushes the halo
contributions back (`assemble!`). Bounded halo width is guaranteed for
FEM matrices in lexicographic (or RCM) dof order; `shard_csr` asserts it
at setup.

Everything here composes under jit: shard_map programs with static halo
widths, operators as pytrees (values/cols sharded leaves, sizes static).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def pad_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


# ---------------------------------------------------------------------------
# halo exchange primitives (inside shard_map)
# ---------------------------------------------------------------------------


def _fwd(n):
    return [(i, i + 1) for i in range(n - 1)]


def _bwd(n):
    return [(i, i - 1) for i in range(1, n)]


def halo_extend(x_loc, hl: int, hr: int, axis: str):
    """[prev shard's tail | own | next shard's head] along axis 0.
    Boundary shards receive zeros (their halo is pure padding).
    The reference's `consistent!` owner->ghost broadcast."""
    n = jax.lax.axis_size(axis)
    parts = []
    if hl:
        parts.append(jax.lax.ppermute(x_loc[-hl:], axis, _fwd(n)))
    parts.append(x_loc)
    if hr:
        parts.append(jax.lax.ppermute(x_loc[:hr], axis, _bwd(n)))
    return jnp.concatenate(parts, axis=0) if len(parts) > 1 else x_loc


def halo_reduce(y_ext, hl: int, hr: int, axis: str):
    """Adjoint of halo_extend: fold each shard's halo contributions back
    onto the owning neighbor and add. The reference's `assemble!`
    ghost->owner reduction."""
    n = jax.lax.axis_size(axis)
    m = y_ext.shape[0] - hl - hr
    y = y_ext[hl:hl + m]
    if hl:
        c = jax.lax.ppermute(y_ext[:hl], axis, _bwd(n))
        y = y.at[m - hl:].add(c)
    if hr:
        c = jax.lax.ppermute(y_ext[hl + m:], axis, _fwd(n))
        y = y.at[:hr].add(c)
    return y


# ---------------------------------------------------------------------------
# the operator
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DistELLMatrix:
    """Row-sharded padded-ELL matrix over a 1-D device axis.

    values   : (n_rows, K) sharded P(axis, None)
    cols_loc : (n_rows, K) int32, extended-window coordinates, sharded
    n_rows/n_cols are PADDED global sizes (divisible by the axis size).
    """

    values: jnp.ndarray
    cols_loc: jnp.ndarray
    n_cols: int = dataclasses.field(metadata=dict(static=True))
    m_in: int = dataclasses.field(metadata=dict(static=True))
    hl: int = dataclasses.field(metadata=dict(static=True))
    hr: int = dataclasses.field(metadata=dict(static=True))
    mesh: Mesh = dataclasses.field(metadata=dict(static=True))
    axis: str = dataclasses.field(metadata=dict(static=True))

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.values.shape[0], self.n_cols)

    @property
    def n_rows(self) -> int:
        return self.values.shape[0]

    @property
    def dtype(self):
        return self.values.dtype

    def _vec_spec(self):
        return P(self.axis)

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        hl, hr, axis = self.hl, self.hr, self.axis

        def f(vals, cols, xl):
            xe = halo_extend(xl, hl, hr, axis)
            return jnp.sum(vals * xe[cols], axis=1)

        return jax.shard_map(
            f,
            mesh=self.mesh,
            in_specs=(P(axis, None), P(axis, None), P(axis)),
            out_specs=P(axis),
        )(self.values, self.cols_loc, x)

    def matvec_t(self, y: jnp.ndarray) -> jnp.ndarray:
        hl, hr, axis, m_in = self.hl, self.hr, self.axis, self.m_in

        def f(vals, cols, yl):
            contrib = vals * yl[:, None]
            L = hl + m_in + hr
            ze = jnp.zeros((L,), vals.dtype).at[cols.reshape(-1)].add(
                contrib.reshape(-1)
            )
            return halo_reduce(ze, hl, hr, axis)

        return jax.shard_map(
            f,
            mesh=self.mesh,
            in_specs=(P(axis, None), P(axis, None), P(axis)),
            out_specs=P(axis),
        )(self.values, self.cols_loc, y)

    def diag(self) -> jnp.ndarray:
        """Diagonal (requires square partition: m_out == m_in)."""
        hl, axis = self.hl, self.axis

        def f(vals, cols):
            m = vals.shape[0]
            rows = hl + jax.lax.broadcasted_iota(jnp.int32, (m, 1), 0)
            return jnp.sum(jnp.where(cols == rows, vals, 0.0), axis=1)

        return jax.shard_map(
            f,
            mesh=self.mesh,
            in_specs=(P(axis, None), P(axis, None)),
            out_specs=P(axis),
        )(self.values, self.cols_loc)

    def abs_row_sum(self) -> jnp.ndarray:
        return jax.shard_map(
            lambda v: jnp.sum(jnp.abs(v), axis=1),
            mesh=self.mesh,
            in_specs=(P(self.axis, None),),
            out_specs=P(self.axis),
        )(self.values)

    def astype(self, dtype) -> "DistELLMatrix":
        return dataclasses.replace(self, values=self.values.astype(dtype))


# ---------------------------------------------------------------------------
# host-side constructors
# ---------------------------------------------------------------------------


def localize_cols(
    cols: np.ndarray,
    m_out: int,
    m_in: int,
    pad_value: str = "window0",
) -> Tuple[np.ndarray, int, int]:
    """Global column table -> extended-window coordinates + halo widths.

    cols: (n_rows_pad, K) int64 GLOBAL (padded) column indices, where
    negative entries mark padding slots (replaced by an in-window col).
    Returns (cols_loc, hl, hr)."""
    n_rows = cols.shape[0]
    shard = (np.arange(n_rows) // m_out)[:, None]
    rel = cols - shard * m_in
    real = cols >= 0
    if real.any():
        hl = max(0, int(-(rel[real]).min()))
        hr = max(0, int(rel[real].max()) - m_in + 1)
    else:
        hl = hr = 0
    if hl > m_in or hr > m_in:
        raise ValueError(
            f"halo width ({hl},{hr}) exceeds shard size {m_in}: the dof "
            "ordering has too large a bandwidth for single-hop halo "
            "exchange — reorder (e.g. native.rcm_order) or use fewer shards"
        )
    loc = np.where(real, rel + hl, hl)  # padding -> first own col (value 0)
    return loc.astype(np.int32), hl, hr


def padded_ell_from_csr(
    S,
    n_rows_pad: int,
    n_cols_pad: int,
    m_out: int,
    m_in: int,
    identity_pad: bool = False,
    row_width: Optional[int] = None,
    dtype=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Canonical padded ELL (vals, GLOBAL cols) of a scipy CSR.

    Padding slots/rows carry value 0 with an always-in-window column
    (the row's own shard-proportional input offset), so the same layout
    serves both the sharded SpMV and value-refresh paths without any
    padding-detection heuristics."""
    S = S.tocsr().copy()
    S.sum_duplicates()
    S.sort_indices()
    n_r, n_c = S.shape

    counts = np.diff(S.indptr)
    K = max(int(counts.max()) if counts.size else 1, 1)
    if row_width is not None:
        assert row_width >= K
        K = row_width

    vals = np.zeros((n_rows_pad, K), dtype=dtype or S.dtype)
    # default column: start of the row's own input window (rel = 0)
    cols = np.broadcast_to(
        ((np.arange(n_rows_pad) // m_out) * m_in)[:, None], (n_rows_pad, K)
    ).astype(np.int64).copy()
    r = np.repeat(np.arange(n_r), counts)
    slot = np.arange(S.nnz) - np.repeat(S.indptr[:-1], counts)
    vals[r, slot] = S.data
    cols[r, slot] = S.indices
    if identity_pad and n_rows_pad > n_r:
        assert n_rows_pad == n_cols_pad, "identity_pad needs square padding"
        pad_rows = np.arange(n_r, n_rows_pad)
        vals[pad_rows, 0] = 1.0
        cols[pad_rows, 0] = pad_rows
    return vals, cols


def shard_ell_arrays(
    vals: np.ndarray,
    cols: np.ndarray,
    mesh: Mesh,
    axis: str = "p",
    n_cols_pad: Optional[int] = None,
    halo: Optional[Tuple[int, int]] = None,
) -> DistELLMatrix:
    """Padded host ELL arrays (global cols, no -1 markers) -> sharded."""
    nprocs = mesh.shape[axis]
    n_rows_pad = vals.shape[0]
    assert n_rows_pad % nprocs == 0
    if n_cols_pad is None:
        n_cols_pad = int(cols.max()) + 1
        n_cols_pad = pad_multiple(n_cols_pad, nprocs)
    assert n_cols_pad % nprocs == 0
    m_out, m_in = n_rows_pad // nprocs, n_cols_pad // nprocs

    cols_loc, hl, hr = localize_cols(cols.astype(np.int64), m_out, m_in)
    if halo is not None:
        fl, fr = max(halo[0], hl), max(halo[1], hr)
        cols_loc = cols_loc + (fl - hl)
        hl, hr = fl, fr

    sh2 = NamedSharding(mesh, P(axis, None))
    return DistELLMatrix(
        values=jax.device_put(jnp.asarray(vals), sh2),
        cols_loc=jax.device_put(jnp.asarray(cols_loc), sh2),
        n_cols=n_cols_pad,
        m_in=m_in,
        hl=hl,
        hr=hr,
        mesh=mesh,
        axis=axis,
    )


def shard_csr(
    S,
    mesh: Mesh,
    axis: str = "p",
    n_rows_pad: Optional[int] = None,
    n_cols_pad: Optional[int] = None,
    identity_pad: bool = False,
    row_width: Optional[int] = None,
    halo: Optional[Tuple[int, int]] = None,
    dtype=None,
) -> DistELLMatrix:
    """scipy CSR (real, unpadded) -> DistELLMatrix (padded, sharded).

    identity_pad: give padding rows a unit diagonal (square blocks: keeps
    pad dofs decoupled at zero). Otherwise padding rows are zero rows.
    halo: optionally force larger (hl, hr) than the sparsity requires
    (e.g. so a patch smoother's extraction window fits the same table).
    """
    n_r, n_c = S.shape
    nprocs = mesh.shape[axis]
    if n_rows_pad is None:
        n_rows_pad = pad_multiple(n_r, nprocs)
    if n_cols_pad is None:
        n_cols_pad = pad_multiple(n_c, nprocs)
    assert n_rows_pad % nprocs == 0 and n_cols_pad % nprocs == 0
    m_out, m_in = n_rows_pad // nprocs, n_cols_pad // nprocs
    vals, cols = padded_ell_from_csr(
        S, n_rows_pad, n_cols_pad, m_out, m_in, identity_pad, row_width, dtype
    )
    return shard_ell_arrays(vals, cols, mesh, axis, n_cols_pad, halo)


def shard_vector(
    x, mesh: Mesh, axis: str = "p", n_pad: Optional[int] = None
) -> jnp.ndarray:
    """Flat host vector -> padded sharded device vector P(axis)."""
    x = np.asarray(x)
    nprocs = mesh.shape[axis]
    n_pad = n_pad if n_pad is not None else pad_multiple(x.shape[0], nprocs)
    if n_pad > x.shape[0]:
        x = np.pad(x, (0, n_pad - x.shape[0]))
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(axis)))


def unshard_vector(x, n: int) -> np.ndarray:
    """Sharded padded vector -> host (unpadded)."""
    return np.asarray(jax.device_get(x))[:n]


def dist_to_scipy(A: DistELLMatrix):
    """Host-side validation view (padded sizes)."""
    import scipy.sparse as sp

    vals = np.asarray(A.values)
    cols_loc = np.asarray(A.cols_loc)
    n_rows, K = vals.shape
    m_out = n_rows // A.mesh.shape[A.axis]
    shard = (np.arange(n_rows) // m_out)[:, None]
    cols = cols_loc - A.hl + shard * A.m_in
    rows = np.repeat(np.arange(n_rows), K)
    keep = vals.reshape(-1) != 0
    M = sp.coo_matrix(
        (vals.reshape(-1)[keep], (rows[keep], cols.reshape(-1)[keep])),
        shape=(n_rows, A.n_cols),
    )
    return M.tocsr()
