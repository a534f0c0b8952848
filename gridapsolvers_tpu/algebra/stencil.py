"""Stencil (generalized-DIA) matrices on structured grids — the hot path.

Design: on a structured Cartesian grid every FE dof couples only
to neighbors at a *static* set of grid offsets (Q1: the 3^d cube). Instead
of storing column indices at all, we store one dense band per offset:

    bands[s, i...] = A[i, i + offsets[s]]     (0 where the neighbor is
                                               outside the grid)

SpMV becomes sum_s bands[s] * shift(x, offsets[s]) — a handful of dense
elementwise multiply-adds over shifted views, ZERO gathers, which XLA fuses
into a single memory-bound loop. This is the format the
benchmark SpMV roofline target is measured on; ELLMatrix (ell.py) covers
general sparsity.

The reference has no analog (it uses generic CSC everywhere); this is the
kind of hardware-first redesign SURVEY.md §7 calls for.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def shift(
    xg: jnp.ndarray, off: Sequence[int], periodic: Sequence[bool] = None
) -> jnp.ndarray:
    """shifted[i] = xg[i + off] with zero outside the grid on open axes
    and wraparound on periodic ones. Static offsets compile to pad+slice
    (open) / slice+concat (periodic roll) — no gathers; under SPMD
    sharding both lower to neighbor collective-permutes (the periodic
    wrap is just one extra ppermute edge closing the device ring)."""
    out = xg
    for d, o in enumerate(off):
        if o == 0:
            continue
        if periodic is not None and periodic[d]:
            out = jnp.roll(out, -o, axis=d)
            continue
        n = out.shape[d]
        idx = [slice(None)] * out.ndim
        pad = [(0, 0)] * out.ndim
        if o > 0:
            idx[d] = slice(o, n)
            pad[d] = (0, o)
        else:
            idx[d] = slice(0, n + o)
            pad[d] = (-o, 0)
        out = jnp.pad(out[tuple(idx)], pad)
    return out


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class StencilMatrix:
    """Structured-grid operator with static neighbor offsets.

    bands      : (n_offsets, *grid_shape)
    offsets    : tuple of d-tuples (static)
    grid_shape : dof grid shape (static); vectors are flat (prod(grid),)
    """

    bands: jnp.ndarray
    offsets: Tuple[Tuple[int, ...], ...] = dataclasses.field(
        metadata=dict(static=True)
    )
    grid_shape: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    # When True, vectors are grid-shaped (nx, ny, ...) instead of flat (n,).
    # The distributed path (parallel/dist.py) uses grid-shaped vectors so the
    # leading grid axis carries the device sharding and XLA's SPMD
    # partitioner turns the shifted slices into neighbor halo exchanges.
    grid_vectors: bool = dataclasses.field(
        default=False, metadata=dict(static=True)
    )
    # per-axis periodic wrap (None = all non-periodic)
    periodic: Tuple[bool, ...] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )

    @property
    def n(self) -> int:
        return int(np.prod(self.grid_shape))

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.bands.dtype

    @property
    def nnz(self) -> int:
        return self.bands.shape[0] * self.n

    def _periodic(self):
        return self.periodic or tuple(False for _ in self.grid_shape)

    def _pad_halo(self, xg, lo, hi):
        """Pad with zeros (open axes) or wrapped values (periodic axes)."""
        per = self._periodic()
        xp = xg
        for k in range(xg.ndim):
            if lo[k] == 0 and hi[k] == 0:
                continue
            parts = []
            if lo[k]:
                n = xp.shape[k]
                sl = [slice(None)] * xp.ndim
                sl[k] = slice(n - lo[k], n)
                parts.append(
                    xp[tuple(sl)]
                    if per[k]
                    else jnp.zeros_like(xp[tuple(sl)])
                )
            parts.append(xp)
            if hi[k]:
                sl = [slice(None)] * xp.ndim
                sl[k] = slice(0, hi[k])
                parts.append(
                    xp[tuple(sl)]
                    if per[k]
                    else jnp.zeros_like(xp[tuple(sl)])
                )
            xp = jnp.concatenate(parts, axis=k) if len(parts) > 1 else xp
        return xp

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        xg = x if self.grid_vectors else x.reshape(self.grid_shape)
        if self.grid_vectors:
            # sharded path: per-offset pad+slice keeps each shift local so
            # the SPMD partitioner emits minimal halo exchanges; periodic
            # axes wrap via roll (one extra ppermute closing the ring)
            per = self._periodic()
            y = jnp.zeros_like(xg)
            for s, off in enumerate(self.offsets):
                y = y + self.bands[s] * shift(xg, off, per)
            return y
        # single-device path: pad once, slice per offset — one materialized
        # buffer and 3^d fused multiply-adds instead of 3^d pad ops
        d = xg.ndim
        lo = [max(-min(o[k] for o in self.offsets), 0) for k in range(d)]
        hi = [max(max(o[k] for o in self.offsets), 0) for k in range(d)]
        xp = self._pad_halo(xg, lo, hi)
        y = jnp.zeros_like(xg)
        for s, off in enumerate(self.offsets):
            sl = tuple(
                slice(lo[k] + off[k], lo[k] + off[k] + xg.shape[k])
                for k in range(d)
            )
            y = y + self.bands[s] * xp[sl]
        return y.reshape(-1)

    def matvec_host(self, x: np.ndarray) -> np.ndarray:
        """Pure-NumPy matvec for setup-time host paths (RHS lifting,
        host-side f64 residual checks)."""
        xg = np.asarray(x).reshape(self.grid_shape)
        bands = np.asarray(self.bands)
        d = xg.ndim
        per = self._periodic()
        lo = [max(-min(o[k] for o in self.offsets), 0) for k in range(d)]
        hi = [max(max(o[k] for o in self.offsets), 0) for k in range(d)]
        xp = xg
        for k in range(d):
            mode = "wrap" if per[k] else "constant"
            pw = [(0, 0)] * d
            pw[k] = (lo[k], hi[k])
            xp = np.pad(xp, pw, mode=mode)
        y = np.zeros_like(xg)
        for s, off in enumerate(self.offsets):
            sl = tuple(
                slice(lo[k] + off[k], lo[k] + off[k] + xg.shape[k])
                for k in range(d)
            )
            y += bands[s] * xp[sl]
        return y.reshape(-1)

    def diag(self) -> jnp.ndarray:
        center = self.offsets.index(tuple(0 for _ in self.grid_shape))
        d = self.bands[center]
        return d if self.grid_vectors else d.reshape(-1)

    def abs_row_sum(self) -> jnp.ndarray:
        """sum_j |a_ij| per row (Gershgorin bounds)."""
        s = jnp.sum(jnp.abs(self.bands), axis=0)
        return s if self.grid_vectors else s.reshape(-1)

    def astype(self, dtype) -> "StencilMatrix":
        return StencilMatrix(
            self.bands.astype(dtype), self.offsets, self.grid_shape,
            self.grid_vectors, self.periodic,
        )

    def with_grid_vectors(self, flag: bool = True) -> "StencilMatrix":
        return StencilMatrix(
            self.bands, self.offsets, self.grid_shape, flag, self.periodic
        )

    def to_ell(self):
        """Convert to ELLMatrix (host-side; for validation / generic paths)."""
        from .ell import ell_from_coo

        bands = np.asarray(self.bands)
        gs = self.grid_shape
        n = self.n
        idx = np.arange(n).reshape(gs)
        rows_all, cols_all, vals_all = [], [], []
        per = self._periodic()
        for s, off in enumerate(self.offsets):
            # neighbor index for each grid point; out-of-range is invalid
            # on open axes and wraps on periodic ones
            coords = np.meshgrid(*[np.arange(m) for m in gs], indexing="ij")
            valid = np.ones(gs, dtype=bool)
            for d in range(len(gs)):
                c = coords[d] + off[d]
                if not per[d]:
                    valid &= (c >= 0) & (c < gs[d])
            # flat index in C-order: idx = sum_d coord_d * stride_d
            strides = np.cumprod([1] + list(gs[::-1]))[:-1][::-1]
            nb = sum(
                (
                    (coords[d] + off[d]) % gs[d]
                    if per[d]
                    else np.clip(coords[d] + off[d], 0, gs[d] - 1)
                )
                * strides[d]
                for d in range(len(gs))
            )
            v = bands[s]
            m = valid & (v != 0)
            rows_all.append(idx[m])
            cols_all.append(nb[m])
            vals_all.append(v[m])
        rows = np.concatenate(rows_all)
        cols = np.concatenate(cols_all)
        vals = np.concatenate(vals_all)
        return ell_from_coo(n, n, rows, cols, vals, row_width=len(self.offsets))

    def todense(self) -> jnp.ndarray:
        return self.to_ell().todense()


def stencil_from_scipy(
    S, grid_shape, periodic=None, dtype=None
) -> StencilMatrix:
    """Host-side scipy sparse -> banded StencilMatrix on a dof grid.

    Works for any grid-local operator whose column offsets (in grid
    coordinates) form a small static set — e.g. Q2 stiffness on the Q2
    node grid has a 5^d offset envelope. Bands carry explicit zeros where
    a pair inside the envelope is uncoupled; the payoff is a gather-free
    SpMV (shifted slices) that reads no column indices.
    """
    coo = S.tocoo()
    gs = tuple(int(m) for m in grid_shape)
    d = len(gs)
    n = int(np.prod(gs))
    assert S.shape == (n, n), (S.shape, gs)
    ri = np.stack(np.unravel_index(coo.row, gs), axis=1).astype(np.int64)
    ci = np.stack(np.unravel_index(coo.col, gs), axis=1).astype(np.int64)
    delta = ci - ri
    per = tuple(periodic) if periodic is not None else (False,) * d
    for k in range(d):
        if per[k]:
            m = gs[k]
            delta[:, k] = (delta[:, k] + m // 2) % m - m // 2
    lo = delta.min(axis=0)
    hi = delta.max(axis=0)
    dims = tuple(int(h - l + 1) for l, h in zip(lo, hi))
    key = np.ravel_multi_index(tuple((delta - lo).T), dims)
    ukeys, inv = np.unique(key, return_inverse=True)
    offs = np.stack(np.unravel_index(ukeys, dims), axis=1) + lo
    offsets = [tuple(int(v) for v in row) for row in offs]
    center = tuple(0 for _ in gs)
    if center not in offsets:  # diag() needs the center band
        offsets.append(center)
    bands = np.zeros((len(offsets), n), dtype=dtype or coo.data.dtype)
    np.add.at(bands, (inv, coo.row), coo.data)
    return StencilMatrix(
        jnp.asarray(bands.reshape((len(offsets),) + gs)),
        tuple(offsets),
        gs,
        periodic=per if any(per) else None,
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ConstStencilMatrix:
    """Matrix-free constant-coefficient stencil operator with Dirichlet
    elimination — the speed-of-light operator for uniform-grid problems.

    On a uniform mesh the assembled FE stencil is spatially constant at
    every interior (free) dof, so instead of 3^d dense bands we store 3^d
    SCALARS plus the free-dof mask:

        y = free * (sum_s w_s * shift(free * x, s)) + (1 - free) * x

    which is EXACTLY the Dirichlet-eliminated operator (identity on
    constrained dofs, zeroed constrained columns) whenever every free dof
    has a full cell neighborhood — true for boundary-constrained problems.
    Memory traffic drops from (3^d + 2) n values to ~3 n values per apply
    (~14x less in 3D); the 3^d fused multiply-adds become arithmetic. The
    counterpart of the reference's matrix-free weakform operators.
    """

    weights: jnp.ndarray   # (n_offsets,)
    free: jnp.ndarray      # grid-shaped {0,1} mask
    offsets: Tuple[Tuple[int, ...], ...] = dataclasses.field(
        metadata=dict(static=True)
    )
    grid_shape: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    grid_vectors: bool = dataclasses.field(
        default=False, metadata=dict(static=True)
    )

    @property
    def n(self) -> int:
        return int(np.prod(self.grid_shape))

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.weights.dtype

    @property
    def nnz(self) -> int:
        return self.weights.shape[0] * self.n

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        xg = x if self.grid_vectors else x.reshape(self.grid_shape)
        xm = self.free * xg
        d = xg.ndim
        lo = [max(-min(o[k] for o in self.offsets), 0) for k in range(d)]
        hi = [max(max(o[k] for o in self.offsets), 0) for k in range(d)]
        xp = jnp.pad(xm, list(zip(lo, hi)))
        y = jnp.zeros_like(xg)
        for s, off in enumerate(self.offsets):
            sl = tuple(
                slice(lo[k] + off[k], lo[k] + off[k] + xg.shape[k])
                for k in range(d)
            )
            y = y + self.weights[s] * xp[sl]
        y = self.free * y + (1.0 - self.free) * xg
        return y if self.grid_vectors else y.reshape(-1)

    def diag(self) -> jnp.ndarray:
        center = self.offsets.index(tuple(0 for _ in self.grid_shape))
        d = self.free * self.weights[center] + (1.0 - self.free)
        return d if self.grid_vectors else d.reshape(-1)

    def abs_row_sum(self) -> jnp.ndarray:
        s = self.free * jnp.sum(jnp.abs(self.weights)) + (1.0 - self.free)
        return s if self.grid_vectors else s.reshape(-1)

    def expand(self) -> "StencilMatrix":
        """Materialize as a banded StencilMatrix (host/debug/coarse)."""
        from ..fem.assembly import eliminate_dirichlet

        w = np.asarray(self.weights)
        bands = np.broadcast_to(
            w.reshape((-1,) + (1,) * len(self.grid_shape)),
            (w.shape[0],) + self.grid_shape,
        ).copy()
        A = StencilMatrix(bands, self.offsets, self.grid_shape, self.grid_vectors)
        mask = np.asarray(self.free) < 0.5
        return eliminate_dirichlet(A, mask)

    def to_ell(self):
        return self.expand().to_ell()

    def todense(self):
        return self.expand().todense()

    def with_grid_vectors(self, flag: bool = True) -> "ConstStencilMatrix":
        return ConstStencilMatrix(
            self.weights, self.free, self.offsets, self.grid_shape, flag
        )


def poisson_stencil(
    grid_shape: Tuple[int, ...],
    h: Sequence[float],
    dtype=jnp.float64,
    dirichlet_mask: np.ndarray | None = None,
) -> StencilMatrix:
    """Q1 FEM Laplacian bands on a uniform Cartesian vertex grid.

    Assembled band-wise on the host from the Q1 element stiffness tensor
    (see fem/assembly.py for the general path). `dirichlet_mask` marks
    constrained dofs: their rows/cols become identity (the standard
    eliminate-with-diagonal-1 treatment; lifting goes to the RHS).
    """
    from ..fem.assembly import assemble_poisson_stencil

    return assemble_poisson_stencil(grid_shape, h, dtype, dirichlet_mask)
