"""Explicit halo-exchange stencil matvec (shard_map + lax.ppermute).

The auto-partitioned StencilMatrix matvec (parallel/dist.py) lets XLA's
SPMD partitioner turn every per-band shifted slice into its own
collective-permute — measured 273 permutes per GMG-CG iteration at 8
devices (COMMS_r04). This wrapper performs ONE halo exchange per matvec
(2 ppermutes per sharded axis, halo width = the stencil's reach) and
applies all bands locally:

  y = y_interior(x_local)  +  corrections(halo_lo, halo_hi)

The interior term is data-independent of the permutes, so the latency-
hiding scheduler can overlap the halo exchange with the bulk of the
local SpMV — BASELINE's "halo exchange overlapped with local compute"
north star, expressed structurally in the dataflow rather than left to
the partitioner.

Reference counterpart: PartitionedArrays' consistent! neighbor exchange
(SURVEY §2.8.2, PAExtras.jl:84-97) — a neighbor-graph exchange, not
per-band traffic.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ..algebra.stencil import StencilMatrix


def _halo_widths(offsets, k):
    lo = max(-min(o[k] for o in offsets), 0)
    hi = max(max(o[k] for o in offsets), 0)
    return lo, hi


def _perm_up(p):
    # values move to the next-higher rank: halo_lo of rank i+1 comes
    # from rank i. Missing pairs deliver zeros (exactly the open-BC pad).
    return [(i, i + 1) for i in range(p - 1)]


def _perm_down(p):
    return [(i + 1, i) for i in range(p - 1)]


def _conv(bands, xp, offsets, lo, out_shape):
    """All-bands multiply-add: output[r] = sum_s b_s[r] * xp[r + off + lo]
    (xp already padded so indices are in range)."""
    d = len(out_shape)
    y = None
    for s, off in enumerate(offsets):
        sl = tuple(
            slice(lo[k] + off[k], lo[k] + off[k] + out_shape[k])
            for k in range(d)
        )
        t = bands[s] * xp[sl]
        y = t if y is None else y + t
    return y


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class HaloStencilMatrix:
    """StencilMatrix whose matvec runs inside shard_map with an explicit
    neighbor halo exchange. `inner` holds the (device-sharded) bands with
    grid_vectors=True; `axes` names the mesh axes mapped onto the leading
    grid dimensions (slab partition = one axis)."""

    inner: StencilMatrix
    mesh: Mesh = dataclasses.field(metadata=dict(static=True))
    axes: Tuple[str, ...] = dataclasses.field(metadata=dict(static=True))

    # -- pass-throughs --------------------------------------------------
    @property
    def grid_shape(self):
        return self.inner.grid_shape

    @property
    def offsets(self):
        return self.inner.offsets

    @property
    def grid_vectors(self):
        return True

    @property
    def periodic(self):
        return self.inner.periodic

    @property
    def n(self):
        return self.inner.n

    @property
    def shape(self):
        return self.inner.shape

    @property
    def dtype(self):
        return self.inner.dtype

    @property
    def nnz(self):
        return self.inner.nnz

    @property
    def bands(self):
        return self.inner.bands

    def diag(self):
        return self.inner.diag()

    def abs_row_sum(self):
        return self.inner.abs_row_sum()

    def todense(self):
        return self.inner.todense()

    def astype(self, dtype):
        return HaloStencilMatrix(
            self.inner.astype(dtype), self.mesh, self.axes
        )

    # -- matvec ---------------------------------------------------------
    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        A = self.inner
        mesh, axes = self.mesh, self.axes
        d = len(A.grid_shape)
        per = A.periodic or tuple(False for _ in range(d))
        if any(per[k] for k in range(len(axes))):
            # periodic sharded axes would need wrap pairs in the permute;
            # fall back to the auto-partitioned path (correct, more comms)
            return A.matvec(x)
        offsets = A.offsets
        nshard = len(axes)
        xspec = P(*axes, *([None] * (d - nshard)))
        bspec = P(None, *axes, *([None] * (d - nshard)))
        psizes = tuple(mesh.shape[a] for a in axes)

        def _pad_unsharded(blk):
            """Zero/periodic pad every axis >= nshard of a local block."""
            xp = blk
            for k in range(nshard, d):
                lo_k, hi_k = _halo_widths(offsets, k)
                if lo_k == 0 and hi_k == 0:
                    continue
                parts = []
                nloc = xp.shape[k]
                if lo_k:
                    sl = [slice(None)] * d
                    sl[k] = slice(nloc - lo_k, nloc)
                    b = xp[tuple(sl)]
                    parts.append(b if per[k] else jnp.zeros_like(b))
                parts.append(xp)
                if hi_k:
                    sl = [slice(None)] * d
                    sl[k] = slice(0, hi_k)
                    b = xp[tuple(sl)]
                    parts.append(b if per[k] else jnp.zeros_like(b))
                xp = jnp.concatenate(parts, axis=k)
            return xp

        @partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(bspec, xspec),
            out_specs=xspec,
        )
        def fn_slab(bl, xl):
            """1 sharded axis: interior/corrections split. y0 depends
            only on the local block — the two ppermutes and the O(halo)
            correction strips are the only halo-dependent work, so the
            scheduler can overlap the exchange with the bulk SpMV."""
            lo0, hi0 = _halo_widths(offsets, 0)
            p = psizes[0]
            n0 = xl.shape[0]
            name = axes[0]
            h_lo = h_hi = None
            if lo0 and p > 1:
                h_lo = jax.lax.ppermute(
                    xl[n0 - lo0:], name, _perm_up(p)
                )
            if hi0 and p > 1:
                h_hi = jax.lax.ppermute(xl[:hi0], name, _perm_down(p))

            # interior: all bands on the zero-haloed local block
            zlo = jnp.zeros_like(xl[:lo0])
            zhi = jnp.zeros_like(xl[:hi0])
            xp0 = jnp.concatenate([zlo, xl, zhi], axis=0) \
                if (lo0 or hi0) else xl
            lo = [lo0] + [_halo_widths(offsets, k)[0] for k in range(1, d)]
            y = _conv(bl, _pad_unsharded(xp0), offsets, lo, xl.shape)

            # corrections: only the first lo0 / last hi0 output rows
            if h_lo is not None:
                strip = jnp.concatenate(
                    [h_lo, jnp.zeros_like(xl[: lo0 + hi0])], axis=0
                )
                corr = _conv(
                    bl[:, :lo0], _pad_unsharded(strip), offsets, lo,
                    (lo0,) + xl.shape[1:],
                )
                y = y.at[:lo0].add(corr)
            if h_hi is not None:
                strip = jnp.concatenate(
                    [jnp.zeros_like(xl[: hi0 + lo0]), h_hi], axis=0
                )
                corr = _conv(
                    bl[:, n0 - hi0:], _pad_unsharded(strip), offsets, lo,
                    (hi0,) + xl.shape[1:],
                )
                y = y.at[n0 - hi0:].add(corr)
            return y

        if nshard == 1:
            return fn_slab(A.bands, x)

        @partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(bspec, xspec),
            out_specs=xspec,
        )
        def fn(bl, xl):
            # ---- halo exchange: 2 ppermutes per sharded axis ----
            src = xl
            for j, name in enumerate(axes):
                lo_w, hi_w = _halo_widths(offsets, j)
                p = psizes[j]
                h_lo = h_hi = None
                if lo_w and p > 1:
                    sl = [slice(None)] * d
                    sl[j] = slice(src.shape[j] - lo_w, src.shape[j])
                    h_lo = jax.lax.ppermute(
                        src[tuple(sl)], name, _perm_up(p)
                    )
                if hi_w and p > 1:
                    sl = [slice(None)] * d
                    sl[j] = slice(0, hi_w)
                    h_hi = jax.lax.ppermute(
                        src[tuple(sl)], name, _perm_down(p)
                    )
                # extend src along j so the NEXT axis' exchange carries
                # corner halos through the neighbor (sequential-axis
                # corner trick)
                parts = []
                if h_lo is not None:
                    parts.append(h_lo)
                elif lo_w:
                    sl = [slice(None)] * d
                    sl[j] = slice(0, lo_w)
                    parts.append(jnp.zeros_like(src[tuple(sl)]))
                parts.append(src)
                if h_hi is not None:
                    parts.append(h_hi)
                elif hi_w:
                    sl = [slice(None)] * d
                    sl[j] = slice(0, hi_w)
                    parts.append(jnp.zeros_like(src[tuple(sl)]))
                if len(parts) > 1:
                    src = jnp.concatenate(parts, axis=j)

            # ---- unsharded axes: plain zero pad (open BCs; periodic
            # unsharded axes wrap locally) ----
            lo = [0] * d
            hi = [0] * d
            for k in range(d):
                if k < nshard:
                    lo[k], hi[k] = _halo_widths(offsets, k)
                    continue
                lo[k], hi[k] = _halo_widths(offsets, k)
            xp = src
            for k in range(nshard, d):
                if lo[k] == 0 and hi[k] == 0:
                    continue
                parts = []
                nloc = xp.shape[k]
                if lo[k]:
                    sl = [slice(None)] * d
                    sl[k] = slice(nloc - lo[k], nloc)
                    blk = xp[tuple(sl)]
                    parts.append(
                        blk if per[k] else jnp.zeros_like(blk)
                    )
                parts.append(xp)
                if hi[k]:
                    sl = [slice(None)] * d
                    sl[k] = slice(0, hi[k])
                    blk = xp[tuple(sl)]
                    parts.append(
                        blk if per[k] else jnp.zeros_like(blk)
                    )
                xp = jnp.concatenate(parts, axis=k)

            return _conv(bl, xp, offsets, lo, xl.shape)

        return fn(A.bands, x)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class HaloProlongation:
    """Factor-2 Q1 interpolation between NESTED-padded sharded grids
    (fine shard = 2 x coarse shard along the slab axis): ONE ppermute
    (coarse high halo row) + local interleave, instead of the
    auto-partitioned lowering's full all-gather at the misaligned shard
    boundary (COMMS_r04: 14 all-gathers / 414 KB per GMG-CG iteration).

    fine[2t] = c[t]; fine[2t+1] = 0.5 (c[t] + c[t+1]) with c[m] = the
    neighbor's first row (edge shard receives ppermute zeros = the pad
    region, masked after)."""

    fine_shape: Tuple[int, ...] = dataclasses.field(
        metadata=dict(static=True)
    )
    coarse_shape: Tuple[int, ...] = dataclasses.field(
        metadata=dict(static=True)
    )
    mesh: Mesh = dataclasses.field(metadata=dict(static=True))
    axes: Tuple[str, ...] = dataclasses.field(metadata=dict(static=True))
    mask_fine: object = None
    periodic: Tuple[bool, ...] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )

    def matvec(self, xc: jnp.ndarray) -> jnp.ndarray:
        from ..multilevel.transfer import _expand_dim

        d = len(self.coarse_shape)
        per = self.periodic or tuple(False for _ in range(d))
        assert len(self.axes) == 1 and not per[0]
        name = self.axes[0]
        p = self.mesh.shape[name]
        xspec = P(name, *([None] * (d - 1)))

        @partial(
            jax.shard_map, mesh=self.mesh, in_specs=(xspec,),
            out_specs=xspec,
        )
        def fn(cl):
            m = cl.shape[0]
            c_next = jax.lax.ppermute(cl[:1], name, _perm_down(p)) \
                if p > 1 else jnp.zeros_like(cl[:1])
            nxt = jnp.concatenate([cl[1:], c_next], axis=0)
            odd = 0.5 * (cl + nxt)
            inter = jnp.stack([cl, odd], axis=1)
            out = inter.reshape((2 * m,) + cl.shape[1:])
            for k in range(1, d):
                out = _expand_dim(out, k, per[k])
            # unsharded axes expand to 2n-1 == the true fine size; the
            # sharded axis is exactly 2m by construction (nested pads)
            return out

        y = fn(xc)
        tgt = tuple(self.fine_shape)
        if y.shape != tgt:
            y = y[tuple(slice(0, n) for n in tgt)]
        if self.mask_fine is not None:
            y = y * self.mask_fine
        return y


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class HaloRestriction:
    """Full-weighting restriction between NESTED-padded sharded grids:
    z[t] = f[2t] + 0.5 f[2t-1] + 0.5 f[2t+1], with f[-1] = the previous
    shard's last row via ONE ppermute. Transpose of HaloProlongation on
    the real region."""

    fine_shape: Tuple[int, ...] = dataclasses.field(
        metadata=dict(static=True)
    )
    coarse_shape: Tuple[int, ...] = dataclasses.field(
        metadata=dict(static=True)
    )
    mesh: Mesh = dataclasses.field(metadata=dict(static=True))
    axes: Tuple[str, ...] = dataclasses.field(metadata=dict(static=True))
    mask_coarse: object = None
    mask_fine: object = None
    periodic: Tuple[bool, ...] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )

    def matvec(self, xf: jnp.ndarray) -> jnp.ndarray:
        from ..multilevel.transfer import _reduce_dim

        d = len(self.fine_shape)
        per = self.periodic or tuple(False for _ in range(d))
        assert len(self.axes) == 1 and not per[0]
        name = self.axes[0]
        p = self.mesh.shape[name]
        xspec = P(name, *([None] * (d - 1)))
        if self.mask_fine is not None:
            xf = xf * self.mask_fine

        @partial(
            jax.shard_map, mesh=self.mesh, in_specs=(xspec,),
            out_specs=xspec,
        )
        def fn(fl):
            m2 = fl.shape[0]
            m = m2 // 2
            h_prev = jax.lax.ppermute(fl[m2 - 1:], name, _perm_up(p)) \
                if p > 1 else jnp.zeros_like(fl[:1])
            pairs = fl.reshape((m, 2) + fl.shape[1:])
            even = pairs[:, 0]
            odd = pairs[:, 1]
            odd_right = jnp.concatenate([h_prev, odd[:-1]], axis=0)
            out = even + 0.5 * odd + 0.5 * odd_right
            for k in range(1, d):
                out = _reduce_dim(out, k, per[k])
            return out

        y = fn(xf)
        tgt = tuple(self.coarse_shape)
        if y.shape != tgt:
            y = y[tuple(slice(0, n) for n in tgt)]
        if self.mask_coarse is not None:
            y = y * self.mask_coarse
        return y


def halo_wrap(A: StencilMatrix, mesh: Mesh, axes) -> "HaloStencilMatrix":
    """Wrap a sharded grid-vector StencilMatrix with the halo-exchange
    matvec. `axes` as in parallel.dist (one name, tuple, or None=all)."""
    from .dist import _axes_tuple

    return HaloStencilMatrix(A, mesh, tuple(_axes_tuple(mesh, axes)))


def halo_spmv(A: StencilMatrix, mesh: Mesh, axis: str = "p"):
    """Back-compat closure form of the round-2 explicit halo SpMV:
    returns a jittable matvec using the HaloStencilMatrix machinery."""
    H = halo_wrap(A, mesh, axis)
    return H.matvec


def _ghost_extend(mesh, name, p, W, arrs, band_axis_first):
    """Build ghosted-layout copies: each device's shard extended by W
    rows of its neighbors' data (zeros at the physical edges). The
    result is a normal sharded jax.Array whose global leading axis is
    p * (m + 2W) — per-shard overlap made explicit. One-time setup cost."""
    def mk(ax0, d):
        spec = (P(None, name, *([None] * (d - 2)))
                if ax0 == 1 else P(name, *([None] * (d - 1))))

        @partial(jax.shard_map, mesh=mesh, in_specs=(spec,),
                 out_specs=spec)
        def fn(al):
            n0 = al.shape[ax0]
            lo_sl = [slice(None)] * d
            lo_sl[ax0] = slice(n0 - W, n0)
            hi_sl = [slice(None)] * d
            hi_sl[ax0] = slice(0, W)
            if p > 1:
                h_lo = jax.lax.ppermute(al[tuple(lo_sl)], name,
                                        _perm_up(p))
                h_hi = jax.lax.ppermute(al[tuple(hi_sl)], name,
                                        _perm_down(p))
            else:
                h_lo = jnp.zeros_like(al[tuple(lo_sl)])
                h_hi = jnp.zeros_like(al[tuple(hi_sl)])
            return jnp.concatenate([h_lo, al, h_hi], axis=ax0)

        # jit: run eagerly, the shard_map compiles each op on its own
        return jax.jit(fn)

    out = []
    for a, is_band in zip(arrs, band_axis_first):
        out.append(mk(1 if is_band else 0, a.ndim)(a))
    return out


@dataclasses.dataclass(frozen=True)
class HaloChebyshevSmoother:
    """Communication-avoiding Chebyshev smoother for slab-sharded
    HaloStencilMatrix levels: ONE depth-W halo exchange per sweep
    (W = degree * stencil reach) instead of one exchange per matvec —
    the s-step/ghost-cells trick. The whole degree-d recurrence runs
    locally on the W-extended block; values inside the core are
    bit-identical to the per-matvec-exchange sweep (same data, same
    op order), garbage in the shrinking margin never reaches the core.

    Setup stores ghosted-layout copies of the bands and inverse
    diagonal (built once with the same exchange). Requires local shard
    height m >= W; construction sites fall back to the plain
    ChebyshevSmoother otherwise. Collectives per GMG-CG iteration at 8
    devices drop ~27 -> ~16 loop-body permutes (COMMS_r05).

    Reference counterpart: the Richardson/Chebyshev-wrapped smoothers
    applied between consistent! exchanges (SURVEY §3.3) — here the
    exchange is hoisted out of the polynomial loop entirely.
    """

    degree: int = 3
    ratio: float = 30.0
    safety: float = 1.1
    lanczos_iters: int = 20
    eig_method: str = "gershgorin"

    def _base(self):
        from ..linear.smoothers import ChebyshevSmoother

        return ChebyshevSmoother(
            degree=self.degree, ratio=self.ratio, safety=self.safety,
            lanczos_iters=self.lanczos_iters, eig_method=self.eig_method,
        )

    def setup(self, A, x=None):
        assert isinstance(A, HaloStencilMatrix) and len(A.axes) == 1
        base = self._base().setup(A)
        name = A.axes[0]
        p = A.mesh.shape[name]
        reach = max(max(-o[0], o[0]) for o in A.offsets)
        W = self.degree * reach
        m = A.grid_shape[0] // p
        assert m >= W, (m, W)
        bands_ext, invd_ext = _ghost_extend(
            A.mesh, name, p, W, [A.bands, base["inv_diag"]],
            [True, False],
        )
        return {
            "A": A, "lmax": base["lmax"], "lmin": base["lmin"],
            "bands_ext": bands_ext, "invd_ext": invd_ext,
        }

    def update(self, state, A, x=None):
        return self.setup(A, x)

    def apply(self, state, r):
        x = pt_zeros(r)
        x, _ = self.smooth(state, x, r)
        return x

    def smooth(self, state, x, r):
        A = state["A"]
        name = A.axes[0]
        p = A.mesh.shape[name]
        offsets = A.offsets
        d = len(A.grid_shape)
        per = A.periodic or tuple(False for _ in range(d))
        reach = max(max(-o[0], o[0]) for o in A.offsets)
        W = self.degree * reach
        degree = self.degree
        lo_rest = [_halo_widths(offsets, k)[0] for k in range(1, d)]

        xspec = P(name, *([None] * (d - 1)))
        bspec = P(None, name, *([None] * (d - 1)))
        sspec = P()

        def local_mv(be, v):
            # zero-halo local matvec on the EXTENDED block (margin rows
            # produce garbage that stays in the shrinking margin)
            lo0, hi0 = _halo_widths(offsets, 0)
            zlo = jnp.zeros_like(v[:lo0])
            zhi = jnp.zeros_like(v[:hi0])
            vp = jnp.concatenate([zlo, v, zhi], axis=0) \
                if (lo0 or hi0) else v
            # unsharded axes: zero/periodic pad
            for k in range(1, d):
                lo_k, hi_k = _halo_widths(offsets, k)
                if lo_k == 0 and hi_k == 0:
                    continue
                parts = []
                nloc = vp.shape[k]
                if lo_k:
                    sl = [slice(None)] * d
                    sl[k] = slice(nloc - lo_k, nloc)
                    b = vp[tuple(sl)]
                    parts.append(b if per[k] else jnp.zeros_like(b))
                parts.append(vp)
                if hi_k:
                    sl = [slice(None)] * d
                    sl[k] = slice(0, hi_k)
                    b = vp[tuple(sl)]
                    parts.append(b if per[k] else jnp.zeros_like(b))
                vp = jnp.concatenate(parts, axis=k)
            return _conv(be, vp, offsets, [lo0] + lo_rest, v.shape)

        @partial(
            jax.shard_map, mesh=A.mesh,
            in_specs=(bspec, xspec, xspec, xspec, sspec, sspec),
            out_specs=(xspec, xspec),
        )
        def fn(be, de, xl, rl, lmax, lmin):
            theta = 0.5 * (lmax + lmin)
            delta = 0.5 * (lmax - lmin)
            sigma1 = theta / delta
            rho = 1.0 / sigma1
            # ONE depth-W exchange of the residual
            if p > 1:
                h_lo = jax.lax.ppermute(rl[-W:], name, _perm_up(p))
                h_hi = jax.lax.ppermute(rl[:W], name, _perm_down(p))
            else:
                h_lo = jnp.zeros_like(rl[:W])
                h_hi = jnp.zeros_like(rl[:W])
            re = jnp.concatenate([h_lo, rl, h_hi], axis=0)
            z = de * re
            dvec = z / theta
            xe = jnp.zeros_like(re)
            for _ in range(degree):
                xe = xe + dvec
                re = re - local_mv(be, dvec)
                rho_new = 1.0 / (2.0 * sigma1 - rho)
                z = de * re
                d_coef = 2.0 * rho_new / delta
                dvec = d_coef * z + (rho_new * rho) * dvec
                rho = rho_new
            return xl + xe[W:-W], re[W:-W]

        lmax = jnp.asarray(state["lmax"])
        lmin = jnp.asarray(state["lmin"])
        return fn(state["bands_ext"], state["invd_ext"], x, r, lmax, lmin)

    def solve(self, state, b, x0=None):
        x = pt_zeros(b) if x0 is None else x0
        r = b - state["A"].matvec(x)
        x, _ = self.smooth(state, x, r)
        return x, None


def pt_zeros(r):
    return jax.tree_util.tree_map(jnp.zeros_like, r)
