"""Distributed Vanka smoother over BOX-PARTITIONED (multi-axis) systems.

Generalizes `patches/dist_vanka.py` (1-D interleaved layout, contiguous
halo windows) to block systems whose leaves are `DistGraphELL` over
D-dimensional box partitions. Two design changes make the general case
SIMPLER than the 1-D one:

  * patch-matrix extraction matches column ids in GLOBAL interleaved
    coordinates (per-shard static tables precomputed at build time), so
    no window-coordinate translation between neighbors is needed — the
    1-D code's `cols_ext ± M` shift disappears;
  * ghost patch members move along the same static neighbor-offset
    tables as the DistGraphELL SpMV: one `lax.ppermute` per offset
    fetches (a) the owner's interleaved VALUE rows at refresh — the
    device-side ghost-row fetch the reference does with MPI
    (src/SolverInterfaces/PAExtras.jl:9-110) — and (b) the residual
    entries at apply, with the adjoint reverse permute accumulating
    patch corrections back on the owners (`assemble!`).

Interleaved layout: per shard, the fields' padded local boxes are
concatenated — interleaved id of (field f, padded row i) =
owner(i) * M + soff_f + slot(i), M = Σ_f m_f.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..algebra.ell_view import iter_field_leaves
from ..interfaces import Smoother
from ..parallel.dist_ell_nd import (
    BoxPartition,
    DistGraphELL,
    _neighbor_perm,
    global_cols_nd,
)
from ..utils import pytrees as pt


@dataclasses.dataclass(frozen=True, eq=False)
class NDVankaMeta:
    """Static structure of the box-partitioned patch solve."""

    mesh: object
    axes: Tuple[str, ...]
    mesh_shape: Tuple[int, ...]
    m: Tuple[int, ...]          # per-field padded local sizes
    rows: Tuple[Tuple[int, ...], ...]   # leaf ids per field row
    leaf_widths: Tuple[int, ...]
    width: int                   # Kw of the interleaved table
    dirs: Tuple[Tuple[int, ...], ...]
    dir_widths: Tuple[int, ...]
    npp: int
    k: int

    @property
    def M(self) -> int:
        return sum(self.m)

    @property
    def soff(self) -> Tuple[int, ...]:
        return tuple(int(x) for x in np.cumsum([0] + list(self.m))[:-1])

    @property
    def L(self) -> int:
        return self.M + sum(self.dir_widths)

    def perms(self):
        return [_neighbor_perm(self.mesh_shape, d) for d in self.dirs]


def build_dist_vanka_nd(A_dist, parts: Tuple[BoxPartition, ...], topo):
    """Host-side, once. A_dist: block operator with DistGraphELL leaves
    (field-major order must match `parts`). topo: PatchTopology over the
    REAL field-major dof space (real field sizes = parts[f].n). Patches
    are assigned to the shard owning their first valid dof."""
    leaves = list(iter_field_leaves(A_dist))
    assert leaves, "empty block operator"
    mesh = leaves[0][2].mesh
    axes = leaves[0][2].axes
    mesh_shape = tuple(mesh.shape[a] for a in axes)
    S = int(np.prod(mesh_shape))
    nf = len(parts)
    m = tuple(p.m for p in parts)
    soff = tuple(int(x) for x in np.cumsum([0] + list(m))[:-1])
    M = sum(m)

    rows: List[Tuple[int, ...]] = [tuple() for _ in range(nf)]
    widths = []
    for lid, (fi, fj, leaf) in enumerate(leaves):
        assert isinstance(leaf, DistGraphELL), type(leaf)
        rows[fi] = rows[fi] + (lid,)
        widths.append(int(leaf.values.shape[1]))
    Kw = max(
        sum(widths[lid] for lid in rows[f]) if rows[f] else 1
        for f in range(nf)
    )

    def inter_of_padded(f, pidx):
        """Padded field-local id -> global interleaved id."""
        return (pidx // m[f]) * M + soff[f] + pidx % m[f]

    # ---- interleaved global column table (S*M, Kw) ------------------------
    cols_inter = np.zeros((S * M, Kw), dtype=np.int64)
    for f in range(nf):
        blocks = []
        for lid in rows[f]:
            fi, fj, leaf = leaves[lid]
            assert leaf.values.shape[0] == S * m[f], (
                "leaf rows must cover field partition"
            )
            gc = global_cols_nd(leaf)  # global padded ids in field fj
            blocks.append(inter_of_padded(fj, gc.astype(np.int64)))
        if blocks:
            blk = np.concatenate(blocks, axis=1)
        else:
            blk = np.zeros((S * m[f], 0), dtype=np.int64)
        n_f_pad = S * m[f]
        pidx = np.arange(n_f_pad)
        if blk.shape[1] < Kw:
            # padding slots: own shard's first interleaved slot (value 0)
            pad = np.broadcast_to(
                ((pidx // m[f]) * M)[:, None], (n_f_pad, Kw - blk.shape[1])
            )
            blk = np.concatenate([blk, pad], axis=1)
        cols_inter[inter_of_padded(f, pidx)] = blk

    # ---- patches: real field-major ids -> interleaved ---------------------
    real_offs = np.cumsum([0] + [p.n for p in parts])
    dofs = topo.dofs.astype(np.int64)
    valid = dofs != topo.dummy
    fld = np.clip(
        np.searchsorted(real_offs, dofs, side="right") - 1, 0, nf - 1
    )
    loc = dofs - real_offs[fld]
    owner = np.zeros_like(dofs)
    slot = np.zeros_like(dofs)
    for f in range(nf):
        sel = (fld == f) & valid
        owner[sel] = parts[f].owner[loc[sel]]
        slot[sel] = parts[f].slot[loc[sel]] + soff[f]
    inter = np.where(valid, owner * M + slot, -1)

    first = np.argmax(valid, axis=1)
    has = valid.any(axis=1)
    pshard = np.where(has, owner[np.arange(len(first)), first], 0)
    npp = int(np.bincount(pshard[has], minlength=S).max()) if has.any() else 1
    k = topo.width
    dofs_glob = np.full((S, npp, k), -1, dtype=np.int64)
    fill = np.zeros(S, dtype=np.int64)
    for pch in np.nonzero(has)[0]:
        s = int(pshard[pch])
        dofs_glob[s, fill[s]] = inter[pch]
        fill[s] += 1

    # ---- ghost exchange tables (owner != patch shard) ----------------------
    t_of = np.repeat(np.arange(S), npp * k).reshape(S, npp, k)
    gv = dofs_glob >= 0
    g_owner = np.where(gv, dofs_glob // M, t_of)
    ghost = gv & (g_owner != t_of)
    dirs, dir_widths, send_tbls = [], [], []
    dofs_win = np.where(gv, dofs_glob - t_of * M, 0)  # own default
    if ghost.any():
        tg = t_of[ghost]
        og = g_owner[ghost]
        tc = np.array(np.unravel_index(tg, mesh_shape)).T
        oc = np.array(np.unravel_index(og, mesh_shape)).T
        delta = oc - tc
        dkey, dinv = np.unique(delta, axis=0, return_inverse=True)
        dinv = dinv.reshape(-1)
        gidx = np.argwhere(ghost)  # (ng, 3)
        off = M
        for di in range(len(dkey)):
            d = tuple(int(x) for x in dkey[di])
            sel = dinv == di
            t = tg[sel]
            gid = dofs_glob[ghost][sel]
            key = t * (S * M) + gid
            uk, inv = np.unique(key, return_inverse=True)
            ut = uk // (S * M)
            ug = uk % (S * M)
            grp = np.searchsorted(ut, np.arange(S), side="left")
            pos = np.arange(len(uk)) - grp[ut]
            W = int(np.bincount(ut, minlength=S).max())
            tbl = np.zeros((S, W), dtype=np.int32)
            u_send = np.ravel_multi_index(
                tuple(
                    np.unravel_index(ut, mesh_shape)[a] + d[a]
                    for a in range(len(mesh_shape))
                ),
                mesh_shape,
            )
            tbl[u_send, pos] = (ug % M).astype(np.int32)
            ii = gidx[sel]
            dofs_win[ii[:, 0], ii[:, 1], ii[:, 2]] = off + pos[inv]
            dirs.append(d)
            dir_widths.append(W)
            send_tbls.append(tbl)
            off += W
    L = M + sum(dir_widths)
    dofs_win = np.where(gv, dofs_win, L).astype(np.int32)

    # ---- static ghost column rows (S, sum W, Kw) ---------------------------
    ghost_cols = np.full((S, max(1, L - M), Kw), -1, dtype=np.int64)
    off = 0
    for d, W, tbl in zip(dirs, dir_widths, send_tbls):
        for t in range(S):
            tc = np.array(np.unravel_index(t, mesh_shape)) + np.array(d)
            if not all(0 <= c < sdim for c, sdim in zip(tc, mesh_shape)):
                continue
            u = int(np.ravel_multi_index(tuple(tc), mesh_shape))
            ghost_cols[t, off : off + W] = cols_inter[
                u * M + tbl[u].astype(np.int64)
            ]
        off += W

    # ---- overlap weights ----------------------------------------------------
    counts = np.zeros(S * M)
    np.add.at(counts, inter[valid].reshape(-1), 1.0)
    w = 1.0 / np.maximum(counts, 1.0)
    uncov = counts == 0

    meta = NDVankaMeta(
        mesh=mesh,
        axes=axes,
        mesh_shape=mesh_shape,
        m=m,
        rows=tuple(rows),
        leaf_widths=tuple(widths),
        width=Kw,
        dirs=tuple(dirs),
        dir_widths=tuple(dir_widths),
        npp=npp,
        k=k,
    )
    arrays = {
        "cols": cols_inter,               # (S*M, Kw) GLOBAL inter ids
        "ghost_cols": ghost_cols,         # (S, sumW|1, Kw)
        "dofs_win": dofs_win,             # (S, npp, k) window coords
        "dofs_glob": dofs_glob,           # (S, npp, k) global ids, -1 pad
        "send": send_tbls,                # per dir (S, W) local slots
        "w": w,
        "uncov": uncov,
    }
    return meta, arrays


@dataclasses.dataclass(frozen=True, eq=False)
class DistVankaNDSolver(Smoother):
    """Sharded batched overlapping Vanka over a box-partitioned block
    system. Construct via `make_dist_vanka_nd`; update() re-extracts and
    re-factorizes fully on device (numerical_setup!)."""

    meta: NDVankaMeta = None
    host_arrays: dict = None
    omega: float = 1.0
    weighting: str = "overlap"
    jacobi_uncovered: bool = True

    def setup(self, A, x=None):
        meta = self.meta
        ha = self.host_arrays
        sh1 = NamedSharding(meta.mesh, P(meta.axes))
        sh2 = NamedSharding(meta.mesh, P(meta.axes, None))
        sh3 = NamedSharding(meta.mesh, P(meta.axes, None, None))
        state = {
            "cols": jax.device_put(jnp.asarray(ha["cols"]), sh2),
            "ghost_cols": jax.device_put(jnp.asarray(ha["ghost_cols"]), sh3),
            "dofs_win": jax.device_put(jnp.asarray(ha["dofs_win"]), sh3),
            "dofs_glob": jax.device_put(jnp.asarray(ha["dofs_glob"]), sh3),
            "send": tuple(
                jax.device_put(jnp.asarray(t), sh2) for t in ha["send"]
            ),
            "w": jax.device_put(jnp.asarray(ha["w"]), sh1),
            "uncov": jax.device_put(jnp.asarray(ha["uncov"]), sh1),
        }
        return self._refresh(state, A)

    def _local_values(self, leaf_vals):
        meta = self.meta
        blocks = []
        for f, lids in enumerate(meta.rows):
            parts = [leaf_vals[lid] for lid in lids]
            blk = parts[0] if len(parts) == 1 else jnp.concatenate(parts, 1)
            if blk.shape[1] < meta.width:
                blk = jnp.pad(blk, ((0, 0), (0, meta.width - blk.shape[1])))
            blocks.append(blk)
        return jnp.concatenate(blocks, axis=0)

    def update(self, state, A, x=None):
        return self._refresh(state, A)

    def _refresh(self, state, A):
        meta = self.meta
        axes, M, L = meta.axes, meta.M, meta.L
        perms = meta.perms()
        ndir = len(meta.dirs)
        leaf_vals = [leaf.values for _, _, leaf in iter_field_leaves(A)]

        def local(cols, gcols, dwin, dglob, *rest):
            tbls, lv = rest[:ndir], rest[ndir:]
            vals_loc = self._local_values(lv)            # (M, Kw)
            slabs = [vals_loc]
            for tbl, perm in zip(tbls, perms):
                slabs.append(jax.lax.ppermute(vals_loc[tbl[0]], axes, perm))
            vals_win = jnp.concatenate(slabs) if ndir else vals_loc
            cols_win = jnp.concatenate([cols, gcols[0]]) if ndir else cols
            dwin, dglob = dwin[0], dglob[0]
            safe = jnp.minimum(dwin, L - 1)
            row_vals = vals_win[safe]                    # (npp, k, Kw)
            row_cols = cols_win[safe]
            match = row_cols[:, :, None, :] == dglob[:, None, :, None]
            Ap = jnp.sum(
                jnp.where(match, row_vals[:, :, None, :], 0.0), axis=-1
            )
            valid = dglob >= 0
            vi = valid[:, :, None] & valid[:, None, :]
            eye = jnp.eye(meta.k, dtype=vals_loc.dtype)[None]
            Ap = jnp.where(vi, Ap, eye)
            # explicit batched inverse: apply-time solve = one product
            inv = jnp.linalg.inv(Ap)
            own_glob = (
                jax.lax.axis_index(axes).astype(cols.dtype) * M
                + jax.lax.broadcasted_iota(cols.dtype, (M, 1), 0)
            )
            dloc = jnp.sum(jnp.where(cols == own_glob, vals_loc, 0.0), axis=1)
            return inv[None], dloc

        # jit: run eagerly, the shard_map would dispatch (and compile)
        # each of its primitives on its own
        inv, diag = jax.jit(jax.shard_map(
            local,
            mesh=meta.mesh,
            in_specs=(
                P(axes, None),
                P(axes, None, None),
                P(axes, None, None),
                P(axes, None, None),
            )
            + tuple(P(axes, None) for _ in state["send"])
            + tuple(P(axes, None) for _ in leaf_vals),
            out_specs=(
                P(axes, None, None, None),
                P(axes),
            ),
        ))(
            state["cols"], state["ghost_cols"], state["dofs_win"],
            state["dofs_glob"], *state["send"], *leaf_vals,
        )

        new = dict(state)
        new.update(
            {
                "A": A,
                "inv": inv,
                "uncovered_inv_diag": jnp.where(
                    state["uncov"] & self.jacobi_uncovered,
                    1.0 / jnp.where(diag == 0, 1.0, diag),
                    0.0,
                ),
            }
        )
        return new

    def apply(self, state, r):
        meta = self.meta
        axes, M, L = meta.axes, meta.M, meta.L
        m, soff = meta.m, meta.soff
        perms = meta.perms()
        perms_rev = [tuple((b, a) for a, b in p) for p in perms]
        ndir = len(meta.dirs)
        dir_widths = meta.dir_widths
        overlap = self.weighting == "overlap"
        r_leaves = jax.tree_util.tree_leaves(r)

        def local(dwin, inv, w, inv_diag, *rest):
            tbls, rl = rest[:ndir], rest[ndir:]
            r_loc = jnp.concatenate(rl, axis=0)          # (M,)
            slabs = [r_loc]
            for tbl, perm in zip(tbls, perms):
                slabs.append(jax.lax.ppermute(r_loc[tbl[0]], axes, perm))
            r_win = jnp.concatenate(slabs) if ndir else r_loc
            r_win1 = jnp.concatenate([r_win, jnp.zeros((1,), r_win.dtype)])
            dwin = dwin[0]
            rp = r_win1[jnp.minimum(dwin, L)]            # sentinel -> 0
            dxp = jnp.einsum(
                "pij,pj->pi", inv[0], rp, preferred_element_type=rp.dtype,
                precision="highest",
            )
            dxp = jnp.where(dwin != L, dxp, 0.0)
            ze = jnp.zeros((L + 1,), r_win.dtype).at[dwin.reshape(-1)].add(
                dxp.reshape(-1)
            )
            own = ze[:M]
            off = M
            for tbl, wd, prm in zip(tbls, dir_widths, perms_rev):
                back = jax.lax.ppermute(ze[off : off + wd], axes, prm)
                own = own.at[tbl[0]].add(back)
                off += wd
            z = own * w if overlap else own
            z = z + inv_diag * r_loc
            return tuple(z[soff[f] : soff[f] + m[f]] for f in range(len(m)))

        parts = jax.shard_map(
            local,
            mesh=meta.mesh,
            in_specs=(
                P(axes, None, None),
                P(axes, None, None, None),
                P(axes),
                P(axes),
            )
            + tuple(P(axes, None) for _ in state["send"])
            + tuple(P(axes) for _ in r_leaves),
            out_specs=tuple(P(axes) for _ in m),
        )(
            state["dofs_win"], state["inv"], state["w"],
            state["uncovered_inv_diag"], *state["send"], *r_leaves,
        )
        z = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(r),
            [self.omega * p for p in parts],
        )
        return z

    def smooth(self, state, x, r):
        dx = self.apply(state, r)
        x = pt.add(x, dx)
        r = pt.sub(r, state["A"].matvec(dx))
        return x, r

    def solve(self, state, b, x0=None):
        x = pt.zeros_like(b) if x0 is None else x0
        r = pt.sub(b, state["A"].matvec(x))
        x, _ = self.smooth(state, x, r)
        return x, None


def make_dist_vanka_nd(
    A_dist,
    parts,
    topo,
    omega: float = 1.0,
    weighting: str = "overlap",
) -> DistVankaNDSolver:
    """Distributed Vanka for a box-partitioned block system: pass the
    DISTRIBUTED operator (DistGraphELL leaves), the per-field
    BoxPartitions, and a PatchTopology over the real field-major dofs."""
    meta, arrays = build_dist_vanka_nd(A_dist, tuple(parts), topo)
    return DistVankaNDSolver(
        meta=meta, host_arrays=arrays, omega=omega, weighting=weighting
    )
