"""Materialized (assembled) Vanka smoother.

The batched Vanka apply — gather r over patch dofs, per-patch dense
solve, scatter-add — is a LINEAR map in r. For linear problems its patch
inverses are fixed after setup, so the whole smoother can be assembled
ONCE into one sparse matrix

    M_vanka = omega * ( W  Σ_p  S_p A_p^{-1} R_p  +  diag(uncovered) )

and each application becomes ONE SpMV (per-field ELL blocks, see
algebra/flat.py) instead of a gather + batched solve + scatter-add per
patch.

Reference counterpart: BlockJacobiSolvers.jl's matrix-extracted patch
solves (src/PatchBasedSmoothers/BlockJacobiSolvers.jl:111-170) —
algebraically identical, with the patch loop folded into the matrix at
numerical-setup time.

Nonlinear (per-Newton) refresh is JIT-TRACEABLE: the assembled matrix's
sparsity is determined by the patch topology alone, so setup records a
static scatter plan — (patch, i, j) gather indices into the batched
patch inverses, per-block segment ids into each block's ELL slot layout
— and `update` recomputes the batched inverses (VankaSolver._refresh,
already traceable), and segment-sums them into the ELL values of the
pattern. One-SpMV smoothing inside the device Newton loop.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from ..algebra.ell import ell_from_scipy
from ..interfaces import Smoother
from ..utils import pytrees as pt
from ..utils.pytrees import flatten_concat, unflatten_like
from .topology import PatchTopology
from .vanka import VankaSolver


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True)
class _PlanMeta:
    """Static half of the refresh scatter plan: per nonzero block
    (i, j, n_b, K_b). The index ARRAYS travel as ordinary pytree leaves
    in the state dict (as device arguments — closing over them as
    static would bake MB-scale HLO constants into every compile)."""

    blocks: tuple  # of (i, j, n_b, K_b) int tuples


def materialize_vanka(
    vanka: VankaSolver, state: dict, n: int
) -> sp.csr_matrix:
    """Assemble the additive-Schwarz patch-solve map of a set-up
    VankaSolver into one scipy CSR (host-side)."""
    dofs = np.asarray(state["dofs"])
    inv = np.asarray(state["inv"])                    # (np, k, k)
    valid = dofs != n  # VankaSolver's dummy slot is always n (vanka.py)
    rows = np.broadcast_to(dofs[:, :, None], inv.shape)
    cols = np.broadcast_to(dofs[:, None, :], inv.shape)
    m = valid[:, :, None] & valid[:, None, :]
    M = sp.coo_matrix(
        (inv[m], (rows[m], cols[m])), shape=(n, n)
    ).tocsr()                                          # overlaps ADD
    if vanka.weighting == "overlap":
        M = sp.diags(np.asarray(state["wdof"])[:n]) @ M
    M = M + sp.diags(np.asarray(state["uncovered_inv_diag"])[:n])
    return (vanka.omega * M).tocsr()


@dataclasses.dataclass(frozen=True, eq=False)
class MaterializedVankaSmoother(Smoother):
    """VankaSolver-equivalent smoother whose apply is one SpMV.

    Same constructor surface as VankaSolver (topo/omega/weighting/
    jacobi_uncovered). setup is host-side; update is jit-traceable."""

    topo: PatchTopology = None
    omega: float = 1.0
    weighting: str = "overlap"  # same default as VankaSolver
    seed_field: int = -1
    jacobi_uncovered: bool = True

    def _vanka(self) -> VankaSolver:
        return VankaSolver(
            topo=self.topo,
            omega=self.omega,
            weighting=self.weighting,
            seed_field=self.seed_field,
            jacobi_uncovered=self.jacobi_uncovered,
        )

    def setup(self, A, x=None):
        """Host-side: assemble M_vanka, cut per-field ELL blocks (see
        algebra/flat.py), and record the STATIC scatter plan that makes
        `update` a pure device computation."""
        from ..algebra.flat import blocked_kernel_from_scipy

        inner = getattr(A, "inner", A)
        vanka = self._vanka()
        vst = vanka.setup(inner)
        n = int(np.asarray(vst["uncovered_inv_diag"]).shape[0])
        dt = np.asarray(vst["uncovered_inv_diag"]).dtype
        sizes = vst["meta"].row_sizes

        # ---- static stream: (p, i, j) -> (row, col) coo entries, plus
        # one diagonal slot per dof (uncovered point-Jacobi)
        dofs = np.asarray(vst["dofs"])
        valid = dofs != n
        pp, ii, jj = np.nonzero(valid[:, :, None] & valid[:, None, :])
        rows = dofs[pp, ii]
        cols = dofs[pp, jj]
        w_coo = (
            np.asarray(vst["wdof"])[rows]
            if self.weighting == "overlap"
            else np.ones(len(rows), dtype=dt)
        ).astype(dt)
        drow = np.arange(n)
        all_rows = np.concatenate([rows, drow])
        all_cols = np.concatenate([cols, drow])

        # assembled values at the current state (duplicates sum; explicit
        # zeros KEPT — the refresh pattern contract)
        inv0 = np.asarray(vst["inv"])
        data0 = np.concatenate(
            [
                inv0[pp, ii, jj] * w_coo,
                np.asarray(vst["uncovered_inv_diag"]),
            ]
        )
        M_sp = sp.coo_matrix(
            (self.omega * data0, (all_rows, all_cols)), shape=(n, n)
        ).tocsr()
        M_sp.sum_duplicates()
        M_sp.sort_indices()

        Mop = blocked_kernel_from_scipy(
            M_sp, sizes, dtype=dt, refreshable=True
        )

        # ---- per-stream-entry destination: block id + flat ELL slot.
        # ell_from_scipy packs row entries in CSR (sorted-column) order,
        # so slot-of-(r,c) = position of c within the block CSR row.
        offs = np.cumsum([0] + list(sizes))
        bi = np.searchsorted(offs, all_rows, side="right") - 1
        bj = np.searchsorted(offs, all_cols, side="right") - 1
        nf = len(sizes)
        plan = []  # (i, j, sel_idx, seg_ids, n_b, K_b) per nonzero block
        for i in range(nf):
            for j in range(nf):
                if Mop.kblocks[i][j] is None:
                    continue
                blk = M_sp[offs[i]:offs[i + 1], offs[j]:offs[j + 1]].tocsr()
                blk.sort_indices()
                K_b = int(np.diff(blk.indptr).max())
                sel = np.nonzero((bi == i) & (bj == j))[0]
                r_l = all_rows[sel] - offs[i]
                c_l = all_cols[sel] - offs[j]
                # vectorized (row, col) -> CSR entry: keys sorted by
                # (row, col) == CSR storage order after sort_indices
                ncb = blk.shape[1]
                blk_rows = np.repeat(
                    np.arange(blk.shape[0]), np.diff(blk.indptr)
                )
                blk_keys = blk_rows.astype(np.int64) * ncb + blk.indices
                keys = r_l.astype(np.int64) * ncb + c_l
                pos_abs = np.searchsorted(blk_keys, keys)
                assert (
                    pos_abs < len(blk_keys)
                ).all() and np.array_equal(
                    blk_keys[pos_abs], keys
                ), "materialized refresh: pattern slot missing"
                seg = r_l * K_b + (pos_abs - blk.indptr[r_l])
                plan.append(
                    (
                        (i, j, int(blk.shape[0]), K_b),
                        jnp.asarray(sel.astype(np.int32)),
                        jnp.asarray(seg.astype(np.int32)),
                    )
                )
        return {
            "A": A,
            "Mv": Mop,
            "vst": vst,
            "w_coo": jnp.asarray(w_coo),
            "idx": (
                jnp.asarray(pp.astype(np.int32)),
                jnp.asarray(ii.astype(np.int32)),
                jnp.asarray(jj.astype(np.int32)),
            ),
            "plan_meta": _PlanMeta(tuple(m for m, _, _ in plan)),
            "plan_sel": tuple(s for _, s, _ in plan),
            "plan_seg": tuple(g for _, _, g in plan),
        }

    def update(self, state, A, x=None):
        """Jit-traceable numerical_setup!: new batched patch inverses ->
        static segment-sum into the assembled ELL pattern. Falls back to full host setup when the state
        predates the refresh plan."""
        if "plan_meta" not in state:
            return self.setup(A, x)
        inner = getattr(A, "inner", A)
        vanka = self._vanka()
        vst = vanka.update(state["vst"], inner)
        inv = vst["inv"]
        pp, ii, jj = state["idx"]
        stream = jnp.concatenate(
            [
                inv[pp, ii, jj] * state["w_coo"],
                vst["uncovered_inv_diag"],
            ]
        )
        om = jnp.asarray(self.omega, stream.dtype)
        kb = [list(row) for row in state["Mv"].kblocks]
        for (i, j, n_b, K_b), sel, seg in zip(
            state["plan_meta"].blocks, state["plan_sel"], state["plan_seg"]
        ):
            vals = om * jax.ops.segment_sum(
                stream[sel], seg, num_segments=n_b * K_b
            ).reshape(n_b, K_b)
            blk = kb[i][j]
            kb[i][j] = dataclasses.replace(
                blk, values=vals.astype(blk.values.dtype)
            )
        Mop = dataclasses.replace(
            state["Mv"], kblocks=tuple(tuple(r) for r in kb)
        )
        new = dict(state)
        new.update({"A": A, "Mv": Mop, "vst": vst})
        return new

    def apply(self, state, r):
        return state["Mv"].matvec(r)

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
