"""Patch-based smoothers as batched dense kernels.

Redesign of the reference's PatchBasedSmoothers
(src/PatchBasedSmoothers/PatchSolvers.jl, BlockJacobiSolvers.jl): the
reference loops patches, LU-factorizing each little matrix with lazy_map
and gather/ldiv!/scatter per patch (PatchSolvers.jl:227-277). Here all
patches have one padded width, so the whole smoother is three batched ops:

    gather   (n_patches, k)        <- r[patch_dofs]
    solve    (n_patches, k, k) batched explicit-inverse matvec
    scatter-add with overlap weights -> additive Schwarz over patches

Patch matrices are extracted from the assembled operator (the reference's
BlockJacobiSolver matrix-extraction approach, BlockJacobiSolvers.jl:67-84)
— works for StencilMatrix, ELLMatrix and concatenated block systems, and
re-extraction at a new Newton iterate is just re-running the same gather
(numerical_setup! analog).
"""
from __future__ import annotations

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np

from ..interfaces import Smoother
from ..utils import pytrees as pt
from .topology import PatchTopology


def _extend(v: jnp.ndarray) -> jnp.ndarray:
    """Append the dummy slot (one zero) to a flat vector."""
    return jnp.concatenate([v, jnp.zeros((1,), v.dtype)])


def extract_patch_matrices_ell(A, dofs: np.ndarray, dummy: int) -> jnp.ndarray:
    """(n_patches, k, k) dense patch matrices from an ELLMatrix.

    A_p[p, i, j] = A[dofs[p,i], dofs[p,j]]; padded slots get identity."""
    vals, cols = A.values, A.cols
    d = jnp.asarray(dofs)
    K = vals.shape[1]
    # rows of each patch dof: (np, k, K)
    safe = jnp.minimum(d, vals.shape[0] - 1)
    row_vals = vals[safe]            # (np, k, K)
    row_cols = cols[safe]            # (np, k, K)
    match = row_cols[:, :, None, :] == d[:, None, :, None]  # (np,k,k,K)
    Ap = jnp.sum(jnp.where(match, row_vals[:, :, None, :], 0.0), axis=-1)
    valid = d != dummy
    vi = valid[:, :, None] & valid[:, None, :]
    eye = jnp.eye(d.shape[1], dtype=vals.dtype)[None]
    return jnp.where(vi, Ap, eye)


def extract_patch_matrices_stencil(A, dofs: np.ndarray, dummy: int) -> jnp.ndarray:
    """Patch matrices from a StencilMatrix via its banded ELL view."""
    from ..algebra.ell import ELLMatrix
    from ..algebra.ell_view import ell_view

    ell, _, _ = ell_view(A)
    return extract_patch_matrices_ell(ell, dofs, dummy)


@dataclasses.dataclass(frozen=True, eq=False)
class PatchSolver(Smoother):
    """Overlapping additive-Schwarz patch smoother on a flat-vector operator
    (reference PatchSolvers.jl solve_patch_overlapping!:227-277).

    weighting: 'unit' (plain scatter-add, reference overlapping behavior),
    'overlap' (divide by patch multiplicity), or 'nonoverlapping' (each
    dof written by exactly one patch — the reference's
    solve_patch_nonoverlapping!, last patch wins). omega damps the update.
    """

    topo: PatchTopology
    omega: float = 1.0
    weighting: str = "unit"
    # kept for API compatibility; both paths now materialize explicit
    # patch inverses (see _refresh note)
    spd: bool = True

    def setup(self, A, x=None):
        """Host-side pattern work happens once here; `update` (the per-
        Newton numerical_setup! analog) is pure device work."""
        from ..algebra.ell_view import ell_pattern

        meta, ell_cols, leaf_masks = ell_pattern(A)
        state = {
            "meta": meta,            # static (no-leaf pytree)
            "ell_cols": ell_cols,
            "leaf_masks": leaf_masks,
            "dofs": jnp.asarray(self.topo.dofs),
            "uncov": jnp.asarray(
                self.topo.overlap_counts()[: self.topo.n_dofs] == 0
            ),
        }
        if self.weighting == "overlap":
            w = 1.0 / np.maximum(self.topo.overlap_counts(), 1.0)
            state["wdof"] = jnp.asarray(w)
        elif self.weighting == "nonoverlapping":
            state["wslot"] = jnp.asarray(self.topo.owner_slot_mask())
        return self._refresh(state, A)

    def update(self, state, A, x=None):
        """Re-extract + re-factorize, fully jittable (reference
        PatchSolvers.jl numerical_setup! re-assembly)."""
        return self._refresh(state, A)

    def _refresh(self, state, A):
        from ..algebra.ell import ELLMatrix
        from ..algebra.ell_view import ell_values

        meta = state["meta"]
        vals = ell_values(A, meta, state["leaf_masks"])
        ell = ELLMatrix(vals, state["ell_cols"], meta.n_cols)
        Ap = extract_patch_matrices_ell(ell, state["dofs"], self.topo.dummy)
        new = dict(state)
        # EXPLICIT batched inverses, not factorizations: the apply-time
        # solve becomes one batched (np,k,k)@(np,k) product instead of
        # batched triangular solves;
        # patch blocks are small and well-conditioned, so the inverse is
        # numerically safe and setup-time-only.
        new["inv"] = jnp.linalg.inv(Ap)
        # dofs not covered by any patch (e.g. eliminated Dirichlet rows with
        # identity diagonal) get a point-Jacobi update so the smoother's
        # error propagation covers the whole space
        new["uncovered_inv_diag"] = jnp.where(
            state["uncov"], 1.0 / A.diag(), 0.0
        )
        new["A"] = A
        return new

    def _patch_solve(self, state, rp):
        # batched dense solve via precomputed inverse: one batched product
        return jnp.einsum(
            "pij,pj->pi", state["inv"], rp,
            preferred_element_type=rp.dtype, precision="highest",
        )

    def apply(self, state, r):
        dofs = state["dofs"]
        re = _extend(r)
        rp = re[dofs]                       # gather (np, k)
        valid = dofs != self.topo.dummy
        rp = jnp.where(valid, rp, 0.0)
        dxp = self._patch_solve(state, rp)
        dxp = jnp.where(valid, dxp, 0.0)
        if self.weighting == "nonoverlapping":
            dxp = dxp * state["wslot"]
        z = jnp.zeros_like(re).at[dofs.reshape(-1)].add(
            dxp.reshape(-1)
        )[: r.shape[0]]
        if self.weighting == "overlap":
            z = z * state["wdof"][: r.shape[0]]
        z = z + state["uncovered_inv_diag"] * r
        return self.omega * z

    def smooth(self, state, x, r):
        dx = self.apply(state, r)
        x = x + dx
        r = r - state["A"].matvec(dx)
        return x, r

    def solve(self, state, b, x0=None):
        x = pt.zeros_like(b) if x0 is None else x0
        r = b - state["A"].matvec(x)
        x, _ = self.smooth(state, x, r)
        return x, None
