"""Vanka (block-Jacobi) smoother for mixed saddle-point systems.

Analog of the reference's BlockJacobiSolver (ex-VankaSolver,
src/PatchBasedSmoothers/BlockJacobiSolvers.jl:2-43,111-170): patches seeded
at the dofs of one field (pressure), each patch containing the seed dof plus
every dof it couples to through the off-diagonal blocks; patch matrices are
EXTRACTED from the assembled block system (not reassembled), LU-factorized,
and applied as batched overlapping solves with scatter-add.

The reference needs a distributed ghost-row fetch (PAExtras.jl:9-110) so
every owned patch sees complete rows; here the sharded arrays already
expose a global view — XLA materializes whatever remote rows the gathers
touch, so the fetch machinery disappears.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..algebra.convert import to_scipy
from ..algebra.ell import ELLMatrix
from ..algebra.ell_view import ell_pattern, ell_values
from ..interfaces import Smoother
from ..utils import pytrees as pt
from .smoothers import extract_patch_matrices_ell
from .topology import PatchTopology


def vanka_patches(A, seed_field: int = -1) -> PatchTopology:
    """Build Vanka patches from an assembled BlockOperator: one patch per
    row of the seed field (default: last = pressure), containing that dof
    and all dofs coupled through the seed field's block row (host-side)."""
    S = to_scipy(A)  # full system
    # field sizes from the block structure
    sizes = _field_sizes(A)
    offs = np.cumsum([0] + sizes)
    if seed_field < 0:
        seed_field = len(sizes) + seed_field
    lo, hi = offs[seed_field], offs[seed_field + 1]

    Sc = S.tocsr()
    n_total = S.shape[0]
    dummy = n_total
    from ..native import union_patches

    table = union_patches(Sc.indptr, Sc.indices, int(lo), int(hi), dummy)
    return PatchTopology(dofs=table, dummy=dummy, n_dofs=n_total)


def _field_sizes(A) -> list:
    """Leaf field sizes of the block system in flatten order."""
    from ..algebra.block import BlockOperator, FieldwiseOperator

    sizes = []
    n = len(A.blocks)
    for i in range(n):
        diag = A.blocks[i][i]
        if isinstance(diag, FieldwiseOperator):
            sizes.extend(o.shape[0] for o in diag.ops)
            continue
        if diag is not None and hasattr(diag, "shape"):
            sizes.append(diag.shape[0])
            continue
        # empty diagonal (e.g. Stokes pressure block): infer from couplings
        size = None
        for j in range(n):
            blk = A.blocks[i][j]
            if blk is not None and hasattr(blk, "shape"):
                size = blk.shape[0]
                break
        if size is None:
            for j in range(n):
                blk = A.blocks[j][i]
                if blk is not None and hasattr(blk, "shape"):
                    size = blk.shape[1]
                    break
        assert size is not None, f"cannot infer size of block field {i}"
        sizes.append(size)
    return sizes


from ..utils.pytrees import flatten_concat as _flatten
from ..utils.pytrees import unflatten_like as _unflatten


@dataclasses.dataclass(frozen=True, eq=False)
class VankaSolver(Smoother):
    """Batched overlapping Vanka smoother over a BlockOperator system."""

    topo: PatchTopology = None
    omega: float = 1.0
    weighting: str = "overlap"
    seed_field: int = -1
    # point-Jacobi fallback on dofs no patch covers (Dirichlet identity
    # rows). Disable when the solver is used as a patch CORRECTION that
    # must leave non-patch dofs untouched (patch prolongations).
    jacobi_uncovered: bool = True

    def setup(self, A, x=None):
        """Host-side pattern construction happens ONCE here; every later
        `update` (the per-Newton numerical_setup! analog) is pure device
        work — see _refresh."""
        topo = self.topo if self.topo is not None else vanka_patches(
            A, self.seed_field
        )
        meta, ell_cols, leaf_masks = ell_pattern(A)
        state = {
            "dofs": jnp.asarray(topo.dofs),
            "meta": meta,                  # static (no-leaf pytree)
            "ell_cols": ell_cols,
            "leaf_masks": leaf_masks,
            "uncov": jnp.asarray(topo.overlap_counts()[: topo.n_dofs] == 0),
        }
        if self.weighting == "overlap":
            state["wdof"] = jnp.asarray(
                1.0 / np.maximum(topo.overlap_counts(), 1.0)
            )
        return self._refresh(state, A)

    def update(self, state, A, x=None):
        """Re-extract + re-factorize at the new Jacobian, fully jittable
        (reference BlockJacobiSolvers.jl:141-170 numerical_setup!)."""
        return self._refresh(state, A)

    def _refresh(self, state, A):
        meta = state["meta"]
        vals = ell_values(A, meta, state["leaf_masks"])
        ell = ELLMatrix(vals, state["ell_cols"], meta.n_cols)
        Ap = extract_patch_matrices_ell(ell, state["dofs"], meta.n_rows)
        # explicit batched patch inverses: apply becomes one batched
        # product instead of batched triangular solves (see
        # PatchSolver._refresh note)
        inv = jnp.linalg.inv(Ap)
        # uncovered dofs (eliminated Dirichlet identity rows): point-Jacobi
        diag = ell.diag()
        uncovered_inv_diag = jnp.where(
            state["uncov"] & self.jacobi_uncovered,
            1.0 / jnp.where(diag == 0, 1.0, diag),
            0.0,
        )
        new = dict(state)
        new.update(
            {"A": A, "inv": inv,
             "uncovered_inv_diag": uncovered_inv_diag}
        )
        return new

    def apply(self, state, r):
        flat, info = _flatten(r)
        re = jnp.concatenate([flat, jnp.zeros((1,), flat.dtype)])
        dofs = state["dofs"]
        valid = dofs != (re.shape[0] - 1)
        rp = jnp.where(valid, re[dofs], 0.0)
        dxp = jnp.einsum(
            "pij,pj->pi", state["inv"], rp,
            preferred_element_type=rp.dtype, precision="highest",
        )
        dxp = jnp.where(valid, dxp, 0.0)
        z = jnp.zeros_like(re).at[dofs.reshape(-1)].add(dxp.reshape(-1))
        z = z[:-1]
        if self.weighting == "overlap":
            z = z * state["wdof"][:-1]
        z = z + state["uncovered_inv_diag"] * flat
        return _unflatten(self.omega * z, info)

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


# Reference naming alias (BlockJacobiSolver == matrix-extracted Vanka)
BlockJacobiSolver = VankaSolver
