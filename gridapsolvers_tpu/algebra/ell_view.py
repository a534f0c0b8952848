"""Jittable ELL views of composite operators.

The reference refreshes matrix-extracted patch solvers per Newton step with
`numerical_setup!` re-copying values out of the assembled PSparseMatrix
(src/PatchBasedSmoothers/BlockJacobiSolvers.jl:141-170). Here the refresh
runs inside the device Newton loop, so the extraction must run entirely
under jit. The split is the usual one:

  - `ell_pattern(A)`  (host, once at setup): the SPARSITY of the flattened
    system — global padded-ELL column table, field offsets, per-leaf widths.
    Depends only on the operator's structure, which is static across Newton
    steps.
  - `ell_values(A, meta, leaf_masks)`  (jittable, per refresh): re-assemble
    the global ELL VALUES from the current operator's arrays with pure
    concatenation/padding — no gathers, no host.

Supported leaves: ELLMatrix, StencilMatrix (via a static-validity banded
view). Supported composites: BlockOperator (nested), FieldwiseOperator,
ColumnStack, RowStack, None blocks.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .block import BlockOperator, ColumnStack, FieldwiseOperator, RowStack
from .ell import ELLMatrix
from .stencil import StencilMatrix


# ---------------------------------------------------------------------------
# field-leaf traversal (deterministic order shared by pattern & values)
# ---------------------------------------------------------------------------


def _is_leaf(op) -> bool:
    from ..parallel.dist_ell import DistELLMatrix
    from ..parallel.dist_ell_nd import DistGraphELL

    return isinstance(
        op, (ELLMatrix, StencilMatrix, DistELLMatrix, DistGraphELL)
    )


def _row_fields(op) -> int:
    if op is None:
        return 0
    if _is_leaf(op):
        return 1
    if isinstance(op, FieldwiseOperator):
        return len(op.ops)
    if isinstance(op, ColumnStack):
        return len(op.ops)
    if isinstance(op, RowStack):
        return 1
    if isinstance(op, BlockOperator):
        return sum(_block_row_fields(op))
    raise TypeError(f"ell_view: unsupported operator {type(op)}")


def _col_fields(op) -> int:
    if op is None:
        return 0
    if _is_leaf(op):
        return 1
    if isinstance(op, FieldwiseOperator):
        return len(op.ops)
    if isinstance(op, ColumnStack):
        return 1
    if isinstance(op, RowStack):
        return len(op.ops)
    if isinstance(op, BlockOperator):
        return sum(_block_col_fields(op))
    raise TypeError(f"ell_view: unsupported operator {type(op)}")


def _block_row_fields(op: BlockOperator) -> List[int]:
    n = len(op.blocks)
    out = []
    for i in range(n):
        c = max(
            (_row_fields(b) for b in op.blocks[i] if b is not None), default=0
        )
        if c == 0:
            # empty diagonal row (e.g. Stokes pressure): look at the column
            c = max(
                (_col_fields(op.blocks[j][i]) for j in range(n)
                 if op.blocks[j][i] is not None),
                default=1,
            )
        out.append(c)
    return out


def _block_col_fields(op: BlockOperator) -> List[int]:
    n = len(op.blocks)
    out = []
    for j in range(n):
        c = max(
            (_col_fields(op.blocks[i][j]) for i in range(n)
             if op.blocks[i][j] is not None),
            default=0,
        )
        if c == 0:
            c = max(
                (_row_fields(op.blocks[j][i]) for i in range(n)
                 if op.blocks[j][i] is not None),
                default=1,
            )
        out.append(c)
    return out


def iter_field_leaves(op, fi: int = 0, fj: int = 0):
    """Yield (field_row, field_col, leaf) in deterministic order."""
    if op is None:
        return
    if _is_leaf(op):
        yield (fi, fj, op)
        return
    if isinstance(op, FieldwiseOperator):
        for k, o in enumerate(op.ops):
            yield from iter_field_leaves(o, fi + k, fj + k)
        return
    if isinstance(op, ColumnStack):
        for k, o in enumerate(op.ops):
            yield from iter_field_leaves(o, fi + k, fj)
        return
    if isinstance(op, RowStack):
        for k, o in enumerate(op.ops):
            yield from iter_field_leaves(o, fi, fj + k)
        return
    if isinstance(op, BlockOperator):
        rf = np.cumsum([0] + _block_row_fields(op))
        cf = np.cumsum([0] + _block_col_fields(op))
        for i, row in enumerate(op.blocks):
            for j, b in enumerate(row):
                yield from iter_field_leaves(b, fi + int(rf[i]), fj + int(cf[j]))
        return
    raise TypeError(f"ell_view: unsupported operator {type(op)}")


# ---------------------------------------------------------------------------
# stencil banded view (static validity, jittable values)
# ---------------------------------------------------------------------------


def stencil_cols_valid(A: StencilMatrix) -> Tuple[np.ndarray, np.ndarray]:
    """Static (cols, valid) tables of a StencilMatrix's banded sparsity:
    cols[i, s] = flat index of grid point i + offsets[s] (0 where the
    neighbor falls outside the grid, marked invalid)."""
    gs = A.grid_shape
    coords = np.meshgrid(*[np.arange(m) for m in gs], indexing="ij")
    strides = np.cumprod([1] + list(gs[::-1]))[:-1][::-1]
    cols = np.zeros((A.n, len(A.offsets)), dtype=np.int32)
    valid = np.zeros((A.n, len(A.offsets)), dtype=bool)
    for s, off in enumerate(A.offsets):
        ok = np.ones(gs, dtype=bool)
        for d in range(len(gs)):
            c = coords[d] + off[d]
            ok &= (c >= 0) & (c < gs[d])
        nb = sum(
            np.clip(coords[d] + off[d], 0, gs[d] - 1) * strides[d]
            for d in range(len(gs))
        )
        # invalid (out-of-grid) slots carry value 0 and must point at the
        # row ITSELF: any other target (e.g. column 0) gives the flattened
        # ELL pattern unbounded column offsets d = col - row, so padding
        # gathers would read far from the row's own x entries
        self_idx = np.arange(cols.shape[0], dtype=np.int64).reshape(gs)
        cols[:, s] = np.where(ok, nb, self_idx).reshape(-1)
        valid[:, s] = ok.reshape(-1)
    return cols, valid


def stencil_values(A: StencilMatrix, valid: jnp.ndarray) -> jnp.ndarray:
    """Jittable (n, n_offsets) banded values aligned with stencil_cols_valid."""
    vals = A.bands.reshape(A.bands.shape[0], -1).T
    return jnp.where(valid, vals, 0.0)


# ---------------------------------------------------------------------------
# global pattern + values
# ---------------------------------------------------------------------------


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True)
class ELLPatternMeta:
    """Static structure of the flattened system (a no-leaf pytree, safe to
    carry inside solver state dicts under jit)."""

    n_rows: int
    n_cols: int
    width: int
    row_sizes: Tuple[int, ...]
    rows: Tuple[Tuple[int, ...], ...]   # leaf ids per field row (concat order)
    leaf_widths: Tuple[int, ...]
    leaf_kinds: Tuple[str, ...]          # 'ell' | 'stencil'


def ell_pattern(A):
    """Host-side, once: returns (meta, cols, leaf_masks).

    cols       : (n_rows, width) int32 global padded column table (device)
    leaf_masks : tuple aligned with leaf order; validity mask array for
                 stencil leaves, None for ELL leaves (goes into solver state)
    """
    leaves = list(iter_field_leaves(A))
    nf_r = max(fi for fi, _, _ in leaves) + 1
    nf_c = max(fj for _, fj, _ in leaves) + 1

    row_sizes = [0] * nf_r
    col_sizes = [0] * nf_c
    for fi, fj, leaf in leaves:
        row_sizes[fi] = int(leaf.shape[0])
        col_sizes[fj] = int(leaf.shape[1])
    assert all(s > 0 for s in row_sizes), "uncovered field row"
    assert all(s > 0 for s in col_sizes), "uncovered field col"
    row_offs = np.cumsum([0] + row_sizes)
    col_offs = np.cumsum([0] + col_sizes)
    n_rows = int(row_offs[-1])
    n_cols = int(col_offs[-1])

    leaf_kinds, leaf_widths, leaf_masks = [], [], []
    leaf_cols = []
    for _, fj, leaf in leaves:
        if isinstance(leaf, ELLMatrix):
            leaf_kinds.append("ell")
            c = np.asarray(leaf.cols)
            leaf_masks.append(None)
        else:
            leaf_kinds.append("stencil")
            c, valid = stencil_cols_valid(leaf)
            leaf_masks.append(jnp.asarray(valid))
        leaf_widths.append(int(c.shape[1]))
        leaf_cols.append(c.astype(np.int64) + int(col_offs[fj]))

    rows: List[Tuple[int, ...]] = [tuple() for _ in range(nf_r)]
    for lid, (fi, _, _) in enumerate(leaves):
        rows[fi] = rows[fi] + (lid,)

    widths = [
        sum(leaf_widths[lid] for lid in rows[fi]) for fi in range(nf_r)
    ]
    K = max(widths)

    cols_np = np.zeros((n_rows, K), dtype=np.int64)
    for fi in range(nf_r):
        lo, hi = int(row_offs[fi]), int(row_offs[fi + 1])
        parts = [leaf_cols[lid] for lid in rows[fi]]
        if widths[fi] < K:
            # self-pointing padding (zero values added at assembly time)
            pad = np.broadcast_to(
                np.arange(lo, hi)[:, None] % n_cols,
                (hi - lo, K - widths[fi]),
            )
            parts.append(pad)
        cols_np[lo:hi] = np.concatenate(parts, axis=1)

    meta = ELLPatternMeta(
        n_rows=n_rows,
        n_cols=n_cols,
        width=K,
        row_sizes=tuple(row_sizes),
        rows=tuple(rows),
        leaf_widths=tuple(leaf_widths),
        leaf_kinds=tuple(leaf_kinds),
    )
    return meta, jnp.asarray(cols_np.astype(np.int32)), tuple(leaf_masks)


def ell_values(A, meta: ELLPatternMeta, leaf_masks) -> jnp.ndarray:
    """Jittable: global ELL values for the current operator A (same
    structure as at ell_pattern time)."""
    leaves = list(iter_field_leaves(A))
    vals = []
    for lid, (_, _, leaf) in enumerate(leaves):
        if meta.leaf_kinds[lid] == "ell":
            vals.append(leaf.values)
        else:
            vals.append(stencil_values(leaf, leaf_masks[lid]))

    nf_r = len(meta.rows)
    out_rows = []
    for fi in range(nf_r):
        parts = [vals[lid] for lid in meta.rows[fi]]
        block = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=1)
        if block.shape[1] < meta.width:
            block = jnp.pad(
                block, ((0, 0), (0, meta.width - block.shape[1]))
            )
        out_rows.append(block)
    return out_rows[0] if len(out_rows) == 1 else jnp.concatenate(out_rows, 0)


def rebuild_with_leaves(op, leaves_iter):
    """Reconstruct a composite operator with its leaves replaced, walking
    the same order as iter_field_leaves. leaves_iter yields replacements."""
    if op is None:
        return None
    if _is_leaf(op):
        return next(leaves_iter)
    if isinstance(op, FieldwiseOperator):
        return FieldwiseOperator(
            tuple(rebuild_with_leaves(o, leaves_iter) for o in op.ops)
        )
    if isinstance(op, ColumnStack):
        return ColumnStack(
            tuple(rebuild_with_leaves(o, leaves_iter) for o in op.ops)
        )
    if isinstance(op, RowStack):
        return RowStack(
            tuple(rebuild_with_leaves(o, leaves_iter) for o in op.ops)
        )
    if isinstance(op, BlockOperator):
        return BlockOperator(
            tuple(
                tuple(rebuild_with_leaves(b, leaves_iter) for b in row)
                for row in op.blocks
            )
        )
    raise TypeError(f"ell_view: unsupported operator {type(op)}")


def ell_view(A) -> Tuple[ELLMatrix, ELLPatternMeta, tuple]:
    """One-call setup helper: (flattened ELL, meta, leaf_masks)."""
    meta, cols, masks = ell_pattern(A)
    return (
        ELLMatrix(ell_values(A, meta, masks), cols, meta.n_cols),
        meta,
        masks,
    )
