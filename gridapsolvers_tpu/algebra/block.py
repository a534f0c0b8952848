"""Block operators for multiphysics (saddle-point) systems.

Replacement for the reference's BlockPRange / block PSparseMatrix
(BlockMultiFieldStyle assembly): a block operator is just an N x N grid of
per-field operators, and a block *vector* is a tuple of per-field arrays
(a pytree — so the Krylov drivers in linear/ work on it unchanged; see
utils/pytrees.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BlockOperator:
    """N x N block matrix; entries are operators with .matvec or None."""

    blocks: Tuple[Tuple[Optional[object], ...], ...]

    @property
    def nblocks(self) -> int:
        return len(self.blocks)

    def matvec(self, x: Sequence) -> Tuple:
        import jax

        out = []
        for i, row in enumerate(self.blocks):
            acc = None
            for j, blk in enumerate(row):
                if blk is None:
                    continue
                contrib = blk.matvec(x[j])
                acc = (
                    contrib
                    if acc is None
                    else jax.tree_util.tree_map(jnp.add, acc, contrib)
                )
            if acc is None:
                acc = jax.tree_util.tree_map(jnp.zeros_like, x[i])
            out.append(acc)
        return tuple(out)

    def diag(self) -> Tuple[jnp.ndarray, ...]:
        return tuple(row[i].diag() for i, row in enumerate(self.blocks))

    def block(self, i: int, j: int):
        return self.blocks[i][j]

    @property
    def dtype(self):
        for row in self.blocks:
            for blk in row:
                if blk is not None:
                    return blk.dtype
        raise ValueError("empty BlockOperator")

    def todense(self) -> jnp.ndarray:
        """Debug-only densification."""
        rows = []
        sizes = self._block_sizes()
        for i, row in enumerate(self.blocks):
            cols = []
            for j, blk in enumerate(row):
                if blk is None:
                    cols.append(jnp.zeros((sizes[i], sizes[j])))
                else:
                    cols.append(blk.todense())
            rows.append(jnp.concatenate(cols, axis=1))
        return jnp.concatenate(rows, axis=0)

    def _block_sizes(self):
        n = self.nblocks
        sizes = [None] * n
        for i, row in enumerate(self.blocks):
            for j, blk in enumerate(row):
                if blk is not None:
                    sizes[i] = blk.shape[0]
                    break
        return sizes


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ColumnStack:
    """Maps one field to a tuple of fields: y_i = ops[i] @ x.
    Used for e.g. the pressure -> velocity-components gradient coupling."""

    ops: Tuple[object, ...]

    def matvec(self, x):
        return tuple(op.matvec(x) for op in self.ops)

    @property
    def shape(self):
        return (sum(op.shape[0] for op in self.ops), self.ops[0].shape[1])


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class RowStack:
    """Maps a tuple of fields to one field: y = sum_i ops[i] @ x_i.
    Used for e.g. the velocity-components -> pressure divergence coupling."""

    ops: Tuple[object, ...]

    def matvec(self, x):
        out = None
        for op, xi in zip(self.ops, x):
            c = op.matvec(xi)
            out = c if out is None else out + c
        return out

    @property
    def shape(self):
        return (self.ops[0].shape[0], sum(op.shape[1] for op in self.ops))


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class FieldwiseOperator:
    """Applies one operator per field of a tuple vector (block-diagonal with
    independent fields) — e.g. a vector Laplacian as d scalar Laplacians."""

    ops: Tuple[object, ...]

    def matvec(self, x):
        return tuple(op.matvec(xi) for op, xi in zip(self.ops, x))

    def diag(self):
        return tuple(op.diag() for op in self.ops)

    def abs_row_sum(self):
        return tuple(op.abs_row_sum() for op in self.ops)

    @property
    def dtype(self):
        return self.ops[0].dtype

    @property
    def shape(self):
        n = sum(op.shape[0] for op in self.ops)
        m = sum(op.shape[1] for op in self.ops)
        return (n, m)

    def todense(self) -> jnp.ndarray:
        import jax.scipy.linalg as jsl

        return jsl.block_diag(*[op.todense() for op in self.ops])
