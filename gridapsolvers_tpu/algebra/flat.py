"""Field-blocked view of composite block operators.

`flat_kernel_operator(A)` rebuilds a square composite (BlockOperator /
FieldwiseOperator of ELL/Stencil leaves) as a field-blocked operator
whose every nonzero field block is one padded ELL matrix: one gather +
row-sum per block instead of one XLA op per band or per leaf of the
composite (25-band blocks at GMG level sizes are launch-bound).

Why per-BLOCK ELL rather than one ELL over the flattened system: each
square field block couples one grid to itself, so its rows have the
same width; flattening mixes the widest row of every field into one
padded width.

The original composite stays reachable as `.inner` for machinery that
reads block structure (Vanka patch extraction via ell_view, coarse
densification, field sizes).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .ell import ell_from_scipy


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BlockedKernelOperator:
    """Square composite operator with one ELL matrix per field block.

    Operates on the same block-pytree vectors as the wrapped composite
    (leaves in tree-flatten order == field order)."""

    kblocks: tuple        # nf x nf tuple-of-tuples of ELLMatrix or None
    inner: object         # the original composite operator (pytree)
    sizes: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def shape(self):
        n = sum(self.sizes)
        return (n, n)

    @property
    def dtype(self):
        if self.inner is not None and hasattr(self.inner, "dtype"):
            return self.inner.dtype
        for row in self.kblocks:
            for blk in row:
                if blk is not None:
                    return blk.dtype
        raise ValueError("empty BlockedKernelOperator")

    def matvec(self, x):
        leaves, treedef = jax.tree_util.tree_flatten(x)
        out = []
        for i, row in enumerate(self.kblocks):
            acc = None
            for j, blk in enumerate(row):
                if blk is None:
                    continue
                c = blk.matvec(jnp.ravel(leaves[j]))
                acc = c if acc is None else acc + c
            if acc is None:
                acc = jnp.zeros_like(jnp.ravel(leaves[i]))
            out.append(acc.reshape(leaves[i].shape))
        return jax.tree_util.tree_unflatten(treedef, out)

    def diag(self):
        return self.inner.diag() if hasattr(self.inner, "diag") else None

    def block(self, i, j):
        return self.inner.block(i, j)

    def todense(self):
        return self.inner.todense()


def blocked_kernel_from_scipy(
    S, sizes, inner=None, dtype=None, refreshable: bool = False,
) -> BlockedKernelOperator:
    """Cut a square scipy matrix into field blocks (row/col offsets from
    `sizes`) and store every nonzero block as an ELL matrix.

    refreshable=True keeps explicit zeros in the block patterns (the
    pattern-static refresh contract: every stored entry of S must keep
    its slot so later values can land there)."""
    offs = np.cumsum([0] + list(sizes))
    nf = len(sizes)
    S = S.tocsr()
    rows = []
    for i in range(nf):
        row = []
        for j in range(nf):
            blk = S[offs[i]:offs[i + 1], offs[j]:offs[j + 1]].tocsr()
            if not refreshable:
                blk.eliminate_zeros()
            if blk.nnz == 0:
                row.append(None)
            else:
                row.append(ell_from_scipy(blk, dtype=dtype))
        rows.append(tuple(row))
    return BlockedKernelOperator(
        kblocks=tuple(rows), inner=inner, sizes=tuple(int(s) for s in sizes)
    )


def flat_kernel_operator(A) -> BlockedKernelOperator:
    """Build a BlockedKernelOperator from a square composite operator."""
    from .convert import to_scipy
    from .ell_view import ell_pattern

    meta, _, _ = ell_pattern(A)
    assert meta.n_rows == meta.n_cols, "square composites only"
    S = to_scipy(A)
    dtype = np.dtype(
        jnp.float32 if A.dtype == jnp.float32 else A.dtype
    )
    return blocked_kernel_from_scipy(
        S, meta.row_sizes, inner=A, dtype=dtype
    )
