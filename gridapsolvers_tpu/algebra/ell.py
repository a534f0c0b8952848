"""ELL (padded fixed-width) sparse matrix — the general-sparsity workhorse.

Design choice (vs the reference's CSR/CSC via SparseArrays /
PartitionedArrays): CSR row-pointer iteration gives every row its own
length and a serial scan, which XLA cannot turn into one fused loop. FEM
matrices on meshes have bounded row degree
(Q1 3D: 27; Q2 3D: 125), so we store every row padded to a fixed width K:

    values : (n_rows, K) float      — zero-padded
    cols   : (n_rows, K) int32      — padding points at the row itself

SpMV is then `(values * x[cols]).sum(-1)`: one gather + a dense
elementwise reduce, which XLA fuses into a single loop.

Row degree histograms of our assembled matrices are near-uniform, so padding
waste is small (<15% for Q1/Q2 interiors).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ELLMatrix:
    """Square-or-rectangular sparse matrix in padded ELL format."""

    values: jnp.ndarray  # (n_rows, K)
    cols: jnp.ndarray    # (n_rows, K) int32
    ncols: int = dataclasses.field(metadata=dict(static=True))

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.values.shape[0], self.ncols)

    @property
    def nrows(self) -> int:
        return self.values.shape[0]

    @property
    def row_width(self) -> int:
        return self.values.shape[1]

    @property
    def nnz(self) -> int:
        """Stored entries (including explicit zeros, excluding padding is
        not tracked; use count_nonzero on values for a true count)."""
        return self.values.shape[0] * self.values.shape[1]

    @property
    def dtype(self):
        return self.values.dtype

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        """y = A @ x. x: (ncols,) -> y: (nrows,)."""
        return jnp.sum(self.values * x[self.cols], axis=1)

    def matvec_t(self, y: jnp.ndarray) -> jnp.ndarray:
        """x = A.T @ y via scatter-add (used by transpose-mode transfers)."""
        contrib = self.values * y[:, None]
        return jnp.zeros((self.ncols,), self.dtype).at[self.cols.reshape(-1)].add(
            contrib.reshape(-1)
        )

    def diag(self) -> jnp.ndarray:
        """Diagonal extraction (requires square A)."""
        n = self.nrows
        rows = jnp.arange(n)[:, None]
        mask = self.cols == rows
        return jnp.sum(jnp.where(mask, self.values, 0.0), axis=1)

    def abs_row_sum(self) -> jnp.ndarray:
        """sum_j |a_ij| per row (Gershgorin bounds)."""
        return jnp.sum(jnp.abs(self.values), axis=1)

    def scale_rows(self, d: jnp.ndarray) -> "ELLMatrix":
        return ELLMatrix(self.values * d[:, None], self.cols, self.ncols)

    def astype(self, dtype) -> "ELLMatrix":
        return ELLMatrix(self.values.astype(dtype), self.cols, self.ncols)

    def todense(self) -> jnp.ndarray:
        """Debug/coarse-solve densification."""
        n, K = self.values.shape
        dense = jnp.zeros((n, self.ncols), self.dtype)
        rows = jnp.repeat(jnp.arange(n), K)
        return dense.at[rows, self.cols.reshape(-1)].add(self.values.reshape(-1))


def ell_from_coo(
    n_rows: int,
    n_cols: int,
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    row_width: int | None = None,
) -> ELLMatrix:
    """Host-side COO -> ELL conversion (duplicates are summed).

    This is the assembly exit point: FE element loops emit COO triplets,
    this packs them into the static-shape device format. Runs in NumPy on
    host (the C++ native path in native/ does the same faster).
    """
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    # sum duplicates via lexicographic sort + segment reduce
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    key = rows.astype(np.int64) * n_cols + cols.astype(np.int64)
    uniq, inv = np.unique(key, return_inverse=True)
    summed = np.zeros(len(uniq), dtype=vals.dtype)
    np.add.at(summed, inv, vals)
    urows = (uniq // n_cols).astype(np.int64)
    ucols = (uniq % n_cols).astype(np.int64)

    counts = np.bincount(urows, minlength=n_rows)
    K = int(counts.max()) if row_width is None else int(row_width)
    if counts.max() > K:
        raise ValueError(f"row degree {counts.max()} exceeds row_width {K}")

    ell_vals = np.zeros((n_rows, K), dtype=vals.dtype)
    ell_cols = np.tile(
        np.minimum(np.arange(n_rows), n_cols - 1)[:, None], (1, K)
    ).astype(np.int32)
    # position of each entry within its row
    starts = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(len(urows)) - starts[urows]
    ell_vals[urows, slot] = summed
    ell_cols[urows, slot] = ucols.astype(np.int32)
    return ELLMatrix(jnp.asarray(ell_vals), jnp.asarray(ell_cols), int(n_cols))


def ell_from_scipy(S, row_width: int | None = None, dtype=None) -> ELLMatrix:
    """scipy.sparse -> padded ELL (host-side setup path)."""
    import numpy as np

    S = S.tocsr()
    S.sum_duplicates()
    n_rows, n_cols = S.shape
    counts = np.diff(S.indptr)
    K = int(counts.max()) if row_width is None else int(row_width)
    if counts.max() > K:
        raise ValueError(f"row degree {counts.max()} exceeds row_width {K}")
    vals = np.zeros((n_rows, K), dtype=dtype or S.dtype)
    cols = np.tile(
        np.minimum(np.arange(n_rows), n_cols - 1)[:, None], (1, K)
    ).astype(np.int32)
    # rows with slots filled from CSR
    r = np.repeat(np.arange(n_rows), counts)
    slot = np.arange(S.nnz) - np.repeat(S.indptr[:-1], counts)
    vals[r, slot] = S.data
    cols[r, slot] = S.indices.astype(np.int32)
    return ELLMatrix(jnp.asarray(vals), jnp.asarray(cols), int(n_cols))


def ell_to_scipy(A: ELLMatrix):
    """Convert to scipy.sparse.csr_matrix for test validation."""
    import scipy.sparse as sp

    n, K = A.values.shape
    vals = np.asarray(A.values).reshape(-1)
    cols = np.asarray(A.cols).reshape(-1)
    rows = np.repeat(np.arange(n), K)
    M = sp.coo_matrix((vals, (rows, cols)), shape=A.shape)
    return M.tocsr()
