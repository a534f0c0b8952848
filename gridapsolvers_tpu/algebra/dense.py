"""Dense operator wrapper (coarse grids, small tests)."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DenseMatrix:
    A: jnp.ndarray

    @property
    def shape(self):
        return self.A.shape

    @property
    def dtype(self):
        return self.A.dtype

    @property
    def nnz(self):
        return self.A.size

    def matvec(self, x):
        return jnp.matmul(self.A, x, precision="highest")

    def diag(self):
        return jnp.diagonal(self.A)

    def abs_row_sum(self):
        return jnp.sum(jnp.abs(self.A), axis=1)

    def todense(self):
        return self.A

    def astype(self, dtype):
        return DenseMatrix(self.A.astype(dtype))
