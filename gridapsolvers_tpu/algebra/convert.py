"""Host-side operator conversions (setup paths, validation)."""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .block import BlockOperator, ColumnStack, FieldwiseOperator, RowStack
from .dense import DenseMatrix
from .ell import ELLMatrix, ell_to_scipy
from .flat import BlockedKernelOperator
from .stencil import StencilMatrix


def to_scipy(op) -> sp.csr_matrix:
    """Any operator -> scipy CSR (explicit zeros eliminated)."""
    if isinstance(op, ELLMatrix):
        S = ell_to_scipy(op)
    elif isinstance(op, StencilMatrix):
        S = ell_to_scipy(op.to_ell())
    elif isinstance(op, DenseMatrix):
        S = sp.csr_matrix(np.asarray(op.A))
    elif isinstance(op, FieldwiseOperator):
        S = sp.block_diag([to_scipy(o) for o in op.ops], format="csr")
    elif isinstance(op, ColumnStack):
        S = sp.vstack([to_scipy(o) for o in op.ops], format="csr")
    elif isinstance(op, RowStack):
        S = sp.hstack([to_scipy(o) for o in op.ops], format="csr")
    elif isinstance(op, BlockOperator):
        sizes_r = []
        sizes_c = []
        mats = []
        for row in op.blocks:
            mats.append([None if b is None else to_scipy(b) for b in row])
        # infer missing (None) block sizes from siblings
        n = len(op.blocks)
        rs = [None] * n
        cs = [None] * n
        for i in range(n):
            for j in range(n):
                if mats[i][j] is not None:
                    rs[i] = rs[i] or mats[i][j].shape[0]
                    cs[j] = cs[j] or mats[i][j].shape[1]
        for i in range(n):
            for j in range(n):
                if mats[i][j] is None:
                    mats[i][j] = sp.csr_matrix((rs[i], cs[j]))
        S = sp.bmat(mats, format="csr")
    elif isinstance(op, BlockedKernelOperator):
        S = sp.bmat(
            [
                [
                    sp.csr_matrix((ni, nj)) if b is None else to_scipy(b)
                    for b, nj in zip(row, op.sizes)
                ]
                for row, ni in zip(op.kblocks, op.sizes)
            ],
            format="csr",
        )
    elif type(op).__name__ == "DistELLMatrix":
        from ..parallel.dist_ell import dist_to_scipy

        S = dist_to_scipy(op)  # PADDED sizes (identity pad rows intact)
    elif type(op).__name__ == "DistGraphELL":
        from ..parallel.dist_ell_nd import dist_to_scipy_nd

        S = dist_to_scipy_nd(op)  # padded, shard-major box ordering
    else:
        raise TypeError(f"to_scipy: unsupported {type(op)}")
    S = S.copy()
    S.eliminate_zeros()
    return S
