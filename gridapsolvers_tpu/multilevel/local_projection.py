"""Cell-local L2 projection maps.

Analog of the reference's LocalProjectionMap
(src/MultilevelTools/LocalProjectionMaps.jl:5,86-208): project a field onto
a (lower-order) local space cell by cell via small mass solves — used e.g.
for grad-div stabilization Pi_Qh(div u) in Stokes/Navier-Stokes.

On a uniform mesh every cell shares one projection matrix
P_e = M_to^{-1} B_e (precomputed on host), so the map is one gather, one
batched small matmul, and one multiplicity-averaged scatter.
"""
from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

from ..fem import assembly2 as asm
from ..fem.elements import TensorElement, mass_matrix
from ..fem.mesh import CartesianMesh


@dataclasses.dataclass(eq=False)  # hashable by identity (jit-friendly)
class LocalProjectionMap:
    """Projects nodal fields of order `order_from` onto order `order_to`
    (continuous, cell-averaged) on the same mesh."""

    mesh: CartesianMesh
    order_from: int
    order_to: int

    def __post_init__(self):
        mesh = self.mesh
        e_from = TensorElement(
            self.order_from, mesh.h, nquad=self.order_from + 1
        )
        e_to = TensorElement(self.order_to, mesh.h, nquad=self.order_from + 1)
        # B_e[i_to, j_from] = int phi_to_i phi_from_j
        Vt = e_to._phi_table(None)
        Vf = e_from._phi_table(None)
        W = e_to.quad_weights()
        B = np.einsum("iq,jq,q->ij", Vt, Vf, W)
        M = mass_matrix(e_to)
        self._P = jnp.asarray(np.linalg.solve(M, B))  # (n_to, n_from)
        self._conn_from = jnp.asarray(asm.connectivity(mesh, self.order_from))
        conn_to = asm.connectivity(mesh, self.order_to)
        self._conn_to = jnp.asarray(conn_to)
        n_to = asm.num_nodes(mesh, self.order_to)
        counts = np.zeros(n_to)
        np.add.at(counts, conn_to.reshape(-1), 1.0)
        self._inv_counts = jnp.asarray(1.0 / np.maximum(counts, 1.0))
        self.n_from = asm.num_nodes(mesh, self.order_from)
        self.n_to = n_to

    def __call__(self, u: jnp.ndarray) -> jnp.ndarray:
        """(n_from,) -> (n_to,): cell-local projection, averaged at shared
        nodes (the reference's assembled-projection behavior up to the
        averaging convention)."""
        u_cell = u[self._conn_from]                      # (ncells, n_from_e)
        p_cell = jnp.matmul(u_cell, self._P.T, precision="highest")  # (ncells, n_to_e)
        out = jnp.zeros(self.n_to, u.dtype).at[
            self._conn_to.reshape(-1)
        ].add(p_cell.reshape(-1))
        return out * self._inv_counts


@dataclasses.dataclass(eq=False)  # hashable by identity (jit-friendly)
class SpaceProjectionMap:
    """Cell-local L2 projection onto a CONSTRAINED FE space.

    Reference SpaceProjectionMap (LocalProjectionMaps.jl:172-279): per
    cell the local mass system is restricted to the cell's free dofs
    (`ids = findall(id -> id > 0, dof_ids)`), Cholesky-solved, and the
    constrained slots get zeros. Needed when the arrival space has
    Dirichlet constraints the projection must respect.

    The mesh is uniform, so cells fall into a handful of
    constraint-pattern CLASSES (interior cells all-free; boundary cells
    by which faces they touch). Host setup solves one restricted system
    per class; the device apply is one gather, one batched matmul over
    per-cell class matrices, one averaged scatter — identical cost shape
    to ReffeProjectionMap's (LocalProjectionMap above).
    """

    space_to: object          # FESpace (multilevel/spaces.py)
    order_from: int

    def __post_init__(self):
        space = self.space_to
        mesh = space.mesh
        order_to = space.order
        e_from = TensorElement(
            self.order_from, mesh.h, nquad=max(self.order_from, order_to) + 1
        )
        e_to = TensorElement(
            order_to, mesh.h, nquad=max(self.order_from, order_to) + 1
        )
        Vt = e_to._phi_table(None)
        Vf = e_from._phi_table(None)
        W = e_to.quad_weights()
        B = np.einsum("iq,jq,q->ij", Vt, Vf, W)     # (n_to_e, n_from_e)
        M = mass_matrix(e_to)                        # (n_to_e, n_to_e)

        conn_to = asm.connectivity(mesh, order_to)   # (ncells, n_to_e)
        free = ~np.asarray(space.dirichlet_mask())
        cell_free = free[conn_to]                    # (ncells, n_to_e) bool
        # constraint-pattern classes: one restricted solve per class
        classes, cls_idx = np.unique(cell_free, axis=0, return_inverse=True)
        Ps = np.zeros((len(classes), B.shape[0], B.shape[1]))
        for c, m in enumerate(classes):
            if not m.any():
                continue
            f = np.where(m)[0]
            Ps[c][f] = np.linalg.solve(M[np.ix_(f, f)], B[f])
        self._P = jnp.asarray(Ps)                    # (ncls, n_to_e, n_from_e)
        self._cls = jnp.asarray(cls_idx)
        self._conn_from = jnp.asarray(
            asm.connectivity(mesh, self.order_from)
        )
        self._conn_to = jnp.asarray(conn_to)
        n_to = asm.num_nodes(mesh, order_to)
        counts = np.zeros(n_to)
        np.add.at(counts, conn_to.reshape(-1), 1.0)
        self._inv_counts = jnp.asarray(1.0 / np.maximum(counts, 1.0))
        self.n_from = asm.num_nodes(mesh, self.order_from)
        self.n_to = n_to

    def __call__(self, u: jnp.ndarray) -> jnp.ndarray:
        """(n_from,) -> (n_to,): constrained cell-local projection,
        averaged at shared free nodes, exact zeros at constrained dofs."""
        u_cell = u[self._conn_from]                  # (ncells, n_from_e)
        P_cell = self._P[self._cls]                  # (ncells, n_to_e, n_from_e)
        p_cell = jnp.einsum("cij,cj->ci", P_cell, u_cell, precision="highest")
        out = jnp.zeros(self.n_to, u.dtype).at[
            self._conn_to.reshape(-1)
        ].add(p_cell.reshape(-1))
        return out * self._inv_counts
