"""One- and two-level additive Schwarz.

Analog of the reference's SchwarzLinearSolver
(src/LinearSolvers/SchwarzLinearSolvers.jl:6-17,24-32,44-49): local solves
on overlapping subdomains followed by an additive combine. The reference's
subdomains are MPI-rank locals; here we take contiguous overlapping
row-slabs of the structured grid (one per "virtual rank"), factorize each
slab operator densely, and apply all slab solves batched — the combine is a
weighted scatter-add (the reference's assemble!+consistent!).

(multiplicative variant: reference leaves it as TODO; same here.)

TwoLevelSchwarzSolver adds a GenEO spectral coarse space — the in-repo
analog of the reference's HPDDMLinearSolver (ext/GridapPETScExt/
HPDDMLinearSolvers.jl:44-55,124-143: PCHPDDM fed with local overlapping
Neumann matrices, which builds the GenEO coarse space of Spillane et al.).
Redesign: the per-subdomain generalized eigenproblems
    A_i^Neumann z = lambda (D_i A_i^Dirichlet D_i) z
are ONE batched Cholesky + eigh over all subdomains (no per-rank
loop), the coarse space is the partition-of-unity lift of the
nev smallest eigenvectors, and both levels apply as batched
gather/solve/scatter kernels.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..interfaces import LinearSolver
from ..patches.smoothers import PatchSolver
from ..patches.topology import PatchTopology


def slab_bounds(n0: int, n_subdomains: int, overlap: int = 1):
    """Overlapping [lo, hi) leading-axis row ranges of the subdomains."""
    bounds = np.linspace(0, n0, n_subdomains + 1).astype(int)
    return [
        (max(bounds[s] - overlap, 0), min(bounds[s + 1] + overlap, n0))
        for s in range(n_subdomains)
    ]


def slab_patches(
    grid_shape, n_subdomains: int, overlap: int = 1
) -> PatchTopology:
    """Overlapping slabs of the leading grid axis as subdomains."""
    n0 = grid_shape[0]
    rest = int(np.prod(grid_shape[1:])) if len(grid_shape) > 1 else 1
    n = n0 * rest
    dummy = n
    rows = []
    width = 0
    for lo, hi in slab_bounds(n0, n_subdomains, overlap):
        dofs = np.arange(lo * rest, hi * rest)
        rows.append(dofs)
        width = max(width, len(dofs))
    table = np.full((n_subdomains, width), dummy, dtype=np.int32)
    for i, dofs in enumerate(rows):
        table[i, : len(dofs)] = dofs
    return PatchTopology(dofs=table, dummy=dummy, n_dofs=n)


@dataclasses.dataclass(frozen=True)
class SchwarzLinearSolver(LinearSolver):
    """Additive Schwarz over overlapping row-slab subdomains."""

    n_subdomains: int = 4
    overlap: int = 2
    omega: float = 1.0

    def setup(self, A, x=None):
        topo = slab_patches(A.grid_shape, self.n_subdomains, self.overlap)
        inner = PatchSolver(topo, omega=self.omega, weighting="overlap",
                            spd=False)
        return {"inner": inner, "state": inner.setup(A, x)}

    def update(self, state, A, x=None):
        inner = state["inner"]
        return {"inner": inner, "state": inner.update(state["state"], A, x)}

    def apply(self, state, r):
        return state["inner"].apply(state["state"], r)

    def solve(self, state, b, x0=None):
        return self.apply(state, b), None


def slab_neumann_matrices(
    mesh,
    n_subdomains: int,
    overlap: int = 2,
    kappa=None,
    dirichlet="boundary",
    dtype=np.float64,
) -> np.ndarray:
    """Local overlapping NEUMANN matrices for the slab subdomains of a
    CartesianMesh — the reference's ghost-including-measure subassembly
    (HPDDMLinearSolvers.jl:60-96: `a(u,v) = ∫(∇u·∇v)dΩg` over a
    Triangulation(with_ghost)): each slab's operator is assembled on the
    slab's own sub-mesh with natural boundaries at the subdomain
    interfaces, then the GLOBAL Dirichlet rows inside the slab are
    symmetric-eliminated. Returns (n_subdomains, k, k) padded with unit
    diagonals, aligned with `slab_patches` dof order."""
    from ..fem.assembly import laplacian, laplacian_var

    vshape = mesh.vertex_shape
    n0 = vshape[0]
    rest_shape = vshape[1:]
    rest = int(np.prod(rest_shape)) if rest_shape else 1
    assert not mesh.periodic[0], "slab subdomains need an open leading axis"
    gmask = (
        mesh.boundary_vertex_mask(dirichlet)
        if dirichlet is not None
        else np.zeros(vshape, dtype=bool)
    )
    bounds = slab_bounds(n0, n_subdomains, overlap)
    kmax = max(hi - lo for lo, hi in bounds) * rest
    kap = None if kappa is None else np.asarray(kappa).reshape(mesh.ncells)
    out = np.zeros((n_subdomains, kmax, kmax), dtype=dtype)
    import dataclasses as _dc

    for s, (lo, hi) in enumerate(bounds):
        ncells_s = (hi - lo - 1,) + tuple(mesh.ncells[1:])
        dom = list(mesh.domain)
        dom[0], dom[1] = 0.0, mesh.h[0] * ncells_s[0]
        smesh = _dc.replace(
            mesh,
            ncells=ncells_s,
            domain=tuple(dom),
            periodic=(False,) + tuple(mesh.periodic[1:]),
        )
        if kap is None:
            As = laplacian(smesh, dtype)
        else:
            As = laplacian_var(smesh, kap[lo : hi - 1], dtype)
        D = np.array(As.todense())  # copy: jax arrays are read-only
        dmask = gmask[lo:hi].reshape(-1)
        if dmask.any():
            idx = np.nonzero(dmask)[0]
            D[idx, :] = 0.0
            D[:, idx] = 0.0
            D[idx, idx] = 1.0
        k = D.shape[0]
        out[s, :k, :k] = D
        if k < kmax:
            out[s, k:, k:] = np.eye(kmax - k, dtype=dtype)
    return out


@dataclasses.dataclass(frozen=True)
class TwoLevelSchwarzSolver(LinearSolver):
    """Additive two-level Schwarz with a GenEO spectral coarse space (the
    reference's HPDDM/PCHPDDM analog, HPDDMLinearSolvers.jl:124-143).

    Level 1: the one-level slab Schwarz (batched dense local solves with
    partition-of-unity weighting). Level 2: per subdomain i, solve the
    generalized eigenproblem
        N_i z = lambda (D_i A_i D_i) z
    (N_i: local Neumann matrix if given, else the extracted local
    Dirichlet matrix A_i) for the `nev` SMALLEST eigenpairs — one batched
    Cholesky + one batched eigh across all subdomains — and span the
    coarse space with the partition-of-unity lifts Z[:, (i,a)] =
    R_i^T D_i z_ia. Coarse correction: Z (Z^T A Z)^{-1} Z^T, dense.

    `neumann_matrices`: optional (n_subdomains, k, k) array from
    `slab_neumann_matrices` (true GenEO). Without it the Dirichlet-
    extracted pencil still yields a subdomain-robust coarse space.
    """

    n_subdomains: int = 4
    overlap: int = 2
    nev: int = 2
    omega: float = 1.0
    neumann_matrices: object = None
    # optional solver for the coarse problem A0 = Zᵀ A Z (default: dense
    # LU). Injecting an iterative/preconditioned solver here is the
    # PCHPDDM nesting pattern (multilevel DD = the coarse level solved by
    # another inner KSP/preconditioner rather than exactly —
    # HPDDMLinearSolvers.jl's PCHPDDM levels_1_pc_type chain).
    coarse_solver: object = None

    def _inner(self, A):
        topo = slab_patches(A.grid_shape, self.n_subdomains, self.overlap)
        return (
            # unit weighting keeps the two-level operator symmetric
            # (sum_i R_i^T A_i^{-1} R_i + Z A0^{-1} Z^T is SPD), so CG is
            # a safe outer solver; the PoU weights D_i only enter the
            # GenEO pencil and the coarse-space lift
            PatchSolver(topo, omega=1.0, weighting="unit", spd=False),
            topo,
        )

    def setup(self, A, x=None):
        inner, topo = self._inner(A)
        st1 = inner.setup(A, x)

        # partition-of-unity weights in patch-local layout (0 on padding)
        w = 1.0 / np.maximum(topo.overlap_counts(), 1.0)
        wp = w[np.minimum(topo.dofs, topo.n_dofs)]
        wp[~topo.valid_mask()] = 0.0

        state = {
            "inner": st1,
            "topo_dofs": jnp.asarray(topo.dofs),
            "wp": jnp.asarray(wp),
            "neumann": None
            if self.neumann_matrices is None
            else jnp.asarray(self.neumann_matrices),
        }
        return self._refresh_coarse(state, A, topo)

    def update(self, state, A, x=None):
        """numerical_setup! analog: re-extract local matrices, re-run the
        batched eigensolves, rebuild the coarse operator — all device work
        (jittable)."""
        inner, topo = self._inner(A)
        new = dict(state)
        new["inner"] = inner.update(state["inner"], A, x)
        return self._refresh_coarse(new, A, topo)

    def _refresh_coarse(self, state, A, topo):
        from ..algebra.ell import ELLMatrix
        from ..algebra.ell_view import ell_values
        from ..patches.smoothers import extract_patch_matrices_ell

        st1 = state["inner"]
        vals = ell_values(A, st1["meta"], st1["leaf_masks"])
        ell = ELLMatrix(vals, st1["ell_cols"], st1["meta"].n_cols)
        Ap = extract_patch_matrices_ell(ell, topo.dofs, topo.dummy)

        wp = state["wp"]                      # (ns, k)
        valid = jnp.asarray(topo.valid_mask())
        # B = D A D with unit diagonal on padding (keeps it SPD)
        B = wp[:, :, None] * Ap * wp[:, None, :]
        eye = jnp.eye(topo.width, dtype=Ap.dtype)[None]
        B = jnp.where(
            valid[:, :, None] & valid[:, None, :], B, eye
        ) + 1e-12 * eye
        N = state["neumann"] if state["neumann"] is not None else Ap
        # push padding modes to lambda=BIG so they are never selected
        pad_diag = jnp.where(valid, 0.0, 1e8)
        N = N + pad_diag[:, :, None] * eye

        # generalized eigh of the pencil (N, B): whiten by chol(B), one
        # batched eigh over all subdomains, un-whiten, take nev smallest
        L = jnp.linalg.cholesky(B)
        Ct = jax.scipy.linalg.solve_triangular(L, N, lower=True)
        C = jax.scipy.linalg.solve_triangular(
            L, jnp.swapaxes(Ct, -1, -2), lower=True
        )
        C = 0.5 * (C + jnp.swapaxes(C, -1, -2))
        _, Q = jnp.linalg.eigh(C)             # ascending eigenvalues
        Zl = jax.scipy.linalg.solve_triangular(
            jnp.swapaxes(L, -1, -2), Q[:, :, : self.nev], lower=False
        )                                     # (ns, k, nev)
        # coarse vectors: partition-of-unity lift, zero on padding
        Zp = wp[:, :, None] * Zl * valid[:, :, None]

        # A0 = Z^T A Z via ns*nev batched full matvecs (coarse space is
        # tiny: m = n_subdomains * nev)
        n = topo.n_dofs
        ns, _, nev = Zp.shape
        dofs = state["topo_dofs"]
        s_ix = jnp.repeat(jnp.arange(ns), nev)
        e_ix = jnp.tile(jnp.arange(nev), ns)
        cols = jax.vmap(
            lambda s, e: jnp.zeros((n + 1,), Zp.dtype)
            .at[dofs[s]]
            .add(Zp[s, :, e])[:n]
        )(s_ix, e_ix)                          # (m, n)
        Acols = jax.vmap(A.matvec)(cols)       # (m, n)
        A0 = jnp.matmul(cols, Acols.T, precision="highest")
        m = ns * nev
        A0 = A0 + 1e-10 * jnp.trace(A0) / m * jnp.eye(m, dtype=A0.dtype)

        new = dict(state)
        new["Zp"] = Zp
        if self.coarse_solver is None:
            new["A0_lu"] = jax.scipy.linalg.lu_factor(A0)
        else:
            from ..algebra.dense import DenseMatrix

            new["A0_state"] = self.coarse_solver.setup(DenseMatrix(A0))
        new["A"] = A
        return new

    def apply(self, state, r):
        # level 1: batched overlapping local solves (symmetric combine);
        # the PatchSolver is rebuilt from static metadata so the state
        # pytree holds only arrays (jit-safe)
        inner, _ = self._inner(state["A"])
        z1 = inner.apply(state["inner"], r)
        # level 2: coarse correction Z A0^{-1} Z^T r, all gather/einsum
        dofs, Zp = state["topo_dofs"], state["Zp"]
        ns, _, nev = Zp.shape
        re = jnp.concatenate([r, jnp.zeros((1,), r.dtype)])
        rp = re[dofs]                                    # (ns, k)
        rc = jnp.einsum("ska,sk->sa", Zp, rp, precision="highest").reshape(-1)
        if self.coarse_solver is None:
            c = jax.scipy.linalg.lu_solve(state["A0_lu"], rc)
        else:
            c, _ = self.coarse_solver.solve(state["A0_state"], rc)
        dxp = jnp.einsum(
            "ska,sa->sk", Zp, c.reshape(ns, nev), precision="highest"
        )
        z2 = (
            jnp.zeros((r.shape[0] + 1,), r.dtype)
            .at[dofs.reshape(-1)]
            .add(dxp.reshape(-1))[: r.shape[0]]
        )
        return self.omega * (z1 + z2)

    def solve(self, state, b, x0=None):
        return self.apply(state, b), None
