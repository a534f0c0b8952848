"""Steady incompressible Navier-Stokes (2D, Taylor-Hood Q2/Q1).

Mirrors the reference's NavierStokes applications
(test/Applications/NavierStokes.jl, NavierStokesGMG.jl:80-176): Newton on

    R(u, p) = [ nu K u + C(u) u + Bᵀ p - f ;  B u ]

with homogeneous velocity Dirichlet BCs and a manufactured divergence-free
solution. Design point: convection (re)assembly is fully on-device —
the sparsity slots of every (cell, i, j) pair into the ELL pattern are
precomputed on host once, and each Newton step's Jacobian is a batched
einsum over quadrature + one scatter-add (jit-able), instead of the
reference's per-cell assembly loops through Gridap.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from ..algebra import BlockOperator, ELLMatrix
from ..algebra.block import ColumnStack, RowStack
from ..algebra.ell import ell_from_scipy
from ..nonlinear import NonlinearOperator
from . import assembly2 as asm
from .elements import TensorElement
from .mesh import CartesianMesh
from .stokes import _A_POLY, _poly_eval, exact_pressure, exact_velocity


def _csr_slot_map(S: sp.csr_matrix, rows: np.ndarray, cols: np.ndarray):
    """slot[e] such that ELL(values)[rows[e], slot[e]] is entry
    (rows[e], cols[e]) — relies on CSR/ELL storing each row's entries in
    ascending column order."""
    keys = rows.astype(np.int64) * S.shape[1] + cols.astype(np.int64)
    all_keys = (
        np.repeat(np.arange(S.shape[0]), np.diff(S.indptr)).astype(np.int64)
        * S.shape[1]
        + S.indices
    )
    pos = np.searchsorted(all_keys, keys.reshape(-1))
    assert np.all(all_keys[pos] == keys.reshape(-1)), "pattern mismatch"
    slots = pos - S.indptr[rows.reshape(-1)]
    return slots.reshape(rows.shape).astype(np.int32)


def ns_forcing(xy: np.ndarray, nu: float) -> np.ndarray:
    """f = -nu lap(u) + (u.grad)u + grad(p) for the Stokes manufactured u,p."""
    from .stokes import forcing as stokes_forcing

    f = stokes_forcing(xy, nu)  # -nu lap u + grad p
    x, y = xy[:, 0], xy[:, 1]
    a = _A_POLY
    av = _poly_eval(a, x)
    a1 = _poly_eval(a, x, 1)
    a2 = _poly_eval(a, x, 2)
    bv = _poly_eval(a, y)
    b1 = _poly_eval(a, y, 1)
    b2 = _poly_eval(a, y, 2)
    # u = (a b', -a' b)
    conv_x = av * a1 * b1 * b1 - av * a1 * bv * b2
    conv_y = -av * a2 * bv * b1 + a1 * a1 * bv * b1
    f[:, 0] += conv_x
    f[:, 1] += conv_y
    return f


@dataclasses.dataclass
class NavierStokesProblem(NonlinearOperator):
    """Nonlinear operator + exact-solution record."""

    mesh: CartesianMesh
    nu: float
    # pattern and values
    cols_ell: jnp.ndarray            # (n_u, K) shared ELL pattern (Q2)
    n_u: int
    base_vals: jnp.ndarray           # constrained nu*K values + identity diag
    mask_ell: jnp.ndarray            # rowfree * colfree per (row, slot)
    free_u: jnp.ndarray              # (n_u,) 1/0 free velocity dof mask
    # quadrature tables (device)
    phi: jnp.ndarray                 # (nn, nq)
    dphi: jnp.ndarray                # (d, nn, nq)
    wq: jnp.ndarray                  # (nq,)
    conn: jnp.ndarray                # (ncells, nn)
    slots: jnp.ndarray               # (ncells, nn, nn)
    # Stokes coupling blocks + rhs + exact solution
    BTs: tuple
    Bs: tuple
    Mp: ELLMatrix
    Mu: ELLMatrix
    f: tuple
    u_exact: tuple
    p_exact: np.ndarray
    # constant grad-div values on the shared ELL pattern, (d, d) nested
    # tuple (augmented-Lagrangian NS, reference NavierStokesGMG.jl:108-125:
    # jac_u = lap + dc + graddiv); None for the plain formulation
    gd_vals: tuple = None
    # inhomogeneous-Dirichlet (lid-driven cavity) extras — None for MMS.
    # lift_g: per-component boundary values g (reference
    # NavierStokesGMG.jl:101-106: u = (1,0) on the lid, Re = 1/nu);
    # res_vals / gd_res_vals / res_Bs: ROW-masked-only (columns kept, no
    # identity) operator values for the residual action, so couplings
    # from boundary values into interior rows are retained — the
    # constrained rows are overwritten with u_i - g_i instead.
    lift_g: tuple = None
    res_vals: jnp.ndarray = None
    gd_res_vals: tuple = None
    res_Bs: tuple = None
    row_mask_ell: jnp.ndarray = None

    # -- assembly -------------------------------------------------------

    def _u_cell(self, u: Tuple[jnp.ndarray, ...]) -> jnp.ndarray:
        # MMS (g = 0): free-mask the velocity before gathering, keeping
        # the Jacobian (whose rows/cols are masked) exactly consistent
        # with the residual's u-dependence. Cavity (g != 0): convection
        # must see the TRUE iterate including the lid velocity; Newton
        # consistency holds because constrained dofs never move
        # (identity rows + zero constrained residual => du_i = 0).
        if getattr(self, "lift_g", None) is not None:
            return jnp.stack([ui[self.conn] for ui in u], axis=-1)
        return jnp.stack(
            [(ui * self.free_u)[self.conn] for ui in u], axis=-1
        )

    def _convection_elems(self, u, newton: bool):
        """N1_e (c,i,j) and (if newton) N2_e (c,i,j,a,b)."""
        u_cell = self._u_cell(u)
        u_q = jnp.einsum(
            "cnd,nq->cqd", u_cell, self.phi, precision="highest"
        )
        # N1: int v_i (u . grad) w_j
        N1 = jnp.einsum(
            "q,iq,cqb,bjq->cij", self.wq, self.phi, u_q, self.dphi,
            precision="highest",
        )
        if not newton:
            return N1, None
        grad_u = jnp.einsum(
            "cna,bnq->cqab", u_cell, self.dphi, precision="highest"
        )
        N2 = jnp.einsum(
            "q,iq,jq,cqab->cijab", self.wq, self.phi, self.phi, grad_u,
            precision="highest",
        )
        return N1, N2

    def _scatter(self, elems: jnp.ndarray, mask=None) -> jnp.ndarray:
        """(ncells, nn, nn) element values -> masked ELL values (n_u, K).
        mask defaults to the row*col free mask (Jacobian); pass
        row_mask_ell for the residual action of the cavity problem."""
        rows = jnp.broadcast_to(
            self.conn[:, :, None], self.slots.shape
        ).reshape(-1)
        vals = jnp.zeros_like(self.base_vals)
        vals = vals.at[rows, self.slots.reshape(-1)].add(elems.reshape(-1))
        return vals * (self.mask_ell if mask is None else mask)

    def velocity_block(self, u, newton: bool = True) -> BlockOperator:
        """d x d velocity Jacobian block:
        delta_ab (nu K + N1) + N2_ab [+ G_ab] — the grad-div term is
        LINEAR in u, so the same values serve the residual action and the
        Jacobian."""
        N1, N2 = self._convection_elems(u, newton)
        vals_N1 = self._scatter(N1)
        gd = getattr(self, "gd_vals", None)
        d = len(u)
        blocks = []
        for a in range(d):
            row = []
            for b in range(d):
                vals = jnp.zeros_like(self.base_vals)
                if a == b:
                    vals = vals + self.base_vals + vals_N1
                if gd is not None:
                    vals = vals + gd[a][b]
                if newton and N2 is not None:
                    vals = vals + self._scatter(N2[..., a, b])
                row.append(ELLMatrix(vals, self.cols_ell, self.n_u))
            blocks.append(tuple(row))
        return BlockOperator(tuple(blocks))

    # -- NonlinearOperator protocol -------------------------------------

    def jacobian(self, x):
        u, p = x
        Auu = self.velocity_block(u, newton=True)
        return BlockOperator(
            (
                (Auu, ColumnStack(self.BTs)),
                (RowStack(self.Bs), None),
            )
        )

    def picard_jacobian(self, x):
        u, p = x
        Auu = self.velocity_block(u, newton=False)
        return BlockOperator(
            (
                (Auu, ColumnStack(self.BTs)),
                (RowStack(self.Bs), None),
            )
        )

    def residual(self, x):
        u, p = x
        if getattr(self, "lift_g", None) is not None:
            return self._residual_cavity(u, p)
        Auu = self.velocity_block(u, newton=False)  # action: (nuK + N1(u)) u
        r_u = Auu.matvec(u)
        grad_p = ColumnStack(self.BTs).matvec(p)
        r_u = tuple(
            ru + gp - fi for ru, gp, fi in zip(r_u, grad_p, self.f)
        )
        r_p = RowStack(self.Bs).matvec(u)
        return (r_u, r_p)

    def _residual_cavity(self, u, p):
        """Inhomogeneous-Dirichlet residual: ROW-masked-only operators act
        on the full iterate (boundary-to-interior couplings kept), then
        constrained rows are overwritten with the BC residual u_i - g_i.
        The Jacobian stays the masked velocity_block: since constrained
        rows are identity with zero residual at the BC, Newton keeps
        du_i = 0 and the masked columns never see a nonzero du."""
        d = len(u)
        N1, _ = self._convection_elems(u, newton=False)
        vals = self.res_vals + self._scatter(N1, mask=self.row_mask_ell)
        Adiag = ELLMatrix(vals, self.cols_ell, self.n_u)
        grad_p = ColumnStack(self.BTs).matvec(p)
        gd = getattr(self, "gd_res_vals", None)
        bdry = 1.0 - self.free_u
        r_u = []
        for a in range(d):
            ra = Adiag.matvec(u[a]) + grad_p[a] - self.f[a]
            if gd is not None:
                for b in range(d):
                    ra = ra + ELLMatrix(
                        gd[a][b], self.cols_ell, self.n_u
                    ).matvec(u[b])
            r_u.append(ra + bdry * (u[a] - self.lift_g[a]))
        r_p = sum(
            Bc.matvec(uc) for Bc, uc in zip(self.res_Bs, u)
        )
        return (tuple(r_u), r_p)

    def initial_guess(self):
        """BC-consistent start: the lift for cavity, zero for MMS."""
        if getattr(self, "lift_g", None) is None:
            return self.zero_guess()
        return (
            tuple(jnp.asarray(g) for g in self.lift_g),
            jnp.zeros(self.Mp.shape[0]),
        )

    # -- diagnostics ----------------------------------------------------

    def velocity_error(self, u) -> float:
        err = 0.0
        for ui, uei in zip(u, self.u_exact):
            e = ui - jnp.asarray(uei)
            err += float(jnp.vdot(e, self.Mu.matvec(e)))
        return float(np.sqrt(err))

    def zero_guess(self):
        d = self.mesh.dim
        n_p = self.Mp.shape[0]
        return (
            tuple(jnp.zeros(self.n_u) for _ in range(d)),
            jnp.zeros(n_p),
        )


def _graddiv_ell_vals(obj, mesh: CartesianMesh, alpha: float,
                      mask=None) -> tuple:
    """Constant grad-div values on obj's shared ELL pattern: the cell-local
    element blocks (elements.graddiv_element) scattered through the same
    slot tables the convection assembly uses (same sparsity support: dofs
    sharing a cell). mask defaults to the Jacobian row*col free mask; pass
    the row-only mask for the cavity residual action."""
    from .elements import graddiv_element

    elem = TensorElement(2, mesh.h, nquad=3)
    Ge = graddiv_element(elem, alpha)
    d = mesh.dim
    ncells = obj.conn.shape[0]
    return tuple(
        tuple(
            obj._scatter(
                jnp.broadcast_to(
                    jnp.asarray(Ge[a][b]), (ncells,) + Ge[a][b].shape
                ),
                mask=mask,
            )
            for b in range(d)
        )
        for a in range(d)
    )


def navier_stokes_problem(
    ncells: Tuple[int, int],
    nu: float = 1.0,
    dtype=np.float64,
    graddiv_alpha: float = 0.0,
    bc: str = "mms",
) -> NavierStokesProblem:
    """graddiv_alpha > 0 selects the augmented-Lagrangian formulation of
    the reference's NavierStokesGMG.jl:108-125 (alpha = 1e3 there):
    res_u/jac_u gain the cell-local grad-div term and the pressure space
    becomes P1disc (`space=:P`), so the augmentation is exactly
    consistent (Bp u = 0 is the system constraint) and the Schur
    complement is spectrally -(1/alpha) Mp.

    bc='mms' (default): homogeneous Dirichlet + manufactured solution.
    bc='cavity': the reference's ACTUAL NavierStokesGMG problem — the
    lid-driven cavity with u = (1, 0) on the top-face interior, zero
    forcing, Re = 1/nu (NavierStokesGMG.jl:101-106 runs Re = 10). The
    nonlinear residual acts through row-masked-only operators on the
    full iterate (see NavierStokesProblem._residual_cavity); start
    Newton from `initial_guess()` so the lid values are in the state."""
    dim = len(ncells)
    assert dim == 2
    assert bc in ("mms", "cavity")
    domain = tuple(x for _ in range(dim) for x in (0.0, 1.0))
    mesh = CartesianMesh(tuple(ncells), domain)

    mask_u = asm.boundary_node_mask(mesh, 2)
    free = (~mask_u).astype(dtype)
    n_u = asm.num_nodes(mesh, 2)

    # shared Q2 pattern (stiffness sparsity, zeros kept)
    pattern = asm.assemble_bilinear(mesh, 2, "stiffness", scale=1.0)
    pattern.sort_indices()
    ell_pat = ell_from_scipy(pattern)

    # constrained nu*K values aligned with the pattern
    rows_nnz = np.repeat(np.arange(n_u), np.diff(pattern.indptr))
    cols_nnz = pattern.indices
    kdata = nu * pattern.data
    kdata = kdata * free[rows_nnz] * free[cols_nnz]
    kdata = kdata + ((rows_nnz == cols_nnz) & mask_u[rows_nnz])
    K_con = sp.csr_matrix((kdata, pattern.indices, pattern.indptr), pattern.shape)
    base_vals = np.asarray(ell_from_scipy(K_con).values)
    # ell_from_scipy re-packs rows; safe because K_con shares the pattern
    # (explicit zeros preserved: same indices/indptr reused above)

    # mask per (row, slot)
    cols_ell = np.asarray(ell_pat.cols)
    mask_ell = free[:, None] * free[cols_ell]

    # quadrature tables
    elem = TensorElement(2, mesh.h, nquad=4)
    phi = elem._phi_table(None)
    dphi = np.stack([elem._phi_table(d_) for d_ in range(dim)])
    wq = elem.quad_weights()
    conn = asm.connectivity(mesh, 2)
    slots = _csr_slot_map(
        pattern,
        np.broadcast_to(conn[:, :, None], (conn.shape[0],) + (conn.shape[1],) * 2),
        np.broadcast_to(conn[:, None, :], (conn.shape[0],) + (conn.shape[1],) * 2),
    )

    # Stokes coupling blocks (velocity columns constrained); the
    # unconstrained B_fulls drive the cavity residual's constraint row
    Bs, BTs, B_fulls = [], [], []
    for c in range(dim):
        if graddiv_alpha > 0.0:
            B_full = asm.assemble_divergence_pdisc(mesh, 2, c)
        else:
            B_full = asm.assemble_divergence(mesh, 2, 1, c)
        B_fulls.append(B_full)
        B_csr = asm.zero_columns(B_full, mask_u)
        Bs.append(asm.to_ell(B_csr))
        BTs.append(asm.to_ell(B_csr.T.tocsr()))

    Mu = asm.to_ell(asm.assemble_bilinear(mesh, 2, "mass"))
    if graddiv_alpha > 0.0:
        Mp = asm.to_ell(asm.pdisc_mass_matrix(mesh))
        p_ex = asm.project_pdisc(mesh, exact_pressure)
    else:
        Mp = asm.to_ell(asm.assemble_bilinear(mesh, 1, "mass"))
        p_ex = exact_pressure(asm.node_coords(mesh, 1))

    if bc == "mms":
        coords_u = asm.node_coords(mesh, 2)
        u_ex = exact_velocity(coords_u)
        f_nodal = ns_forcing(coords_u, nu)
        f = tuple(
            jnp.asarray(
                np.where(
                    mask_u, 0.0,
                    np.asarray(Mu.matvec(jnp.asarray(f_nodal[:, c]))),
                )
            )
            for c in range(dim)
        )
        u_exact = tuple(u_ex[:, c] for c in range(dim))
    else:
        # lid-driven cavity: zero forcing, no exact solution
        f = tuple(jnp.zeros(n_u, dtype) for _ in range(dim))
        u_exact, p_ex = None, None

    prob = NavierStokesProblem(
        mesh=mesh,
        nu=nu,
        cols_ell=jnp.asarray(cols_ell),
        n_u=n_u,
        base_vals=jnp.asarray(base_vals),
        mask_ell=jnp.asarray(mask_ell),
        free_u=jnp.asarray(free),
        phi=jnp.asarray(phi),
        dphi=jnp.asarray(dphi),
        wq=jnp.asarray(wq),
        conn=jnp.asarray(conn),
        slots=jnp.asarray(slots),
        BTs=tuple(BTs),
        Bs=tuple(Bs),
        Mp=Mp,
        Mu=Mu,
        f=f,
        u_exact=u_exact,
        p_exact=p_ex,
    )
    if graddiv_alpha > 0.0:
        prob.gd_vals = _graddiv_ell_vals(prob, mesh, graddiv_alpha)
    if bc == "cavity":
        from .stokes import cavity_lift

        row_mask = jnp.asarray(
            np.broadcast_to(free[:, None], mask_ell.shape).copy()
        )
        # row-masked-only nu*K (columns kept, no identity diagonal)
        res_data = nu * pattern.data * free[rows_nnz]
        K_res = sp.csr_matrix(
            (res_data, pattern.indices, pattern.indptr), pattern.shape
        )
        prob.lift_g = tuple(
            jnp.asarray(g) for g in cavity_lift(mesh, dtype)
        )
        prob.res_vals = jnp.asarray(
            np.asarray(ell_from_scipy(K_res).values)
        )
        prob.row_mask_ell = row_mask
        prob.res_Bs = tuple(asm.to_ell(Bf) for Bf in B_fulls)
        if graddiv_alpha > 0.0:
            prob.gd_res_vals = _graddiv_ell_vals(
                prob, mesh, graddiv_alpha, mask=row_mask
            )
    return prob


# ---------------------------------------------------------------------------
# Nonlinear GMG for the velocity block (reference GMGLinearSolverFromWeakform
# with is_nonlinear=true, GMGLinearSolvers.jl:78-94,125-158: per-level
# Jacobians reassembled at the solution iterate restricted down the
# hierarchy via primal restrictions).
# ---------------------------------------------------------------------------


class Q2ConvectionAssembler:
    """Per-mesh Q2 convection machinery (subset of NavierStokesProblem's
    assembly, reusable per GMG level): velocity_block(u, newton) builds the
    d x d ELL Jacobian block at nodal velocity u."""

    def __init__(
        self,
        mesh: CartesianMesh,
        nu: float,
        dtype=np.float64,
        graddiv_alpha: float = 0.0,
        bc: str = "mms",
    ):
        dim = mesh.dim
        self.mesh = mesh
        # cavity: _u_cell must see the full iterate (incl. lid values);
        # a non-None lift_g switches the shared _u_cell off free-masking
        self.lift_g = () if bc == "cavity" else None
        mask_u = asm.boundary_node_mask(mesh, 2)
        free = (~mask_u).astype(dtype)
        n_u = asm.num_nodes(mesh, 2)
        pattern = asm.assemble_bilinear(mesh, 2, "stiffness", scale=1.0)
        pattern.sort_indices()
        ell_pat = ell_from_scipy(pattern)
        rows_nnz = np.repeat(np.arange(n_u), np.diff(pattern.indptr))
        cols_nnz = pattern.indices
        kdata = nu * pattern.data * free[rows_nnz] * free[cols_nnz]
        kdata = kdata + ((rows_nnz == cols_nnz) & mask_u[rows_nnz])
        K_con = sp.csr_matrix(
            (kdata, pattern.indices, pattern.indptr), pattern.shape
        )
        self.base_vals = jnp.asarray(np.asarray(ell_from_scipy(K_con).values))
        cols_ell = np.asarray(ell_pat.cols)
        self.cols_ell = jnp.asarray(cols_ell)
        self.mask_ell = jnp.asarray(free[:, None] * free[cols_ell])
        self.free_u = jnp.asarray(free)
        self.n_u = n_u
        elem = TensorElement(2, mesh.h, nquad=4)
        self.phi = jnp.asarray(elem._phi_table(None))
        self.dphi = jnp.asarray(
            np.stack([elem._phi_table(d_) for d_ in range(dim)])
        )
        self.wq = jnp.asarray(elem.quad_weights())
        conn = asm.connectivity(mesh, 2)
        self.conn = jnp.asarray(conn)
        self.slots = jnp.asarray(
            _csr_slot_map(
                pattern,
                np.broadcast_to(
                    conn[:, :, None], (conn.shape[0],) + (conn.shape[1],) * 2
                ),
                np.broadcast_to(
                    conn[:, None, :], (conn.shape[0],) + (conn.shape[1],) * 2
                ),
            )
        )
        self.gd_vals = (
            _graddiv_ell_vals(self, mesh, graddiv_alpha)
            if graddiv_alpha > 0.0
            else None
        )

    # reuse NavierStokesProblem's methods via duck typing
    _u_cell = NavierStokesProblem._u_cell
    _convection_elems = NavierStokesProblem._convection_elems
    _scatter = NavierStokesProblem._scatter
    velocity_block = NavierStokesProblem.velocity_block


def ns_velocity_gmg(
    ncells: Tuple[int, int],
    num_levels: int,
    nu: float = 1.0,
    smoother=None,
    dtype=np.float64,
    graddiv_alpha: float = 0.0,
    materialized_vanka: bool = False,
    cheby_degree: int = 0,
    bc: str = "mms",
    **kw,
):
    """GMG preconditioner for the Navier-Stokes velocity block with
    NONLINEAR level reassembly: level Jacobians are rebuilt at the current
    Newton iterate, which is projected down the hierarchy by solution-mode
    (injection) restrictions — the realization of the reference's
    primal_restrictions + gmg_project_solutions! machinery.

    graddiv_alpha > 0: the augmented configuration of the reference's
    NavierStokesGMG.jl:131-150 — per-level Jacobians gain the grad-div
    term, smoothers are vertex-star patch Vanka (re-extracted at each
    Newton iterate through the GMG update path = the reference's
    nonlinear patch smoothers), transfers are the exact Q2 FE embedding,
    and prolongations carry a patch correction built on the CONSTANT
    Stokes part K + G of the Jacobian (the reference re-assembles the
    correction at each iterate; the alpha-heavy term the correction
    exists for is iterate-independent, so freezing it keeps alpha-
    robustness — a declared substitution)."""
    from ..linear.gmg import GMGSolver
    from ..linear.smoothers import ChebyshevSmoother
    from ..multilevel.hierarchy import cartesian_hierarchy
    from ..multilevel.multifield import MultiFieldTransfer
    from ..multilevel.transfer import (
        StructuredProlongation,
        StructuredRestriction,
    )

    dim = len(ncells)
    hierarchy = cartesian_hierarchy(ncells, num_levels)
    assemblers = [
        Q2ConvectionAssembler(
            m, nu, dtype, graddiv_alpha=graddiv_alpha, bc=bc
        )
        for m in hierarchy.meshes
    ]

    prolongs, restricts, sol_restricts = [], [], []
    for l in range(num_levels - 1):
        fine, coarse = hierarchy[l], hierarchy[l + 1]
        fshape = asm.node_grid_shape(fine, 2)
        cshape = asm.node_grid_shape(coarse, 2)
        mf = jnp.asarray((~asm.boundary_node_mask(fine, 2)).astype(dtype))
        mc = jnp.asarray((~asm.boundary_node_mask(coarse, 2)).astype(dtype))
        Rsol = StructuredRestriction(fshape, cshape, "solution")
        sol_restricts.append(
            MultiFieldTransfer(tuple(Rsol for _ in range(dim)))
        )
        if graddiv_alpha > 0.0:
            # geometry-only (no Newton-refresh interaction): the separable
            # dense lowering, numerically identical to the ELL pair
            from ..multilevel.transfer import fe_transfer_pair_dense

            Pe, Re = fe_transfer_pair_dense(
                coarse.ncells, 2,
                asm.boundary_node_mask(fine, 2),
                asm.boundary_node_mask(coarse, 2),
            )
            prolongs.append(MultiFieldTransfer(tuple(Pe for _ in range(dim))))
            restricts.append(MultiFieldTransfer(tuple(Re for _ in range(dim))))
        else:
            P = StructuredProlongation(fshape, cshape, mf)
            R = StructuredRestriction(fshape, cshape, "residual", mc, mf)
            prolongs.append(MultiFieldTransfer(tuple(P for _ in range(dim))))
            restricts.append(MultiFieldTransfer(tuple(R for _ in range(dim))))

    if graddiv_alpha > 0.0:
        from ..linear.smoothers import RichardsonSmoother
        from .stokes import (
            graddiv_patch_prolongation,
            velocity_vanka_smoother,
        )

        if smoother is None:
            if cheby_degree > 0:
                # Chebyshev over the Vanka iteration: Richardson(10)'s
                # smoothing class at (d+1)/10 of the SpMVs (fem/stokes
                # velocity_gmg note; same vertex-star 'unit' SPD Vanka)
                from ..linear.smoothers import (
                    PreconditionedChebyshevSmoother,
                )

                smoother = [
                    PreconditionedChebyshevSmoother(
                        M=velocity_vanka_smoother(
                            m, omega=1.0, materialized=materialized_vanka
                        ),
                        degree=cheby_degree,
                    )
                    for m in hierarchy.meshes[:-1]
                ]
            else:
                smoother = [
                    RichardsonSmoother(
                        velocity_vanka_smoother(
                            m, omega=1.0, materialized=materialized_vanka
                        ),
                        niter=10,
                        omega=0.2,
                    )
                    for m in hierarchy.meshes[:-1]
                ]
        # build the patch prolongations from the NS ASSEMBLER's operators
        # (K + G at u = 0) so they share the convection-pattern ELL
        # layout: GMGSolver.update then re-extracts them at each Newton
        # iterate's Jacobian (the reference's update_transfer_operator!
        # with is_nonlinear=true) — a Stokes-assembled pattern would
        # mismatch the refreshed operators
        for l in range(num_levels - 1):
            a_l = assemblers[l]
            zero_u = tuple(jnp.zeros(a_l.n_u) for _ in range(dim))
            K0 = a_l.velocity_block(zero_u, newton=True)
            G_op = BlockOperator(
                tuple(
                    tuple(
                        ELLMatrix(
                            a_l.gd_vals[a][b], a_l.cols_ell, a_l.n_u
                        )
                        for b in range(dim)
                    )
                    for a in range(dim)
                )
            )
            prolongs[l] = graddiv_patch_prolongation(
                hierarchy[l], hierarchy[l + 1], prolongs[l], K0, G_op
            )

    def matrices_fn(A_fine, u):
        # A_fine is the assembled fine-level velocity block at the current
        # iterate; coarser Jacobians are reassembled at the injected iterate
        if u is None:
            u = tuple(
                jnp.zeros(assemblers[0].n_u) for _ in range(dim)
            )
        mats = [A_fine]
        u_lev = u
        for l in range(1, num_levels):
            u_lev = sol_restricts[l - 1].matvec(u_lev)
            mats.append(assemblers[l].velocity_block(u_lev, newton=True))
        return mats

    return GMGSolver(
        matrices_fn=matrices_fn,
        solution_restrictions=tuple(sol_restricts),
        prolongations=tuple(prolongs),
        restrictions=tuple(restricts),
        smoother=smoother or ChebyshevSmoother(degree=3, ratio=50.0),
        **kw,
    )
