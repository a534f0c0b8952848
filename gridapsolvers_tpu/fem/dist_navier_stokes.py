"""Distributed steady Navier-Stokes: sharded nonlinear (re)assembly.

Closes the round-2 gap "the serial on-device convection path in
fem/navier_stokes.py is not yet sharded": the reference assembles the
convection Jacobian as a distributed PSparseMatrix every Newton step
(test/Applications/NavierStokesGMG.jl:80-176 via Gridap.Distributed cell
loops + assemble!); here the whole refresh is ONE shard_map program —

    halo_extend(u)  ->  cell-batched einsum over local cells
                    ->  scatter-add into the extended ELL window
                    ->  halo_reduce (the reference's `assemble!`)

so each Newton step's Jacobian refresh costs the same two ppermutes as a
SpMV. Cells are partitioned by the shard owning their first dof row
(grid-aligned padding guarantees whole-grid-row ownership, so every cell's
rows/cols stay within one halo hop).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..algebra import BlockOperator
from ..algebra.block import ColumnStack, RowStack
from ..nonlinear import NonlinearOperator
from ..parallel.dist_ell import (
    DistELLMatrix,
    halo_extend,
    halo_reduce,
    localize_cols,
    pad_multiple,
    padded_ell_from_csr,
    shard_csr,
    shard_vector,
)
from . import assembly2 as asm
from .elements import TensorElement
from .mesh import CartesianMesh
from .navier_stokes import _csr_slot_map


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class FlatGrid:
    """Adapter: run a grid-shaped transfer on flat (sharded) vectors.
    (Moved here from dist_stokes.py in the round-3 consolidation — the
    NS distribution still rides the 1-D window design.)"""

    op: object
    in_shape: tuple = dataclasses.field(metadata=dict(static=True))

    def matvec(self, x):
        return self.op.matvec(x.reshape(self.in_shape)).reshape(-1)


def stokes_grid_pads(ncells, nprocs: int):
    """Grid-aligned proportional padded node-grid shapes (velocity Q2,
    pressure Q1): pressure leading axis padded to the device count, the
    velocity one to exactly twice that, so each shard's velocity slab
    covers its pressure slab spatially (one-hop coupling halos)."""
    n0 = ncells[0]
    gp = -(-(n0 + 1) // nprocs)          # pressure grid rows per shard
    P0p = nprocs * gp
    V0p = 2 * P0p
    vshape = (V0p,) + tuple(2 * n + 1 for n in ncells[1:])
    pshape = (P0p,) + tuple(n + 1 for n in ncells[1:])
    return vshape, pshape


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DistQ2Convection:
    """Row-sharded Q2 convection assembler for one mesh level.

    Holds the sharded constrained nu*K base values plus per-shard cell
    tables; `velocity_block(u, newton)` returns the d x d velocity
    Jacobian BlockOperator with DistELLMatrix leaves, entirely on device.
    """

    # sharded ELL tables (n_pad rows)
    base_vals: jnp.ndarray   # (n_pad, K)  P(axis, None)
    cols_loc: jnp.ndarray    # (n_pad, K)  window-relative columns
    mask_ell: jnp.ndarray    # (n_pad, K)  rowfree*colfree
    free_u: jnp.ndarray      # (n_pad,)
    # per-shard cell tables, leading axis = nprocs, P(axis, ...)
    conn_loc: jnp.ndarray    # (nprocs, cmax, nn) window-relative node ids
    slots: jnp.ndarray       # (nprocs, cmax, nn, nn)
    cell_mask: jnp.ndarray   # (nprocs, cmax) 1 for real cells
    # quadrature tables (replicated constants)
    phi: jnp.ndarray         # (nn, nq)
    dphi: jnp.ndarray        # (d, nn, nq)
    wq: jnp.ndarray          # (nq,)
    # statics
    n_pad: int = dataclasses.field(metadata=dict(static=True))
    m_in: int = dataclasses.field(metadata=dict(static=True))
    hl: int = dataclasses.field(metadata=dict(static=True))
    hr: int = dataclasses.field(metadata=dict(static=True))
    dim: int = dataclasses.field(metadata=dict(static=True))
    mesh: Mesh = dataclasses.field(metadata=dict(static=True))
    axis: str = dataclasses.field(metadata=dict(static=True))

    # -- device-side refresh -------------------------------------------

    def _conv_values(self, u: tuple, newton: bool):
        """Scattered + assembled N1 (and N2) ELL values, sharded.

        Returns (vals_N1, vals_N2) with vals_N2 of shape
        (n_pad, K, d, d) or None.
        """
        hl, hr, axis = self.hl, self.hr, self.axis
        m, K = self.m_in, self.base_vals.shape[1]
        d = self.dim
        phi, dphi, wq = self.phi, self.dphi, self.wq

        def f(conn_l, slots_l, cmask_l, *u_ls):
            conn_l = conn_l[0]           # (cmax, nn)
            slots_l = slots_l[0]         # (cmax, nn, nn)
            cmask_l = cmask_l[0]         # (cmax,)
            ues = [halo_extend(ul, hl, hr, axis) for ul in u_ls]
            u_cell = jnp.stack([ue[conn_l] for ue in ues], axis=-1)
            u_q = jnp.einsum(
                "cnd,nq->cqd", u_cell, phi, precision="highest"
            )
            N1 = jnp.einsum(
                "q,iq,cqb,bjq->cij", wq, phi, u_q, dphi,
                precision="highest",
            ) * cmask_l[:, None, None]
            L = hl + m + hr
            rows = jnp.broadcast_to(
                conn_l[:, :, None], slots_l.shape
            ).reshape(-1)
            z1 = jnp.zeros((L, K), N1.dtype).at[
                rows, slots_l.reshape(-1)
            ].add(N1.reshape(-1))
            out1 = halo_reduce(z1, hl, hr, axis)
            if not newton:
                return (out1,)
            grad_u = jnp.einsum(
                "cna,bnq->cqab", u_cell, dphi, precision="highest"
            )
            N2 = jnp.einsum(
                "q,iq,jq,cqab->cijab", wq, phi, phi, grad_u,
                precision="highest",
            ) * cmask_l[:, None, None, None, None]
            z2 = jnp.zeros((L, K, d, d), N2.dtype).at[
                rows, slots_l.reshape(-1)
            ].add(N2.reshape(-1, d, d))
            out2 = halo_reduce(z2, hl, hr, axis)
            return (out1, out2)

        ax = self.axis
        nvec = len(u)
        outs = jax.shard_map(
            f,
            mesh=self.mesh,
            in_specs=(P(ax), P(ax), P(ax)) + tuple(P(ax) for _ in u),
            out_specs=(
                (P(ax, None),)
                if not newton
                else (P(ax, None), P(ax, None, None, None))
            ),
        )(self.conn_loc, self.slots, self.cell_mask, *u)
        vals_N1 = outs[0] * self.mask_ell
        vals_N2 = None
        if newton:
            vals_N2 = outs[1] * self.mask_ell[:, :, None, None]
        return vals_N1, vals_N2

    def _leaf(self, values: jnp.ndarray) -> DistELLMatrix:
        return DistELLMatrix(
            values=values,
            cols_loc=self.cols_loc,
            n_cols=self.n_pad,
            m_in=self.m_in,
            hl=self.hl,
            hr=self.hr,
            mesh=self.mesh,
            axis=self.axis,
        )

    def velocity_block(self, u: tuple, newton: bool = True) -> BlockOperator:
        """d x d velocity Jacobian: delta_ab (nu K + N1) + N2_ab, sharded."""
        u = tuple(ui * self.free_u for ui in u)
        vals_N1, vals_N2 = self._conv_values(u, newton)
        d = self.dim
        blocks = []
        for a in range(d):
            row = []
            for b in range(d):
                vals = None
                if a == b:
                    vals = self.base_vals + vals_N1
                if vals_N2 is not None:
                    v2 = vals_N2[:, :, a, b]
                    vals = v2 if vals is None else vals + v2
                row.append(None if vals is None else self._leaf(vals))
            blocks.append(tuple(row))
        return BlockOperator(tuple(blocks))

    def zero_velocity(self) -> tuple:
        sh = NamedSharding(self.mesh, P(self.axis))
        return tuple(
            jax.device_put(jnp.zeros(self.n_pad), sh) for _ in range(self.dim)
        )


def dist_q2_convection(
    cmesh: CartesianMesh,
    mesh: Mesh,
    axis: str = "p",
    nu: float = 1.0,
    n_pad: Optional[int] = None,
    dtype=np.float64,
) -> DistQ2Convection:
    """Host-side construction of the sharded convection assembler."""
    dim = cmesh.dim
    nprocs = mesh.shape[axis]
    gs = asm.node_grid_shape(cmesh, 2)
    if n_pad is None:
        n_pad = int(np.prod((pad_multiple(gs[0], nprocs),) + gs[1:]))
    assert n_pad % nprocs == 0
    m_in = n_pad // nprocs
    stride = int(np.prod(gs[1:]))
    assert m_in % stride == 0, (
        "padding must be grid-aligned: shard boundaries on whole grid rows"
    )

    mask_u = asm.boundary_node_mask(cmesh, 2)
    free = (~mask_u).astype(dtype)
    n_u = asm.num_nodes(cmesh, 2)

    pattern = asm.assemble_bilinear(cmesh, 2, "stiffness", scale=1.0)
    pattern.sort_indices()
    rows_nnz = np.repeat(np.arange(n_u), np.diff(pattern.indptr))
    cols_nnz = pattern.indices
    kdata = nu * pattern.data * free[rows_nnz] * free[cols_nnz]
    kdata = kdata + ((rows_nnz == cols_nnz) & mask_u[rows_nnz])
    K_con = sp.csr_matrix(
        (kdata, pattern.indices, pattern.indptr), pattern.shape
    )

    vals_pad, cols_pad = padded_ell_from_csr(
        K_con, n_pad, n_pad, m_in, m_in, identity_pad=True, dtype=dtype
    )
    K = vals_pad.shape[1]

    # cell tables (global), then shard-local
    conn = asm.connectivity(cmesh, 2)             # (ncells, nn)
    nn = conn.shape[1]
    slots_g = _csr_slot_map(
        pattern,
        np.broadcast_to(conn[:, :, None], (conn.shape[0], nn, nn)),
        np.broadcast_to(conn[:, None, :], (conn.shape[0], nn, nn)),
    )
    owner = conn.min(axis=1) // m_in              # shard per cell
    rel = conn - owner[:, None] * m_in
    hl_a = max(0, int(-(rel.min())))
    hr_a = max(0, int(rel.max()) - m_in + 1)

    # matrix halo (from the sparsity), then the max with the assembly halo
    cols_loc, hl_m, hr_m = localize_cols(
        cols_pad.astype(np.int64), m_in, m_in
    )
    hl = max(hl_a, hl_m)
    hr = max(hr_a, hr_m)
    cols_loc = cols_loc + (hl - hl_m)
    if hl > m_in or hr > m_in:
        raise ValueError(
            f"assembly halo ({hl},{hr}) exceeds shard size {m_in}"
        )

    cmax = max(int(np.bincount(owner, minlength=nprocs).max()), 1)
    conn_loc = np.zeros((nprocs, cmax, nn), np.int32)
    slots_loc = np.zeros((nprocs, cmax, nn, nn), np.int32)
    cell_mask = np.zeros((nprocs, cmax), dtype)
    fill = np.zeros(nprocs, np.int64)
    order = np.argsort(owner, kind="stable")
    for c in order:
        s = owner[c]
        k = fill[s]
        conn_loc[s, k] = rel[c] + hl
        slots_loc[s, k] = slots_g[c]
        cell_mask[s, k] = 1.0
        fill[s] += 1

    free_pad = np.zeros(n_pad, dtype)
    free_pad[:n_u] = free
    # mask per (row, slot): pattern slots only (padding slots receive no
    # scatter, so their mask value is irrelevant)
    col_free = np.zeros(n_pad, dtype)
    col_free[:n_u] = free
    mask_ell = free_pad[:, None] * col_free[np.clip(cols_pad, 0, n_pad - 1)]

    elem = TensorElement(2, cmesh.h, nquad=4)
    phi = elem._phi_table(None)
    dphi = np.stack([elem._phi_table(d_) for d_ in range(dim)])
    wq = elem.quad_weights()

    sh2 = NamedSharding(mesh, P(axis, None))
    shc = NamedSharding(mesh, P(axis))

    def put(x, sh):
        return jax.device_put(jnp.asarray(x), sh)

    return DistQ2Convection(
        base_vals=put(vals_pad, sh2),
        cols_loc=put(cols_loc, sh2),
        mask_ell=put(mask_ell, sh2),
        free_u=put(free_pad, shc),
        conn_loc=put(conn_loc, shc),
        slots=put(slots_loc, shc),
        cell_mask=put(cell_mask, shc),
        phi=jnp.asarray(phi),
        dphi=jnp.asarray(dphi),
        wq=jnp.asarray(wq),
        n_pad=n_pad,
        m_in=m_in,
        hl=hl,
        hr=hr,
        dim=dim,
        mesh=mesh,
        axis=axis,
    )


# ---------------------------------------------------------------------------
# the distributed nonlinear problem
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DistNavierStokesProblem(NonlinearOperator):
    """Sharded NS operator: residual/jacobian on sharded block vectors."""

    assembler: DistQ2Convection
    BTs: tuple               # d DistELL (n_u_pad x n_p_pad)
    Bs: tuple                # d DistELL (n_p_pad x n_u_pad)
    Mp: DistELLMatrix
    f: tuple                 # d sharded (n_u_pad,)
    n_u: int                 # real velocity dofs
    n_p: int
    u_exact: tuple           # host arrays (real sizes)
    p_exact: np.ndarray
    serial: object = None    # serial NavierStokesProblem (validation)

    def jacobian(self, x):
        u, p = x
        Auu = self.assembler.velocity_block(u, newton=True)
        return BlockOperator(
            ((Auu, ColumnStack(self.BTs)), (RowStack(self.Bs), None))
        )

    def picard_jacobian(self, x):
        u, p = x
        Auu = self.assembler.velocity_block(u, newton=False)
        return BlockOperator(
            ((Auu, ColumnStack(self.BTs)), (RowStack(self.Bs), None))
        )

    def residual(self, x):
        u, p = x
        Auu = self.assembler.velocity_block(u, newton=False)
        r_u = Auu.matvec(u)
        grad_p = ColumnStack(self.BTs).matvec(p)
        r_u = tuple(
            ru + gp - fi for ru, gp, fi in zip(r_u, grad_p, self.f)
        )
        r_p = RowStack(self.Bs).matvec(u)
        return (r_u, r_p)

    def zero_guess(self):
        sh = NamedSharding(self.assembler.mesh, P(self.assembler.axis))
        n_p_pad = self.Mp.shape[0]
        return (
            self.assembler.zero_velocity(),
            jax.device_put(jnp.zeros(n_p_pad), sh),
        )

    def unshard(self, x):
        u, p = x
        return (
            tuple(np.asarray(jax.device_get(ui))[: self.n_u] for ui in u),
            np.asarray(jax.device_get(p))[: self.n_p],
        )

    def velocity_error(self, u) -> float:
        uh, _ = self.unshard((u, jnp.zeros(self.Mp.shape[0])))
        err = 0.0
        Mu = self.serial.Mu
        for ui, uei in zip(uh, self.u_exact):
            e = jnp.asarray(ui - uei)
            err += float(jnp.vdot(e, Mu.matvec(e)))
        return float(np.sqrt(err))


def distributed_ns_problem(
    ncells: Tuple[int, int],
    mesh: Mesh,
    axis: str = "p",
    nu: float = 1.0,
    dtype=np.float64,
) -> DistNavierStokesProblem:
    """Serial setup (host scipy assembly of the linear parts) -> sharded
    problem. The nonlinear refresh itself never touches the host again."""
    from .navier_stokes import navier_stokes_problem

    dim = len(ncells)
    nprocs = mesh.shape[axis]
    serial = navier_stokes_problem(ncells, nu=nu, dtype=dtype)
    cmesh = serial.mesh

    vshape, pshape = stokes_grid_pads(ncells, nprocs)
    n_u_pad = int(np.prod(vshape))
    n_p_pad = int(np.prod(pshape))

    assembler = dist_q2_convection(
        cmesh, mesh, axis=axis, nu=nu, n_pad=n_u_pad, dtype=dtype
    )

    Bs, BTs = [], []
    for c in range(dim):
        B_csr = asm.assemble_divergence(cmesh, 2, 1, c)
        B_csr = asm.zero_columns(
            B_csr, asm.boundary_node_mask(cmesh, 2)
        )
        B_csr.eliminate_zeros()
        Bs.append(
            shard_csr(
                B_csr, mesh, axis=axis,
                n_rows_pad=n_p_pad, n_cols_pad=n_u_pad, dtype=dtype,
            )
        )
        BT = B_csr.T.tocsr()
        BT.eliminate_zeros()
        BTs.append(
            shard_csr(
                BT, mesh, axis=axis,
                n_rows_pad=n_u_pad, n_cols_pad=n_p_pad, dtype=dtype,
            )
        )

    Mp_csr = asm.assemble_bilinear(cmesh, 1, "mass")
    Mp = shard_csr(
        Mp_csr, mesh, axis=axis, n_rows_pad=n_p_pad, n_cols_pad=n_p_pad,
        identity_pad=True, dtype=dtype,
    )

    f = tuple(
        shard_vector(np.asarray(fi), mesh, axis, n_pad=n_u_pad)
        for fi in serial.f
    )

    return DistNavierStokesProblem(
        assembler=assembler,
        BTs=tuple(BTs),
        Bs=tuple(Bs),
        Mp=Mp,
        f=f,
        n_u=serial.n_u,
        n_p=Mp_csr.shape[0],
        u_exact=serial.u_exact,
        p_exact=serial.p_exact,
        serial=serial,
    )


# ---------------------------------------------------------------------------
# distributed nonlinear velocity GMG (reassembled sharded level Jacobians)
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DistInjection:
    """Solution-mode (injection) restriction between PADDED sharded node
    grids: stride-2 slicing on the global array + fit to the coarse padded
    shape (the distributed analog of StructuredRestriction 'solution')."""

    fine_shape: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    coarse_shape: Tuple[int, ...] = dataclasses.field(
        metadata=dict(static=True)
    )

    def matvec(self, xf: jnp.ndarray) -> jnp.ndarray:
        from ..parallel.dist import _fit0

        xg = xf.reshape(self.fine_shape)
        y = xg[tuple(slice(None, None, 2) for _ in self.fine_shape)]
        return _fit0(y, self.coarse_shape).reshape(-1)


def dist_ns_velocity_gmg(
    ncells: Tuple[int, int],
    num_levels: int,
    mesh: Mesh,
    axis: str = "p",
    nu: float = 1.0,
    smoother=None,
    min_sharded_rows: int = 2,
    dtype=np.float64,
    **kw,
):
    """Sharded GMG for the NS velocity block with NONLINEAR level
    reassembly: every sharded level re-runs its DistQ2Convection refresh at
    the injected Newton iterate; levels below the sharding cutoff fall back
    to the serial assembler on replicated vectors (the reference's
    subcommunicator shrinkage, GMGLinearSolvers.jl:125-158)."""
    from ..linear.gmg import GMGSolver
    from ..linear.smoothers import ChebyshevSmoother
    from ..multilevel.hierarchy import cartesian_hierarchy
    from ..multilevel.multifield import MultiFieldTransfer
    from ..parallel.dist import DistProlongation, DistRestriction, Resharded
    from .navier_stokes import Q2ConvectionAssembler

    dim = len(ncells)
    nprocs = mesh.shape[axis]
    hierarchy = cartesian_hierarchy(ncells, num_levels)
    vshape_f, _ = stokes_grid_pads(ncells, nprocs)

    def padded_vshape(lev_mesh, lev):
        gs = asm.node_grid_shape(lev_mesh, 2)
        if lev == 0:
            return vshape_f
        return (pad_multiple(gs[0], nprocs),) + gs[1:]

    def is_sharded(lev_mesh, lev):
        if lev == num_levels - 1:
            return False
        return asm.node_grid_shape(lev_mesh, 2)[0] >= min_sharded_rows * nprocs

    assemblers = []
    for lev, lev_mesh in enumerate(hierarchy.meshes):
        if is_sharded(lev_mesh, lev):
            gsp = padded_vshape(lev_mesh, lev)
            assemblers.append(
                dist_q2_convection(
                    lev_mesh, mesh, axis=axis, nu=nu,
                    n_pad=int(np.prod(gsp)), dtype=dtype,
                )
            )
        else:
            assemblers.append(Q2ConvectionAssembler(lev_mesh, nu, dtype))

    prolongs, restricts, sol_restricts = [], [], []
    for lev in range(num_levels - 1):
        fine, coarse = hierarchy[lev], hierarchy[lev + 1]
        sh_f = is_sharded(fine, lev)
        sh_c = is_sharded(coarse, lev + 1)
        fsh = (
            padded_vshape(fine, lev) if sh_f else asm.node_grid_shape(fine, 2)
        )
        csh = (
            padded_vshape(coarse, lev + 1)
            if sh_c
            else asm.node_grid_shape(coarse, 2)
        )
        mf_np = (~asm.boundary_node_mask(fine, 2)).astype(dtype).reshape(
            asm.node_grid_shape(fine, 2)
        )
        mc_np = (~asm.boundary_node_mask(coarse, 2)).astype(dtype).reshape(
            asm.node_grid_shape(coarse, 2)
        )
        mf = jnp.asarray(
            np.pad(mf_np, [(0, a - b) for a, b in zip(fsh, mf_np.shape)])
        )
        mc = jnp.asarray(
            np.pad(mc_np, [(0, a - b) for a, b in zip(csh, mc_np.shape)])
        )
        Pop = FlatGrid(DistProlongation(fsh, csh, mf), csh)
        Rop = FlatGrid(DistRestriction(fsh, csh, mc, mf), fsh)
        Sop = FlatGrid(DistInjection(fsh, csh), fsh)
        spec_f = P(axis) if sh_f else P()
        spec_c = P(axis) if sh_c else P()
        prolongs.append(
            MultiFieldTransfer(
                tuple(Resharded(Pop, spec_f, mesh) for _ in range(dim))
            )
        )
        restricts.append(
            MultiFieldTransfer(
                tuple(Resharded(Rop, spec_c, mesh) for _ in range(dim))
            )
        )
        sol_restricts.append(
            MultiFieldTransfer(
                tuple(Resharded(Sop, spec_c, mesh) for _ in range(dim))
            )
        )

    def matrices_fn(A_fine, u):
        if u is None:
            u = (
                assemblers[0].zero_velocity()
                if isinstance(assemblers[0], DistQ2Convection)
                else tuple(
                    jnp.zeros(assemblers[0].n_u) for _ in range(dim)
                )
            )
        mats = [A_fine]
        u_lev = u
        for lev in range(1, num_levels):
            u_lev = sol_restricts[lev - 1].matvec(u_lev)
            mats.append(assemblers[lev].velocity_block(u_lev, newton=True))
        return mats

    return GMGSolver(
        matrices_fn=matrices_fn,
        solution_restrictions=tuple(sol_restricts),
        prolongations=tuple(prolongs),
        restrictions=tuple(restricts),
        smoother=smoother or ChebyshevSmoother(degree=3, ratio=50.0),
        **kw,
    )


def distributed_ns_solver(
    prob: DistNavierStokesProblem,
    ncells: Tuple[int, int],
    num_levels: int,
    mesh: Mesh,
    axis: str = "p",
    nu: float = 1.0,
    newton_rtol: float = 1e-9,
    newton_maxiter: int = 15,
    gmg_kw: Optional[dict] = None,
):
    """Newton + FGMRES + upper block-triangular preconditioning with the
    nonlinear distributed velocity GMG and pressure-mass CG (the sharded
    twin of the reference's NavierStokesGMG driver)."""
    from ..blocks import (
        BlockTriangularSolver,
        MatrixBlock,
        NonlinearSystemBlock,
    )
    from ..linear import CGSolver, FGMRESSolver, JacobiSolver
    from ..nonlinear import NewtonSolver

    gmg = dist_ns_velocity_gmg(
        ncells, num_levels, mesh, axis=axis, nu=nu, **(gmg_kw or {})
    )
    prec = BlockTriangularSolver(
        solvers=(gmg, CGSolver(Pl=JacobiSolver(), rtol=1e-10, maxiter=60)),
        blocks=(
            (NonlinearSystemBlock(), None),
            (None, MatrixBlock(prob.Mp)),
        ),
        half="upper",
    )
    fgmres = FGMRESSolver(m=40, Pr=prec, rtol=1e-10, maxiter=120)
    return NewtonSolver(
        fgmres, maxiter=newton_maxiter, rtol=newton_rtol, atol=1e-11
    )
