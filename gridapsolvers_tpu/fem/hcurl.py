"""H(curl) machinery: Nédélec edge elements + AMS-lite preconditioner.

Covers the reference's auxiliary-space solver family
(ext/GridapPETScExt/HipmairXuSolvers.jl:31-61 — hypre AMS fed with the
discrete gradient G and nodal interpolation Π built by
PETScUtils.interpolation_operator:82-139). Model problem

    a(u, v) = α ∫ curl u · curl v + β ∫ u · v

on lowest-order Nédélec edge elements over a uniform grid, with essential
(tangential) boundary conditions.

Assembly exploits the discrete de Rham complex on tensor grids:
curl maps the edge space EXACTLY onto the RT0 face space via a ±1/h
incidence operator C (and C @ G == 0 identically), so

    A = α Cᵀ M_face C + β M_edge

with every factor a Kronecker chain of 1D matrices (reusing darcy.rt0
blocks for M_face). The AMS-lite preconditioner is the additive
Hiptmair/auxiliary-space operator

    P r = S r + G B_node(Gᵀ r) + Π B_vec(Πᵀ r)

with S a Chebyshev edge smoother and B the smoothed-aggregation AMG of
the projected nodal systems (hypre BoomerAMG's role).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from ..algebra.ell import ell_from_scipy
from ..interfaces import LinearSolver
from . import assembly2 as asm2
from .darcy import _kron_chain, _rt0_mass_1d, rt0_blocks


def edge_shape(ncells, d) -> Tuple[int, ...]:
    """Family-d edges: cells along axis d, nodes transverse."""
    return tuple(
        n if a == d else n + 1 for a, n in enumerate(ncells)
    )


def _diff_1d(n: int, h: float) -> sp.csr_matrix:
    """(n, n+1) node-difference / h along one axis."""
    return (
        sp.diags([np.full(n, -1.0), np.full(n, 1.0)], [0, 1], shape=(n, n + 1))
        / h
    ).tocsr()


def _avg_1d(n: int) -> sp.csr_matrix:
    """(n, n+1) endpoint average (nodal -> edge interpolation 1D)."""
    return sp.diags(
        [np.full(n, 0.5), np.full(n, 0.5)], [0, 1], shape=(n, n + 1)
    ).tocsr()


def edge_mass(ncells) -> list:
    """Per-family Nédélec edge mass: constant along the edge axis (cell
    measure), 1D hats transverse."""
    dim = len(ncells)
    h = tuple(1.0 / n for n in ncells)
    out = []
    for d in range(dim):
        parts = []
        for a, n in enumerate(ncells):
            if a == d:
                parts.append(sp.identity(n) * h[a])
            else:
                parts.append(_rt0_mass_1d(n + 1, h[a]))
        out.append(_kron_chain(parts))
    return out


def discrete_gradient(ncells) -> list:
    """G: nodes -> edges per family (reference
    PETScUtils.interpolation_operator gradient mode). Family d is the
    1D difference along axis d, identity transverse."""
    dim = len(ncells)
    h = tuple(1.0 / n for n in ncells)
    out = []
    for d in range(dim):
        parts = [
            _diff_1d(n, h[a]) if a == d else sp.identity(n + 1)
            for a, n in enumerate(ncells)
        ]
        out.append(_kron_chain(parts))
    return out


def nodal_interpolation(ncells) -> list:
    """Π: nodal scalar field -> family-d edge values (endpoint averages;
    the AMS Π operator per vector component)."""
    dim = len(ncells)
    out = []
    for d in range(dim):
        parts = [
            _avg_1d(n) if a == d else sp.identity(n + 1)
            for a, n in enumerate(ncells)
        ]
        out.append(_kron_chain(parts))
    return out


def discrete_curl(ncells) -> list:
    """C: edges -> faces (3D, per face family) or cells (2D, scalar curl):
    the ±1/h incidence realizing curl exactly on the complex
    (C @ G == 0 identically)."""
    dim = len(ncells)
    h = tuple(1.0 / n for n in ncells)

    def chain(op_axis: dict) -> sp.csr_matrix:
        parts = []
        for a, n in enumerate(ncells):
            kind = op_axis.get(a)
            if kind == "diff":
                parts.append(_diff_1d(n, h[a]))
            elif kind == "cell":
                parts.append(sp.identity(n))
            else:
                parts.append(sp.identity(n + 1))
        return _kron_chain(parts)

    if dim == 2:
        # scalar curl on cells: d(uy)/dx - d(ux)/dy
        Cx = -chain({0: "cell", 1: "diff"})   # acts on ux (nx, ny+1)
        Cy = chain({0: "diff", 1: "cell"})    # acts on uy (nx+1, ny)
        return [Cx, Cy]
    assert dim == 3
    # (curl u)_x on x-faces = d(uz)/dy - d(uy)/dz, etc. Each entry maps one
    # edge family to one face family; return a 3x3 grid (face, edge).
    Z = None
    C = [[Z] * 3 for _ in range(3)]
    # face family f, with (a, b) the cyclic pair after f
    for f in range(3):
        a, b = (f + 1) % 3, (f + 2) % 3
        # (curl u)_f = d(u_b)/d(a) - d(u_a)/d(b)
        C[f][b] = chain({a: "diff", b: "cell"})
        C[f][a] = -chain({b: "diff", a: "cell"})
    return C


def edge_boundary_masks(ncells) -> list:
    """Essential (tangential) boundary masks per edge family: family-d
    edges lying on any boundary face NOT normal to d."""
    dim = len(ncells)
    out = []
    for d in range(dim):
        shape = edge_shape(ncells, d)
        m = np.zeros(shape, dtype=bool)
        for a in range(dim):
            if a == d:
                continue
            idx = [slice(None)] * dim
            idx[a] = 0
            m[tuple(idx)] = True
            idx[a] = shape[a] - 1
            m[tuple(idx)] = True
        out.append(m.reshape(-1))
    return out


def curlcurl_system(ncells, alpha: float = 1.0, beta: float = 1.0):
    """Assemble the (d*d)-block curl-curl + mass system with essential
    tangential BCs eliminated. Returns dict with scipy blocks, masks, and
    the auxiliary operators G (per family) and Pi (per family)."""
    dim = len(ncells)
    Me = edge_mass(ncells)
    masks = edge_boundary_masks(ncells)
    C = discrete_curl(ncells)

    if dim == 2:
        ncellsv = int(np.prod(ncells))
        cellvol = float(np.prod([1.0 / n for n in ncells]))
        W = sp.identity(ncellsv) * cellvol
        blocks = [[None] * 2 for _ in range(2)]
        for a in range(2):
            for b in range(2):
                S = alpha * (C[a].T @ W @ C[b]).tocsr()
                if a == b:
                    S = S + beta * Me[a]
                blocks[a][b] = S
    else:
        rt = rt0_blocks(ncells)
        Mf = rt["M"]
        blocks = [[None] * 3 for _ in range(3)]
        for a in range(3):
            for b in range(3):
                S = None
                for f in range(3):
                    Ca, Cb = C[f][a], C[f][b]
                    if Ca is None or Cb is None:
                        continue
                    term = alpha * (Ca.T @ Mf[f] @ Cb).tocsr()
                    S = term if S is None else (S + term).tocsr()
                if a == b:
                    S = (S + beta * Me[a]).tocsr() if S is not None else (
                        beta * Me[a]
                    )
                blocks[a][b] = S

    # eliminate tangential boundary edges
    for a in range(dim):
        for b in range(dim):
            S = blocks[a][b]
            if S is None:
                continue
            S = asm2.zero_rows(S.tocsr(), masks[a])
            S = asm2.zero_columns(S, masks[b])
            if a == b:
                S = (S + sp.diags(masks[a].astype(float))).tocsr()
            blocks[a][b] = S.tocsr()

    return dict(
        blocks=blocks,
        masks=masks,
        G=discrete_gradient(ncells),
        Pi=nodal_interpolation(ncells),
        Me=Me,
        ncells=tuple(ncells),
    )


def curlcurl_operator(ncells, alpha: float = 1.0, beta: float = 1.0):
    """(BlockOperator over edge families, free masks, system dict)."""
    from ..algebra import BlockOperator

    S = curlcurl_system(ncells, alpha, beta)
    rows = tuple(
        tuple(
            None if b is None else ell_from_scipy(b) for b in row
        )
        for row in S["blocks"]
    )
    free = tuple(jnp.asarray((~m).astype(float)) for m in S["masks"])
    return BlockOperator(rows), free, S


@jax.tree_util.register_static
@dataclasses.dataclass(frozen=True, eq=False)
class _AMSPattern:
    """Static state node holding the host-side (scipy) masked projection
    matrices, so AMSSolver.update can recompute GᵀAG / ΠᵀAΠ without a
    full re-setup (pattern-reusing numerical_setup!, like AMGSolver)."""

    G: object
    Pis: tuple


@dataclasses.dataclass(frozen=True, eq=False)
class AMSSolver(LinearSolver):
    """AMS-lite: additive auxiliary-space preconditioner for curl-curl
    systems (reference HipmairXuSolvers.jl AMS via hypre).

        P r = S r + G B_g (Gᵀ r) + Π B_Π (Πᵀ r)

    S: Chebyshev edge smoother; B_g: AMG on the gradient-space projection
    Gᵀ A G; B_Π: AMG per vector component on Πᵀ A Π (optional).
    Construct with make_ams(...).
    """

    system: dict = None
    smoother: object = None
    vector_correction: bool = True

    def setup(self, A, x=None):
        from ..linear.amg import AMGSolver
        from ..linear.smoothers import ChebyshevSmoother

        sys = self.system
        dim = len(sys["ncells"])
        masks = sys["masks"]
        blocks = sys["blocks"]
        # flat scipy system for the projections
        Afull = sp.bmat(
            [
                [
                    blocks[a][b]
                    if blocks[a][b] is not None
                    else sp.csr_matrix(blocks[a][a].shape)
                    for b in range(dim)
                ]
                for a in range(dim)
            ],
            format="csr",
        )
        # G maps nodes -> concatenated edges, with constrained edge rows
        # zeroed (the correction lives in the free space)
        free_diag = sp.diags(
            np.concatenate([(~m).astype(float) for m in masks])
        )
        G = free_diag @ sp.vstack(sys["G"], format="csr")
        Anode = (G.T @ Afull @ G).tocsr()
        # boundary nodes decouple under the masked G: regularize
        dn = Anode.diagonal()
        Anode = (Anode + sp.diags(np.where(dn == 0, 1.0, 0.0))).tocsr()

        amg = AMGSolver(coarse_size=200)
        state = {
            "G": ell_from_scipy(G),
            "GT": ell_from_scipy(G.T.tocsr()),
            "node": amg.setup(ell_from_scipy(Anode)),
            # host-side projection matrices (geometric — fixed across
            # numerical_setup! calls) carried as a static pytree node so
            # update() can re-project without rebuilding patterns
            "host": _AMSPattern(G, ()),
        }

        sm = self.smoother or ChebyshevSmoother(degree=3)
        state["sm"] = sm.setup(A)
        state["A"] = A

        if self.vector_correction:
            offs = np.cumsum(
                [0] + [len(m) for m in masks]
            )
            Pis, PiTs, vec_states, Pi_sps = [], [], [], []
            for c in range(dim):
                # Π_c: nodal scalar -> edges of family c only (zero rows
                # for the other families), constrained edges zeroed
                Pi_c = sp.vstack(
                    [
                        sys["Pi"][c]
                        if a == c
                        else sp.csr_matrix(
                            (len(masks[a]), sys["Pi"][c].shape[1])
                        )
                        for a in range(dim)
                    ],
                    format="csr",
                )
                Pi_c = free_diag @ Pi_c
                Avec = (Pi_c.T @ Afull @ Pi_c).tocsr()
                dv = Avec.diagonal()
                Avec = (
                    Avec + sp.diags(np.where(dv == 0, 1.0, 0.0))
                ).tocsr()
                Pis.append(ell_from_scipy(Pi_c))
                PiTs.append(ell_from_scipy(Pi_c.T.tocsr()))
                vec_states.append(amg.setup(ell_from_scipy(Avec)))
                Pi_sps.append(Pi_c)
            state["Pi"] = tuple(Pis)
            state["PiT"] = tuple(PiTs)
            state["vec"] = tuple(vec_states)
            state["host"] = _AMSPattern(G, tuple(Pi_sps))
        return state

    def update(self, state, A, x=None):
        """Pattern-reusing numerical_setup!: the geometric projections
        (G, Π) and the AMG aggregation patterns are fixed across operator
        updates; only the triple products GᵀAG / ΠᵀAΠ and the level values
        recompute (mirrors AMGSolver.update)."""
        host = state.get("host") if isinstance(state, dict) else None
        if host is None:
            return self.setup(A, x)
        from ..algebra.convert import to_scipy
        from ..linear.smoothers import ChebyshevSmoother

        amg = self._amg()
        Afull = to_scipy(A).tocsr()

        def _project(P):
            Ap = (P.T @ Afull @ P).tocsr()
            d = Ap.diagonal()
            return (Ap + sp.diags(np.where(d == 0, 1.0, 0.0))).tocsr()

        new = dict(state)
        new["node"] = amg.update(
            state["node"], ell_from_scipy(_project(host.G))
        )
        sm = self.smoother or ChebyshevSmoother(degree=3)
        new["sm"] = sm.update(state["sm"], A)
        new["A"] = A
        if self.vector_correction and "Pi" in state:
            new["vec"] = tuple(
                amg.update(vs, ell_from_scipy(_project(Pi_c)))
                for Pi_c, vs in zip(host.Pis, state["vec"])
            )
        return new

    def _amg(self):
        from ..linear.amg import AMGSolver

        return AMGSolver(coarse_size=200)

    def apply(self, state, r):
        from ..linear.smoothers import ChebyshevSmoother
        from ..utils.pytrees import flatten_concat, unflatten_like

        sm = self.smoother or ChebyshevSmoother(degree=3)
        z = sm.apply(state["sm"], r)
        flat, info = flatten_concat(r)
        amg = self._amg()
        zg = state["G"].matvec(
            amg.apply(state["node"], state["GT"].matvec(flat))
        )
        acc = zg
        if self.vector_correction and "Pi" in state:
            for Pi, PiT, vs in zip(state["Pi"], state["PiT"], state["vec"]):
                acc = acc + Pi.matvec(amg.apply(vs, PiT.matvec(flat)))
        return jax.tree_util.tree_map(
            jnp.add, z, unflatten_like(acc, info)
        )

    def solve(self, state, b, x0=None):
        return self.apply(state, b), None

    def smooth(self, state, x, r):
        from ..utils import pytrees as pt

        dx = self.apply(state, r)
        x = pt.add(x, dx)
        r = pt.sub(r, state["A"].matvec(dx))
        return x, r


def make_ams(
    ncells,
    alpha: float = 1.0,
    beta: float = 1.0,
    smoother=None,
    vector_correction: bool = True,
):
    """Build (A, free_masks, AMSSolver) for the model curl-curl problem."""
    A, free, sysd = curlcurl_operator(ncells, alpha, beta)
    return A, free, AMSSolver(
        system=sysd, smoother=smoother, vector_correction=vector_correction
    )
