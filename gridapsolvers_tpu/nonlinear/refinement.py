"""Two-float Newton endgame: push f32 residual floors toward f64.

The alpha-scaled augmented NS residual plateaus at ~1.8e-3 in f32
(= 2.2e-6 relative to the alpha-scale): the iterate's f32
REPRESENTATION and the cancelling alpha-scaled matvec ACCUMULATION both
contribute O(||J|| * eps32 * ||x||). The reference meets its f64 CI
tolerances on the same problem (NavierStokesGMG.jl + KrylovTests.jl:25
rtol 1e-8); the in-repo counterpart is iterative refinement with a
double-f32 iterate and an error-free-transform residual:

  x = x_hi + x_lo (two f32 pytrees)
  r = R_comp(x_hi (+) x_lo)     compensated matvecs (utils/compensated)
  solve J(x_hi) dx = -r          the EXISTING f32 preconditioned Krylov
  (x_hi, x_lo) <- two_sum renormalized update

Each refinement step is one jit program; two or three steps drop the
cavity grad-div residual below rtol 1e-6 * r0 with atol-free
convergence (tests/test_refinement.py measures the achieved floor).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..algebra import ELLMatrix
from ..utils import pytrees as pt
from ..utils.compensated import (
    comp_ell_matvec,
    df_add,
    fast_two_sum,
    two_sum,
)


def residual_cavity_df(prob, x_hi, x_lo):
    """Compensated cavity-NS residual at the two-float iterate.

    Structure mirrors NavierStokesProblem._residual_cavity, with every
    alpha-scaled / stiffness / coupling matvec going through
    comp_ell_matvec (exact products + exact slot accumulation, first-
    order x_lo contribution). The convection values are assembled at
    u_hi in plain f32 — their O(1) magnitudes contribute ~eps32
    absolutely, far below the alpha-scaled floor being removed — and the
    (dN1/du . u_lo) u_hi second-order term is O(eps * h^2), negligible.
    Returns an f32 residual pytree (small by construction, so the final
    rounding is harmless).
    """
    assert getattr(prob, "lift_g", None) is not None, "cavity problems only"
    (u_hi, p_hi), (u_lo, p_lo) = x_hi, x_lo
    d = len(u_hi)
    # convection at the two-float iterate's best f32 rounding
    u_eval = tuple(ui + li for ui, li in zip(u_hi, u_lo))
    N1, _ = prob._convection_elems(u_eval, newton=False)
    vals = prob.res_vals + prob._scatter(N1, mask=prob.row_mask_ell)
    gd = getattr(prob, "gd_res_vals", None)
    bdry = 1.0 - prob.free_u
    r_u = []
    for a in range(d):
        hi, lo = comp_ell_matvec(vals, prob.cols_ell, u_hi[a], u_lo[a])
        if gd is not None:
            for b in range(d):
                ghi, glo = comp_ell_matvec(
                    gd[a][b], prob.cols_ell, u_hi[b], u_lo[b]
                )
                hi, lo = df_add(hi, lo, ghi, glo)
        BT = prob.BTs[a]
        thi, tlo = comp_ell_matvec(BT.values, BT.cols, p_hi, p_lo)
        hi, lo = df_add(hi, lo, thi, tlo)
        hi, lo = df_add(hi, lo, -prob.f[a])
        # constrained rows: exact (u - g) at two-float precision
        bc_hi, bc_e = two_sum(u_hi[a], -prob.lift_g[a])
        bc_hi, bc_lo = fast_two_sum(bc_hi, bc_e + u_lo[a])
        ra = jnp.where(bdry > 0, bc_hi + bc_lo, hi + lo)
        r_u.append(ra)
    rp_hi = jnp.zeros_like(p_hi)
    rp_lo = jnp.zeros_like(p_hi)
    for c in range(d):
        B = prob.res_Bs[c]
        bhi, blo = comp_ell_matvec(B.values, B.cols, u_hi[c], u_lo[c])
        rp_hi, rp_lo = df_add(rp_hi, rp_lo, bhi, blo)
    return (tuple(r_u), rp_hi + rp_lo)


def _df_update(x_hi, x_lo, dx):
    """(x_hi, x_lo) + dx with two_sum renormalization, leafwise."""

    def upd(hi, lo, d):
        s, e = two_sum(hi, d)
        return fast_two_sum(s, e + lo)

    flat_hi, tree = jax.tree_util.tree_flatten(x_hi)
    flat_lo = jax.tree_util.tree_leaves(x_lo)
    flat_dx = jax.tree_util.tree_leaves(dx)
    out = [upd(h, l, d) for h, l, d in zip(flat_hi, flat_lo, flat_dx)]
    new_hi = jax.tree_util.tree_unflatten(tree, [o[0] for o in out])
    new_lo = jax.tree_util.tree_unflatten(tree, [o[1] for o in out])
    return new_hi, new_lo


@dataclasses.dataclass(frozen=True)
class NewtonRefinement:
    """Refinement loop around a converged f32 Newton solve.

    linear: the SAME preconditioned Krylov solver the Newton loop used
    (its state is refreshed at the refinement iterate through the
    3-arg update protocol — no new setup). niter refinement steps, each
    one jit program. Returns (x_hi, x_lo, rnorms) with rnorms[k] the
    compensated residual norm after k steps (rnorms[0] = entry floor).
    """

    linear: object
    niter: int = 3

    def refine(self, prob, x, ls_state, device=None):
        """prob's array fields ride as jit ARGUMENTS (closure capture
        would inline them as HLO constants)."""
        from .newton import _split_op_fields

        dyn0 = _split_op_fields(prob)
        x_hi = x
        x_lo = jax.tree_util.tree_map(jnp.zeros_like, x)
        solver = self.linear
        if device is not None:
            dyn0, x_hi, x_lo, ls_state = jax.device_put(
                (dyn0, x_hi, x_lo, ls_state), device
            )

        @jax.jit
        def step(dyn, x_hi, x_lo, st):
            op = dataclasses.replace(prob, **dyn)
            r = residual_cavity_df(op, x_hi, x_lo)
            A = op.jacobian(
                jax.tree_util.tree_map(lambda a, b: a + b, x_hi, x_lo)
            )
            st = solver.update(st, A, x_hi)
            dx, _ = solver.solve(
                st, jax.tree_util.tree_map(jnp.negative, r)
            )
            x_hi2, x_lo2 = _df_update(x_hi, x_lo, dx)
            return x_hi2, x_lo2, st, pt.norm(r)

        @jax.jit
        def resnorm(dyn, x_hi, x_lo):
            op = dataclasses.replace(prob, **dyn)
            return pt.norm(residual_cavity_df(op, x_hi, x_lo))

        rnorms = [float(resnorm(dyn0, x_hi, x_lo))]
        for _ in range(self.niter):
            x_hi, x_lo, ls_state, _ = step(dyn0, x_hi, x_lo, ls_state)
            rnorms.append(float(resnorm(dyn0, x_hi, x_lo)))
        return x_hi, x_lo, rnorms
