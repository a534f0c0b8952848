"""Newton-Raphson nonlinear driver.

Analog of the reference's NewtonSolver
(src/NonlinearSolvers/NewtonRaphsonSolver.jl:11-20,31-80). The defining
behavior replicated exactly: the current iterate x is threaded into the
linear solver's setup/update (`numerical_setup(ss, A, x)` /
`numerical_setup!(ns, A, x)`) so solution-dependent preconditioners — GMG
with reassembled level Jacobians, Triform/NonlinearSystemBlock block
preconditioners, Vanka patches — refresh at every Newton step.

The nonlinear operator protocol:
    op.residual(x) -> r (pytree)
    op.jacobian(x) -> operator (pytree with .matvec)
Both may be jax-jitted functions (on-device reassembly) or host-side.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..interfaces import (
    LinearSolver,
    SolverStats,
    SolverTolerances,
)
from ..interfaces.tolerances import ConvergenceFlag
from ..utils import pytrees as pt


class NonlinearOperator:
    """Duck-typed base for nonlinear problems."""

    def residual(self, x):
        raise NotImplementedError

    def jacobian(self, x):
        raise NotImplementedError


def _split_op_fields(op):
    """Partition a dataclass operator's fields into (dynamic, static):
    dynamic = fields whose every pytree leaf is an array/scalar (safe to
    pass as jit arguments), static = everything else (meshes, ints,
    callables — closed over, which is safe because they hold no device
    data). Device arrays must ride as ARGUMENTS: closure capture would
    inline them as HLO constants in every compiled program, and
    multi-process JAX needs them as global arrays."""
    dyn = {}
    for f in dataclasses.fields(op):
        v = getattr(op, f.name)
        leaves = jax.tree_util.tree_leaves(v)
        # arrays only: python scalars stay static (they are commonly
        # shapes/branch predicates, and they hold no device data)
        if leaves and all(
            isinstance(l, (jnp.ndarray, np.ndarray)) for l in leaves
        ):
            dyn[f.name] = v
    return dyn


# per-(solver, op) compiled device-loop cache: jax.jit caches by callable
# identity, so the jitted closure must be REUSED across solve() calls on
# the same operator (each Newton bench/run calls solve at least twice)
_DEVICE_LOOP_CACHE = {}


@dataclasses.dataclass(frozen=True)
class NewtonSolver:
    """loop='host': classic host-driven loop (one host sync per Newton
    step). loop='device': the WHOLE
    Newton iteration — inner Krylov solve, residual, Jacobian reassembly,
    preconditioner update — inside one jit program via lax.while_loop
    (zero per-step host sync; requires op.residual/op.jacobian and
    linear.update/solve traceable, which the in-repo operators are).
    Falls back to the host loop if tracing fails.

    Reference counterpart: NewtonRaphsonSolver.jl:31-80; the device loop
    is its one-program form (the reference's MPI version has no analog of
    per-step host syncs to avoid)."""

    linear: LinearSolver
    maxiter: int = 20
    atol: float = 1e-12
    rtol: float = 1e-8
    loop: str = "host"
    # live per-Newton-step residual printing (reference ConvergenceLog
    # verbose=HIGH); works in BOTH loops (device loop: jax.debug.callback)
    verbose: bool = False
    name: str = "Newton"
    depth: int = 0

    @property
    def tols(self):
        return SolverTolerances(self.maxiter, self.atol, self.rtol)

    def solve(self, op, x0):
        if self.loop == "device":
            try:
                return self._solve_device(op, x0)
            except (TypeError, ValueError, NotImplementedError) as e:
                import warnings

                warnings.warn(
                    f"NewtonSolver: device loop failed to trace "
                    f"({type(e).__name__}: {e}); falling back to host loop"
                )
        return self._solve_host(op, x0)

    def prepare(self, op, x0, device=None):
        """Device-loop plumbing, exposed for callers that control
        placement/timing (bench.py): returns (fn, dyn, ls_state, x0)
        where `fn(dyn, ls_state, x0) -> (x, niter, flag, hist)` is the
        cached one-program Newton loop. Host-side setup happens HERE
        (symbolic + first numerical, like the reference's
        symbolic_setup/numerical_setup split); pass `device` to move all
        run inputs to it in one device_put."""
        if not dataclasses.is_dataclass(op):
            raise TypeError("device loop needs a dataclass operator")
        dyn0 = _split_op_fields(op)
        # identity keys (solvers/operators hold arrays — unhashable);
        # the cache entry pins both refs so ids cannot be recycled
        key = (id(self), id(op))
        cached = _DEVICE_LOOP_CACHE.get(key)
        if cached is None or cached[0] is not op or cached[1] is not self:
            fn = self._build_device_loop(op, tuple(sorted(dyn0)))
            if len(_DEVICE_LOOP_CACHE) > 64:
                _DEVICE_LOOP_CACHE.clear()
            _DEVICE_LOOP_CACHE[key] = (op, self, fn)
        fn = _DEVICE_LOOP_CACHE[key][2]

        A = op.jacobian(x0)
        ls_state = self.linear.setup(A, x0)
        if device is not None:
            dyn0, ls_state, x0 = jax.device_put(
                (dyn0, ls_state, x0), device
            )
        return fn, dyn0, ls_state, x0

    def _solve_device(self, op, x0):
        fn, dyn0, ls_state, x0 = self.prepare(op, x0)
        x, it, flag, hist = fn(dyn0, ls_state, x0)
        stats = SolverStats(niter=it, flag=flag, residuals=hist)
        return x, stats

    def _build_device_loop(self, op, dyn_names):
        import jax.lax as lax

        solver = self

        @jax.jit
        def run(dyn, ls_state, x0):
            op2 = dataclasses.replace(op, **dyn)
            r = op2.residual(x0)
            r0 = pt.norm(r)
            hist0 = jnp.full(solver.maxiter + 1, jnp.nan)
            hist0 = hist0.at[0].set(r0)

            def tol(r0):
                return jnp.maximum(solver.atol, solver.rtol * r0)

            def cond(carry):
                x, r, rnorm, it, st, hist = carry
                return jnp.logical_and(it < solver.maxiter, rnorm > tol(r0))

            def body(carry):
                x, r, rnorm, it, st, hist = carry
                dx, _ = solver.linear.solve(st, pt.scale(-1.0, r))
                x = pt.add(x, dx)
                r = op2.residual(x)
                rnorm = pt.norm(r)
                it = it + 1
                hist = hist.at[it].set(rnorm)
                if solver.verbose:
                    from ..interfaces.logs import live_print

                    live_print(solver.name, solver.depth)(it, rnorm)

                def refresh(st):
                    A = op2.jacobian(x)
                    return solver.linear.update(st, A, x)

                st = lax.cond(
                    jnp.logical_and(it < solver.maxiter, rnorm > tol(r0)),
                    refresh,
                    lambda st: st,
                    st,
                )
                return (x, r, rnorm, it, st, hist)

            carry0 = (x0, r, r0, jnp.asarray(0), ls_state, hist0)
            x, r, rnorm, it, st, hist = lax.while_loop(cond, body, carry0)
            flag = jnp.where(
                rnorm <= solver.atol,
                int(ConvergenceFlag.CONVERGED_ATOL),
                jnp.where(
                    rnorm <= solver.rtol * r0,
                    int(ConvergenceFlag.CONVERGED_RTOL),
                    int(ConvergenceFlag.DIVERGED_MAXITER),
                ),
            )
            return x, it, flag, hist

        return run

    def _solve_host(self, op, x0):
        """Host-driven Newton loop with jitted inner solves (the assembly
        callbacks decide what runs on device)."""
        x = x0
        r = op.residual(x)
        rnorm = float(pt.norm(r))
        r0 = rnorm
        residuals = [rnorm]

        A = op.jacobian(x)
        ls_state = self.linear.setup(A, x)

        it = 0
        while it < self.maxiter and not self._done(rnorm, r0):
            dx, _ = self.linear.solve(ls_state, pt.scale(-1.0, r))
            x = pt.add(x, dx)
            r = op.residual(x)
            rnorm = float(pt.norm(r))
            residuals.append(rnorm)
            it += 1
            if self.verbose:
                pad = "  " * self.depth
                print(
                    f"{pad}{self.name}: iteration {it:4d}  "
                    f"r = {rnorm:.6e}"
                )
            if self._done(rnorm, r0):
                break
            A = op.jacobian(x)
            ls_state = self.linear.update(ls_state, A, x)

        hist = np.full(self.maxiter + 1, np.nan)
        hist[: len(residuals)] = residuals
        flag = (
            ConvergenceFlag.CONVERGED_ATOL
            if rnorm <= self.atol
            else ConvergenceFlag.CONVERGED_RTOL
            if rnorm <= self.rtol * r0
            else ConvergenceFlag.DIVERGED_MAXITER
        )
        stats = SolverStats(
            niter=jnp.asarray(it),
            flag=jnp.asarray(int(flag)),
            residuals=jnp.asarray(hist),
        )
        return x, stats

    def _done(self, rnorm, r0):
        return rnorm <= max(self.atol, self.rtol * r0)
