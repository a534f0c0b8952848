"""Convergence logging and solver statistics.

Redesign of the reference's ConvergenceLog
(src/SolverInterfaces/ConvergenceLogs.jl:12-16,42-60,101-150): instead of
mutating a host-side log inside the iteration (which would force host sync
per step), every solver records its residual history into a fixed-size
device array carried through lax.while_loop and returns a `SolverStats`
pytree. Pretty-printing happens post-hoc on the host, reproducing the
reference's nested-indentation output (depth).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import jax
import jax.numpy as jnp

from .tolerances import ConvergenceFlag, SolverTolerances


class VerboseLevel(enum.IntEnum):
    """Reference SolverVerboseLevel (ConvergenceLogs.jl:1-24)."""

    NONE = 0
    LOW = 1
    HIGH = 2


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SolverStats:
    """Result record of one solve. A pytree — safe to return from jit.

    niter     : number of iterations performed (device scalar).
    flag      : ConvergenceFlag value (device scalar int).
    residuals : (maxiter+1,) residual-norm history; entries past `niter`
                hold NaN.  residuals[0] is the initial residual.
    """

    niter: jnp.ndarray
    flag: jnp.ndarray
    residuals: jnp.ndarray
    # Optional solver-specific diagnostics (e.g. CG Lanczos coefficients);
    # any pytree or None.
    extra: Optional[object] = None

    @property
    def final_residual(self):
        return self.residuals[jnp.minimum(self.niter, self.residuals.shape[0] - 1)]

    def converged(self) -> bool:
        f = int(self.flag)
        return f in (ConvergenceFlag.CONVERGED_ATOL, ConvergenceFlag.CONVERGED_RTOL)


def live_print(name: str, depth: int = 0):
    """Returns a jit-safe per-iteration printer (jax.debug.callback): the
    reference's verbose ConvergenceLog output
    (`> name: iter k, r = ...`, ConvergenceLogs.jl:101-150) emitted live
    from inside the compiled loop. Use sparingly — each call is a host
    callback."""
    pad = "  " * depth

    def cb(it, rnorm):
        print(f"{pad}{name}: iteration {int(it):4d}  r = {float(rnorm):.6e}")

    def hook(it, rnorm):
        jax.debug.callback(cb, it, rnorm)

    return hook


def init_history(maxiter: int, r0norm, dtype=None) -> jnp.ndarray:
    """Fresh residual-history array with residuals[0] = ||r0||."""
    dtype = dtype or jnp.asarray(r0norm).dtype
    hist = jnp.full((maxiter + 1,), jnp.nan, dtype=dtype)
    return hist.at[0].set(r0norm)


def record(hist: jnp.ndarray, it, rnorm) -> jnp.ndarray:
    """Record residual at iteration `it` (1-based). jit/while_loop safe."""
    return hist.at[it].set(rnorm)


def make_stats(tols: SolverTolerances, niter, rnorm, r0norm, hist) -> SolverStats:
    return SolverStats(
        niter=jnp.asarray(niter),
        flag=tols.finished_flag(niter, rnorm, r0norm),
        residuals=hist,
    )


@dataclasses.dataclass
class ConvergenceLog:
    """Host-side pretty printer for SolverStats (post-hoc).

    Mirrors the reference output format: a header, per-iteration residual
    table (verbose=HIGH), and a convergence summary line, with two-space
    indentation per nesting `depth` (ConvergenceLogs.jl:71-83,101-150).
    """

    name: str
    tols: SolverTolerances = dataclasses.field(default_factory=SolverTolerances)
    verbose: VerboseLevel = VerboseLevel.NONE
    depth: int = 0

    def _indent(self) -> str:
        return "  " * self.depth

    def report(self, stats: SolverStats) -> str:
        niter = int(stats.niter)
        res = jax.device_get(stats.residuals)
        flag = ConvergenceFlag(int(stats.flag))
        pad = self._indent()
        lines = []
        if self.verbose >= VerboseLevel.HIGH:
            lines.append(f"{pad}{self.name}: starting, ||r0|| = {res[0]:.6e}")
            for it in range(1, niter + 1):
                lines.append(f"{pad}  iter {it:4d}  r = {res[it]:.6e}")
        if self.verbose >= VerboseLevel.LOW:
            rfinal = res[min(niter, len(res) - 1)]
            lines.append(
                f"{pad}{self.name}: {flag.name} in {niter} iterations, "
                f"||r|| = {rfinal:.6e}"
            )
        text = "\n".join(lines)
        if text:
            print(text)
        return text
