"""Weak-scaling harness (BASELINE.json config 5).

Analog of the reference's joss_paper/scalability driver: constant local
problem size per device, growing global problem with the device count,
GMG levels deepened to keep the coarse problem size constant
(preparejobs.jl:80-105), time-per-iteration and iteration counts recorded.

Runs identically on real devices (where the timings mean something) and
on a simulated CPU mesh (algorithmic weak scaling: iteration counts must
stay flat); timings end in jax.block_until_ready.
"""
from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..fem import poisson_problem
from ..linear import CGSolver, ChebyshevSmoother
from ..multilevel import cartesian_hierarchy
from .dist import distributed_poisson_gmg, shard_grid_vector
from .mesh import device_mesh


def weak_scaling_poisson(
    local_cells: Tuple[int, int, int] = (16, 16, 16),
    device_counts: Sequence = (1, 2, 4, 8),
    base_levels: int = 3,
    rtol: float = 1e-6,
    maxiter: int = 25,
    dtype=np.float64,
) -> List[Dict]:
    """Scale the domain with the device count; deepen the hierarchy with
    log2(p) extra levels so the coarse grid stays ~constant.

    device_counts entries may be ints (1-D slab partition, x extent
    scaled) or tuples (multi-axis box partition, each extent scaled by its
    axis count — the reference's D-dimensional weak scaling,
    joss_paper/scalability/preparejobs.jl:80-105)."""
    from .mesh import device_mesh_nd

    results = []
    for p in device_counts:
        if isinstance(p, tuple):
            layout = p
            mesh = device_mesh_nd(layout)
            axis_arg = None
            p_total = int(np.prod(layout))
        else:
            layout = (p,)
            mesh = device_mesh(p)
            axis_arg = "p"
            p_total = p
        ncells = tuple(
            local_cells[d] * (layout[d] if d < len(layout) else 1)
            for d in range(len(local_cells))
        )
        nlevels = base_levels + int(np.log2(p_total))
        prob = poisson_problem(ncells, dtype=dtype)
        hierarchy = cartesian_hierarchy(ncells, nlevels)
        gmg, Ad = distributed_poisson_gmg(
            hierarchy,
            mesh,
            smoother=ChebyshevSmoother(degree=3),
            axis=axis_arg,
            dtype=jnp.float64 if dtype == np.float64 else jnp.float32,
        )
        solver = CGSolver(Pl=gmg, rtol=rtol, maxiter=maxiter)
        bd = shard_grid_vector(
            jnp.asarray(prob.b), mesh, prob.A.grid_shape, axis=axis_arg,
            target_shape=Ad.grid_shape,
        )
        state = solver.setup(Ad)

        @jax.jit
        def solve_ck(st, b):
            x, stats = solver.solve(st, b)
            return jnp.sum(x.ravel()[:8]), stats.niter

        jax.block_until_ready(solve_ck(state, bd))  # compile + warm
        t0 = time.perf_counter()
        ck, niter = jax.block_until_ready(solve_ck(state, bd))
        dt = time.perf_counter() - t0
        results.append(
            dict(
                devices=p_total,
                layout=layout,
                ncells=ncells,
                dofs=prob.A.n,
                levels=nlevels,
                iters=int(niter),
                time_s=dt,
                time_per_iter=dt / max(int(niter), 1),
            )
        )
    base = results[0]["time_per_iter"]
    for r in results:
        r["efficiency"] = base / r["time_per_iter"]
    return results


def weak_scaling_stokes(
    local_cells: Tuple[int, int] = (16, 16),
    device_counts: Sequence[int] = (1, 2, 4),
    base_levels: int = 2,
    rtol: float = 1e-8,
    maxiter: int = 60,
) -> List[Dict]:
    """Weak scaling of the flagship Stokes configuration — the exact
    subject of the reference's JOSS scalability study
    (joss_paper/scalability/src/stokes_gmg.jl, up to 3,072 cores): FGMRES
    + upper block-triangular P (velocity GMG, pressure mass CG) with the
    leading extent scaled by the device count and the hierarchy deepened
    by log2(p). Algorithmic weak scaling = flat outer FGMRES counts.

    device_counts entries may be ints (1-D slab partition) or tuples
    (multi-axis box partition via fem/dist_stokes_nd — each extent
    scaled by its axis count, the reference's np=(px,py) layouts)."""
    from ..fem.dist_stokes import (
        distributed_stokes_solver,
        distributed_stokes_system,
    )
    from ..fem.dist_stokes_nd import (
        distributed_stokes_solver_nd,
        distributed_stokes_system_nd,
    )
    from .mesh import device_mesh_nd

    results = []
    for p in device_counts:
        if isinstance(p, tuple):
            mesh = device_mesh_nd(p)
            ncells = tuple(
                local_cells[d] * (p[d] if d < len(p) else 1)
                for d in range(len(local_cells))
            )
            nlevels = base_levels + int(np.log2(max(p)))
            prob, A_dist, b_dist, _, _ = distributed_stokes_system_nd(
                ncells, mesh, p
            )
            solver, _ = distributed_stokes_solver_nd(
                ncells, nlevels, mesh, p, rtol=rtol, maxiter=maxiter
            )
            p_total = int(np.prod(p))
        else:
            mesh = device_mesh(p)
            ncells = (local_cells[0] * p,) + tuple(local_cells[1:])
            nlevels = base_levels + int(np.log2(p))
            prob, A_dist, b_dist, layout, _ = distributed_stokes_system(
                ncells, mesh
            )
            solver, _ = distributed_stokes_solver(
                ncells, nlevels, mesh, rtol=rtol, maxiter=maxiter
            )
            p_total = p
        state = solver.setup(A_dist)

        @jax.jit
        def solve_ck(st, b):
            x, stats = solver.solve(st, b)
            leaves = jax.tree_util.tree_leaves(x)
            return sum(jnp.sum(l.ravel()[:4]) for l in leaves), stats.niter

        jax.block_until_ready(solve_ck(state, b_dist))  # compile + warm
        t0 = time.perf_counter()
        ck, niter = jax.block_until_ready(solve_ck(state, b_dist))
        dt = time.perf_counter() - t0
        n_u = prob.A.block(0, 0).shape[0]
        results.append(
            dict(
                devices=p_total,
                layout=p if isinstance(p, tuple) else (p,),
                ncells=ncells,
                dofs=int(n_u + prob.Mp.shape[0]),
                levels=nlevels,
                iters=int(niter),
                time_s=dt,
                time_per_iter=dt / max(int(niter), 1),
            )
        )
    base = results[0]["time_per_iter"]
    for r in results:
        r["efficiency"] = base / r["time_per_iter"]
    return results


if __name__ == "__main__":
    # CLI. Runs on the visible devices; --simulate-cpu instead creates a
    # CPU backend with as many simulated devices as the largest requested
    # count.
    #
    # Usage: python -m gridapsolvers_tpu.parallel.weak_scaling \
    #            [--simulate-cpu] [stokes] [LXxLY[xLZ]]
    #            [counts... | PXxPY layouts...]
    # e.g.  ... stokes 48x64 1 2 4 8      (1-D slabs, JOSS local size)
    #       ... stokes 48x64 1x1 2x2 2x4  (multi-axis boxes)
    import json
    import sys

    from ..utils.cache import enable_compile_cache

    enable_compile_cache()
    args = sys.argv[1:]
    simulate = "--simulate-cpu" in args
    args = [a for a in args if a != "--simulate-cpu"]
    fn = weak_scaling_poisson
    kw = {}
    if args and args[0] == "stokes":
        fn, args = weak_scaling_stokes, args[1:]
    if args and "x" in args[0] and not args[0][0].isalpha():
        kw["local_cells"] = tuple(int(v) for v in args[0].split("x"))
        args = args[1:]

    def _count(a):
        return tuple(int(v) for v in a.split("x")) if "x" in a else int(a)

    counts = [_count(c) for c in args] or [1, 2, 4]
    if simulate:
        n = max(
            int(np.prod(c)) if isinstance(c, tuple) else c for c in counts
        )
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", n)
        jax.config.update("jax_enable_x64", True)
        from jax.extend.backend import clear_backends

        clear_backends()
        assert jax.devices()[0].platform == "cpu" and len(jax.devices()) >= n
    for r in fn(device_counts=counts, **kw):
        print(json.dumps(r), flush=True)
