"""Real multi-process distributed execution — the analog of the
reference's `mpiexec -n 4` CI axis (test/LinearSolvers/mpi/runtests.jl:
5-20). scripts/run_multiproc.sh launches 4 OS processes x 2 CPU devices
each (jax.distributed + gloo collectives); rank 0 prints iteration
counts and checksums. This test runs it and asserts parity against the
SAME flagship builds on the single-process 8-device mesh (the repo's
seq backend) — the reference's seq-vs-mpi dual-backend check."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _single_process_reference():
    """The worker's two flagships on this process's 8-device mesh."""
    from gridapsolvers_tpu.fem import poisson_problem
    from gridapsolvers_tpu.fem.dist_stokes import (
        distributed_stokes_solver,
        distributed_stokes_system,
    )
    from gridapsolvers_tpu.linear import CGSolver, ChebyshevSmoother
    from gridapsolvers_tpu.multilevel import cartesian_hierarchy
    from gridapsolvers_tpu.parallel import (
        device_mesh,
        distributed_poisson_gmg,
        shard_grid_vector,
    )

    dtype = np.float32
    mesh = device_mesh(8)
    prob = poisson_problem((16, 16, 16), dtype=dtype)
    hierarchy = cartesian_hierarchy((16, 16, 16), 3)
    gmg, Ad = distributed_poisson_gmg(
        hierarchy, mesh, smoother=ChebyshevSmoother(degree=3),
        dtype=jnp.float32,
    )
    solver = CGSolver(Pl=gmg, rtol=1e-6, maxiter=20)
    bd = shard_grid_vector(
        jnp.asarray(np.asarray(prob.b, dtype=dtype)), mesh,
        prob.A.grid_shape, target_shape=Ad.grid_shape,
    )
    st = solver.setup(Ad)
    x, stats = jax.jit(lambda s, A, b: solver.solve(s, b))(st, Ad, bd)
    gmg_iters = int(stats.niter)
    gmg_ck = float(jnp.sum(x))

    sprob, A_dist, b_dist, pv, pq = distributed_stokes_system(
        (16, 16), mesh, dtype=dtype
    )
    ssolver, _ = distributed_stokes_solver(
        (16, 16), 2, mesh, rtol=1e-6, maxiter=40, dtype=dtype
    )
    sstate = ssolver.setup(A_dist)
    xs, sstats = jax.jit(lambda s, b: ssolver.solve(s, b))(
        sstate, b_dist
    )
    s_iters = int(sstats.niter)
    s_ck = float(
        sum(jnp.sum(l) for l in jax.tree_util.tree_leaves(xs))
    )
    return gmg_iters, gmg_ck, s_iters, s_ck


@pytest.mark.skipif(
    os.environ.get("SKIP_MULTIPROC") == "1",
    reason="multi-process launch disabled",
)
def test_multiproc_matches_single_process():
    r = subprocess.run(
        ["bash", os.path.join(REPO, "scripts", "run_multiproc.sh"),
         "4", "45997"],
        capture_output=True, text=True, timeout=900,
        env={**os.environ,
             "PYTHONPATH": REPO},
    )
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    line = [
        ln for ln in r.stdout.splitlines()
        if ln.startswith("MULTIPROC_RESULT ")
    ]
    assert line, r.stdout[-2000:]
    mp = json.loads(line[-1].split(" ", 1)[1])
    assert mp["n_devices"] == 8
    assert mp["gmg_cg_rel_resid"] < 1e-5

    # augmented grad-div flagship across real processes: alpha-robust
    # iteration regime (the single-process count is ~8 at this size)
    assert 4 <= mp["graddiv_iters"] <= 14, mp

    gmg_iters, gmg_ck, s_iters, s_ck = _single_process_reference()
    # iteration parity (fp reduction order differs across transports —
    # the reference's own seq/mpi axis tolerates the same)
    assert abs(mp["gmg_cg_iters"] - gmg_iters) <= 1, (mp, gmg_iters)
    assert abs(mp["stokes_iters"] - s_iters) <= 2, (mp, s_iters)
    assert abs(mp["gmg_cg_checksum"] - gmg_ck) <= 1e-3 * max(
        1.0, abs(gmg_ck)
    )
    assert abs(mp["stokes_checksum"] - s_ck) <= 1e-3
