"""Drive the solver stack's main paths once on an NVIDIA GPU and check
each against a plain reference.

    python chip_smoke.py                # one GPU, phases below
    python chip_smoke.py --four-cards   # four GPUs: distributed phase only

Each phase prints one JSON line: its sizes, dtype, iterations, the
setup / compile / solve seconds (every timing ends in
jax.block_until_ready), the device's peak_bytes_in_use so far, and its
check against the reference. A failed check raises, so the script exits
non-zero without the final line. On a platform other than "gpu" it exits
with code 2 before any phase runs; it never falls back to the CPU.

Phases of the one-GPU run:

1. device          platform, device_kind, count, and nvidia-smi's name and
                   power limit.
2. poisson_gmg     GMG-CG (Chebyshev V-cycle, explicit-inverse coarse solve)
                   on 3-D Poisson, f64, 256^3 cells, 5 levels
                   (models.poisson_solver). L2 error vs the exact linear
                   solution < 1e-6; true residual in f64 on the host
                   <= 1e-7 (rtol 1e-8 plus the drift between CG's
                   recursive residual and the true one).
3. flagship_f32    the same solve in f32 on the matrix-free constant
                   stencil, rtol 1e-5 (__graft_entry__._build). Host f64
                   true residual <= 1e-4, the f32 floor.
4. stokes_graddiv  augmented-Lagrangian Stokes, Q2/P1disc, 256x256 cells,
                   alpha 1e3 (models.stokes_solver), with the banded
                   engine and again with engine="flat" (field-blocked
                   ELL + materialized Vanka). FGMRES converges, the f64
                   residual of the assembled system (algebra.convert.
                   to_scipy) is <= 10 rtol, and both engines take the
                   same number of iterations +-1.
5. amg_cg          AMG-preconditioned CG on 3-D Poisson at 96^3 cells: a
                   check that the path runs (host f64 true residual).
6. ns_newton       device-loop Newton on the lid-driven cavity (Re 10),
                   nc 64: FGMRES + block-triangular [nonlinear GMG with
                   materialized Vanka, mass CG]. Newton converges; the
                   final nonlinear residual is reported.
7. ell_spmv        ELL SpMV of the AMG finest level and of the Q2
                   velocity block of phase 4 against scipy in f64, in f32
                   and f64: ||y - y_ref|| / ||y_ref|| <= 1e-6 in f32
                   (K <= 25 terms at eps32), <= 1e-13 in f64. The error
                   relative to |A||x|, the scale of the summation's
                   rounding bound, is printed beside it.
8. matmul_precision DenseInverseSolver.apply at 4913 dofs in f32 against
                   the same product in f64: <= 1e-5 relative. A TF32
                   product would be off by about 1e-3.

--four-cards runs distributed GMG-CG on 3-D Poisson (128^3 cells) and the
distributed augmented Stokes FGMRES (128x128 cells) on a 1-D mesh of 4
devices (parallel.device_mesh; NVLink joins the cards all to all), and
the same problems on a 1-device mesh. Shards must sit on 4 distinct
devices, iteration counts match +-1 and the solutions agree to 1e-10
relative in f64 (the reductions run in another order).

The last line of standard output is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np


def _emit(phase: str, **fields) -> dict:
    line = {"phase": phase, **fields}
    print(json.dumps(line, default=float), flush=True)
    return line


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _host(x) -> np.ndarray:
    import jax

    leaves = jax.tree_util.tree_leaves(x)
    return np.concatenate([np.asarray(l, np.float64).ravel() for l in leaves])


def _run(solver, A, b, label=None):
    """setup, compile and solve, each timed to completion. Returns
    (x, stats, timings). With a label, each stage's start goes to stderr,
    so a run cut by a time limit shows where it stood."""
    import jax

    def stage(name):
        if label:
            print(f"chip_smoke: {label}: {name}", file=sys.stderr, flush=True)

    stage("setup")
    t0 = time.perf_counter()
    state = jax.block_until_ready(solver.setup(A))
    t1 = time.perf_counter()
    stage("compile")
    step = jax.jit(solver.solve).lower(state, b).compile()
    t2 = time.perf_counter()
    stage("solve")
    x, stats = jax.block_until_ready(step(state, b))
    t3 = time.perf_counter()
    return x, stats, {
        "setup_s": t1 - t0, "compile_s": t2 - t1, "solve_s": t3 - t2,
    }


def _rel_residual(matvec_host, x, b) -> float:
    b = _host(b)
    return float(np.linalg.norm(b - matvec_host(_host(x))) / np.linalg.norm(b))


def phase_device() -> dict:
    """Platform check and card identity. Raises SystemExit(2) off the GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(
            f"chip_smoke: needs a GPU, JAX's default device is "
            f"{dev.platform!r}", file=sys.stderr,
        )
        raise SystemExit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    return _emit(
        "device", platform=dev.platform, kind=dev.device_kind,
        count=len(jax.devices()), nvidia_smi=smi,
    )


def phase_poisson_gmg(n: int = 256, levels: int = 5) -> dict:
    from gridapsolvers_tpu.models import poisson_solver

    t0 = time.perf_counter()
    prob, solver = poisson_solver(
        (n, n, n), num_levels=levels, rtol=1e-8, maxiter=30,
        dtype=np.float64,
    )
    assemble_s = time.perf_counter() - t0
    x, stats, t = _run(solver, prob.A, prob.b)
    assert x.dtype == np.float64, x.dtype
    l2 = float(prob.l2_error(x))
    rel = _rel_residual(prob.A.matvec_host, x, prob.b)
    assert stats.converged(), int(stats.flag)
    assert l2 < 1e-6, l2
    assert rel <= 1e-7, rel
    return _emit(
        "poisson_gmg", ncells=n, levels=levels, dofs=prob.A.n,
        dtype=str(x.dtype), iters=int(stats.niter), assemble_s=assemble_s,
        **t, peak_bytes_in_use=_peak_bytes(), l2_error=l2,
        true_rel_residual=rel, limits={"l2_error": 1e-6, "rel": 1e-7},
    )


def phase_flagship_f32(n: int = 256, levels: int = 5) -> dict:
    import jax.numpy as jnp

    from __graft_entry__ import _build
    from gridapsolvers_tpu.fem.assembly import laplacian_const

    t0 = time.perf_counter()
    prob, solver = _build((n, n, n), levels, np.float32)
    A = laplacian_const(prob.mesh, np.float32)
    b = jnp.asarray(np.asarray(prob.b, np.float32))
    assemble_s = time.perf_counter() - t0
    x, stats, t = _run(solver, A, b)
    assert x.dtype == np.float32, x.dtype
    A64 = laplacian_const(prob.mesh, np.float64).expand()
    rel = _rel_residual(A64.matvec_host, x, b)
    assert stats.converged(), int(stats.flag)
    assert rel <= 1e-4, rel
    return _emit(
        "flagship_f32", ncells=n, levels=levels, dofs=A.n,
        dtype=str(x.dtype), iters=int(stats.niter), assemble_s=assemble_s,
        **t, peak_bytes_in_use=_peak_bytes(), true_rel_residual=rel,
        limits={"rel": 1e-4},
    )


def phase_stokes_graddiv(
    n: int = 256, levels: int = 5, rtol: float = 1e-8
) -> tuple:
    """Both engines; returns (line, velocity block as scipy CSR)."""
    from gridapsolvers_tpu.algebra.convert import to_scipy
    from gridapsolvers_tpu.models import stokes_solver

    runs = {}
    for engine in ("block", "flat"):
        t0 = time.perf_counter()
        prob, solver = stokes_solver(
            (n, n), num_levels=levels, rtol=rtol, maxiter=60,
            graddiv_alpha=1e3, engine=engine,
        )
        assemble_s = time.perf_counter() - t0
        x, stats, t = _run(solver, prob.A, prob.b)
        S = to_scipy(prob.A)
        rel = _rel_residual(lambda v: S @ v, x, prob.b)
        assert stats.converged(), (engine, int(stats.flag))
        assert rel <= 10 * rtol, (engine, rel)
        runs[engine] = dict(
            iters=int(stats.niter), assemble_s=assemble_s, **t,
            true_rel_residual=rel,
        )
        if engine == "block":
            K = to_scipy(prob.A.block(0, 0))
    assert abs(runs["block"]["iters"] - runs["flat"]["iters"]) <= 1, runs
    line = _emit(
        "stokes_graddiv", ncells=n, levels=levels, alpha=1e3,
        dofs=int(S.shape[0]), dtype=str(_host(x).dtype), rtol=rtol,
        engines=runs, peak_bytes_in_use=_peak_bytes(),
        limits={"rel": 10 * rtol, "iter_diff": 1},
    )
    return line, K


def phase_amg_cg(n: int = 96) -> tuple:
    """Returns (line, finest operator as scipy CSR)."""
    from gridapsolvers_tpu.algebra.convert import to_scipy
    from gridapsolvers_tpu.fem import poisson_problem
    from gridapsolvers_tpu.linear import CGSolver
    from gridapsolvers_tpu.linear.amg import AMGSolver

    t0 = time.perf_counter()
    prob = poisson_problem((n, n, n), dtype=np.float64)
    solver = CGSolver(Pl=AMGSolver(), rtol=1e-8, maxiter=100)
    assemble_s = time.perf_counter() - t0
    x, stats, t = _run(solver, prob.A, prob.b)
    rel = _rel_residual(prob.A.matvec_host, x, prob.b)
    assert stats.converged(), int(stats.flag)
    assert rel <= 1e-7, rel
    line = _emit(
        "amg_cg", ncells=n, dofs=prob.A.n, dtype=str(x.dtype),
        iters=int(stats.niter), assemble_s=assemble_s, **t,
        peak_bytes_in_use=_peak_bytes(), true_rel_residual=rel,
        limits={"rel": 1e-7},
        note="checks that the AMG path runs; AMG at deployment size is "
        "not measured here",
    )
    return line, to_scipy(prob.A)


def phase_ns_newton(nc: int = 64, levels: int = 3) -> dict:
    import jax

    from gridapsolvers_tpu.blocks import (
        BlockTriangularSolver,
        MatrixBlock,
        NonlinearSystemBlock,
    )
    from gridapsolvers_tpu.fem.navier_stokes import (
        navier_stokes_problem,
        ns_velocity_gmg,
    )
    from gridapsolvers_tpu.interfaces import ConvergenceFlag
    from gridapsolvers_tpu.linear import (
        CGSolver,
        FGMRESSolver,
        JacobiSolver,
        RichardsonSmoother,
    )
    from gridapsolvers_tpu.nonlinear import NewtonSolver
    from gridapsolvers_tpu.patches.materialized import (
        MaterializedVankaSmoother,
    )

    nu = 0.1
    t0 = time.perf_counter()
    prob = navier_stokes_problem(
        (nc, nc), nu=nu, dtype=np.float32, bc="cavity"
    )
    smoother = RichardsonSmoother(
        MaterializedVankaSmoother(omega=1.0, seed_field=-1),
        niter=1, omega=0.8,
    )
    gmg = ns_velocity_gmg(
        (nc, nc), num_levels=levels, nu=nu, smoother=smoother, ncycles=2,
        dtype=np.float32, bc="cavity",
    )
    P = BlockTriangularSolver(
        solvers=(gmg, CGSolver(Pl=JacobiSolver(), rtol=1e-6, maxiter=30)),
        blocks=((NonlinearSystemBlock(), None), (None, MatrixBlock(prob.Mp))),
        half="upper",
    )
    fgmres = FGMRESSolver(m=40, Pr=P, rtol=1e-8, maxiter=100)
    newton = NewtonSolver(
        fgmres, maxiter=12, rtol=1e-6, atol=1e-8, loop="device"
    )
    assemble_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fn, dyn, ls, x0 = newton.prepare(prob, prob.zero_guess())
    jax.block_until_ready((dyn, ls, x0))
    t1 = time.perf_counter()
    step = fn.lower(dyn, ls, x0).compile()
    t2 = time.perf_counter()
    x, it, flag, hist = jax.block_until_ready(step(dyn, ls, x0))
    t3 = time.perf_counter()
    hist = np.asarray(hist, np.float64)
    final = float(hist[int(it)])
    host_res = float(np.linalg.norm(_host(prob.residual(x))))
    converged = int(flag) in (
        ConvergenceFlag.CONVERGED_ATOL, ConvergenceFlag.CONVERGED_RTOL
    )
    assert converged and np.isfinite(host_res), (int(it), int(flag), final)
    return _emit(
        "ns_newton", nc=nc, levels=levels, nu=nu, dtype="float32",
        newton_iters=int(it), flag=int(flag), assemble_s=assemble_s,
        setup_s=t1 - t0, compile_s=t2 - t1, solve_s=t3 - t2,
        peak_bytes_in_use=_peak_bytes(), initial_residual=float(hist[0]),
        final_residual=final, final_residual_recomputed=host_res,
        limits={"rtol": 1e-6, "atol": 1e-8},
    )


def phase_ell_spmv(matrices: dict) -> dict:
    """matrices: name -> scipy CSR. Every matrix in f32 and f64."""
    import jax
    import jax.numpy as jnp

    from gridapsolvers_tpu.algebra.ell import ell_from_scipy

    limits = {"float32": 1e-6, "float64": 1e-13}
    rng = np.random.default_rng(0)
    out = {}
    for name, S in matrices.items():
        for dt in (np.float32, np.float64):
            A = ell_from_scipy(S, dtype=dt)
            x = rng.normal(size=S.shape[1]).astype(dt)
            y = np.asarray(
                jax.block_until_ready(jax.jit(A.matvec)(jnp.asarray(x))),
                np.float64,
            )
            Sd = S.astype(dt).astype(np.float64)
            xd = x.astype(np.float64)
            y_ref = Sd @ xd
            scale = abs(Sd) @ np.abs(xd)
            diff = np.linalg.norm(y - y_ref)
            err = float(diff / np.linalg.norm(y_ref))
            key = f"{name}_{np.dtype(dt).name}"
            out[key] = dict(
                rows=int(S.shape[0]), row_width=int(A.row_width), err=err,
                err_vs_abs_scale=float(diff / np.linalg.norm(scale)),
            )
            assert err <= limits[np.dtype(dt).name], (key, err)
    return _emit(
        "ell_spmv", cases=out, peak_bytes_in_use=_peak_bytes(),
        limits=limits,
    )


def phase_matmul_precision(n_cells: int = 16) -> dict:
    import jax.numpy as jnp

    from gridapsolvers_tpu.fem import poisson_problem
    from gridapsolvers_tpu.linear import DenseInverseSolver

    A = poisson_problem((n_cells,) * 3, dtype=np.float64).A
    solver = DenseInverseSolver()
    inv32 = np.asarray(solver.setup(A)["inv"]).astype(np.float32)
    r = np.random.default_rng(1).normal(size=inv32.shape[0]).astype(
        np.float32
    )
    z = np.asarray(
        solver.apply({"inv": jnp.asarray(inv32)}, jnp.asarray(r)), np.float64
    )
    z_ref = inv32.astype(np.float64) @ r.astype(np.float64)
    rel = float(np.linalg.norm(z - z_ref) / np.linalg.norm(z_ref))
    assert rel <= 1e-5, rel
    return _emit(
        "matmul_precision", dofs=int(inv32.shape[0]), dtype="float32",
        rel_err_vs_f64=rel, limits={"rel": 1e-5},
    )


def _n_devices(x) -> int:
    import jax

    return len({
        s.device for l in jax.tree_util.tree_leaves(x)
        for s in l.addressable_shards
    })


def four_cards_poisson(mesh, n: int) -> tuple:
    """Distributed GMG-CG on 3-D Poisson, n^3 cells, f64, on `mesh`.
    Returns (solution on the host, iterations, devices holding it,
    timings)."""
    import jax.numpy as jnp

    from gridapsolvers_tpu.fem import poisson_problem
    from gridapsolvers_tpu.linear import CGSolver, ChebyshevSmoother
    from gridapsolvers_tpu.multilevel import cartesian_hierarchy
    from gridapsolvers_tpu.parallel import (
        distributed_poisson_gmg,
        shard_grid_vector,
    )
    from gridapsolvers_tpu.parallel.dist import unpad_grid_vector

    ncells = (n,) * 3
    prob = poisson_problem(ncells, dtype=np.float64)
    gmg, Ad = distributed_poisson_gmg(
        cartesian_hierarchy(ncells, 4), mesh,
        smoother=ChebyshevSmoother(degree=3), dtype=jnp.float64,
    )
    solver = CGSolver(Pl=gmg, rtol=1e-10, maxiter=40)
    bd = shard_grid_vector(
        jnp.asarray(prob.b), mesh, prob.A.grid_shape,
        target_shape=Ad.grid_shape,
    )
    x, stats, t = _run(
        solver, Ad, bd, label=f"poisson_gmg on {mesh.size} device(s)"
    )
    assert stats.converged(), int(stats.flag)
    xh = np.asarray(unpad_grid_vector(x, prob.A.grid_shape)).ravel()
    return xh, int(stats.niter), _n_devices(x), t


def four_cards_stokes(mesh, n: int) -> tuple:
    """Distributed augmented Stokes FGMRES, n x n cells, alpha 1e3, f64,
    on `mesh`. Returns what four_cards_poisson returns."""
    from gridapsolvers_tpu.fem.dist_stokes import (
        distributed_stokes_graddiv_solver,
        distributed_stokes_graddiv_system,
        unshard_stokes_solution,
    )

    ncells = (n, n)
    prob, A, b, pv, pp = distributed_stokes_graddiv_system(
        ncells, mesh, dtype=np.float64
    )
    solver, _ = distributed_stokes_graddiv_solver(
        ncells, 4, mesh, rtol=1e-10, maxiter=40, dtype=np.float64
    )
    x, stats, t = _run(
        solver, A, b, label=f"stokes_graddiv on {mesh.size} device(s)"
    )
    assert stats.converged(), int(stats.flag)
    n_u = int(np.asarray(prob.b[0][0]).size)
    n_p = int(np.asarray(prob.b[1]).size)
    u, p = unshard_stokes_solution(x, ncells, mesh, n_u, n_p, pressure="p1disc")
    return _host((tuple(u), p)), int(stats.niter), _n_devices(x), t


def phase_four_cards(n_poisson: int = 128, n_stokes: int = 128) -> dict:
    """Distributed GMG-CG (Poisson) and augmented Stokes FGMRES on a
    4-device mesh against the same code on a 1-device mesh, in f64."""
    import jax

    from gridapsolvers_tpu.parallel import device_mesh

    assert len(jax.devices()) >= 4, jax.devices()
    out = {}
    for name, fn, n in (
        ("poisson_gmg", four_cards_poisson, n_poisson),
        ("stokes_graddiv", four_cards_stokes, n_stokes),
    ):
        x1, it1, d1, t1 = fn(device_mesh(1), n)
        _emit("four_cards_run", case=name, n=n, devices=d1, iters=it1, **t1)
        x4, it4, d4, t4 = fn(device_mesh(4), n)
        _emit("four_cards_run", case=name, n=n, devices=d4, iters=it4, **t4)
        rel = float(np.linalg.norm(x4 - x1) / np.linalg.norm(x1))
        out[name] = dict(
            n=n, iters_1=it1, iters_4=it4, devices_4=d4, rel_diff=rel,
            one_device=t1, four_devices=t4,
        )
        assert d4 == 4, (name, d4)
        assert abs(it1 - it4) <= 1, (name, it1, it4)
        assert rel <= 1e-10, (name, rel)
    return _emit(
        "four_cards", dtype="float64", cases=out,
        peak_bytes_in_use=_peak_bytes(),
        limits={"rel": 1e-10, "iter_diff": 1},
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--four-cards", action="store_true",
        help="run only the distributed path on 4 GPUs and its 1-GPU twin",
    )
    args = parser.parse_args(argv)

    import jax

    from gridapsolvers_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    jax.config.update("jax_enable_x64", True)
    phase_device()
    if args.four_cards:
        phase_four_cards()
    else:
        phase_poisson_gmg()
        phase_flagship_f32()
        _, K_velocity = phase_stokes_graddiv()
        _, A_amg = phase_amg_cg()
        phase_ns_newton()
        phase_ell_spmv(
            {"amg_finest": A_amg, "q2_velocity_block": K_velocity}
        )
        phase_matmul_precision()
    dev = jax.devices()[0]
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
