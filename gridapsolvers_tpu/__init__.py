"""gridapsolvers_tpu — a sparse linear-algebra and preconditioned solver
framework in JAX, run on NVIDIA GPUs.

Built from scratch with the capabilities of GridapSolvers.jl (reference
surveyed in SURVEY.md) but an idiomatic XLA/shard_map design:

- ``algebra``     : sparse operator formats (ELL, stencil/DIA, block, dense)
                    as JAX pytrees with fused, gather-light matvecs.
- ``interfaces``  : solver protocol (setup/update/solve), tolerances,
                    convergence logs, solver-info trees, nullspaces.
                    (reference: src/SolverInterfaces/)
- ``linear``      : Krylov drivers (CG/GMRES/FGMRES/MINRES/Richardson),
                    smoothers (Jacobi/Chebyshev/block-GS), GMG, Schur,
                    Schwarz, wrapper solvers. (reference: src/LinearSolvers/)
- ``blocks``      : block-diagonal/triangular preconditioners for saddle
                    point systems. (reference: src/BlockSolvers/)
- ``patches``     : batched overlapping patch (vertex-star) smoothers and
                    patch transfer operators.
                    (reference: src/PatchBasedSmoothers/)
- ``multilevel``  : structured mesh hierarchies and grid transfer.
                    (reference: src/MultilevelTools/)
- ``nonlinear``   : Newton and continuation drivers.
                    (reference: src/NonlinearSolvers/)
- ``fem``         : minimal structured-grid FE layer (Q1/Q2/mixed) used to
                    generate the test/benchmark systems (reference relies on
                    the external Gridap.jl for this).
- ``parallel``    : device-mesh SPMD: sharded vectors, halo-exchange SpMV
                    via shard_map + ppermute, coarse-level re-sharding
                    (replaces PartitionedArrays.jl/MPI in the reference).
- ``models``      : application drivers (Poisson, Darcy, Stokes,
                    Navier-Stokes, Elasticity). (reference: test/Applications)
"""

__version__ = "0.1.0"
