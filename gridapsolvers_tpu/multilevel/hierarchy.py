"""Structured mesh hierarchies.

Analog of the reference's ModelHierarchy machinery
(src/MultilevelTools/ModelHierarchies.jl:18-24,80-148): an ordered list of
Cartesian meshes finest-first, each coarser level a factor-2 (or given
factor) coarsening, plus the per-level assembled operators.

Divergence from the reference (SURVEY.md §7 "GMG level
re-sharding"): the reference moves coarse levels onto MPI subcommunicators
(nested rank subsets, HierarchicalArray holding `nothing` on non-member
ranks). On a device mesh ALL devices participate in every level — coarse levels
simply change the data sharding (or replicate), so there is no membership
bookkeeping and no `with_level` guard; hierarchies are plain lists.
Per-level sharding specs live in parallel/dist.py.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

from ..fem.mesh import CartesianMesh


@dataclasses.dataclass
class GridHierarchy:
    """Meshes finest-first: meshes[0] is the fine grid."""

    meshes: List[CartesianMesh]

    @property
    def num_levels(self) -> int:
        return len(self.meshes)

    def __getitem__(self, lev: int) -> CartesianMesh:
        return self.meshes[lev]


def _level_factors(factor, num_levels: int):
    """Normalize `factor`: int | per-axis tuple | per-level list of either
    (the reference's anisotropic nrefs, ModelHierarchies.jl:85-87)."""
    if isinstance(factor, list):
        assert len(factor) == num_levels - 1
        return factor
    return [factor] * (num_levels - 1)


def cartesian_hierarchy(
    ncells_fine: Tuple[int, ...],
    num_levels: int,
    domain: Optional[Tuple[float, ...]] = None,
    factor=2,
    periodic: Optional[Tuple[bool, ...]] = None,
    labels=(),
) -> GridHierarchy:
    """Build by coarsening the fine mesh (requires divisibility), mirroring
    CartesianModelHierarchy's coarsest->finest refinement chain
    (ModelHierarchies.jl:80-148) run in reverse. `factor` may be an int, a
    per-axis tuple (anisotropic nrefs), or a per-level list of either.
    `labels` = named boundary tags (reference add_labels!), inherited by
    every level."""
    dim = len(ncells_fine)
    if domain is None:
        domain = tuple(x for _ in range(dim) for x in (0.0, 1.0))
    meshes = [CartesianMesh(tuple(ncells_fine), domain, periodic, tuple(labels))]
    for f in _level_factors(factor, num_levels):
        meshes.append(meshes[-1].coarsen(f))
    return GridHierarchy(meshes)


def hierarchy_from_coarse(
    ncells_coarse: Tuple[int, ...],
    num_levels: int,
    domain: Optional[Tuple[float, ...]] = None,
    factor=2,
    periodic: Optional[Tuple[bool, ...]] = None,
    labels=(),
) -> GridHierarchy:
    """Build by refining a coarse seed (the reference's primary direction,
    ModelHierarchies.jl:127-146). `labels` = named boundary tags
    (reference add_labels!), inherited by every level."""
    dim = len(ncells_coarse)
    if domain is None:
        domain = tuple(x for _ in range(dim) for x in (0.0, 1.0))
    meshes = [
        CartesianMesh(tuple(ncells_coarse), domain, periodic, tuple(labels))
    ]
    for f in _level_factors(factor, num_levels):
        meshes.insert(0, meshes[0].refine(f))
    return GridHierarchy(meshes)


def octree_cartesian_hierarchy(
    ncells_coarse: Tuple[int, ...],
    num_levels: int,
    domain: Optional[Tuple[float, ...]] = None,
    num_refs_coarse: int = 0,
    periodic: Optional[Tuple[bool, ...]] = None,
    factor=2,
) -> GridHierarchy:
    """Uniform-octree hierarchy from a coarse Cartesian seed — the
    reference's P4estCartesianModelHierarchy
    (ext/GridapP4estExt/GridapP4estExt.jl:25-39): the seed is pre-refined
    `num_refs_coarse` times to form the coarsest level, then refined into
    `num_levels` levels. The reference's per-level processor counts
    (np_per_level) map to per-level sharding choices in parallel/dist;
    ADAPTIVE (non-uniform) refinement lives in multilevel/adaptive.py."""
    seed = tuple(n * (2 ** num_refs_coarse) for n in ncells_coarse)
    return hierarchy_from_coarse(seed, num_levels, domain, factor, periodic)


def compute_hierarchy_matrices(
    hierarchy: GridHierarchy,
    assemble: Callable[[CartesianMesh], object],
) -> List[object]:
    """Per-level operator assembly (reference
    FESpaceHierarchies.jl:141-174 compute_hierarchy_matrices): geometric
    rediscretization on every level."""
    return [assemble(mesh) for mesh in hierarchy.meshes]
