"""Pytree vector algebra.

Every solver in this framework operates on vectors that are arbitrary JAX
pytrees (a flat array, a tuple of per-field blocks, a dict, ...). This is the
Replacement for the reference's PVector/BlockPVector distinction:
block structure is just tree structure, and sharding is carried by the leaves,
so a single Krylov implementation serves serial, distributed, and block
systems (reference needs PartitionedArrays.jl + BlockArrays.jl for this).

Reductions (dot/norm) on sharded leaves are partitioned automatically by XLA
(lowering to psum over the device mesh), which replaces the reference's
MPI_Allreduce inside PartitionedArrays norms (SURVEY.md §2.8.5).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

tree_map = jax.tree_util.tree_map


def dot(a, b):
    """Global inner product sum_i <a_i, b_i> over all leaves (real)."""
    leaves_a = jax.tree_util.tree_leaves(a)
    leaves_b = jax.tree_util.tree_leaves(b)
    return sum(
        jnp.vdot(x, y, precision="highest")
        for x, y in zip(leaves_a, leaves_b)
    )


def norm(a):
    """Global 2-norm over all leaves."""
    return jnp.sqrt(dot(a, a))


def axpy(alpha, x, y):
    """y + alpha * x (functional)."""
    return tree_map(lambda xi, yi: yi + alpha * xi, x, y)


def axpby(alpha, x, beta, y):
    return tree_map(lambda xi, yi: alpha * xi + beta * yi, x, y)


def scale(alpha, x):
    return tree_map(lambda xi: alpha * xi, x)


def add(x, y):
    return tree_map(jnp.add, x, y)


def sub(x, y):
    return tree_map(jnp.subtract, x, y)


def mul(x, y):
    """Elementwise (Hadamard) product."""
    return tree_map(jnp.multiply, x, y)


def zeros_like(x):
    return tree_map(jnp.zeros_like, x)


def where(pred, x, y):
    """Leafwise select with a scalar predicate (for while_loop branches)."""
    return tree_map(lambda xi, yi: jnp.where(pred, xi, yi), x, y)


def ravel(x):
    """Flatten a pytree vector into one 1D array (host/debug use)."""
    leaves = jax.tree_util.tree_leaves(x)
    return jnp.concatenate([jnp.ravel(l) for l in leaves])


def flatten_concat(x):
    """Flatten a pytree vector into (flat 1D array, info) — pair with
    `unflatten_like`."""
    leaves, treedef = jax.tree_util.tree_flatten(x)
    flat = jnp.concatenate([jnp.ravel(l) for l in leaves])
    return flat, (treedef, leaves)


def unflatten_like(flat, info):
    treedef, leaves = info
    out, off = [], 0
    for l in leaves:
        out.append(flat[off : off + l.size].reshape(l.shape))
        off += l.size
    return jax.tree_util.tree_unflatten(treedef, out)
