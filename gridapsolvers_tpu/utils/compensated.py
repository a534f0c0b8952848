"""Error-free transformations and double-f32 ("two-float") arithmetic.

The f32 representation/accumulation floor keeps the residuals of
alpha-scaled f32 systems ~1e4 x eps32 above the reference's f64 CI
tolerances (KrylovTests.jl:25,67 asserts L2 < 1e-8). These kernels emulate
~2x f32 precision with IEEE f32 ops only:

- two_sum:  Knuth's branch-free 6-flop exact addition (s + e == a + b).
- two_prod: Dekker's split-based exact product (no FMA dependence —
  XLA does not guarantee contraction; Dekker needs only correctly
  rounded f32 multiplies). tests/test_gpu.py checks exactness on the GPU.
- comp_ell_matvec / comp_stencil_matvec: compensated SpMV returning the
  (hi, lo) unevaluated sum — the per-row accumulation error drops from
  O(K * eps * max|a_k x_k|) to O(eps^2), which is exactly the term that
  dominates the residual floor when entries are alpha-scaled and cancel.

All functions are jit-traceable elementwise code (~4x the flops of the
plain op — irrelevant for bandwidth-bound SpMV).
"""
from __future__ import annotations

import jax.numpy as jnp

# Dekker split constant for IEEE binary32 (p = 24): 2^ceil(p/2) + 1
_SPLIT32 = jnp.float32(4097.0)


def two_sum(a, b):
    """s, e with s = fl(a+b) and s + e == a + b exactly (Knuth)."""
    s = a + b
    ap = s - b
    bp = s - ap
    da = a - ap
    db = b - bp
    return s, da + db


def fast_two_sum(a, b):
    """s, e exact when |a| >= |b| (Dekker, 3 flops)."""
    s = a + b
    return s, b - (s - a)


def _split(a):
    c = _SPLIT32 * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """p, e with p = fl(a*b) and p + e == a * b exactly (Dekker)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_add(hi, lo, y_hi, y_lo=None):
    """Double-f32 addition (hi, lo) + (y_hi[, y_lo]) -> (hi, lo)."""
    s, e = two_sum(hi, y_hi)
    e = e + lo
    if y_lo is not None:
        e = e + y_lo
    return fast_two_sum(s, e)


def df_neg(hi, lo):
    return -hi, -lo


def comp_ell_matvec(values, cols, x, x_lo=None):
    """Compensated padded-ELL SpMV: y_hi + y_lo ~= values @ x to ~eps^2.

    values: (n, K) f32, cols: (n, K) int, x: (n,) f32. The slot loop
    accumulates with two_prod + two_sum so intermediate cancellation
    (the alpha-scaled grad-div rows cancel ~6 decades) is exact; only
    the final (hi, lo) pair carries rounding. x_lo (optional) is the
    low word of a two-float input vector; its contribution is first
    order (x_lo ~ eps * x), so a plain product suffices for it.
    """
    xk = x[cols]  # (n_rows, K)
    p, e = two_prod(values, xk)
    if x_lo is not None:
        e = e + values * x_lo[cols]
    # branch-free pairwise-style accumulation over the K slots
    # (rectangular-safe: output is row-shaped, not x-shaped)
    hi = jnp.zeros(values.shape[0], dtype=values.dtype)
    lo = jnp.zeros(values.shape[0], dtype=values.dtype)
    K = values.shape[1]
    for k in range(K):
        hi, ek = two_sum(hi, p[:, k])
        lo = lo + ek + e[:, k]
    return fast_two_sum(hi, lo)


def comp_stencil_matvec(A, x, x_lo=None):
    """Compensated StencilMatrix matvec -> (hi, lo) with ~eps^2
    accumulation error. Mirrors the single-device padded-slice lowering
    of StencilMatrix.matvec with two_prod per band and exact two_sum
    accumulation; x_lo contributes at first order (plain products)."""
    import numpy as np

    xg = x if A.grid_vectors else x.reshape(A.grid_shape)
    d = xg.ndim
    lo_w = [max(-min(o[k] for o in A.offsets), 0) for k in range(d)]
    hi_w = [max(max(o[k] for o in A.offsets), 0) for k in range(d)]
    xp = A._pad_halo(xg, lo_w, hi_w)
    xp_lo = None
    if x_lo is not None:
        xlg = x_lo if A.grid_vectors else x_lo.reshape(A.grid_shape)
        xp_lo = A._pad_halo(xlg, lo_w, hi_w)
    hi = jnp.zeros_like(xg)
    lo = jnp.zeros_like(xg)
    for s, off in enumerate(A.offsets):
        sl = tuple(
            slice(lo_w[k] + off[k], lo_w[k] + off[k] + xg.shape[k])
            for k in range(d)
        )
        p, e = two_prod(A.bands[s], xp[sl])
        if xp_lo is not None:
            e = e + A.bands[s] * xp_lo[sl]
        hi, ek = two_sum(hi, p)
        lo = lo + ek + e
    hi, lo = fast_two_sum(hi, lo)
    if A.grid_vectors:
        return hi, lo
    return hi.reshape(-1), lo.reshape(-1)


def comp_dot(a, b):
    """Partially compensated dot product -> (hi, lo). Exact two_prod per
    element + exact cross-chunk two_sum, but the within-chunk partial
    sums are plain f32 (a full dot2 would serialize n two_sums).
    Measured ~3-10x tighter than a plain f32 dot; NOT eps^2.
    The eps^2-grade kernel in this module is comp_ell_matvec (residual
    evaluation — where the refinement floor actually lives; the residual
    NORM of an already-small compensated residual only needs plain f32).
    """
    p, e = two_prod(a.ravel(), b.ravel())
    hi = jnp.float32(0.0)
    lo = jnp.float32(0.0)
    # chunked tree accumulation: two_sum down a fori-style python loop
    # would serialize n ops; instead reduce in two stages — exact
    # pairwise two_sum over a modest python-unrolled chunk count
    n = p.shape[0]
    nchunk = 64
    pad = (-n) % nchunk
    p = jnp.pad(p, (0, pad))
    e = jnp.pad(e, (0, pad))
    pc = p.reshape(nchunk, -1)
    ec = e.reshape(nchunk, -1)
    # within-chunk: plain f32 sums of p (error ~ eps * chunk partial),
    # compensated by summing the same chunk's e exactly in f32
    s_c = jnp.sum(pc, axis=1, dtype=jnp.float32)
    err_c = jnp.sum(ec, axis=1, dtype=jnp.float32)
    for k in range(nchunk):
        hi, ek = two_sum(hi, s_c[k])
        lo = lo + ek + err_c[k]
    return fast_two_sum(hi, lo)
