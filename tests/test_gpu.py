"""Numerics that only a GPU can show. Marked `gpu`: they skip in the CPU
suite and run with `python -m pytest tests/test_gpu.py -m gpu` on a
machine with an NVIDIA GPU."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.gpu


def test_f32_products_are_not_tf32(gpu_device):
    """DenseInverseSolver.apply and the GMRES basis dots on the card
    agree with f64 to f32 accuracy; TF32 would be off by ~1e-3."""
    from gridapsolvers_tpu.linear import DenseInverseSolver
    from gridapsolvers_tpu.linear.gmres import _basis_dots

    rng = np.random.default_rng(0)
    M = rng.normal(size=(2048, 2048)).astype(np.float32)
    v = rng.normal(size=2048).astype(np.float32)
    ref = M.astype(np.float64) @ v.astype(np.float64)

    z = DenseInverseSolver().apply({"inv": jnp.asarray(M)}, jnp.asarray(v))
    d = jax.jit(_basis_dots)(jnp.asarray(M), jnp.asarray(v))
    for got in (z, d):
        got = np.asarray(got, np.float64)
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-5


def test_two_float_transforms_are_exact(gpu_device):
    """two_prod / two_sum are error-free on the card: the (hi, lo) pair
    equals the f64 product / sum of the f32 inputs exactly. A contracted
    multiply-add inside the Dekker split would break this."""
    from gridapsolvers_tpu.utils.compensated import two_prod, two_sum

    rng = np.random.default_rng(1)
    a = rng.normal(size=1 << 20).astype(np.float32)
    b = (rng.normal(size=1 << 20) * 1e3).astype(np.float32)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    for fn, ref in ((two_prod, a64 * b64), (two_sum, a64 + b64)):
        hi, lo = jax.jit(fn)(jnp.asarray(a), jnp.asarray(b))
        got = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
        assert np.array_equal(got, ref), fn.__name__
