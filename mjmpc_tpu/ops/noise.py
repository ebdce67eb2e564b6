"""Autoregressive-filtered Gaussian action noise.

The reference generates control perturbations by drawing i.i.d. Gaussian
noise over (particles, horizon) and running an in-place AR(2) smoothing
filter along the horizon (/root/reference/mjmpc/utils/control_utils.py:24-34):

    eps[:, i] = b0*eps[:, i] + b1*eps[:, i-1] + b2*eps[:, i-2]   for i >= 2

with eps[:, 0], eps[:, 1] left unfiltered, and the previous values being the
*already filtered* ones (an IIR recurrence).

Here the sampler is a pure function of a JAX PRNG key; the recurrence is a
`lax.scan` over the horizon with the (particles, action-dim) axes vectorized
— XLA fuses the scan body into one elementwise kernel over N*dA elements.
The reference's exact NumPy procedure (global reseed + multivariate_normal)
is reproduced host-side in oracle/numpy_ref.py for parity tests.
"""
from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp


def ar_filter(eps: jax.Array, filter_coeffs: Sequence[float]) -> jax.Array:
    """Apply the reference AR(2) IIR filter along axis 1 (horizon).

    eps: [N, H, dA] raw noise. filter_coeffs: (b0, b1, b2).
    Returns filtered noise with eps[:, 0] and eps[:, 1] unmodified.
    """
    b0, b1, b2 = (float(c) for c in filter_coeffs)
    if (b0, b1, b2) == (1.0, 0.0, 0.0):
        return eps  # identity filter fast path (the common config)

    horizon = eps.shape[1]
    if horizon <= 2:
        return eps

    eps_t = jnp.moveaxis(eps, 1, 0)  # [H, N, dA]

    def body(carry, x):
        prev1, prev2, i = carry
        filtered = b0 * x + b1 * prev1 + b2 * prev2
        out = jnp.where(i < 2, x, filtered)
        return (out, prev1, i + 1), out

    init = (jnp.zeros_like(eps_t[0]), jnp.zeros_like(eps_t[0]), jnp.array(0, jnp.int32))
    _, out = jax.lax.scan(body, init, eps_t)
    return jnp.moveaxis(out, 0, 1)


def gaussian_noise(key: jax.Array, cov: jax.Array, shape: tuple, dtype=jnp.float32) -> jax.Array:
    """Draw eps ~ N(0, cov) of shape [*shape, dA] with dA = cov.shape[0].

    Full-covariance sampling via Cholesky (dA x dA is tiny — 1..7 across the
    task suite — so the factorization is negligible next to the rollout).
    """
    d_action = cov.shape[0]
    white = jax.random.normal(key, tuple(shape) + (d_action,), dtype=dtype)
    # Jitter keeps the factorization defined when the covariance collapses
    # toward singular (CEM/DMD adaptation can drive variances to ~0; the
    # reference's np.random.multivariate_normal tolerates PSD-singular
    # matrices via SVD, Cholesky does not).
    jitter = 1e-6 * jnp.eye(d_action, dtype=cov.dtype)
    chol = jnp.linalg.cholesky(cov + jitter)
    # HIGHEST: a GPU runs a default-precision f32 product in TF32
    return jnp.matmul(white, chol.T.astype(dtype),
                      precision=jax.lax.Precision.HIGHEST)


def filtered_noise(key: jax.Array, cov: jax.Array, shape: tuple,
                   filter_coeffs: Sequence[float] = (1.0, 0.0, 0.0),
                   dtype=jnp.float32) -> jax.Array:
    """Sample AR(2)-filtered Gaussian noise: the counterpart of
    reference generate_noise(cov, filter_coeffs, shape, base_seed).

    Seeding discipline: callers derive `key` with jax.random.fold_in from the
    solver key and step counter, replacing the reference's global
    np.random.seed(base_seed + num_steps).
    """
    eps = gaussian_noise(key, cov, shape, dtype)
    return ar_filter(eps, filter_coeffs)
