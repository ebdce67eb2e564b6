"""Core control-math kernels, as pure JAX functions.

These mirror the semantics of the reference's math-kernel library
(/root/reference/mjmpc/utils/control_utils.py) but are written for XLA:
no in-place loops, no global RNG; reductions/cumsums vectorize over the
particle axis and fuse into the surrounding solve under jit.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def gamma_sequence(gamma: float, horizon: int) -> np.ndarray:
    """Discount sequence [1, gamma, gamma^2, ...] of shape [1, horizon].

    Matches reference controller.py:71 (np.cumprod of [1, gamma, ...]).
    Computed with NumPy at solver-build time: it is a static constant of the
    solve, so we keep it out of the traced graph.
    """
    return np.cumprod([1.0] + [float(gamma)] * (horizon - 1)).reshape(1, horizon)


def discount_matrix(gamma_seq) -> jax.Array:
    """Upper-triangular [H, H] matrix M with M[s, t] = gamma^(s-t) for
    s >= t, built by gathering from gamma_seq (gamma_seq[k] = gamma^k).

    Exact for every gamma including 0 (M degenerates to the identity — the
    reference's zero-discount passthrough, control_utils.py:41-42, with no
    special case), and for generalized weight sequences like MPPIQ's
    (gamma*lam)^t.
    """
    gamma_seq = jnp.asarray(gamma_seq).reshape(-1)
    h = gamma_seq.shape[0]
    s = jnp.arange(h)[:, None]
    t = jnp.arange(h)[None, :]
    return jnp.where(s >= t, gamma_seq[jnp.abs(s - t)], 0.0)


def cost_to_go(cost_seq: jax.Array, gamma_seq) -> jax.Array:
    """Discounted cost-to-go matrix for a batch of cost sequences.

    cost_seq: [..., H] per-step costs; gamma_seq: [1, H] or [H] discount
    sequence (cumprod powers). Returns [..., H] with out[..., t] =
    sum_{s>=t} gamma^{s-t} c_s.

    The reference computes this with a reversed cumsum of gamma_seq*costs
    divided by gamma_seq (control_utils.py:37-46) — numerically fragile
    (gamma^t underflow in the division) and zero-gamma needs a branch.
    Here it is one [.., H] @ [H, H] contraction against the discount
    matrix, exact at gamma=0 and fused by XLA into the surrounding solve.

    HIGHEST precision is mandatory: at a reduced default matmul precision
    (bf16 passes, or TF32 on a GPU) this contraction errs by O(1) on
    realistic cost scales
    and even gamma=0 is no longer a passthrough — softmax weights,
    elite top-k, and argmin selections all read these values.
    """
    m = discount_matrix(gamma_seq).astype(cost_seq.dtype)
    return jnp.matmul(cost_seq, m, precision=jax.lax.Precision.HIGHEST)


def scale_ctrl(ctrl: jax.Array, action_lows: jax.Array, action_highs: jax.Array,
               squash_fn: str = "clip") -> jax.Array:
    """Squash normalized controls into action bounds.

    Mirrors reference control_utils.py:3-12: 'clip' clips to [-1, 1],
    'tanh' squashes, then affinely maps into [lows, highs].
    """
    half = (action_highs - action_lows) / 2.0
    mid = (action_highs + action_lows) / 2.0
    if squash_fn == "clip":
        ctrl = jnp.clip(ctrl, -1.0, 1.0)
    elif squash_fn == "tanh":
        ctrl = jnp.tanh(ctrl)
    elif squash_fn != "none":
        raise ValueError(f"unknown squash_fn {squash_fn!r}")
    return mid + ctrl * half


def clip_ctrl(ctrl: jax.Array, action_lows, action_highs) -> jax.Array:
    """Hard-clip actions to bounds (what env.step does in the reference)."""
    return jnp.clip(ctrl, action_lows, action_highs)


# ---------------------------------------------------------------------------
# Gaussian utilities (reference control_utils.py:53-124). Column convention
# follows the reference: x and mean are [N, num_samples] with N the event dim.
# ---------------------------------------------------------------------------

def _cov_inv_logdet(cov: jax.Array, cov_type: str):
    if cov_type == "diagonal":
        d = jnp.diagonal(cov)
        return jnp.diag(1.0 / d), jnp.sum(jnp.log(d))
    chol = jnp.linalg.cholesky(cov)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(chol)))
    inv = jax.scipy.linalg.cho_solve((chol, True), jnp.eye(cov.shape[0], dtype=cov.dtype))
    return inv, logdet


def gaussian_logprob(mean, cov, x, cov_type: str = "full"):
    """log N(x; mean, cov) for a batch of samples in columns.

    mean, x: [N, num_samples]; cov: [N, N]. Returns [num_samples].
    (reference control_utils.py:53-79)
    """
    n = cov.shape[0]
    cov_inv, cov_logdet = _cov_inv_logdet(cov, cov_type)
    diff = (x - mean).T
    maha = -0.5 * jnp.sum((diff @ cov_inv) * diff, axis=1)
    return maha - 0.5 * n * jnp.log(2.0 * jnp.pi) - 0.5 * cov_logdet


def gaussian_logprobgrad(mean, cov, x, cov_type: str = "full"):
    """d log N(x)/d mean, shape [num_samples, N] (control_utils.py:81-88)."""
    cov_inv, _ = _cov_inv_logdet(cov, cov_type)
    return (x - mean).T @ cov_inv


def gaussian_entropy(cov, cov_type: str = "full"):
    """Entropy of N(., cov) (control_utils.py:90-101)."""
    n = cov.shape[0]
    _, cov_logdet = _cov_inv_logdet(cov, cov_type)
    return 0.5 * cov_logdet + 0.5 * n * (1.0 + jnp.log(2.0 * jnp.pi))


def gaussian_kl(mean0, cov0, mean1, cov1, cov_type: str = "full"):
    """KL(N0 || N1) per sample column (control_utils.py:103-124)."""
    n = cov0.shape[0]
    cov1_inv, cov1_logdet = _cov_inv_logdet(cov1, cov_type)
    if cov_type == "diagonal":
        cov0_logdet = jnp.sum(jnp.log(jnp.diagonal(cov0)))
    else:
        _, cov0_logdet = _cov_inv_logdet(cov0, cov_type)
    term1 = 0.5 * jnp.trace(cov1_inv @ cov0)
    diff = (mean1 - mean0).T
    maha = 0.5 * jnp.sum((diff @ cov1_inv) * diff, axis=1)
    term3 = 0.5 * (-1.0 * n + cov1_logdet - cov0_logdet)
    return term1 + maha + term3
