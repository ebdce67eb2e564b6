"""Inputs and plain-engine references for comparing a fused rollout
kernel with `rollout/engine.py` at any width (chip_smoke.py, the
GPU-marked tests)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..rollout.engine import rollout_closed_loop_linear, rollout_open_loop

# Kernel families at the benchmark widths (harness/benchmark.py suite):
# (family, env, kernel attribute, horizon, particles). The obs kernel
# serves MPPIQ with a plugged Q, the closed-loop kernel Reinforce.
KERNEL_CASES = [
    ("chain", "reacher_7dof-v0", "fused_rollout", 32, 4096),      # MPPI
    ("chain", "reacher_7dof-v0", "fused_rollout", 32, 16384),     # MPPI
    ("chain", "reacher_7dof-v0", "fused_rollout", 16, 4096),      # CEM
    ("chain_obs", "reacher_7dof-v0", "fused_obs_rollout", 32, 4096),
    ("chain_cl", "reacher_7dof-v0", "fused_cl_rollout", 32, 4096),
    ("chain_ext", "Swimmer-v0", "fused_rollout", 32, 4096),
    ("chain_ext", "HalfCheetah-v0", "fused_rollout", 32, 1024),
    ("forest", "pen-v0", "fused_rollout", 32, 1024),
]

# Bound on |kernel - engine|: atol + rtol * |engine|, per family. The CPU
# tests hold the kernels to 2e-5..5e-5 (chain) and 5e-3 (forest) at
# H <= 8 on a handful of particles. Here H is 16-32 and N is thousands,
# and the kernel and XLA evaluate sin/cos/sqrt/tanh and contract sums in
# different orders, so f32 rounding differences grow along the horizon
# through the dynamics; contact (cheetah ground, the pen's kp=800
# penalty on sub-mm overlaps) and the swimmer's capped drag amplify them
# most. Measured on an H100 (PERF.md): chain families <= 1.2e-5,
# Swimmer 4.4e-3, HalfCheetah 7e-6..1.9e-3, pen 9.2e-5.
BOUNDS = {
    "chain": (2e-4, 2e-4),
    "chain_obs": (2e-4, 2e-4),
    "chain_cl": (2e-4, 2e-4),
    "chain_ext": (2e-2, 2e-3),
    "forest": (1e-2, 5e-3),
}


def kernel_inputs(env, attr: str, horizon: int, n: int, seed: int = 0):
    """Seeded (params, state, mean-or-weights, noise) for env.<attr>."""
    rng = np.random.default_rng(seed)
    d = env.d_action
    state = env.init(env.params, jax.random.PRNGKey(seed))
    noise = jnp.asarray(rng.normal(size=(n, horizon, d)) * 0.3, jnp.float32)
    if attr == "fused_cl_rollout":
        first = jnp.asarray(rng.normal(size=(env.d_obs + 1, d)) * 0.05,
                            jnp.float32)
    else:
        first = jnp.asarray(rng.normal(size=(horizon, d)) * 0.2,
                            jnp.float32)
    return (env.params, state, first, noise)


def compare(got, want, family: str):
    """(max |got - want|, max excess over the family's bound) over the
    output pytrees; raises on a shape mismatch or a non-finite output."""
    atol, rtol = BOUNDS[family]
    worst, excess = 0.0, -np.inf
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        if g.shape != w.shape or not np.isfinite(g).all():
            raise AssertionError(
                f"{family}: bad kernel output {g.shape} vs {w.shape}")
        err = np.abs(g - w)
        worst = max(worst, float(err.max()))
        excess = max(excess, float((err - atol - rtol * np.abs(w)).max()))
    return worst, excess


def reference_rollout(env, attr: str):
    """The plain engine's records matching the kernel's outputs."""
    if attr == "fused_cl_rollout":
        def ref(params, state, weights, noise):
            t = rollout_closed_loop_linear(env, params, state, weights,
                                           noise)
            return t.observations, t.actions, t.costs
    elif attr == "fused_obs_rollout":
        def ref(params, state, mean, noise):
            t = rollout_open_loop(env, params, state, mean, noise)
            return t.observations, t.costs
    else:
        def ref(params, state, mean, noise):
            return rollout_open_loop(env, params, state, mean, noise).costs
    return ref
