"""Particle-filter MPC: non-parametric control distribution.

Math matches reference mjmpc/control/particle_filter_controller.py: a
persistent set of action-sequence particles, softmax-weighted by cost-to-go,
low-variance systematic resampling, time-shift with additive cov_shift
noise, reset by cov_resample noise.

The reference resampler is a sequential cumsum walk (pf:159-174). Here it
is the vectorized equivalent: u_m = r + m/M against the cumulative weight
sum via searchsorted — identical output, and the cumsum/searchsorted pair
parallelizes over the particle axis (a global prefix sum under sharding).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import ops
from ..envs.base import Env
from ..ops.kernel_path import auto_fused
from ..rollout.engine import Trajectories, rollout_open_loop

from .base import _fold  # single RNG-derivation point

_TAG_RESAMPLE = 10
_TAG_SHIFT = 11


class PFState(NamedTuple):
    action_samples: jax.Array  # [N, H, dA]
    mean: jax.Array            # [H, dA]
    step: jax.Array            # int32
    key: jax.Array



@dataclasses.dataclass(frozen=True)
class PFMPC:
    d_action: int
    horizon: int
    num_particles: int
    lam: float = 0.01
    gamma: float = 1.0
    n_iters: int = 1
    cov_shift: float = 0.01
    cov_resample: float = 0.5
    filter_coeffs: Tuple[float, float, float] = (1.0, 0.0, 0.0)
    base_action: str = "repeat"
    sample_mode: str = "mean"
    action_lows: Optional[np.ndarray] = None
    action_highs: Optional[np.ndarray] = None

    @property
    def gamma_seq(self) -> np.ndarray:
        return ops.gamma_sequence(self.gamma, self.horizon)

    def _cov(self, v: float) -> jax.Array:
        return jnp.diag(jnp.full((self.d_action,), v, jnp.float32))

    def init_state(self, key: jax.Array) -> PFState:
        """pf:68-71 / reset pf:152-157: particles ~ filtered N(0, cov_resample)."""
        sample_key, state_key = jax.random.split(key)
        samples = ops.filtered_noise(sample_key, self._cov(self.cov_resample),
                                     (self.num_particles, self.horizon),
                                     self.filter_coeffs)
        return PFState(action_samples=samples,
                       mean=jnp.zeros((self.horizon, self.d_action), jnp.float32),
                       step=jnp.array(0, jnp.int32), key=state_key)

    def systematic_resample(self, samples: jax.Array, weights: jax.Array,
                            r: jax.Array) -> jax.Array:
        """Low-variance resampling (pf:159-174), vectorized.

        r ~ U[0, 1/M). Index m receives the particle whose cumulative
        weight first reaches u_m = r + m/M.
        """
        m = samples.shape[0]
        cumw = jnp.cumsum(weights)
        u = r + jnp.arange(m, dtype=weights.dtype) / m
        # side='left': first index with cumw >= u — the reference's i-1
        # after its `while c < u: i += 1` walk.
        idx = jnp.searchsorted(cumw, u, side="left")
        idx = jnp.clip(idx, 0, m - 1)
        return samples[idx]

    def update(self, state: PFState, traj: Trajectories) -> PFState:
        """Weight + resample + mean (pf:92-113)."""
        traj_costs = ops.cost_to_go(traj.costs, self.gamma_seq)[:, 0]
        w = jax.nn.softmax((-1.0 / self.lam) * traj_costs)
        key = _fold(state.key, _TAG_RESAMPLE, state.step)
        r = jax.random.uniform(key, (), maxval=1.0 / self.num_particles)
        samples = self.systematic_resample(state.action_samples, w, r)
        return state._replace(action_samples=samples,
                              mean=jnp.mean(samples, axis=0))

    def act(self, state: PFState, mode: str = "mean") -> jax.Array:
        """Mean of particles at t=0 (pf:118-125)."""
        return jnp.mean(state.action_samples, axis=0)[0]

    def shift(self, state: PFState) -> PFState:
        """Roll particles one step, add cov_shift noise, append base action
        (pf:127-150). The reference's 'random' branch passes a covariance
        matrix as sigma to np.random.normal (a bug, SURVEY §'quirks') — here
        'random' draws honestly from N(0, cov_resample)."""
        samples = jnp.roll(state.action_samples, -1, axis=1)
        key = _fold(state.key, _TAG_SHIFT, state.step)
        noise = ops.filtered_noise(key, self._cov(self.cov_shift),
                                   (self.num_particles, self.horizon),
                                   self.filter_coeffs)
        samples = samples + noise
        if self.base_action == "random":
            k2 = jax.random.fold_in(key, 1)
            last = jnp.sqrt(self.cov_resample) * jax.random.normal(
                k2, (self.num_particles, self.d_action))
        elif self.base_action == "null":
            last = jnp.zeros((self.num_particles, self.d_action))
        elif self.base_action == "repeat":
            last = samples[:, -2]
        else:
            raise ValueError(f"invalid base_action {self.base_action!r}")
        return state._replace(action_samples=samples.at[:, -1].set(last))

    def value(self, state: PFState, traj: Trajectories):
        raise NotImplementedError("_calc_val not implemented in reference (pf:176)")


def build_solve_fn(solver: PFMPC, env: Env, hotstart: bool = True,
                   shard_particles=None, fused="auto"):
    """One PFMPC solve (optimize + act + shift), jit-compatible.

    fused: PFMPC's update consumes only trajectory COSTS, so the env's
    costs-only fused Pallas rollout applies exactly as in
    base.build_solve_fn ("auto" = ops.kernel_path.auto_fused: available,
    unsharded, and compiled on this platform).
    """
    shard = shard_particles or (lambda x: x)
    if fused == "auto":
        fused = auto_fused(env.fused_rollout,
                           sharded=shard_particles is not None)

    def do_rollout(env_params, env_state, mean, delta):
        if fused:
            costs = env.fused_rollout(env_params, env_state, mean, delta)
            return Trajectories(
                observations=None, actions=mean[None] + delta,
                costs=costs, dones=None, next_observations=None,
                successes=None)
        return rollout_open_loop(env, env_params, env_state, mean, delta)

    def solve(env_params, env_state, state: PFState):
        s = state._replace(action_samples=shard(state.action_samples))
        for _ in range(solver.n_iters):
            delta = shard(s.action_samples - s.mean[None, :, :])
            traj = do_rollout(env_params, env_state, s.mean, delta)
            s = solver.update(s, traj)
        action = solver.act(s)
        s = s._replace(step=s.step + 1)
        if hotstart:
            s = solver.shift(s)
        return action, jnp.float32(0.0), s
    return solve
