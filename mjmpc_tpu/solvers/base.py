"""Solver core: sampling-MPC controllers as pure functions.

The reference implements controllers as stateful classes whose
`optimize(state)` loops generate_rollouts -> _update_distribution, then
plays mean_action[0] and shifts (controller.py:207-257). Here a controller
is a frozen config dataclass plus pure functions over an explicit
`GaussianState` pytree, so the *entire solve* — noise sampling, N-particle
H-step rollout, distribution update, shift — jits into one XLA program.
An episode is then `lax.scan(solve_step)`: zero host round trips per
control step (the reference pays one process scatter/gather per solve).

Seeding discipline: the reference reseeds global NumPy every solve
(`base_seed = seed_val + num_steps`, olgaussian_mpc.py:88-93). Here each
consumer derives a counter-based key: fold_in(key, (tag, step)); identical
solver state => identical noise, with no global RNG.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import ops
from ..envs.base import Env
from ..ops.kernel_path import auto_fused
from ..rollout.engine import Trajectories, rollout_open_loop

# Key-derivation tags (disjoint RNG streams per consumer).
_TAG_ROLLOUT = 0
_TAG_ACT = 1
_TAG_SHIFT = 2


class GaussianState(NamedTuple):
    """Open-loop Gaussian control distribution state
    (reference olgaussian_mpc.py:58-67)."""
    mean: jax.Array   # [H, dA]
    cov: jax.Array    # [dA, dA]
    step: jax.Array   # int32 scalar — reference num_steps
    key: jax.Array    # base PRNG key


def _fold(key, tag: int, step):
    return jax.random.fold_in(jax.random.fold_in(key, tag), step)


@dataclasses.dataclass(frozen=True)
class GaussianMPC:
    """Base open-loop Gaussian MPC solver (reference OLGaussianMPC).

    Subclasses override `update(state, traj)` (the reference
    `_update_distribution`) and `value(state, traj)` (`_calc_val`).
    """
    d_action: int
    horizon: int
    num_particles: int
    gamma: float = 1.0
    n_iters: int = 1
    step_size: float = 1.0
    init_cov: float = 1.0
    filter_coeffs: Tuple[float, float, float] = (1.0, 0.0, 0.0)
    base_action: str = "null"            # random | null | repeat
    cov_type: str = "diagonal"
    use_zero_control_seq: bool = False
    sample_mode: str = "mean"            # mean | sample
    action_lows: Optional[np.ndarray] = None
    action_highs: Optional[np.ndarray] = None

    # ---- static derived quantities -------------------------------------
    @property
    def gamma_seq(self) -> np.ndarray:
        return ops.gamma_sequence(self.gamma, self.horizon)

    @property
    def uses_observations(self) -> bool:
        """Whether update()/value() read traj.observations — gates the
        costs-only fused-rollout fast path (MPPI/CEM/RS/DMD: no;
        MPPIQ with a plugged q_fn: yes)."""
        return False

    @property
    def init_cov_diag(self) -> np.ndarray:
        return np.array([self.init_cov] * self.d_action, np.float32)

    # ---- state lifecycle -------------------------------------------------
    def init_state(self, key: jax.Array) -> GaussianState:
        """reference olgaussian_mpc.py reset(): zero mean, diag init_cov."""
        return GaussianState(
            mean=jnp.zeros((self.horizon, self.d_action), jnp.float32),
            cov=jnp.asarray(np.diag(self.init_cov_diag)),
            step=jnp.array(0, jnp.int32),
            key=key,
        )

    # ---- sampling --------------------------------------------------------
    def sample_noise(self, state: GaussianState) -> jax.Array:
        """AR(2)-filtered Gaussian noise [N, H, dA]
        (reference olgaussian_mpc.py:88-93)."""
        key = _fold(state.key, _TAG_ROLLOUT, state.step)
        delta = ops.filtered_noise(key, state.cov,
                                   (self.num_particles, self.horizon),
                                   self.filter_coeffs)
        if self.use_zero_control_seq:
            # Last particle probes the zero-action sequence
            # (olgaussian_mpc.py:110-111).
            delta = delta.at[-1].set(-state.mean)
        return delta

    # ---- to override -------------------------------------------------------
    def update(self, state: GaussianState, traj: Trajectories) -> GaussianState:
        raise NotImplementedError

    def value(self, state: GaussianState, traj: Trajectories) -> jax.Array:
        raise NotImplementedError

    # ---- action selection / hotstart ------------------------------------
    def act(self, state: GaussianState, mode: Optional[str] = None) -> jax.Array:
        """First mean action, or a sampled perturbation of it
        (reference olgaussian_mpc.py:69-78)."""
        mode = mode or self.sample_mode
        if mode == "mean":
            return state.mean[0]
        if mode == "sample":
            key = _fold(state.key, _TAG_ACT, state.step)
            delta = ops.filtered_noise(key, state.cov, (1, 1), self.filter_coeffs)
            return state.mean[0] + delta.reshape(self.d_action)
        raise ValueError(f"unknown sample mode {mode!r}")

    def shift(self, state: GaussianState) -> GaussianState:
        """Hotstart: roll the mean left one step and append base_action
        (reference olgaussian_mpc.py:116-129)."""
        mean = jnp.roll(state.mean, -1, axis=0)
        if self.base_action == "random":
            key = _fold(state.key, _TAG_SHIFT, state.step)
            # Reference quirk preserved: np.random.normal(0, init_cov, dA)
            # uses the variance value as the scale parameter.
            last = jnp.asarray(self.init_cov_diag) * jax.random.normal(
                key, (self.d_action,))
        elif self.base_action == "null":
            last = jnp.zeros((self.d_action,), mean.dtype)
        elif self.base_action == "repeat":
            last = mean[-2]
        else:
            raise ValueError(f"invalid base_action {self.base_action!r}")
        return state._replace(mean=mean.at[-1].set(last))

    # ---- shared update helpers ------------------------------------------
    def _interp_mean(self, mean, target):
        """(1-a)*mean + a*target — every controller's step-size blend."""
        return (1.0 - self.step_size) * mean + self.step_size * target


def build_solve_fn(solver: GaussianMPC, env: Env, calc_val: bool = False,
                   hotstart: bool = True, shard_particles=None,
                   fused: Any = "auto"):
    """One full MPC solve as a pure function — the reference
    Controller.optimize (controller.py:207-257) compiled end-to-end.

    Returns solve(env_params, env_state, solver_state) ->
        (action [dA], value scalar, new solver_state).
    Jit-compatible; wrap with jax.jit (or pjit with a sharded particle
    axis) at the call site.

    shard_particles: optional fn(x) -> x applying a sharding constraint to
    arrays whose leading axis is the particle axis (see parallel.sharded).
    GSPMD then propagates the layout through the rollout scan and lowers
    the solver's particle reductions to collectives between devices.

    fused: use the env's fused Pallas rollout. "auto" = yes when the env
    provides one matching the solver's trajectory needs (costs-only
    `fused_rollout` for solvers that never read observations;
    `fused_obs_rollout` for observation-consuming ones like MPPIQ with
    a plugged Q), the solve is unsharded, and the kernel is compiled on
    this platform (ops.kernel_path.auto_fused: the GPU; on the CPU the
    kernel runs only when asked for with fused=True). Pass False when planning
    against params that differ from the env's build-time params in
    leaves OUTSIDE the kernel's `dynamic_fields` (the kernel bakes model
    constants; contact gains/radii listed in `fused_rollout
    .dynamic_fields` ride its extras vector and stay live —
    harness/episode.py:_fused_mode applies this rule automatically).
    """
    shard = shard_particles or (lambda x: x)
    if fused == "auto":
        kernel = (env.fused_obs_rollout if solver.uses_observations
                  else env.fused_rollout)
        fused = auto_fused(kernel, sharded=shard_particles is not None)

    def do_rollout(env_params, env_state, mean, noise):
        if fused and solver.uses_observations:
            obs, costs = env.fused_obs_rollout(env_params, env_state,
                                               mean, noise)
            return Trajectories(
                observations=obs, actions=mean[None] + noise,
                costs=costs, dones=None, next_observations=None,
                successes=None)
        if fused:
            costs = env.fused_rollout(env_params, env_state, mean, noise)
            return Trajectories(
                observations=None, actions=mean[None] + noise,
                costs=costs, dones=None, next_observations=None,
                successes=None)
        return rollout_open_loop(env, env_params, env_state, mean, noise)

    def solve(env_params, env_state, solver_state: GaussianState):
        s = solver_state
        for _ in range(solver.n_iters):  # static unroll (n_iters is 1-4)
            noise = shard(solver.sample_noise(s))
            traj = do_rollout(env_params, env_state, s.mean, noise)
            s = solver.update(s, traj)

        action = solver.act(s)
        if calc_val:
            noise = shard(solver.sample_noise(s))
            traj = do_rollout(env_params, env_state, s.mean, noise)
            value = solver.value(s, traj)
        else:
            value = jnp.float32(0.0)

        s = s._replace(step=s.step + 1)
        if hotstart:
            s = solver.shift(s)
        return action, value, s

    return solve


def guard_finite(solve, solver):
    """Failure-recovery wrapper: if a solve produces a non-finite action
    or solver state (diverged rollout, collapsed covariance), discard it
    and re-initialize the control distribution from the state's own key,
    playing a zero action for that step.

    The reference has no failure handling at all (SURVEY.md §5 — a NaN in
    a worker propagates through the pipe into the update); this is the
    single-program SPMD equivalent of restarting a bad worker.
    """
    def guarded(env_params, env_state, solver_state):
        action, value, new_state = solve(env_params, env_state,
                                         solver_state)
        leaves = jax.tree_util.tree_leaves((action, value, new_state))
        ok = jnp.array(True)
        for leaf in leaves:
            if jnp.issubdtype(jnp.asarray(leaf).dtype, jnp.floating):
                ok = ok & jnp.all(jnp.isfinite(leaf))

        fresh = solver.init_state(jax.random.fold_in(
            solver_state.key, solver_state.step))
        fresh = fresh._replace(step=solver_state.step + 1)
        recovered = jax.tree_util.tree_map(
            lambda good, bad: jnp.where(ok, good, bad), new_state, fresh)
        safe_action = jnp.where(ok, action, jnp.zeros_like(action))
        return safe_action, jnp.where(ok, value, jnp.float32(0.0)), \
            recovered

    return guarded


def build_optimal_value_fn(solver: GaussianMPC, env: Env):
    """State-value estimate: reset the control distribution, run a full
    optimize with calc_val and no hotstart, return the value — the
    reference Controller.get_optimal_value (controller.py:259-275), the
    state-value hook of the ICLR'21 MPC/value-blending scheme.

    Returns value(env_params, env_state, key) -> scalar.
    """
    solve = build_solve_fn(solver, env, calc_val=True, hotstart=False)

    def value(env_params, env_state, key):
        fresh = solver.init_state(key)
        _, val, _ = solve(env_params, env_state, fresh)
        return val

    return value


def evaluate_episode(solver: GaussianMPC, env: Env, episode_length: int,
                     calc_val: bool = False, shard_particles=None):
    """Full closed-loop episode — MPC in the loop — as ONE jitted scan.

    The reference's example_mpc.py episode loop (real env.step + one
    optimize per step) with zero host synchronization. Returns
    episode(env_params, key) -> dict(rewards [T], actions [T, dA], ...).
    """
    solve = build_solve_fn(solver, env, calc_val=calc_val,
                           shard_particles=shard_particles)

    def episode(env_params, key):
        env_key, solver_key = jax.random.split(key)
        env_state = env.init(env_params, env_key)
        solver_state = solver.init_state(solver_key)

        def step_fn(carry, _):
            env_state, solver_state = carry
            action, value, solver_state = solve(env_params, env_state, solver_state)
            action = env.clip_action(action)
            env_state, obs, reward, done = env.step(env_params, env_state, action)
            succ = (env.success(env_params, env_state)
                    if env.success is not None else jnp.array(False))
            return (env_state, solver_state), dict(
                reward=reward, action=action, value=value, done=done,
                success=succ)

        (_, _), out = jax.lax.scan(
            step_fn, (env_state, solver_state), None, length=episode_length)
        return out

    return episode
