"""Episode runners: MPC-in-the-loop evaluation, batched over episodes.

The reference's main loop (example_mpc.py:143-186) alternates
policy.get_action (controller optimize on the sim pool) and real
env.step, one episode at a time. Here the whole batch of episodes is one
jitted program: scan over the control horizon, vmap over episodes, with
separate REAL and SIM dynamics parameters so model-mismatch experiments
(dyn-randomized sim pool, nominal real env — example_mpc.py:87-91) run
on device.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import solvers
from ..envs.base import Env


def _build_step_fn(solver, env: Env, shard_particles=None,
                   sim_env: Env = None, guard: bool = True,
                   fused="auto"):
    """One MPC-in-the-loop control step: (carry, params) -> (carry, out).

    guard=True (default, opt out with run_mpc --no_guard) wraps every
    solve in solvers.guard_finite: a diverged solve (NaN rollout,
    collapsed covariance) is discarded, the control distribution
    re-initializes, and a zero action is played for that step — failure
    recovery the reference lacks entirely (SURVEY.md §5)."""
    plan_env = sim_env if sim_env is not None else env
    solve = solvers.make_solve_fn(solver, plan_env,
                                  shard_particles=shard_particles,
                                  fused=fused)
    if guard:
        solve = solvers.guard_finite(solve, solver)

    def step_fn(real_params, sim_params, carry):
        env_state, solver_state = carry
        action, value, solver_state = solve(
            sim_params, env_state, solver_state)
        action = env.clip_action(action)
        env_state, obs, reward, done = env.step(
            real_params, env_state, action)
        succ = (env.success(real_params, env_state)
                if env.success is not None else jnp.array(False))
        return (env_state, solver_state), dict(
            reward=reward, action=action, value=value, done=done,
            success=succ, state=env_state)

    return step_fn


def build_episode_fn(solver, env: Env, episode_length: int,
                     shard_particles=None, sim_env: Env = None,
                     guard: bool = True, fused="auto"):
    """episode(real_params, sim_params, key) -> dict of [T, ...] arrays.

    The solver plans against sim_params (through sim_env's dynamics
    functions when given — the reference's sim_env_name split,
    example_mpc.py:46); the environment advances under real_params via
    env.step. The two envs must share the state pytree structure.
    """
    step_fn = _build_step_fn(solver, env, shard_particles, sim_env, guard,
                             fused=fused)

    def episode(real_params, sim_params, key):
        env_key, solver_key = jax.random.split(key)
        env_state = env.init(real_params, env_key)
        solver_state = solver.init_state(solver_key)
        (_, final_solver_state), out = jax.lax.scan(
            lambda c, _: step_fn(real_params, sim_params, c),
            (env_state, solver_state), None, length=episode_length)
        return out, final_solver_state

    return episode


def _fused_mode(plan_env: Env, sim_params):
    """Whether the fused Pallas rollout may plan against `sim_params`.

    The kernel bakes the env's build-time MODEL constants, but leaves it
    declares in `fused_rollout.dynamic_fields` are read at call time
    (they ride the kernel's extras vector). So planning against a params
    pytree that differs ONLY in dynamic fields — the reference's
    geom_friction/geom_size dynamics randomization
    (gym_env_wrapper.py:392-400) on the hand suite — keeps the fast
    path; any other difference (perturbed masses, damping, a biased sim
    model) takes the general path.
    """
    base = plan_env.params
    if sim_params is base:
        return "auto"
    kernel = plan_env.fused_rollout
    dynamic = getattr(kernel, "dynamic_fields", ()) if kernel else ()
    if (not dynamic or type(sim_params) is not type(base)
            or not hasattr(base, "_fields")):
        return False
    for f in base._fields:
        if getattr(sim_params, f) is getattr(base, f) or f in dynamic:
            continue
        return False
    return "auto"


def run_episodes(solver, env: Env, n_episodes: int, episode_length: int,
                 base_seed: int = 123, sim_params=None,
                 sim_env: Env = None,
                 chunk_size: Optional[int] = None,
                 guard: bool = True) -> Dict[str, Any]:
    """Batch of episodes with the reference's per-episode seeding
    (episode_seed = base_seed + i*12345, example_mpc.py:146).

    Returns rewards [B, T], actions [B, T, dA], success flags, the final
    solver states, plus the aggregate metrics the reference logs
    (AverageReward, StdReward, SuccessMetric = % episodes with > 10
    goal-achieved steps, reacher_env.py:117-125). sim_env/sim_params
    redirect planning to different dynamics (model-mismatch experiments).
    """
    if sim_params is None:
        sim_params = (sim_env.params if sim_env is not None
                      else env.params)

    keys = jnp.stack([jax.random.PRNGKey(base_seed + i * 12345)
                      for i in range(n_episodes)])

    plan_env = sim_env if sim_env is not None else env
    fused = _fused_mode(plan_env, sim_params)

    if chunk_size is None or chunk_size >= episode_length:
        episode = build_episode_fn(solver, env, episode_length,
                                   sim_env=sim_env, guard=guard,
                                   fused=fused)
        batched = jax.jit(jax.vmap(
            lambda k: episode(env.params, sim_params, k)))
        out, final_solver_states = batched(keys)
    else:
        # Chunked execution: one compile unit of `chunk_size` steps,
        # host-chained. Heavy envs (contact + AD bias + long horizons)
        # compile slowly as one fused T-step program; the per-chunk
        # program is T/chunk_size smaller and carries (env_state,
        # solver_state) exactly.
        step_fn = _build_step_fn(solver, env, sim_env=sim_env, guard=guard,
                                 fused=fused)

        def make_chunk(length):
            def chunk(carry):
                return jax.lax.scan(
                    lambda c, _: step_fn(env.params, sim_params, c),
                    carry, None, length=length)
            return jax.jit(jax.vmap(chunk))

        chunk_v = make_chunk(chunk_size)
        n_full, rem = divmod(episode_length, chunk_size)

        def init_one(key):
            env_key, solver_key = jax.random.split(key)
            return (env.init(env.params, env_key),
                    solver.init_state(solver_key))

        carry = jax.jit(jax.vmap(init_one))(keys)
        pieces = []
        for _ in range(n_full):
            carry, piece = chunk_v(carry)
            pieces.append(piece)
        if rem:  # exact remainder: carry parity with the fused program
            carry, piece = make_chunk(rem)(carry)
            pieces.append(piece)
        out = jax.tree_util.tree_map(
            lambda *xs: jnp.concatenate(xs, axis=1), *pieces)
        final_solver_states = carry[1]

    rewards = np.asarray(out["reward"])          # [B, T]
    successes = np.asarray(out["success"])       # [B, T]
    ep_rewards = rewards.sum(axis=1)
    success_counts = successes.sum(axis=1)
    success_metric = 100.0 * float((success_counts > 10).mean())

    result = dict(
        rewards=rewards,
        actions=np.asarray(out["action"]),
        values=np.asarray(out["value"]),
        dones=np.asarray(out["done"]),
        successes=successes,
        ep_rewards=ep_rewards,
        average_reward=float(ep_rewards.mean()),
        reward_std=float(ep_rewards.std()),
        success_metric=success_metric,
        # stacked env-state pytree [B, T, ...] for replay/rendering
        states=jax.tree_util.tree_map(np.asarray, out["state"]),
        # final solver-state pytree [B, ...] for checkpoint/resume
        final_solver_states=final_solver_states,
    )
    return result
