"""Sharded MPC solves: the SubprocVecEnv scatter/rollout/gather re-done
as single-program SPMD over a device mesh.

Mapping from the reference (SURVEY.md §2.5):
- scatter of noise slices over pipes  -> noise constrained to
  PartitionSpec('particles') — each shard *generates* its slice locally.
- per-worker serial rollout           -> sharded vmap inside lax.scan.
- gather + np.concatenate             -> never materialized; solver
  reductions (softmax sums, top-k, prefix sums) lower to psum/all-gather
  collectives via GSPMD (NCCL between GPUs).
- set_env_state broadcast             -> env state replicated.

Everything below is plain jit-with-shardings: we constrain only the
particle-batched arrays and let XLA propagate layouts and insert
collectives (the scaling-book recipe).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..envs.base import Env
from ..solvers import PFMPC, make_solve_fn
from .mesh import EPISODES_AXIS, PARTICLES_AXIS, make_mesh


def _particle_constraint(mesh: Mesh):
    """Constraint fn for arrays with a leading particle axis."""
    def shard(x):
        spec = P(PARTICLES_AXIS, *([None] * (x.ndim - 1)))
        return jax.lax.with_sharding_constraint(x, NamedSharding(mesh, spec))
    return shard


def build_sharded_solve_fn(solver, env: Env, mesh: Optional[Mesh] = None,
                           **kwargs):
    """One MPC solve jitted over a mesh with the particle axis sharded.

    Returns jit-compiled solve(env_params, env_state, solver_state) ->
    (action, value, new_state). Solver state and env state are replicated
    (PF action_samples excepted — they live sharded).
    """
    mesh = mesh or make_mesh()
    solve = make_solve_fn(solver, env,
                          shard_particles=_particle_constraint(mesh), **kwargs)
    repl = NamedSharding(mesh, P())

    if isinstance(solver, PFMPC):
        n_rest = P(PARTICLES_AXIS, None, None)
        # PFState(action_samples[N,H,dA], mean, step, key)
        from ..solvers.pfmpc import PFState
        state_sh = PFState(action_samples=NamedSharding(mesh, n_rest),
                           mean=repl, step=repl, key=repl)
        return jax.jit(solve,
                       in_shardings=(repl, repl, state_sh),
                       out_shardings=(repl, repl, state_sh))
    return jax.jit(solve, in_shardings=(repl, repl, repl),
                   out_shardings=(repl, repl, repl))


def _generic_episode(solver, env: Env, episode_length: int,
                     shard_particles):
    """Episode dispatching through make_solve_fn via the shared harness
    episode scan — every solver family (Gaussian, PFMPC, Reinforce,
    SoftQ, RSNN) shards the same way, and there is exactly ONE episode
    loop in the codebase."""
    from ..harness.episode import build_episode_fn
    inner = build_episode_fn(solver, env, episode_length,
                             shard_particles=shard_particles)

    def episode(env_params, key):
        out, _ = inner(env_params, env_params, key)
        out.pop("state", None)  # sharded batches don't record states
        return out

    return episode


def build_sharded_episode_fn(solver, env: Env, episode_length: int,
                             mesh: Optional[Mesh] = None):
    """Full MPC-in-the-loop episode, jitted with the particle axis sharded.

    The per-step solve's N-particle rollout spreads over the mesh; the
    episode scan itself is sequential (control is causal).
    """
    mesh = mesh or make_mesh()
    episode = _generic_episode(solver, env, episode_length,
                               _particle_constraint(mesh))
    repl = NamedSharding(mesh, P())
    return jax.jit(episode, in_shardings=(repl, repl), out_shardings=repl)


def build_batch_episode_fn(solver, env: Env, episode_length: int,
                           mesh: Optional[Mesh] = None):
    """B independent episodes in parallel: vmap over episode keys, the batch
    axis sharded over the mesh's 'episodes' axis (the reference's
    n_episodes loop / job_script sweep cells, run simultaneously).

    Returns jitted batch(env_params, keys [B]) -> dict of [B, T, ...].
    """
    mesh = mesh or make_mesh()
    episode = _generic_episode(solver, env, episode_length,
                               _particle_constraint(mesh))
    batched = jax.vmap(episode, in_axes=(None, 0))
    repl = NamedSharding(mesh, P())
    keys_sh = NamedSharding(mesh, P(EPISODES_AXIS))

    def run(env_params, keys):
        out = batched(env_params, keys)
        return jax.tree_util.tree_map(
            lambda x: jax.lax.with_sharding_constraint(
                x, NamedSharding(mesh, P(EPISODES_AXIS,
                                         *([None] * (x.ndim - 1))))), out)

    return jax.jit(run, in_shardings=(repl, keys_sh))
