"""Device mesh construction for particle-parallel MPC.

The reference's only parallelism is particle-data-parallel rollouts over OS
processes with a pipe scatter/gather (SubprocVecEnv, reference
mjmpc/envs/vec_env/subproc_vec_env.py:161-186). On a set of GPUs the
same decomposition becomes a `jax.sharding.Mesh` with two logical axes:

- ``particles``: the MPC sampling batch. Every solver reduction (MPPI
  softmax-weighted sums, CEM top-k, PF resampling prefix sums) rides this
  axis as XLA collectives, which XLA hands to NCCL.
- ``episodes``: independent episodes / sweep cells (the reference's
  job_script tune/sweep grid and n_episodes loop); episodes never
  communicate during a solve.

The four cards of one host are joined all to all by NVLink, so every
card reaches every other at the same rate and the mesh shape follows the
algorithm alone: (1, 4) shards one solve's particles over all four
cards, (4, 1) runs four independent episodes, one per card.

Single-program SPMD replaces the worker command protocol entirely: there is
no scatter, no gather, no broadcast of env state — just sharded arrays.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

EPISODES_AXIS = "episodes"
PARTICLES_AXIS = "particles"


def make_mesh(episodes: int = 1, particles: Optional[int] = None,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Build an (episodes × particles) mesh over the given devices.

    Defaults to all local+addressable devices on the particles axis —
    the single-host production layout. Multi-host layouts put the host
    dimension on the episodes axis so no solve crosses hosts.
    """
    devs = np.asarray(devices if devices is not None else jax.devices())
    if particles is None:
        if len(devs) % episodes:
            raise ValueError(
                f"{len(devs)} devices not divisible by episodes={episodes}")
        particles = len(devs) // episodes
    if episodes * particles != len(devs):
        raise ValueError(
            f"mesh {episodes}x{particles} != {len(devs)} devices")
    return Mesh(devs.reshape(episodes, particles),
                axis_names=(EPISODES_AXIS, PARTICLES_AXIS))


def particle_sharding(mesh: Mesh, rank: int = 3) -> NamedSharding:
    """Sharding for [N, ...] arrays: particle axis split, rest replicated."""
    return NamedSharding(mesh, P(PARTICLES_AXIS, *([None] * (rank - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def episode_sharding(mesh: Mesh, rank: int = 1) -> NamedSharding:
    """Sharding for [B, ...] per-episode arrays (keys, env params)."""
    return NamedSharding(mesh, P(EPISODES_AXIS, *([None] * (rank - 1))))


def pad_particles(num_particles: int, mesh: Mesh) -> int:
    """Round N up to a multiple of the particle-axis size (the reference
    asserts num_particles % num_cpu == 0, subproc_vec_env.py:161-163; here
    we pad instead of asserting)."""
    n_shards = mesh.shape[PARTICLES_AXIS]
    return -(-num_particles // n_shards) * n_shards


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize wrapper for multi-host runs.

    Pass the coordinator address (host:port), the number of processes and
    this process's id explicitly: nothing in a plain GPU cluster lets JAX
    discover them. No-op if already initialized.
    """
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except RuntimeError:
        pass  # already initialized
