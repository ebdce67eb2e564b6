"""Replay optimized trajectories as videos
(reference examples/visualize_trajectories.py:23-26 — there it unpickles
trajectories and replays them through the mujoco viewer; here episodes
are deterministic in (config, seed), so the tool re-runs the episode
batch on device and renders the recorded states).

Usage:
    python -m mjmpc_tpu.harness.visualize_trajectories \
        --config cfg.yml --controller mppi --out /tmp/vids
"""
from __future__ import annotations

import argparse
import os
import tempfile

from .. import envs, render
from ..utils import runtime
from . import config as cfg
from .episode import run_episodes


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--controller", type=str, default="mppi")
    parser.add_argument("--out", type=str,
                        default=os.path.join(tempfile.gettempdir(),
                                             "mjmpc_vids"))
    parser.add_argument("--episodes", type=int, default=None,
                        help="number of episodes to render")
    args = parser.parse_args(argv)

    exp = cfg.load_config(args.config)
    env = envs.make(exp["env_name"])
    solver = cfg.make_solver_for_env(exp, args.controller, env)
    n_eps = args.episodes or exp["n_episodes"]
    out = run_episodes(solver, env, n_episodes=n_eps,
                       episode_length=exp["max_ep_length"],
                       base_seed=exp["seed"])
    paths = render.dump_videos(env, out["states"], args.out)
    for p in paths:
        print(p)
    return paths


if __name__ == "__main__":
    runtime.enable_compile_cache()
    main()
