"""Open-loop MPC experiment driver (reference examples/example_mpc.py).

Usage:
    python -m mjmpc_tpu.harness.run_mpc --config cfg.yml \
        --controller mppi [--save_dir /tmp] [--dyn_randomize_config d.yml] \
        [--save_trajectories] [--checkpoint]

Same flags and YAML schema as the reference driver; the per-episode loop
(get_env_state -> policy.get_action -> env.step) is replaced by the fully
on-device batched episode program. Dynamics randomization perturbs only
the SIM params (real env stays nominal, example_mpc.py:87-91).
"""
from __future__ import annotations

import argparse
import os
import tempfile
from datetime import datetime

import numpy as np
import yaml

from .. import envs, solvers
from ..utils import get_logger, runtime, timeit
from . import config as cfg
from .episode import run_episodes


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Run MPC algorithm on given environment")
    parser.add_argument("--config", type=str, required=True,
                        help="yaml file with experiment parameters")
    parser.add_argument("--dyn_randomize_config", type=str, default=None,
                        help="yaml file with dynamics randomization parameters")
    parser.add_argument("--save_dir", type=str,
                        default=tempfile.gettempdir(),
                        help="folder to save data in")
    parser.add_argument("--controller", type=str, default="mppi",
                        help="controller(s) to run, comma separated")
    parser.add_argument("--save_trajectories", action="store_true",
                        help="dump episode arrays to npz")
    parser.add_argument("--checkpoint", action="store_true",
                        help="save final solver state")
    parser.add_argument("--dump_vids", action="store_true",
                        help="render episode videos (reference flag)")
    parser.add_argument("--chunk_size", type=int, default=None,
                        help="compile the episode in chunks of this many "
                             "steps (heavy envs at long horizons)")
    parser.add_argument("--no_guard", action="store_true",
                        help="disable the NaN/Inf solve guard (failure "
                             "recovery is ON by default: a diverged solve "
                             "re-initializes the control distribution)")
    args = parser.parse_args(argv)

    exp_params = cfg.load_config(args.config)
    dyn_params = None
    if args.dyn_randomize_config is not None:
        with open(args.dyn_randomize_config) as f:
            dyn_params = yaml.safe_load(f)

    env = envs.make(exp_params["env_name"])
    sim_env = envs.make(exp_params.get("sim_env_name",
                                       exp_params["env_name"]))

    date_time = datetime.now().strftime("%m_%d_%Y_%H_%M_%S")
    results = {}
    for controller_name in args.controller.split(","):
        controller_name = controller_name.strip()
        log_dir = os.path.join(args.save_dir, exp_params["env_name"],
                               date_time, controller_name)
        os.makedirs(log_dir, exist_ok=True)
        logger = get_logger(
            f"{controller_name}_{exp_params['env_name']}", log_dir)

        sim_params = sim_env.params
        if dyn_params is not None:
            rand_env, defaults, randomized = envs.randomize_dynamics(
                sim_env, dyn_params, base_seed=exp_params["seed"])
            sim_params = rand_env.params
            logger.info("Default params = %s", defaults)
            logger.info("Randomized params = %s", randomized)

        solver = cfg.make_solver_for_env(exp_params, controller_name, env)
        logger.info("%s", exp_params[controller_name])

        timeit.start("start_" + controller_name)
        out = run_episodes(
            solver, env,
            n_episodes=exp_params["n_episodes"],
            episode_length=exp_params["max_ep_length"],
            base_seed=exp_params["seed"],
            sim_params=sim_params,
            sim_env=sim_env if sim_env.name != env.name else None,
            chunk_size=args.chunk_size,
            guard=not args.no_guard)
        timeit.stop("start_" + controller_name)

        logger.info(
            "Avg. reward = %s, Std. Reward = %s, Success Metric = %s",
            out["average_reward"], out["reward_std"], out["success_metric"])

        logger.record_tabular("EpisodeReward", out["ep_rewards"].tolist())
        logger.record_tabular("Horizon", solver.horizon)
        logger.record_tabular("AverageReward", out["average_reward"])
        logger.record_tabular("StdReward", out["reward_std"])
        logger.record_tabular("SuccessMetric", out["success_metric"])
        logger.record_tabular("NumEpisodes", exp_params["n_episodes"])
        logger.record_tabular("NumParticles", solver.num_particles)
        logger.dump_tabular()
        logger.info("\n%s", timeit.report())

        if args.save_trajectories:
            np.savez(os.path.join(log_dir, "trajectories.npz"),
                     rewards=out["rewards"], actions=out["actions"],
                     successes=out["successes"])
        if args.checkpoint:
            from . import checkpoint
            checkpoint.save_solver_state(
                os.path.join(log_dir, "solver_state"),
                out["final_solver_states"],
                metadata=dict(controller=controller_name,
                              env=env.name,
                              n_episodes=exp_params["n_episodes"]))
            logger.info("saved solver-state checkpoint")
        if args.dump_vids:
            from .. import render
            try:
                paths = render.dump_videos(env, out["states"], log_dir)
                logger.info("dumped videos: %s", paths)
            except (ValueError, AttributeError) as e:
                logger.warning("video dump skipped: %s", e)
        results[controller_name] = out
    return results


if __name__ == "__main__":
    runtime.enable_compile_cache()
    main()
