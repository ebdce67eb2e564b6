"""Hyperparameter tune/sweep harness (reference examples/job_script.py).

- 'tune': grid product over `tune_keys` list-valued entries in the
  controller section (job_script.py:151-285): every combination runs
  n_episodes, best-by-average-reward params are tracked, early stop at
  success > 95%.
- 'sweep': paired (horizon, num_particles, ...) lists
  (job_script.py:287-354): the i-th entries of every list run together.

The reference runs every cell serially against a fresh process pool; here
each cell is one batched on-device evaluation, and cells sharing a solver
shape reuse the compiled program (jit cache keyed by static config).

Usage:
    python -m mjmpc_tpu.harness.jobs --config cfg.yml --controller mppi \
        [--job_mode tune|sweep] [--save_dir /tmp]
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import tempfile
from datetime import datetime
from typing import Any, Dict, List

import numpy as np

from .. import envs
from ..utils import get_logger, runtime
from . import config as cfg
from .episode import run_episodes


def _list_keys(section: Dict[str, Any], tune_keys) -> List[str]:
    from .config import _LIST_VALUED  # genuinely list-valued fields
    keys = []
    for k, v in section.items():
        if isinstance(v, list) and k not in _LIST_VALUED \
                and k != "tune_keys":
            if tune_keys is None or k in tune_keys:
                keys.append(k)
    return keys


def run_cell(exp_params, controller_name, env, overrides,
             sim_params=None) -> Dict[str, Any]:
    params = dict(exp_params[controller_name])
    params.update(overrides)
    exp = dict(exp_params)
    exp[controller_name] = params
    solver = cfg.make_solver_for_env(exp, controller_name, env)
    out = run_episodes(
        solver, env, n_episodes=exp_params["n_episodes"],
        episode_length=exp_params["max_ep_length"],
        base_seed=exp_params["seed"], sim_params=sim_params)
    return out


def tune(exp_params, controller_name, env, log_dir,
         tune_keys=None, success_early_stop: float = 95.0):
    """Grid search over list-valued controller params."""
    logger = get_logger(f"tune_{controller_name}", log_dir)
    section = exp_params[controller_name]
    keys = _list_keys(section, tune_keys)
    grids = [section[k] for k in keys]

    best = dict(reward=-np.inf, params=None)
    history = []
    for combo in itertools.product(*grids) if keys else [()]:
        overrides = dict(zip(keys, combo))
        out = run_cell(exp_params, controller_name, env, overrides)
        row = dict(params=overrides, average_reward=out["average_reward"],
                   reward_std=out["reward_std"],
                   success_metric=out["success_metric"])
        history.append(row)
        logger.info("cell %s -> avg %.3f succ %.1f%%", overrides,
                    out["average_reward"], out["success_metric"])
        if out["average_reward"] > best["reward"]:
            best = dict(reward=out["average_reward"], params=overrides,
                        success=out["success_metric"])
        if out["success_metric"] > success_early_stop:
            logger.info("early stop: success %.1f%% > %.1f%%",
                        out["success_metric"], success_early_stop)
            break

    with open(os.path.join(log_dir, "best_params.json"), "w") as f:
        json.dump(dict(best=best, history=history), f, indent=2,
                  default=float)
    return best, history


def sweep(exp_params, controller_name, env, log_dir, tune_keys=None):
    """Paired-list benchmark mode: i-th entries run together."""
    logger = get_logger(f"sweep_{controller_name}", log_dir)
    section = exp_params[controller_name]
    keys = _list_keys(section, tune_keys)
    if keys:
        lengths = {len(section[k]) for k in keys}
        if len(lengths) != 1:
            raise ValueError(
                f"sweep lists must be equal length, got {lengths} for {keys}")
        n_cells = lengths.pop()
    else:
        n_cells = 1

    rows = []
    for i in range(n_cells):
        overrides = {k: section[k][i] for k in keys}
        out = run_cell(exp_params, controller_name, env, overrides)
        logger.record_tabular("Cell", i)
        for k, v in overrides.items():
            logger.record_tabular(k, v)
        logger.record_tabular("AverageReward", out["average_reward"])
        logger.record_tabular("StdReward", out["reward_std"])
        logger.record_tabular("SuccessMetric", out["success_metric"])
        logger.dump_tabular()
        rows.append(dict(params=overrides,
                         average_reward=out["average_reward"],
                         reward_std=out["reward_std"],
                         success_metric=out["success_metric"]))
    with open(os.path.join(log_dir, "sweep_results.json"), "w") as f:
        json.dump(rows, f, indent=2, default=float)
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description="tune/sweep jobs")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--controller", type=str, default="mppi")
    parser.add_argument("--job_mode", type=str, default=None,
                        help="tune | sweep (default: config job_mode)")
    parser.add_argument("--save_dir", type=str, default=tempfile.gettempdir())
    args = parser.parse_args(argv)

    exp_params = cfg.load_config(args.config)
    mode = args.job_mode or exp_params.get("job_mode", "sweep")
    env = envs.make(exp_params["env_name"])

    date_time = datetime.now().strftime("%m_%d_%Y_%H_%M_%S")
    results = {}
    for controller_name in args.controller.split(","):
        controller_name = controller_name.strip()
        log_dir = os.path.join(args.save_dir, exp_params["env_name"],
                               date_time, mode, controller_name)
        os.makedirs(log_dir, exist_ok=True)
        # tune_keys lives INSIDE the controller section in the reference
        # schema (job_script.py:170); accept a top-level fallback too.
        tune_keys = exp_params[controller_name].get(
            "tune_keys", exp_params.get("tune_keys"))
        if mode == "tune":
            results[controller_name] = tune(
                exp_params, controller_name, env, log_dir,
                tune_keys=tune_keys)
        elif mode == "sweep":
            results[controller_name] = sweep(
                exp_params, controller_name, env, log_dir,
                tune_keys=tune_keys)
        else:
            raise ValueError(f"unknown job_mode {mode!r}")
    return results


if __name__ == "__main__":
    runtime.enable_compile_cache()
    main()
