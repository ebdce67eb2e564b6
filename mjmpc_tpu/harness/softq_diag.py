"""Instrumented SoftQMPC diagnosis run (VERDICT r3 weak #4 / task #7).

sawyer_reacher-v0's softq block plateaus at 0% / about -330 reward
(RESULTS.md) while MPPI reaches -101. This driver pins the binding
constraint by tracking, per solve, the quantities the plateau could hide
behind (reference softq_controller.py:198-268 has no instrumentation at
all — its raw SGD NaNs before the question can be asked):

- q_mse_pre / q_mse_post: Q-fit residual on the solve's own targets
  before and after the n_grad_steps SGD block (does the Q fit at all?)
- grad_norm: pre-clip gradient norm (does the clip bind every step,
  i.e. is the configured lr meaningless?)
- entropy: induced-Gaussian entropy of the soft-Q policy (has the
  action distribution collapsed or exploded?)
- sigma_eig_min/max: eigenvalue range of the action covariance
- mu_sat: fraction of policy-mean components outside the action bounds
  at the visited states (is the policy slamming the clip?)
- target_scale: std of the soft-Bellman targets (loss-surface scale)

Arms: the stock config block, and the same block with per-feature obs
whitening (SoftQMPC.obs_shift/obs_scale) computed from a short
random-action episode — the hypothesis from round 3 that the raw
sawyer obs mix (radians vs meters) conditions the quartic loss surface.

Usage: python -m mjmpc_tpu.harness.softq_diag [--whiten] [--steps N]
Prints one JSON line per solve plus a summary line; exits 0 always.
"""
from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np

from .. import envs, ops, solvers
from ..rollout.engine import _scan_rollout
from ..utils import runtime


def obs_stats_from_random(env, n_steps: int = 200, seed: int = 0):
    """Per-feature (mean, std) of observations under uniform random
    actions — the whitening statistics source (no learning involved)."""
    key = jax.random.PRNGKey(seed)
    state = env.init(env.params, key)
    step = jax.jit(env.step)
    obs_list = []
    for t in range(n_steps):
        a = jax.random.uniform(jax.random.fold_in(key, t),
                               (env.d_action,), jnp.float32, -1.0, 1.0)
        state, obs, _, _ = step(env.params, state, a)
        obs_list.append(np.asarray(obs))
    arr = np.stack(obs_list)
    return arr.mean(0), arr.std(0) + 1e-3


def diagnose(whiten: bool = False, steps: int = 75, seed: int = 123,
             lr: float = 0.1, lam: float = 0.05, n_grad_steps: int = 8,
             num_particles: int = 64, horizon: int = 16):
    env = envs.make("sawyer_reacher-v0")
    kw = {}
    if whiten:
        shift, scale = obs_stats_from_random(env)
        kw = dict(obs_shift=shift, obs_scale=scale)
    solver = solvers.SoftQMPC(
        d_obs=env.d_obs, d_action=env.d_action, horizon=horizon,
        num_particles=num_particles, lam=lam, gamma=0.99, lr=lr,
        n_grad_steps=n_grad_steps, grad_clip=10.0, **kw)
    model = solver.model

    def instrumented_solve(env_params, env_state, s):
        mean_fn, chol, entropy = solver._policy(s.q_params)
        key = jax.random.fold_in(jax.random.fold_in(s.key, 30), s.step)
        white = jax.random.normal(
            key, (solver.num_particles, solver.horizon, solver.d_action))
        noise = white @ chol.T
        traj = _scan_rollout(env, env_params, env_state, noise,
                             lambda t, obs: mean_fn(obs))

        # recompute the update's targets for the pre/post residual
        term_q = model(s.q_params,
                       solver._whiten(traj.observations[:, -1]),
                       traj.actions[:, -1])
        costs = traj.costs.at[:, -1].set(term_q)
        ent = jnp.full_like(costs, entropy)
        total = costs - solver.lam * ent
        targets = (ops.cost_to_go(total, solver.gamma_seq)
                   + solver.lam * ent)
        obs_in = solver._whiten(
            traj.observations[:, :-1].reshape(-1, solver.d_obs))
        act_in = traj.actions[:, :-1].reshape(-1, solver.d_action)
        tgt_in = targets[:, :-1].reshape(-1)

        mse_pre = model.loss(s.q_params, obs_in, act_in, tgt_in)
        g = jax.grad(model.loss)(s.q_params, obs_in, act_in, tgt_in,
                                 solver.reg)
        gnorm = jnp.sqrt(sum(jnp.sum(gw ** 2)
                             for gw in jax.tree_util.tree_leaves(g)))
        s2 = solver.update(s, traj, entropy)
        mse_post = model.loss(s2.q_params, obs_in, act_in, tgt_in)

        # policy geometry at the visited states
        _, sigma = model.act_mean_sigma(
            s2.q_params, jnp.zeros((solver.d_obs,)), solver.lam)
        eigs = jnp.linalg.eigvalsh(sigma)
        mus = jax.vmap(lambda o: model.act_mean_sigma(
            s2.q_params, o, solver.lam)[0])(obs_in[:256])
        mu_sat = jnp.mean((jnp.abs(mus) > 1.0).astype(jnp.float32))

        obs = env.observe(env_params, env_state)
        action = solver.act(s2, obs)
        s2 = s2._replace(step=s2.step + 1)
        diag = dict(q_mse_pre=mse_pre, q_mse_post=mse_post,
                    grad_norm=gnorm, entropy=entropy,
                    sigma_eig_min=eigs[0], sigma_eig_max=eigs[-1],
                    mu_sat=mu_sat,
                    target_std=jnp.std(tgt_in),
                    target_mean=jnp.mean(tgt_in))
        return action, diag, s2

    solve = jax.jit(instrumented_solve)
    key = jax.random.PRNGKey(seed)
    s = solver.init_state(key)
    est = env.init(env.params, jax.random.fold_in(key, 1))
    step = jax.jit(env.step)
    total_r, rows = 0.0, []
    for t in range(steps):
        a, diag, s = solve(env.params, est, s)
        a = jnp.clip(a, -1.0, 1.0)
        est, _, r, _ = step(env.params, est, a)
        total_r += float(r)
        row = {k: round(float(v), 5) for k, v in diag.items()}
        row["t"] = t
        rows.append(row)
        if t % 15 == 0 or t == steps - 1:
            print(json.dumps(row), flush=True)
    success = bool(env.success(env.params, est)) if env.success else None
    summary = dict(metric="softq_diag[sawyer_reacher-v0]",
                   whiten=whiten, reward=round(total_r, 1),
                   success=success,
                   clip_bound_frac=round(float(np.mean(
                       [r["grad_norm"] > 10.0 for r in rows])), 3),
                   final_mse=rows[-1]["q_mse_post"])
    print(json.dumps(summary), flush=True)
    return rows, summary


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--whiten", action="store_true")
    p.add_argument("--steps", type=int, default=75)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--lam", type=float, default=0.05)
    p.add_argument("--grad-steps", type=int, default=8)
    args = p.parse_args(argv)
    diagnose(whiten=args.whiten, steps=args.steps, lr=args.lr,
             lam=args.lam, n_grad_steps=args.grad_steps)


if __name__ == "__main__":
    runtime.enable_compile_cache()
    main()
