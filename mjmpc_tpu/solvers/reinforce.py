"""Reinforce: closed-loop linear-Gaussian policy-gradient MPC.

Reference mjmpc/control/reinforce.py + clgaussian_mpc.py. The control
distribution is a linear-Gaussian feedback policy u = Wᵀ[obs; 1] + ε,
ε ~ AR-filtered N(0, Σ) (clgaussian_mpc.py:63-73, 83-88); each solve:

1. roll out N closed-loop particles (rollout_closed_loop_linear);
2. returns = cost-to-go; baseline = per-timestep mean return, or one of
   the four least-squares value functions fit on the fresh returns
   (reinforce.py:218-258);
3. whitened advantages (reinforce.py:287-293);
4. analytic policy gradient obs_catᵀ·(∇_μ logprob · A) (reinforce.py:174-182)
   — computed per-parameter [dObs+1, dA]. (The reference's
   `np.average(grad_mean)` collapses the gradient to a scalar, which only
   type-checks for dA == 1; we keep the honest per-parameter VPG gradient.
   And because returns are COSTS, the update must descend: W ← W − lr·g;
   the reference's `+=` ascends expected cost — documented quirk, not
   replicated. SURVEY.md §'quirks'.)
5. optional KL-constrained backtracking line search: halve lr until
   avg KL(π_new ‖ π_old) ≤ delta_kl (reinforce.py:108-146), here a
   lax.while_loop so the whole update stays on device.

The whole solve — rollout, baseline fit (closed-form LSQ), gradient, line
search — is ONE jitted program; the reference pays a process-pool round
trip plus torch fits per iteration.
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
from ..rollout.engine import Trajectories, rollout_closed_loop_linear
from ..value_functions import make_vf

from .base import _fold  # single RNG-derivation point

_TAG_ROLLOUT = 20
_TAG_ACT = 21


class ReinforceState(NamedTuple):
    mean_weights: jax.Array   # [d_obs+1, d_action]
    cov_diag: jax.Array       # [d_action] action-noise variance diagonal
    vf_weights: jax.Array     # baseline params (zeros when constant baseline)
    vf_bias: jax.Array
    fit_error: jax.Array      # last baseline relative fit error
    step: jax.Array
    key: jax.Array



@dataclasses.dataclass(frozen=True)
class Reinforce:
    d_obs: int
    d_action: int
    horizon: int
    num_particles: int
    lr: float = 0.01
    beta: float = 0.0                     # cov growth (reference arg, unused live)
    gamma: float = 1.0
    n_iters: int = 1
    init_cov: float = 1.0
    baseline_type: Optional[str] = "quadratic"   # None => mean-return baseline
    delta_kl: Optional[float] = None
    max_linesearch_iters: int = 100
    delta_reg: float = 0.0
    filter_coeffs: Tuple[float, float, float] = (1.0, 0.0, 0.0)
    sample_mode: str = "mean"
    action_lows: Optional[np.ndarray] = None
    action_highs: Optional[np.ndarray] = None

    @property
    def gamma_seq(self) -> np.ndarray:
        return ops.gamma_sequence(self.gamma, self.horizon)

    @property
    def vf(self):
        if self.baseline_type in (None, "constant", "none"):
            return None
        return make_vf(self.baseline_type, self.d_obs, self.horizon)

    def init_state(self, key: jax.Array) -> ReinforceState:
        vf = self.vf
        if vf is None:
            vw = jnp.zeros((1,))
            vb = jnp.zeros(())
        else:
            p = vf.init_params()
            vw, vb = p.weights, p.bias
        return ReinforceState(
            mean_weights=jnp.zeros((self.d_obs + 1, self.d_action),
                                   jnp.float32),
            cov_diag=jnp.full((self.d_action,), self.init_cov, jnp.float32),
            vf_weights=vw, vf_bias=vb,
            fit_error=jnp.float32(0.0),
            step=jnp.array(0, jnp.int32), key=key)

    # ---- sampling ---------------------------------------------------------
    def sample_noise(self, state: ReinforceState) -> jax.Array:
        key = _fold(state.key, _TAG_ROLLOUT, state.step)
        cov = jnp.diag(state.cov_diag)
        return ops.filtered_noise(key, cov,
                                  (self.num_particles, self.horizon),
                                  self.filter_coeffs)

    # ---- update -----------------------------------------------------------
    def update(self, state: ReinforceState, traj: Trajectories) -> ReinforceState:
        returns = ops.cost_to_go(traj.costs, self.gamma_seq)      # [N, H]

        vf = self.vf
        if vf is None:
            baselines = jnp.mean(returns, axis=0, keepdims=True)  # [1, H]
            new_vw, new_vb = state.vf_weights, state.vf_bias
            fit_err = state.fit_error
        else:
            from ..value_functions.vf import VFParams
            params0 = VFParams(state.vf_weights, state.vf_bias)
            new_params, _, fit_err = vf.fit(
                params0, traj.observations, returns,
                delta_reg=self.delta_reg, return_errors=True)
            baselines = vf.predict(new_params, traj.observations)
            new_vw, new_vb = new_params.weights, new_params.bias

        adv = returns - baselines
        adv = (adv - jnp.mean(adv)) / (jnp.std(adv) + 1e-6)       # whitening

        obs = traj.observations.reshape(-1, self.d_obs)
        acts = traj.actions.reshape(-1, self.d_action)
        a = adv.reshape(-1)

        obs_cat = jnp.concatenate(
            [obs, jnp.ones((obs.shape[0], 1), obs.dtype)], axis=-1)
        mean_acts = obs_cat @ state.mean_weights
        # d logprob / d mean for diagonal Gaussian: (a - mu) / sigma^2
        grad_act = (acts - mean_acts) / state.cov_diag[None, :]
        grad = obs_cat.T @ (grad_act * a[:, None]) / obs.shape[0]

        if self.delta_kl is None:
            new_w = state.mean_weights - self.lr * grad
        else:
            new_w = self._kl_linesearch(state, obs_cat, grad)

        return state._replace(mean_weights=new_w, vf_weights=new_vw,
                              vf_bias=new_vb, fit_error=fit_err)

    def _kl_linesearch(self, state: ReinforceState, obs_cat: jax.Array,
                       grad: jax.Array) -> jax.Array:
        """Backtracking on lr until avg KL(new ‖ old) <= delta_kl
        (reinforce.py:117-138). Same cov on both sides, so the KL reduces
        to the Mahalanobis mean term."""
        old_mean = obs_cat @ state.mean_weights                   # [NH, dA]

        def mean_kl(w):
            diff = obs_cat @ w - old_mean
            kl = 0.5 * jnp.sum(diff ** 2 / state.cov_diag[None, :], axis=-1)
            return jnp.mean(kl)

        def cond(carry):
            lr, it = carry
            return ((mean_kl(state.mean_weights - lr * grad) > self.delta_kl)
                    & (it < self.max_linesearch_iters))

        def body(carry):
            lr, it = carry
            return lr * 0.5, it + 1

        lr, _ = jax.lax.while_loop(
            cond, body, (jnp.float32(self.lr), jnp.int32(0)))
        return state.mean_weights - lr * grad

    # ---- action selection -------------------------------------------------
    def act(self, state: ReinforceState, obs: jax.Array,
            mode: Optional[str] = None) -> jax.Array:
        """u = Wᵀ[obs; 1] (+ sampled noise) — clgaussian_mpc.py:63-73."""
        mode = mode or self.sample_mode
        obs1 = jnp.concatenate([obs, jnp.ones((1,), obs.dtype)])
        mean = obs1 @ state.mean_weights
        if mode == "mean":
            return mean
        if mode == "sample":
            key = _fold(state.key, _TAG_ACT, state.step)
            eps = ops.filtered_noise(key, jnp.diag(state.cov_diag), (1, 1),
                                     self.filter_coeffs)
            return mean + eps.reshape(self.d_action)
        raise ValueError(f"unknown sample mode {mode!r}")


def build_solve_fn(solver: Reinforce, env: Env, shard_particles=None,
                   fused="auto"):
    """One Reinforce solve: closed-loop rollouts + policy-gradient update.
    The reference's _shift is a no-op (clgaussian_mpc.py:117-131).

    fused: use the env's fused closed-loop Pallas rollout
    (ops/pallas_chain.build_chain_cl_rollout — obs + policy matmul +
    physics + cost in one kernel). "auto" = yes when the env provides
    one, the solve is unsharded and the kernel is compiled on this
    platform (ops.kernel_path.auto_fused); the update consumes only the
    (obs, actions, costs) records the kernel emits. Pass False when
    planning against params differing from the env's build-time params
    (the kernel bakes model constants)."""
    shard = shard_particles or (lambda x: x)
    if fused == "auto":
        fused = auto_fused(env.fused_cl_rollout,
                           sharded=shard_particles is not None)

    def do_rollout(env_params, env_state, weights, noise):
        if fused:
            obs, acts, costs = env.fused_cl_rollout(
                env_params, env_state, weights, noise)
            return Trajectories(observations=obs, actions=acts,
                                costs=costs, dones=None,
                                next_observations=None, successes=None)
        return rollout_closed_loop_linear(
            env, env_params, env_state, weights, noise)

    def solve(env_params, env_state, state: ReinforceState):
        s = state
        for _ in range(solver.n_iters):
            noise = shard(solver.sample_noise(s))
            traj = do_rollout(env_params, env_state, s.mean_weights, noise)
            s = solver.update(s, traj)
        obs = env.observe(env_params, env_state)
        action = solver.act(s, obs)
        s = s._replace(step=s.step + 1)
        return action, jnp.float32(0.0), s

    return solve
