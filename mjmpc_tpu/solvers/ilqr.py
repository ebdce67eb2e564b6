"""Iterative LQR on the differentiable dynamics engine.

The reference ships only scaffolding here — its ilqr.py never chooses an
action (`#TODO: You choose an action`, ilqr.py:147) and its update is
`pass` (SURVEY.md 'quirks'). Because this framework's environments are
differentiable end-to-end (analytic envs and the rigid-body engine), a
REAL iLQR falls out of jax.jacfwd:

- forward pass: nominal rollout under the current action sequence;
- linearize: A_t = df/dx, B_t = df/du along the trajectory (one jacfwd
  over the flattened state, batched over the horizon via the same scan);
- backward Riccati pass with Levenberg-Marquardt regularization on Quu
  (lax.scan in reverse);
- line search on the feedforward gain (static backtracking set, evaluated
  in parallel — pick the best rollout, an accelerator-friendly alternative to a
  sequential while-loop).

State cost is obtained by differentiating the env's own reward.

Scope: intended for SMOOTH analytic envs (LQR — where it is exact against
finite-horizon DP — pendulum, cartpole, point_mass, maze). Engine-backed
envs compose three AD levels (hessian over the engine's jvp/grad bias)
giving very long compiles, and L1-shaped rewards / joint-limit
projections violate the C² assumption vanilla iLQR needs; use the
sampling controllers there (they are also what the reference runs on
those tasks).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..envs.base import Env

_ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.03)   # parallel line-search set


class ILQRState(NamedTuple):
    mean: jax.Array    # [H, dA] nominal action sequence
    step: jax.Array
    key: jax.Array


def _ravel_spec(state):
    """Flatten ONLY the floating-point leaves into the differentiable
    state vector; integer/PRNG-key leaves (timesteps, goal keys) are held
    fixed during planning — casting them through f32 would corrupt uint32
    keys and inject silently-zero Jacobian columns."""
    leaves, treedef = jax.tree_util.tree_flatten(state)
    is_diff = [jnp.issubdtype(jnp.result_type(x), jnp.floating)
               for x in leaves]
    sizes = [int(np.prod(jnp.shape(x))) for x in leaves]
    shapes = [jnp.shape(x) for x in leaves]
    dtypes = [jnp.result_type(x) for x in leaves]
    frozen = [jnp.asarray(x) for x, d in zip(leaves, is_diff) if not d]

    def ravel(s):
        ls = jax.tree_util.tree_leaves(s)
        fl = [jnp.ravel(x).astype(jnp.float32)
              for x, d in zip(ls, is_diff) if d]
        return jnp.concatenate(fl) if fl else jnp.zeros((0,))

    def unravel(vec):
        out, off, fi = [], 0, 0
        for size, shape, dt, d in zip(sizes, shapes, dtypes, is_diff):
            if d:
                out.append(vec[off:off + size].reshape(shape).astype(dt))
                off += size
            else:
                out.append(frozen[fi])
                fi += 1
        return jax.tree_util.tree_unflatten(treedef, out)

    return ravel, unravel


@dataclasses.dataclass(frozen=True)
class ILQR:
    d_action: int
    horizon: int
    num_particles: int = 1          # API symmetry; iLQR is not sampling
    gamma: float = 1.0
    n_iters: int = 5
    mu: float = 1e-3                # Quu Levenberg-Marquardt regularizer
    init_std: float = 0.01          # nominal-sequence init perturbation
    sample_mode: str = "mean"
    action_lows: Optional[np.ndarray] = None
    action_highs: Optional[np.ndarray] = None

    def init_state(self, key: jax.Array) -> ILQRState:
        k1, k2 = jax.random.split(key)
        mean = self.init_std * jax.random.normal(
            k1, (self.horizon, self.d_action))
        return ILQRState(mean=mean, step=jnp.array(0, jnp.int32), key=k2)

    def act(self, state: ILQRState) -> jax.Array:
        return state.mean[0]

    def shift(self, state: ILQRState) -> ILQRState:
        mean = jnp.roll(state.mean, -1, axis=0).at[-1].set(0.0)
        return state._replace(mean=mean)


def build_solve_fn(solver: ILQR, env: Env, shard_particles=None):
    """solve(env_params, env_state, ILQRState) -> (action, value, state)."""
    from .. import ops
    h, da = solver.horizon, solver.d_action
    gamma_pow = jnp.asarray(ops.gamma_sequence(solver.gamma, h).ravel(),
                            jnp.float32)

    def solve(env_params, env_state, state: ILQRState):
        ravel, unravel = _ravel_spec(env_state)
        x0 = ravel(env_state)
        dx = x0.shape[0]

        def f(x_vec, u):
            new_state, _, reward, _ = env.step(env_params, unravel(x_vec),
                                               u)
            return ravel(new_state), -reward    # cost = -reward

        def rollout(us):
            def body(x, u):
                xn, c = f(x, u)
                return xn, (x, c)
            _, (xs, cs) = jax.lax.scan(body, x0, us)
            return xs, cs                        # xs[t] is pre-step state

        def one_iteration(us, _):
            xs, cs = rollout(us)

            def linearize(x, u):
                (a, b) = (jax.jacfwd(lambda xx: f(xx, u)[0])(x),
                          jax.jacfwd(lambda uu: f(x, uu)[0])(u))
                cx = jax.grad(lambda xx: f(xx, u)[1])(x)
                cu = jax.grad(lambda uu: f(x, uu)[1])(u)
                cxx = jax.hessian(lambda xx: f(xx, u)[1])(x)
                cuu = jax.hessian(lambda uu: f(x, uu)[1])(u)
                # cost cross-Hessian d2c/(du dx) — without it Qux is wrong
                # for any cost coupling state and action
                cux = jax.jacfwd(
                    lambda xx: jax.grad(lambda uu: f(xx, uu)[1])(u))(x)
                return a, b, cx, cu, cxx, cuu, cux

            a_s, b_s, cx, cu, cxx, cuu, cux = jax.vmap(linearize)(xs, us)

            # Backward Riccati pass with LM regularization. Per-step cost
            # derivatives are scaled by gamma^t so the quadratic model
            # matches the DISCOUNTED objective the line search scores.
            def back(carry, inp):
                vx, vxx = carry
                a, b, cx_t, cu_t, cxx_t, cuu_t, cux_t, g_t = inp
                qx = g_t * cx_t + a.T @ vx
                qu = g_t * cu_t + b.T @ vx
                qxx = g_t * cxx_t + a.T @ vxx @ a
                quu = g_t * cuu_t + b.T @ vxx @ b + solver.mu * jnp.eye(da)
                qux = g_t * cux_t + b.T @ vxx @ a
                chol = jnp.linalg.cholesky(
                    quu + 1e-6 * jnp.eye(da))
                k_ff = -jax.scipy.linalg.cho_solve((chol, True), qu)
                k_fb = -jax.scipy.linalg.cho_solve((chol, True), qux)
                vx_new = qx + k_fb.T @ quu @ k_ff + k_fb.T @ qu \
                    + qux.T @ k_ff
                vxx_new = qxx + k_fb.T @ quu @ k_fb + k_fb.T @ qux \
                    + qux.T @ k_fb
                vxx_new = 0.5 * (vxx_new + vxx_new.T)
                return (vx_new, vxx_new), (k_ff, k_fb)

            init = (jnp.zeros(dx), jnp.zeros((dx, dx)))
            _, (k_ff, k_fb) = jax.lax.scan(
                back, init, (a_s, b_s, cx, cu, cxx, cuu, cux, gamma_pow),
                reverse=True)

            # Parallel line search over a static alpha set.
            def forward(alpha):
                def body(carry, inp):
                    x, = carry
                    u_nom, x_nom, kf, kb = inp
                    u = u_nom + alpha * kf + kb @ (x - x_nom)
                    xn, c = f(x, u)
                    return (xn,), (u, c)
                (_,), (us_new, cs_new) = jax.lax.scan(
                    body, (x0,), (us, xs, k_ff, k_fb))
                return us_new, jnp.sum(gamma_pow * cs_new)

            us_cand, costs_cand = jax.vmap(forward)(
                jnp.asarray(_ALPHAS, jnp.float32))
            base_cost = jnp.sum(gamma_pow * cs)
            best = jnp.argmin(costs_cand)
            improved = costs_cand[best] < base_cost
            us_next = jnp.where(improved, us_cand[best], us)
            return us_next, jnp.minimum(costs_cand[best], base_cost)

        us, final_costs = jax.lax.scan(one_iteration, state.mean, None,
                                       length=solver.n_iters)
        action = us[0]
        if solver.action_lows is not None:
            action = jnp.clip(action, jnp.asarray(solver.action_lows),
                              jnp.asarray(solver.action_highs))
        new_state = state._replace(mean=us, step=state.step + 1)
        new_state = solver.shift(new_state)
        return action, final_costs[-1], new_state

    return solve
