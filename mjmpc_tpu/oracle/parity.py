"""Parity-noise mode: run the JAX solver against the CPU reference math
at identical seeds and compare control sequences.

BASELINE.md requires 'control-sequence deviation within tolerance of CPU
mjmpc at identical horizon/num_particles/seeds (parity-noise mode)'. The
reference's noise is drawn by reseeding GLOBAL NumPy every solve
(control_utils.py:24-34) — not reproducible with JAX PRNG bit-for-bit —
so in parity mode the noise is generated host-side with the exact
reference procedure (oracle.numpy_ref.generate_noise) and INJECTED into
both sides (SURVEY.md §7 'hard parts', plan (a)):

  CPU side:  serial double-precision rollout (C++ oracle) + NumPy
             reference update equations,
  JAX side:  the framework's fused rollout + solver update with the same
             injected noise,

stepping both for `n_steps` MPC solves and reporting the worst deviation
of the executed control sequence.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import envs, ops, solvers
from ..rollout.engine import rollout_open_loop
from . import numpy_ref
from . import cpp_oracle


def run_mppi_parity(n_steps: int = 10, horizon: int = 16,
                    num_particles: int = 64, base_seed: int = 123,
                    lam: float = 0.05, step_size: float = 0.7,
                    gamma: float = 0.99,
                    filter_coeffs=(0.25, 0.8, 0.0),
                    jax_seed_offset: int = 0,
                    f64_rollout: bool = False) -> Tuple[float, float]:
    """(max control deviation, max mean-sequence deviation) over an
    n_step closed-loop pendulum run at identical injected noise.

    f64_rollout runs the JAX-side rollout+update at double precision
    (jax_enable_x64), separating integration drift from update-math
    error: the f64 path must agree with the f64 CPU oracle to ~1e-8,
    while the production f32 path carries small integrator drift."""
    env = envs.make("SimplePendulum-v0")
    solver = solvers.MPPI(d_action=1, horizon=horizon,
                          num_particles=num_particles, lam=lam,
                          step_size=step_size, gamma=gamma, alpha=1,
                          init_cov=1.0, filter_coeffs=filter_coeffs,
                          base_action="null")
    dtype = jnp.float64 if f64_rollout else jnp.float32

    @jax.jit
    def jax_update(mean, env_state, noise):
        state = solver.init_state(jax.random.PRNGKey(0))._replace(
            mean=jnp.asarray(mean, dtype))
        traj = rollout_open_loop(env, env.params, env_state, state.mean,
                                 jnp.asarray(noise, dtype))
        return solver.update(state, traj).mean

    def cpu_update(mean, actions, costs):
        return cpp_oracle.mppi_update(mean, actions, costs, gamma, lam,
                                      step_size)

    with _x64_if(f64_rollout):
        return _run_parity((cpu_update, jax_update), n_steps, horizon,
                           num_particles, base_seed,
                           filter_coeffs=filter_coeffs,
                           jax_seed_offset=jax_seed_offset,
                           dtype=dtype)


def _x64_if(enabled: bool):
    """Context manager enabling jax_enable_x64 for f64 parity variants
    (restores the previous flag on exit)."""
    import contextlib
    if not enabled:
        return contextlib.nullcontext()

    @contextlib.contextmanager
    def ctx():
        prev = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", True)
        try:
            yield
        finally:
            jax.config.update("jax_enable_x64", prev)
    return ctx()


def _run_parity(update_pair, n_steps, horizon, num_particles, base_seed,
                filter_coeffs=(0.25, 0.8, 0.0), jax_seed_offset=0,
                dtype=jnp.float32):
    """Shared closed-loop parity loop: update_pair = (cpu_update,
    jax_update) where each maps (mean, costs/traj pieces) -> new mean.

    jax_seed_offset != 0 deliberately DESYNCHRONIZES the injected noise
    (JAX side drawn at base_seed + t + offset) — used by the vacuity
    guard in tests: mismatched seeds must NOT stay within tolerance."""
    env = envs.make("SimplePendulum-v0")
    cov = np.eye(1, dtype=np.float64)
    cpu_update, jax_update = update_pair

    env_state = env.init(env.params, jax.random.PRNGKey(1))
    th, thdot = float(env_state.th), float(env_state.thdot)
    mean_cpu = np.zeros((horizon, 1))
    mean_jax = np.zeros((horizon, 1))
    max_act_dev = 0.0
    max_mean_dev = 0.0
    from ..envs.pendulum import PendulumState
    step_fn = jax.jit(env.step)

    for t in range(n_steps):
        noise = numpy_ref.generate_noise(
            cov, filter_coeffs, (num_particles, horizon), base_seed + t)
        noise_jax = noise if jax_seed_offset == 0 else \
            numpy_ref.generate_noise(
                cov, filter_coeffs, (num_particles, horizon),
                base_seed + t + jax_seed_offset)
        costs_cpu = cpp_oracle.pendulum_rollout(
            env.params, th, thdot, mean_cpu, noise)
        mean_cpu = cpu_update(mean_cpu, mean_cpu[None] + noise, costs_cpu)

        env_state = PendulumState(th=jnp.asarray(th, dtype),
                                  thdot=jnp.asarray(thdot, dtype))
        mean_jax = np.asarray(jax_update(mean_jax, env_state, noise_jax))

        max_mean_dev = max(max_mean_dev,
                           float(np.abs(mean_cpu - mean_jax).max()))
        a_cpu = mean_cpu[0]
        max_act_dev = max(max_act_dev,
                          float(np.abs(a_cpu - mean_jax[0]).max()))
        env_state, _, _, _ = step_fn(
            env.params, env_state,
            jnp.asarray(np.clip(a_cpu, -2, 2), jnp.float32))
        th, thdot = float(env_state.th), float(env_state.thdot)
        mean_cpu = np.vstack([mean_cpu[1:], np.zeros((1, 1))])
        mean_jax = np.vstack([mean_jax[1:], np.zeros((1, 1))])
    return max_act_dev, max_mean_dev


def run_random_shooting_parity(n_steps=8, horizon=12, num_particles=48,
                               base_seed=123, step_size=0.7, gamma=0.99):
    env = envs.make("SimplePendulum-v0")
    solver = solvers.RandomShooting(
        d_action=1, horizon=horizon, num_particles=num_particles,
        step_size=step_size, gamma=gamma, init_cov=1.0)
    gamma_seq = ops.gamma_sequence(gamma, horizon)

    @jax.jit
    def jax_update(mean, env_state, noise):
        state = solver.init_state(jax.random.PRNGKey(0))._replace(
            mean=jnp.asarray(mean, jnp.float32))
        traj = rollout_open_loop(env, env.params, env_state, state.mean,
                                 jnp.asarray(noise, jnp.float32))
        return solver.update(state, traj).mean

    def cpu_update(mean, actions, costs):
        return numpy_ref.random_shooting_update(
            mean, actions, costs, gamma_seq, step_size)

    return _run_parity((cpu_update, jax_update), n_steps, horizon,
                       num_particles, base_seed)[0]


def run_cem_parity(n_steps=8, horizon=12, num_particles=48,
                   base_seed=123, step_size=0.8, gamma=0.99,
                   elite_frac=0.25):
    env = envs.make("SimplePendulum-v0")
    solver = solvers.CEM(
        d_action=1, horizon=horizon, num_particles=num_particles,
        step_size=step_size, gamma=gamma, elite_frac=elite_frac,
        beta=0.0, init_cov=1.0, cov_type="diagonal")
    gamma_seq = ops.gamma_sequence(gamma, horizon)

    @jax.jit
    def jax_update(mean, env_state, noise):
        state = solver.init_state(jax.random.PRNGKey(0))._replace(
            mean=jnp.asarray(mean, jnp.float32))
        traj = rollout_open_loop(env, env.params, env_state, state.mean,
                                 jnp.asarray(noise, jnp.float32))
        return solver.update(state, traj).mean

    def cpu_update(mean, actions, costs):
        new_mean, _ = numpy_ref.cem_update(
            mean, np.eye(1), actions, costs, gamma_seq, elite_frac,
            step_size, "diagonal")
        return new_mean

    return _run_parity((cpu_update, jax_update), n_steps, horizon,
                       num_particles, base_seed)[0]


def run_dmd_parity(n_steps=8, horizon=12, num_particles=48,
                   base_seed=123, lam=0.2, step_size=0.7, gamma=0.99,
                   beta=0.05, update_cov=True, cov_type="diagonal",
                   filter_coeffs=(0.25, 0.8, 0.0)):
    """Chained DMD parity: BOTH the mean and the adapted covariance are
    carried across solves (the cov drives the next step's injected noise,
    so covariance drift compounds — the case single-update parity cannot
    see). Matches gaussian_dmd.py:65-116."""
    env = envs.make("SimplePendulum-v0")
    solver = solvers.DMDMPC(
        d_action=1, horizon=horizon, num_particles=num_particles,
        lam=lam, step_size=step_size, gamma=gamma, beta=beta,
        update_cov=update_cov, cov_type=cov_type, init_cov=1.0,
        filter_coeffs=filter_coeffs, base_action="null")
    gamma_seq = ops.gamma_sequence(gamma, horizon)

    @jax.jit
    def jax_update(mean, cov, env_state, noise):
        state = solver.init_state(jax.random.PRNGKey(0))._replace(
            mean=jnp.asarray(mean, jnp.float32),
            cov=jnp.asarray(cov, jnp.float32))
        traj = rollout_open_loop(env, env.params, env_state, state.mean,
                                 jnp.asarray(noise, jnp.float32))
        s = solver.update(state, traj)
        return s.mean, s.cov

    from ..envs.pendulum import PendulumState
    env_state = env.init(env.params, jax.random.PRNGKey(1))
    th, thdot = float(env_state.th), float(env_state.thdot)
    mean_cpu = np.zeros((horizon, 1))
    cov_cpu = np.eye(1, dtype=np.float64)
    mean_jax = np.zeros((horizon, 1))
    cov_jax = np.eye(1, dtype=np.float64)
    step_fn = jax.jit(env.step)
    max_dev = 0.0

    for t in range(n_steps):
        # noise drawn from the CPU-side cov (the sides would diverge in
        # WHICH noise they draw only if the cov chains diverged — which
        # is exactly what max cov dev below bounds)
        noise = numpy_ref.generate_noise(
            cov_cpu, filter_coeffs, (num_particles, horizon),
            base_seed + t)
        costs = cpp_oracle.pendulum_rollout(
            env.params, th, thdot, mean_cpu, noise)
        mean_cpu, cov_cpu = numpy_ref.dmd_update(
            mean_cpu, cov_cpu, mean_cpu[None] + noise, costs, gamma_seq,
            lam, step_size, update_cov, cov_type)

        est = PendulumState(th=jnp.float32(th), thdot=jnp.float32(thdot))
        m, c = jax_update(mean_jax, cov_jax, est, noise)
        mean_jax, cov_jax = np.asarray(m, np.float64), np.asarray(
            c, np.float64)

        max_dev = max(max_dev, float(np.abs(mean_cpu - mean_jax).max()),
                      float(np.abs(cov_cpu - cov_jax).max()))
        env_state, _, _, _ = step_fn(
            env.params, est,
            jnp.asarray(np.clip(mean_cpu[0], -2, 2), jnp.float32))
        th, thdot = float(env_state.th), float(env_state.thdot)
        # shift: roll mean, null last; cov += beta*I (gaussian_dmd:106-116)
        mean_cpu = np.vstack([mean_cpu[1:], np.zeros((1, 1))])
        mean_jax = np.vstack([mean_jax[1:], np.zeros((1, 1))])
        if update_cov:
            cov_cpu = cov_cpu + beta * np.eye(1)
            cov_jax = cov_jax + beta * np.eye(1)
    return max_dev


def run_mppiq_parity(n_steps=8, horizon=12, num_particles=48,
                     base_seed=123, beta=0.1, step_size=0.7,
                     gamma=0.99, td_lam=0.95, alpha=0,
                     filter_coeffs=(0.25, 0.8, 0.0)):
    """Chained MPPIQ parity: TD(lambda) blended returns + per-step control
    costs + time-based weights (mppiq.py:73-136), terminal-cost q
    bootstrap (no plugged Q function — the reference default)."""
    env = envs.make("SimplePendulum-v0")
    solver = solvers.MPPIQ(
        d_action=1, horizon=horizon, num_particles=num_particles,
        beta=beta, td_lam=td_lam, alpha=alpha, step_size=step_size,
        gamma=gamma, time_based_weights=True, init_cov=1.0,
        filter_coeffs=filter_coeffs, base_action="null")

    @jax.jit
    def jax_update(mean, env_state, noise):
        state = solver.init_state(jax.random.PRNGKey(0))._replace(
            mean=jnp.asarray(mean, jnp.float32))
        traj = rollout_open_loop(env, env.params, env_state, state.mean,
                                 jnp.asarray(noise, jnp.float32))
        return solver.update(state, traj).mean

    def cpu_update(mean, actions, costs):
        return numpy_ref.mppiq_update(
            mean, np.eye(1), actions, costs, gamma, td_lam, beta,
            step_size, alpha, time_based_weights=True)

    return _run_parity((cpu_update, jax_update), n_steps, horizon,
                       num_particles, base_seed,
                       filter_coeffs=filter_coeffs)[0]


def run_pfmpc_parity(n_steps=6, horizon=12, num_particles=32,
                     base_seed=123, lam=0.2, cov_shift=0.02,
                     cov_resample=0.5, filter_coeffs=(0.25, 0.8, 0.0)):
    """Chained PFMPC parity: the PERSISTENT particle set evolves on both
    sides — weights, the systematic resample (serial cumsum walk on CPU
    vs vectorized searchsorted in JAX, pf:159-174), mean extraction, and
    the shift-noise hotstart. All stochastic inputs (resample offset r,
    shift noise) are derived once from the solver's own counter-based
    streams and injected into BOTH sides."""
    from ..solvers.pfmpc import PFState
    from ..solvers.base import _fold
    from ..solvers.pfmpc import _TAG_RESAMPLE, _TAG_SHIFT
    from ..envs.pendulum import PendulumState

    env = envs.make("SimplePendulum-v0")
    solver = solvers.PFMPC(
        d_action=1, horizon=horizon, num_particles=num_particles,
        lam=lam, cov_shift=cov_shift, cov_resample=cov_resample,
        filter_coeffs=filter_coeffs, base_action="repeat")

    key = jax.random.PRNGKey(base_seed)
    init = solver.init_state(key)
    state_key = init.key
    samples0 = np.asarray(init.action_samples, np.float64)

    @jax.jit
    def jax_step(samples, env_state, step):
        s = PFState(action_samples=jnp.asarray(samples, jnp.float32),
                    mean=jnp.mean(jnp.asarray(samples, jnp.float32), 0),
                    step=step, key=state_key)
        delta = s.action_samples - s.mean[None, :, :]
        traj = rollout_open_loop(env, env.params, env_state, s.mean, delta)
        s = solver.update(s, traj)
        action = solver.act(s)
        s = s._replace(step=s.step + 1)
        s = solver.shift(s)
        return action, s.action_samples

    samples_cpu = samples0.copy()
    samples_jax = samples0.copy()
    env_state = env.init(env.params, jax.random.PRNGKey(1))
    th, thdot = float(env_state.th), float(env_state.thdot)
    step_fn = jax.jit(env.step)
    max_act_dev = 0.0

    for t in range(n_steps):
        step = jnp.array(t, jnp.int32)
        # shared stochastic inputs from the solver's own streams
        r = float(jax.random.uniform(
            _fold(state_key, _TAG_RESAMPLE, step), (),
            maxval=1.0 / num_particles))
        # the solve path increments step BEFORE shifting (base.py solve)
        shift_noise = np.asarray(ops.filtered_noise(
            _fold(state_key, _TAG_SHIFT, step + 1),
            jnp.diag(jnp.full((1,), cov_shift)),
            (num_particles, horizon), filter_coeffs), np.float64)

        # CPU side: f64 rollout + serial-walk resample + shift
        costs = cpp_oracle.pendulum_rollout(
            env.params, th, thdot, np.zeros((horizon, 1)), samples_cpu)
        ctg = numpy_ref.cost_to_go(
            costs, ops.gamma_sequence(solver.gamma, horizon))[:, 0]
        w = np.exp(-ctg / lam - np.max(-ctg / lam))
        w = w / w.sum()
        samples_cpu = numpy_ref.pf_systematic_resample(samples_cpu, w, r)
        a_cpu = samples_cpu.mean(axis=0)[0]
        samples_cpu = np.concatenate(
            [samples_cpu[:, 1:], samples_cpu[:, -1:]], axis=1) + shift_noise
        samples_cpu[:, -1] = samples_cpu[:, -2]

        # JAX side: the framework's actual solve path
        est = PendulumState(th=jnp.float32(th), thdot=jnp.float32(thdot))
        a_jax, new_samples = jax_step(samples_jax, est, step)
        samples_jax = np.asarray(new_samples, np.float64)

        max_act_dev = max(max_act_dev,
                          float(np.abs(a_cpu - np.asarray(a_jax)).max()))
        env_state, _, _, _ = step_fn(
            env.params, est, jnp.asarray(np.clip(a_cpu, -2, 2),
                                         jnp.float32))
        th, thdot = float(env_state.th), float(env_state.thdot)
    return max_act_dev


# ---------------------------------------------------------------------------
# 7-DOF arm parity (BASELINE north-star: reacher_7dof + sawyer tasks).
# CPU side = serial f64 chain_site_rollout (C++ oracle, the engine's own
# step semantics at double precision) + NumPy reference updates; JAX side
# = the framework's fused rollout + solver update. Noise is the exact
# reference multivariate procedure (control_utils.py:24-34) with per-dim
# covariance, injected into both sides.
# ---------------------------------------------------------------------------

def _reacher_costs(sites: np.ndarray, target: np.ndarray) -> np.ndarray:
    """cost = -reward = l1 + 5*l2 of hand-target (reacher_env.py:29-39)."""
    diff = sites - target
    return np.abs(diff).sum(-1) + 5.0 * np.linalg.norm(diff, axis=-1)


def _peg_costs(sites: np.ndarray, params) -> np.ndarray:
    """cost = -reward of sawyer_peg_insertion-v0 (envs/sawyer_tasks.py
    _peg_step: bottom distance + lateral*inserted - inserted bonus)."""
    entry = np.asarray(params.hole_entry, np.float64)
    axis = np.asarray(params.hole_axis, np.float64)
    depth_max = float(params.hole_depth)
    rel = sites - (entry + np.asarray(params.sensor_bias, np.float64))
    depth = rel @ axis
    lateral = np.linalg.norm(rel - depth[..., None] * axis, axis=-1)
    inserted = np.clip(depth, 0.0, depth_max) / max(depth_max, 1e-6)
    bottom = entry + depth_max * axis
    reward = (-np.linalg.norm(sites - bottom, axis=-1)
              - 5.0 * lateral * inserted + 1.0 * inserted)
    return -reward


def run_reacher_mppi_parity(n_steps: int = 6, horizon: int = 10,
                            num_particles: int = 32, base_seed: int = 123,
                            lam: float = 0.2, step_size: float = 1.0,
                            gamma: float = 1.0, alpha: int = 0,
                            filter_coeffs=(0.25, 0.8, 0.0),
                            init_cov=(0.3, 0.5, 0.7, 0.9, 0.5, 0.3, 0.2),
                            jax_seed_offset: int = 0,
                            env_name: str = "reacher_7dof-v0",
                            f64_rollout: bool = False):
    """Chained MPPI parity on the 7-DOF arm (reference
    configs/reacher_7dof-v0.yml mppi block, but alpha=0 so the
    multivariate Sigma^-1 control-cost path is exercised with a per-dim
    covariance). env_name 'sawyer_peg_insertion-v0' runs the same arm
    under the sawyer peg task cost. Returns (max action dev, max
    mean-sequence dev) over n_steps closed-loop solves; real state is
    advanced by the f64 oracle step on both sides."""
    env = envs.make(env_name)
    model = (env.params.model)
    cov = np.diag(np.asarray(init_cov, np.float64))
    d_action = 7
    solver = solvers.MPPI(
        d_action=d_action, horizon=horizon, num_particles=num_particles,
        lam=lam, step_size=step_size, gamma=gamma, alpha=alpha,
        init_cov=1.0, filter_coeffs=filter_coeffs, base_action="null")
    gamma_seq = np.asarray(ops.gamma_sequence(gamma, horizon), np.float64)

    with _x64_if(f64_rollout):
        dtype = jnp.float64 if f64_rollout else jnp.float32

        @jax.jit
        def jax_update(mean, env_state, noise):
            # per-dim covariance goes in via the state (it feeds the
            # Sigma^-1 control-cost path when alpha=0)
            state = solver.init_state(jax.random.PRNGKey(0))._replace(
                mean=jnp.asarray(mean, dtype),
                cov=jnp.diag(jnp.asarray(init_cov, dtype)))
            traj = rollout_open_loop(env, env.params, env_state,
                                     state.mean,
                                     jnp.asarray(noise, dtype))
            return solver.update(state, traj).mean

        if env_name == "reacher_7dof-v0":
            target = np.array([0.2, -0.1, 0.15], np.float64)
            cost_fn = lambda sites: _reacher_costs(sites, target)

            def make_state(q, qd):
                from ..envs.reacher_7dof import ReacherState
                return ReacherState(
                    qpos=jnp.asarray(q, dtype), qvel=jnp.asarray(qd, dtype),
                    target=jnp.asarray(target, dtype),
                    timestep=jnp.array(0, jnp.int32),
                    key=jax.random.PRNGKey(0))
        else:
            cost_fn = lambda sites: _peg_costs(sites, env.params)

            def make_state(q, qd):
                from ..envs.sawyer_tasks import PegState
                return PegState(qpos=jnp.asarray(q, dtype),
                                qvel=jnp.asarray(qd, dtype),
                                timestep=jnp.array(0, jnp.int32))

        q = np.zeros(7, np.float64)
        qd = np.zeros(7, np.float64)
        mean_cpu = np.zeros((horizon, d_action))
        mean_jax = np.zeros((horizon, d_action))
        max_act_dev = 0.0
        max_mean_dev = 0.0

        for t in range(n_steps):
            noise = numpy_ref.generate_noise(
                cov, filter_coeffs, (num_particles, horizon),
                base_seed + t)
            noise_jax = noise if jax_seed_offset == 0 else \
                numpy_ref.generate_noise(
                    cov, filter_coeffs, (num_particles, horizon),
                    base_seed + t + jax_seed_offset)

            sites = cpp_oracle.chain_site_rollout(
                model, q, qd, mean_cpu, noise, n_substeps=2)
            costs = cost_fn(sites)
            mean_cpu = numpy_ref.mppi_update(
                mean_cpu, cov, mean_cpu[None] + noise, costs, gamma_seq,
                lam, step_size, alpha)

            mean_jax = np.asarray(
                jax_update(mean_jax, make_state(q, qd), noise_jax),
                np.float64)

            max_mean_dev = max(max_mean_dev,
                               float(np.abs(mean_cpu - mean_jax).max()))
            a_cpu = mean_cpu[0]
            max_act_dev = max(max_act_dev,
                              float(np.abs(a_cpu - mean_jax[0]).max()))
            q, qd = cpp_oracle.chain_step(
                model, q, qd, np.clip(a_cpu, -1.0, 1.0), n_substeps=2)
            mean_cpu = np.vstack([mean_cpu[1:],
                                  np.zeros((1, d_action))])
            mean_jax = np.vstack([mean_jax[1:],
                                  np.zeros((1, d_action))])
    return max_act_dev, max_mean_dev


def run_reacher_cem_full_parity(n_steps: int = 6, horizon: int = 10,
                                num_particles: int = 32,
                                base_seed: int = 123,
                                elite_frac: float = 0.2,
                                beta: float = 0.3,
                                step_size: float = 1.0,
                                gamma: float = 1.0,
                                filter_coeffs=(0.25, 0.8, 0.0)):
    """Chained CEM(full-cov) parity on the 7-DOF arm (reference
    configs/reacher_7dof-v0.yml cem block: cov_type full, beta 0.3,
    elite_frac 0.2). The FULL 7x7 action covariance chains across solves
    and drives the next solve's multivariate noise draw — the case where
    cov handling / noise coloring could diverge (VERDICT r2 missing #1).
    Returns max deviation over mean, cov, and the executed action."""
    env = envs.make("reacher_7dof-v0")
    model = env.params.model
    d_action = 7
    target = np.array([0.2, -0.1, 0.15], np.float64)
    solver = solvers.CEM(
        d_action=d_action, horizon=horizon, num_particles=num_particles,
        elite_frac=elite_frac, beta=beta, step_size=step_size,
        gamma=gamma, init_cov=1.0, cov_type="full",
        filter_coeffs=filter_coeffs, base_action="null")
    gamma_seq = np.asarray(ops.gamma_sequence(gamma, horizon), np.float64)

    @jax.jit
    def jax_update(mean, cov, env_state, noise):
        state = solver.init_state(jax.random.PRNGKey(0))._replace(
            mean=jnp.asarray(mean, jnp.float32),
            cov=jnp.asarray(cov, jnp.float32))
        traj = rollout_open_loop(env, env.params, env_state, state.mean,
                                 jnp.asarray(noise, jnp.float32))
        s = solver.update(state, traj)
        return s.mean, s.cov

    from ..envs.reacher_7dof import ReacherState

    def make_state(q, qd):
        return ReacherState(
            qpos=jnp.asarray(q, jnp.float32),
            qvel=jnp.asarray(qd, jnp.float32),
            target=jnp.asarray(target, jnp.float32),
            timestep=jnp.array(0, jnp.int32), key=jax.random.PRNGKey(0))

    q = np.zeros(7, np.float64)
    qd = np.zeros(7, np.float64)
    mean_cpu = np.zeros((horizon, d_action))
    cov_cpu = np.eye(d_action)
    mean_jax = np.zeros((horizon, d_action))
    cov_jax = np.eye(d_action)
    max_dev = 0.0

    for t in range(n_steps):
        # noise drawn from the CPU-side chained cov; cov divergence is
        # bounded by the cov deviation below
        noise = numpy_ref.generate_noise(
            cov_cpu, filter_coeffs, (num_particles, horizon),
            base_seed + t)
        sites = cpp_oracle.chain_site_rollout(
            model, q, qd, mean_cpu, noise, n_substeps=2)
        costs = _reacher_costs(sites, target)
        mean_cpu, cov_cpu = numpy_ref.cem_update(
            mean_cpu, cov_cpu, mean_cpu[None] + noise, costs, gamma_seq,
            elite_frac, step_size, "full")

        m, c = jax_update(mean_jax, cov_jax, make_state(q, qd), noise)
        mean_jax = np.asarray(m, np.float64)
        cov_jax = np.asarray(c, np.float64)

        max_dev = max(max_dev,
                      float(np.abs(mean_cpu - mean_jax).max()),
                      float(np.abs(cov_cpu - cov_jax).max()))
        a_cpu = mean_cpu[0]
        q, qd = cpp_oracle.chain_step(
            model, q, qd, np.clip(a_cpu, -1.0, 1.0), n_substeps=2)
        # shift: roll mean, null last; cov += beta*diag(init_cov)
        # (cem.py:89-95, init_cov = 1)
        mean_cpu = np.vstack([mean_cpu[1:], np.zeros((1, d_action))])
        mean_jax = np.vstack([mean_jax[1:], np.zeros((1, d_action))])
        grow = beta * np.eye(d_action)
        cov_cpu = cov_cpu + grow
        cov_jax = cov_jax + grow
    return max_dev


def main():
    act_dev, mean_dev = run_mppi_parity()
    act_dev64, _ = run_mppi_parity(f64_rollout=True)
    rs_dev = run_random_shooting_parity()
    cem_dev = run_cem_parity()
    print(f"parity-noise MPPI: max action dev {act_dev:.2e}, "
          f"mean-seq dev {mean_dev:.2e} (f64 rollout: {act_dev64:.2e})")
    print(f"parity-noise random_shooting: max action dev {rs_dev:.2e}")
    print(f"parity-noise CEM(diag): max action dev {cem_dev:.2e}")
    r_act, r_mean = run_reacher_mppi_parity(n_steps=8, horizon=16)
    r64_act, _ = run_reacher_mppi_parity(n_steps=8, horizon=16,
                                         f64_rollout=True)
    r_cem = run_reacher_cem_full_parity(n_steps=8, horizon=16)
    p_act, _ = run_reacher_mppi_parity(
        n_steps=8, horizon=16, env_name="sawyer_peg_insertion-v0")
    print(f"parity-noise reacher_7dof MPPI(7-dim cov, control costs): "
          f"act dev {r_act:.2e}, mean dev {r_mean:.2e} "
          f"(f64 rollout: {r64_act:.2e})")
    print(f"parity-noise reacher_7dof CEM(full 7x7 cov chain): "
          f"max dev {r_cem:.2e}")
    print(f"parity-noise sawyer_peg_insertion MPPI: act dev {p_act:.2e}")
    return act_dev, mean_dev


if __name__ == "__main__":
    main()
