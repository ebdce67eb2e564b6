"""Fused Pallas chain-rollout kernel vs the XLA engine and the f64 C++
oracle (ops/pallas_chain.py — the fused path for the reacher/sawyer arm
family; runs in interpreter mode on the CPU mesh)."""
import jax
import jax.numpy as jnp
import numpy as np

from mjmpc_tpu import envs, solvers
from mjmpc_tpu.envs.reacher_7dof import ReacherState
from mjmpc_tpu.ops.pallas_chain import build_chain_rollout
from mjmpc_tpu.oracle import cpp_oracle
from mjmpc_tpu.rollout.engine import rollout_open_loop


def _setup(n, h, seed=0):
    env = envs.make("reacher_7dof-v0")
    rng = np.random.default_rng(seed)
    mean = np.asarray(rng.normal(size=(h, 7)) * 0.3, np.float32)
    noise = np.asarray(rng.normal(size=(n, h, 7)) * 0.5, np.float32)
    q0 = np.asarray(rng.normal(size=7) * 0.1, np.float32)
    qd0 = np.asarray(rng.normal(size=7) * 0.1, np.float32)
    target = np.array([0.2, -0.1, 0.15], np.float32)
    return env, mean, noise, q0, qd0, target


def test_kernel_matches_engine_and_oracle():
    env, mean, noise, q0, qd0, target = _setup(64, 8)
    rollout = build_chain_rollout(env.params.model, n_substeps=2)
    costs_k = np.asarray(jax.jit(rollout)(q0, qd0, target, mean, noise))

    state = ReacherState(qpos=jnp.asarray(q0), qvel=jnp.asarray(qd0),
                         target=jnp.asarray(target),
                         timestep=jnp.array(0, jnp.int32),
                         key=jax.random.PRNGKey(0))
    traj = rollout_open_loop(env, env.params, state, jnp.asarray(mean),
                             jnp.asarray(noise))
    np.testing.assert_allclose(costs_k, np.asarray(traj.costs),
                               rtol=0, atol=5e-5)

    sites = cpp_oracle.chain_site_rollout(env.params.model, q0, qd0,
                                          mean, noise, n_substeps=2)
    diff = sites - target
    costs_o = np.abs(diff).sum(-1) + 5.0 * np.linalg.norm(diff, axis=-1)
    np.testing.assert_allclose(costs_k, costs_o, rtol=0, atol=5e-5)


def test_kernel_pads_ragged_particle_counts():
    env, mean, noise, q0, qd0, target = _setup(37, 5, seed=1)
    rollout = build_chain_rollout(env.params.model, n_substeps=2)
    costs = np.asarray(jax.jit(rollout)(q0, qd0, target, mean, noise))
    assert costs.shape == (37, 5)
    sites = cpp_oracle.chain_site_rollout(env.params.model, q0, qd0,
                                          mean, noise, n_substeps=2)
    diff = sites - target
    costs_o = np.abs(diff).sum(-1) + 5.0 * np.linalg.norm(diff, axis=-1)
    np.testing.assert_allclose(costs, costs_o, rtol=0, atol=5e-5)


def test_fused_solve_matches_general_solve():
    """build_solve_fn's fused fast path must produce the same MPPI
    action/state as the general rollout path (same injected noise via
    the same counter-based stream)."""
    env = envs.make("reacher_7dof-v0")
    assert env.fused_rollout is not None
    solver = solvers.MPPI(d_action=7, horizon=8, num_particles=32,
                          lam=0.2, init_cov=0.5, step_size=1.0,
                          gamma=1.0, alpha=1, base_action="null",
                          filter_coeffs=(0.25, 0.8, 0.0))
    s0 = solver.init_state(jax.random.PRNGKey(0))
    es = env.init(env.params, jax.random.PRNGKey(1))
    a_f, _, sf = jax.jit(solvers.build_solve_fn(solver, env, fused=True))(
        env.params, es, s0)
    a_g, _, sg = jax.jit(solvers.build_solve_fn(solver, env, fused=False))(
        env.params, es, s0)
    np.testing.assert_allclose(np.asarray(a_f), np.asarray(a_g),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(np.asarray(sf.mean), np.asarray(sg.mean),
                               rtol=0, atol=2e-5)


def test_fused_auto_gating():
    """auto mode engages a kernel only where it is compiled (the GPU): on
    the CPU every solve, MPPIQ with a plugged q_fn included, takes the
    general path; envs without a kernel have none to engage."""
    from mjmpc_tpu.ops.kernel_path import auto_fused
    env = envs.make("reacher_7dof-v0")
    assert env.fused_obs_rollout is not None
    assert not auto_fused(env.fused_obs_rollout)
    mppiq = solvers.MPPIQ(d_action=7, horizon=4, num_particles=8,
                          q_fn=lambda obs, act: jnp.zeros(obs.shape[:-1]))
    s0 = mppiq.init_state(jax.random.PRNGKey(0))
    es = env.init(env.params, jax.random.PRNGKey(1))
    a, _, _ = jax.jit(solvers.build_solve_fn(mppiq, env))(
        env.params, es, s0)
    assert np.isfinite(np.asarray(a)).all()

    pend = envs.make("SimplePendulum-v0")
    assert pend.fused_rollout is None


def test_pfmpc_fused_solve_matches_general_solve():
    """PFMPC's solve also rides the costs-only fused kernel (its update
    consumes only trajectory costs); fused and general paths must agree
    on the action and the resampled particle set."""
    env = envs.make("reacher_7dof-v0")
    solver = solvers.PFMPC(d_action=7, horizon=8, num_particles=32,
                           lam=0.1, cov_shift=0.05, cov_resample=0.5,
                           filter_coeffs=(0.25, 0.8, 0.0))
    s0 = solver.init_state(jax.random.PRNGKey(0))
    es = env.init(env.params, jax.random.PRNGKey(1))
    from mjmpc_tpu.solvers.pfmpc import build_solve_fn as pf_build
    a_f, _, sf = jax.jit(pf_build(solver, env, fused=True))(
        env.params, es, s0)
    a_g, _, sg = jax.jit(pf_build(solver, env, fused=False))(
        env.params, es, s0)
    np.testing.assert_allclose(np.asarray(a_f), np.asarray(a_g),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(np.asarray(sf.action_samples),
                               np.asarray(sg.action_samples),
                               rtol=0, atol=2e-5)
