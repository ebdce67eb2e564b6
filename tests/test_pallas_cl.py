"""Fused closed-loop-linear Pallas kernel vs the XLA engine path.

The CL kernel (ops/pallas_chain.build_chain_cl_rollout) computes the
observation, the policy matmul u = W.T [obs; 1] + eps, the physics, and
the cost inside one kernel and emits the (obs, actions, costs) records
the Reinforce policy-gradient update consumes. Parity target:
rollout_closed_loop_linear over reacher_7dof-v0 (interpreter mode on
the CPU mesh; the same kernel runs compiled on the GPU).
"""
import jax
import jax.numpy as jnp
import numpy as np

from mjmpc_tpu import envs, solvers
from mjmpc_tpu.rollout.engine import rollout_closed_loop_linear


def _setup(seed=0, n=8, h=4):
    env = envs.make("reacher_7dof-v0")
    assert env.fused_cl_rollout is not None
    rng = np.random.default_rng(seed)
    d_obs, d_act = env.d_obs, env.d_action
    weights = jnp.asarray(rng.normal(size=(d_obs + 1, d_act)) * 0.05,
                          jnp.float32)
    noise = jnp.asarray(rng.normal(size=(n, h, d_act)) * 0.3, jnp.float32)
    state = env.init(env.params, jax.random.PRNGKey(seed))
    state = state._replace(qpos=state.qpos + jnp.asarray(
        rng.uniform(-0.2, 0.2, d_act), jnp.float32))
    return env, state, weights, noise


def test_cl_kernel_matches_engine():
    env, state, weights, noise = _setup()
    obs_k, acts_k, costs_k = jax.jit(env.fused_cl_rollout)(
        env.params, state, weights, noise)
    traj = rollout_closed_loop_linear(env, env.params, state, weights,
                                      noise)
    np.testing.assert_allclose(np.asarray(obs_k),
                               np.asarray(traj.observations),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(np.asarray(acts_k),
                               np.asarray(traj.actions),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(np.asarray(costs_k),
                               np.asarray(traj.costs),
                               rtol=0, atol=2e-4)


def test_cl_kernel_policy_actually_closes_the_loop():
    """A nonzero K must produce particle-DIVERGENT actions (each
    particle's own obs feeds back), unlike the open-loop path where all
    particles share mean[t]."""
    env, state, weights, noise = _setup(seed=1)
    _, acts, _ = jax.jit(env.fused_cl_rollout)(
        env.params, state, weights, noise)
    # at t=0 all particles share obs0, so actions differ only by noise;
    # by the last step feedback must have decorrelated them beyond it
    a = np.asarray(acts)
    n0 = np.asarray(noise)[:, 0]
    np.testing.assert_allclose(a[:, 0] - a[:1, 0], n0 - n0[:1],
                               rtol=0, atol=1e-5)
    spread_beyond_noise = np.abs(
        (a[:, -1] - a[:1, -1]) - (np.asarray(noise)[:, -1]
                                  - np.asarray(noise)[:1, -1])).max()
    assert spread_beyond_noise > 1e-4


def test_reinforce_fused_solve_matches_general():
    env, state, _, _ = _setup()
    solver = solvers.Reinforce(
        d_obs=env.d_obs, d_action=env.d_action, horizon=4,
        num_particles=16, lr=0.05, init_cov=0.5, gamma=0.99,
        filter_coeffs=(1.0, 0.0, 0.0), baseline_type=None)
    s0 = solver.init_state(jax.random.PRNGKey(0))
    f = jax.jit(solvers.make_solve_fn(solver, env, fused=True))
    g = jax.jit(solvers.make_solve_fn(solver, env, fused=False))
    a_f, _, sf = f(env.params, state, s0)
    a_g, _, sg = g(env.params, state, s0)
    np.testing.assert_allclose(np.asarray(a_f), np.asarray(a_g),
                               rtol=0, atol=5e-5)
    np.testing.assert_allclose(np.asarray(sf.mean_weights),
                               np.asarray(sg.mean_weights),
                               rtol=0, atol=5e-5)


def test_peg_cl_kernel_matches_engine():
    """Generalized CL builder with peg obs/cost (hole params + sensor
    bias ride extras) vs rollout_closed_loop_linear, including the
    v1 biased variant sharing v0's kernel."""
    for name in ("sawyer_peg_insertion-v0", "sawyer_peg_insertion-v1"):
        env = envs.make(name)
        assert env.fused_cl_rollout is not None
        rng = np.random.default_rng(7)
        w = jnp.asarray(rng.normal(size=(env.d_obs + 1, 7)) * 0.05,
                        jnp.float32)
        noise = jnp.asarray(rng.normal(size=(6, 3, 7)) * 0.3, jnp.float32)
        state = env.init(env.params, jax.random.PRNGKey(0))
        state = state._replace(qpos=state.qpos + jnp.asarray(
            rng.uniform(-0.2, 0.2, 7), jnp.float32))
        obs_k, acts_k, costs_k = jax.jit(env.fused_cl_rollout)(
            env.params, state, w, noise)
        traj = rollout_closed_loop_linear(env, env.params, state, w,
                                          noise)
        np.testing.assert_allclose(np.asarray(obs_k),
                                   np.asarray(traj.observations),
                                   rtol=0, atol=2e-5, err_msg=name)
        np.testing.assert_allclose(np.asarray(acts_k),
                                   np.asarray(traj.actions),
                                   rtol=0, atol=2e-5, err_msg=name)
        np.testing.assert_allclose(np.asarray(costs_k),
                                   np.asarray(traj.costs),
                                   rtol=0, atol=2e-4, err_msg=name)


def test_obs_kernel_matches_engine_open_loop():
    """Open-loop + observations kernel (MPPIQ-with-Q path) vs
    rollout_open_loop on reacher and peg."""
    from mjmpc_tpu.rollout.engine import rollout_open_loop
    for name in ("reacher_7dof-v0", "sawyer_peg_insertion-v1"):
        env = envs.make(name)
        assert env.fused_obs_rollout is not None
        rng = np.random.default_rng(11)
        mean = jnp.asarray(rng.normal(size=(4, 7)) * 0.2, jnp.float32)
        noise = jnp.asarray(rng.normal(size=(8, 4, 7)) * 0.3, jnp.float32)
        state = env.init(env.params, jax.random.PRNGKey(0))
        state = state._replace(qpos=state.qpos + jnp.asarray(
            rng.uniform(-0.2, 0.2, 7), jnp.float32))
        obs_k, costs_k = jax.jit(env.fused_obs_rollout)(
            env.params, state, mean, noise)
        traj = rollout_open_loop(env, env.params, state, mean, noise)
        np.testing.assert_allclose(np.asarray(obs_k),
                                   np.asarray(traj.observations),
                                   rtol=0, atol=2e-5, err_msg=name)
        np.testing.assert_allclose(np.asarray(costs_k),
                                   np.asarray(traj.costs),
                                   rtol=0, atol=2e-4, err_msg=name)


def test_mppiq_with_q_fused_solve_matches_general():
    """MPPIQ with a plugged Q (uses_observations) must auto-ride the
    obs kernel and agree with the general engine path end-to-end."""
    env = envs.make("reacher_7dof-v0")

    def q_fn(obs, acts):
        return 0.05 * jnp.sum(obs ** 2, -1) + 0.1 * jnp.sum(acts ** 2, -1)

    solver = solvers.MPPIQ(d_action=7, horizon=4, num_particles=16,
                           beta=0.3, td_lam=0.9, gamma=0.99,
                           init_cov=0.4, step_size=0.8, alpha=1,
                           filter_coeffs=(0.25, 0.8, 0.0),
                           base_action="null", q_fn=q_fn)
    assert solver.uses_observations
    s0 = solver.init_state(jax.random.PRNGKey(0))
    es = env.init(env.params, jax.random.PRNGKey(1))
    a_f, _, sf = jax.jit(solvers.build_solve_fn(solver, env, fused=True))(
        env.params, es, s0)
    a_g, _, sg = jax.jit(solvers.build_solve_fn(solver, env, fused=False))(
        env.params, es, s0)
    np.testing.assert_allclose(np.asarray(a_f), np.asarray(a_g),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(sf.mean), np.asarray(sg.mean),
                               rtol=0, atol=1e-5)
