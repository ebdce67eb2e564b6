"""Fused Pallas rollout kernels for the sawyer + panda arm-task
families vs the XLA engine path (interpreter mode on the CPU mesh).

These envs (sawyer pusher / door / peg insertion, panda tray-glass
v0/v1/fixed-v1) ride the generic forest kernel builder
(ops/pallas_forest.py) with env-specific cost / contact / joint-torque
callbacks, the same pattern as the hand suite. Unlike the 21-body hand
kernels these 8-11 body models compile in seconds on XLA-CPU, so the
parity tests run unconditionally in CI.

Coverage per env of kernel features:
- peg insertion: pure 7-joint chain, cost-only plug (depth-progress
  insertion cost), hole params via extras (v1 shares the kernel).
- pusher: two-tree forest (arm + block slides), equal-and-opposite
  penalty contact through scalar-joint point Jacobians.
- door: proximity-GATED grab spring (branch-free where), force applied
  at a non-origin local point of the door body.
- tray-glass: configuration-dependent gravity feedforward computed in
  lane dialect from the kernel's own FK (joint_torque_fn with fk),
  validated against the engine's jax.grad(potential_energy) inside the
  full rollout; v1/fixed-v1 bake variant damping/range constants.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mjmpc_tpu import envs, solvers
from mjmpc_tpu.rollout.engine import rollout_open_loop


def _parity(env_name, n=8, h=3, seed=3, atol=2e-4, perturb=True):
    env = envs.make(env_name)
    assert env.fused_rollout is not None
    rng = np.random.default_rng(seed)
    d = env.d_action
    mean = jnp.asarray(rng.normal(size=(h, d)) * 0.2, jnp.float32)
    noise = jnp.asarray(rng.normal(size=(n, h, d)) * 0.3, jnp.float32)
    state = env.init(env.params, jax.random.PRNGKey(seed))
    if perturb:
        qpos = state.qpos.at[:d].add(
            jnp.asarray(rng.uniform(-0.2, 0.2, d), jnp.float32))
        state = state._replace(qpos=qpos)
    costs_k = np.asarray(jax.jit(env.fused_rollout)(
        env.params, state, mean, noise))
    traj = rollout_open_loop(env, env.params, state, mean, noise)
    assert np.isfinite(costs_k).all()
    np.testing.assert_allclose(costs_k, np.asarray(traj.costs),
                               rtol=0, atol=atol)
    return env, state


def test_peg_insertion_kernel_matches_engine():
    _parity("sawyer_peg_insertion-v0")


def test_peg_insertion_v1_bias_rides_extras():
    """The v1 sensed-target variant shares v0's kernel; the sensor bias
    enters through extras and must shift the cost."""
    env = envs.make("sawyer_peg_insertion-v1")
    assert float(jnp.abs(env.params.sensor_bias).max()) > 0
    _parity("sawyer_peg_insertion-v1")
    state = env.init(env.params, jax.random.PRNGKey(0))
    # the bias enters the reward only through the depth-gated lateral /
    # inserted terms (_peg_metrics + _peg_step), so move the hole mouth
    # to the tip: depth > 0 and the biased sensed frame becomes live
    from mjmpc_tpu.engine import chain as rb
    tip = rb.site_position(env.params.model, state.qpos)
    params = env.params._replace(
        hole_entry=tip - 0.02 * env.params.hole_axis)
    mean = jnp.zeros((2, 7))
    noise = 0.05 * jax.random.normal(jax.random.PRNGKey(1), (4, 2, 7))
    fr = jax.jit(env.fused_rollout)
    c_biased = np.asarray(fr(params, state, mean, noise))
    unbiased = params._replace(sensor_bias=jnp.zeros(3))
    c_nominal = np.asarray(fr(unbiased, state, mean, noise))
    assert np.abs(c_biased - c_nominal).max() > 1e-6
    # and the kernel still matches the engine in the live-bias regime
    traj = rollout_open_loop(env, params, state, mean, noise)
    np.testing.assert_allclose(c_biased, np.asarray(traj.costs),
                               rtol=0, atol=2e-4)


def test_pusher_kernel_matches_engine():
    _parity("sawyer_pusher-v0")


def test_pusher_contact_engages():
    """Drive the arm toward the block: the rollout must show hand-block
    contact actually moving the block (kernel vs engine on a state where
    the penalty force is live, not just zero-force agreement)."""
    env = envs.make("sawyer_pusher-v0")
    state = env.init(env.params, jax.random.PRNGKey(0))
    # place the block just inside the hand sphere so overlap > 0 at t=0
    rng = np.random.default_rng(4)
    qpos = state.qpos.at[:7].add(
        jnp.asarray(rng.uniform(-0.1, 0.1, 7), jnp.float32))
    from mjmpc_tpu.engine import chain as rb
    _, poss = rb.forward_kinematics(env.params.model, qpos)
    hand = poss[6]
    qpos = qpos.at[7].set(hand[0] + 0.08)  # block x near the hand
    qpos = qpos.at[8].set(hand[1])
    state = state._replace(qpos=qpos)
    mean = jnp.zeros((3, 7))
    noise = 0.2 * jax.random.normal(jax.random.PRNGKey(2), (6, 3, 7))
    costs_k = np.asarray(jax.jit(env.fused_rollout)(
        env.params, state, mean, noise))
    traj = rollout_open_loop(env, env.params, state, mean, noise)
    np.testing.assert_allclose(costs_k, np.asarray(traj.costs),
                               rtol=0, atol=2e-4)


def test_door_kernel_matches_engine():
    _parity("sawyer_door-v0")


def test_tray_glass_kernel_matches_engine():
    """Exercises the lane-dialect gravity feedforward (joint_torque_fn
    with fk) against the engine's jax.grad(potential_energy)."""
    _parity("panda_tray_glass-v0")


def test_tray_glass_v1_variants_bake_their_models():
    _parity("panda_tray_glass-v1")
    _parity("panda_tray_glass_fixed-v1")


def test_fused_solve_matches_general_solve():
    """build_solve_fn fused fast path == general path on the pusher."""
    env = envs.make("sawyer_pusher-v0")
    solver = solvers.MPPI(d_action=env.d_action, horizon=3,
                          num_particles=8, lam=0.2, init_cov=0.3,
                          step_size=1.0, gamma=1.0, alpha=1,
                          base_action="null",
                          filter_coeffs=(0.25, 0.8, 0.0))
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


def test_door_grab_spring_engages():
    """Review finding: the default parity state starts the hand 0.56 m
    from the handle vs grab_radius 0.12, so the grab-spring path was
    zero-force in every test. Enlarge grab_radius (it rides extras) so
    the gated spring is LIVE for the whole rollout and must match the
    engine, and check it actually moves the door."""
    env = envs.make("sawyer_door-v0")
    params = env.params._replace(grab_radius=jnp.float32(1.0))
    state = env.init(params, jax.random.PRNGKey(0))
    # start the door OPEN: at q=0 the spring just presses the door into
    # its closed joint limit (qlow=0) and provably changes nothing;
    # from 0.3 rad it visibly slams the door shut within 3 steps
    state = state._replace(qpos=state.qpos.at[7].set(0.3))
    mean = jnp.zeros((3, 7))
    noise = 0.2 * jax.random.normal(jax.random.PRNGKey(5), (6, 3, 7))
    costs_k = np.asarray(jax.jit(env.fused_rollout)(
        params, state, mean, noise))
    traj = rollout_open_loop(env, params, state, mean, noise)
    np.testing.assert_allclose(costs_k, np.asarray(traj.costs),
                               rtol=0, atol=2e-4)
    # the spring must actually do something: costs differ from the
    # spring-off (tiny radius) rollout
    off = env.params._replace(grab_radius=jnp.float32(1e-6))
    costs_off = np.asarray(jax.jit(env.fused_rollout)(
        off, state, mean, noise))
    assert np.abs(costs_k - costs_off).max() > 1e-5


def test_tray_glass_fall_penalty_branch_live():
    """Review finding: the fall-penalty branch (slide > tray radius)
    was never live in the parity tests. Start the glass OFF the tray
    edge so the branch fires, check kernel == engine, and that the
    penalty value (extras[3]) actually moves the cost."""
    env = envs.make("panda_tray_glass-v0")
    state = env.init(env.params, jax.random.PRNGKey(0))
    qpos = state.qpos.at[7].set(0.13).at[8].set(0.02)  # slide 0.131 > 0.12
    state = state._replace(qpos=qpos)
    mean = jnp.zeros((3, 7))
    noise = 0.1 * jax.random.normal(jax.random.PRNGKey(6), (6, 3, 7))
    fr = jax.jit(env.fused_rollout)
    costs_k = np.asarray(fr(env.params, state, mean, noise))
    traj = rollout_open_loop(env, env.params, state, mean, noise)
    np.testing.assert_allclose(costs_k, np.asarray(traj.costs),
                               rtol=0, atol=2e-4)
    doubled = env.params._replace(fall_penalty=jnp.float32(10.0))
    costs_2x = np.asarray(fr(doubled, state, mean, noise))
    # every step in the fallen region gains exactly the extra 5.0
    gain = costs_2x - costs_k
    assert gain.max() > 4.9, gain.max()
