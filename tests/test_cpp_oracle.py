"""C++ CPU oracle vs the JAX compute path: independent double-precision
serial implementations of the rollout/noise/cost math must agree with the
vectorized JAX-path code to float32 tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mjmpc_tpu import envs, ops, solvers
from mjmpc_tpu.oracle import cpp_oracle
from mjmpc_tpu.rollout.engine import rollout_open_loop


@pytest.fixture(scope="module", autouse=True)
def _build():
    cpp_oracle._load()


def test_ar_filter_parity(rng):
    eps = rng.randn(16, 12, 3).astype(np.float32)
    coeffs = (0.25, 0.8, 0.1)
    ours = np.asarray(ops.ar_filter(jnp.asarray(eps), coeffs))
    oracle = cpp_oracle.ar_filter(eps, coeffs)
    np.testing.assert_allclose(ours, oracle, rtol=1e-5, atol=1e-6)


def test_cost_to_go_parity(rng):
    costs = rng.rand(32, 20).astype(np.float32)
    for gamma in (0.0, 0.9, 1.0):
        gseq = ops.gamma_sequence(gamma, 20)
        ours = np.asarray(ops.cost_to_go(jnp.asarray(costs), gseq))
        oracle = cpp_oracle.cost_to_go(costs, gseq)
        np.testing.assert_allclose(ours, oracle, rtol=2e-4, atol=1e-4)


def test_pendulum_rollout_parity(rng):
    env = envs.make("SimplePendulum-v0")
    state = env.init(env.params, jax.random.PRNGKey(0))
    mean = 0.4 * rng.randn(16, 1).astype(np.float32)
    noise = rng.randn(32, 16, 1).astype(np.float32)
    traj = rollout_open_loop(env, env.params, state,
                             jnp.asarray(mean), jnp.asarray(noise))
    oracle = cpp_oracle.pendulum_rollout(
        env.params, float(state.th), float(state.thdot), mean, noise)
    np.testing.assert_allclose(np.asarray(traj.costs), oracle,
                               rtol=1e-3, atol=1e-3)


def test_lqr_rollout_parity(rng):
    env = envs.make("LQR-v0")
    p = env.params
    state = env.init(p, jax.random.PRNGKey(0))
    dx, du = np.asarray(p.A).shape[0], np.asarray(p.B).shape[1]
    mean = 0.2 * rng.randn(10, du).astype(np.float32)
    noise = 0.1 * rng.randn(8, 10, du).astype(np.float32)
    traj = rollout_open_loop(env, p, state, jnp.asarray(mean),
                             jnp.asarray(noise))
    oracle = cpp_oracle.lqr_rollout(
        np.asarray(p.A), np.asarray(p.B),
        np.diag(np.asarray(p.Q)), np.diag(np.asarray(p.R)),
        np.asarray(state.x), mean, noise)
    np.testing.assert_allclose(np.asarray(traj.costs), oracle,
                               rtol=1e-4, atol=1e-4)


def test_mppi_update_end_to_end_parity(rng):
    """Full MPPI mean update on identical injected rollouts: the JAX-path
    solver vs the serial C++ implementation (BASELINE 'control-sequence
    deviation within tolerance' check, CPU leg)."""
    env = envs.make("SimplePendulum-v0")
    h, n = 12, 64
    solver = solvers.MPPI(d_action=1, horizon=h, num_particles=n,
                          lam=0.05, step_size=0.7, gamma=0.99,
                          alpha=1, init_cov=1.0)
    key = jax.random.PRNGKey(0)
    s0 = solver.init_state(key)
    mean0 = 0.1 * rng.randn(h, 1).astype(np.float32)
    s0 = s0._replace(mean=jnp.asarray(mean0))

    state = env.init(env.params, jax.random.PRNGKey(1))
    noise = solver.sample_noise(s0)
    traj = rollout_open_loop(env, env.params, state, s0.mean, noise)
    s1 = solver.update(s0, traj)

    oracle_mean = cpp_oracle.mppi_update(
        mean0, np.asarray(traj.actions), np.asarray(traj.costs),
        gamma=0.99, lam=0.05, step_size=0.7)
    np.testing.assert_allclose(np.asarray(s1.mean), oracle_mean,
                               rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# Chain-engine cross-check (VERDICT r1 item 7): the serial f64 RNEA /
# Jacobian-composition oracle vs the AD tangent-Lagrangian engine, on the
# actual 7-DOF arm model and a branched gravity chain.
# ---------------------------------------------------------------------------
from mjmpc_tpu.engine import chain as rb


def _arm_model():
    from mjmpc_tpu.envs import reacher_7dof
    return reacher_7dof.make().params.model


def test_chain_mass_matrix_vs_oracle_7dof(rng):
    model = _arm_model()
    for _ in range(5):
        q = jnp.asarray(rng.uniform(-1.2, 1.2, model.nv).astype(np.float32))
        ours = np.asarray(rb.mass_matrix(model, q))
        oracle = cpp_oracle.chain_mass_matrix(model, q)
        np.testing.assert_allclose(ours, oracle, rtol=2e-4, atol=1e-5)


def test_chain_bias_vs_oracle_7dof(rng):
    """AD Lagrangian bias == classic RNEA (different algorithms)."""
    model = _arm_model()
    for _ in range(5):
        q = jnp.asarray(rng.uniform(-1.2, 1.2, model.nv).astype(np.float32))
        qd = jnp.asarray(rng.uniform(-2, 2, model.nv).astype(np.float32))
        ours = np.asarray(rb.bias_forces(model, q, qd))
        oracle = cpp_oracle.chain_bias(model, q, qd)
        np.testing.assert_allclose(ours, oracle, rtol=2e-3, atol=2e-4)


def test_chain_bias_vs_oracle_with_gravity(rng):
    """Branched chain under gravity with slide joints: bias includes the
    gravity generalized force."""
    bodies = [
        dict(pos=(0, 0, 0), axis=(1, 0, 0), type="slide", range=(-2, 2),
             damping=0.1, geoms=[rb.capsule_geom(0.03, (0, 0, 0, 0.2, 0, 0))]),
        dict(pos=(0.2, 0, 0), axis=(0, 1, 0), range=(-3, 3), damping=0.1,
             geoms=[rb.capsule_geom(0.03, (0, 0, 0, 0.25, 0, 0))]),
        dict(pos=(0.25, 0, 0), axis=(0, 0, 1), range=(-3, 3), damping=0.1,
             parent=1, geoms=[rb.capsule_geom(0.02, (0, 0, 0, 0.2, 0, 0))]),
        dict(pos=(0.1, 0, 0), axis=(1, 0, 0), range=(-3, 3), damping=0.1,
             parent=1, geoms=[rb.capsule_geom(0.02, (0, 0, 0, 0.15, 0, 0))]),
    ]
    model = rb.build_chain(bodies, dt=0.002, site_body=2,
                           site_pos=(0.2, 0, 0), gravity=(0, 0, -9.81))
    for _ in range(5):
        q = jnp.asarray(rng.uniform(-1, 1, 4).astype(np.float32))
        qd = jnp.asarray(rng.uniform(-2, 2, 4).astype(np.float32))
        ours = np.asarray(rb.bias_forces(model, q, qd))
        oracle = cpp_oracle.chain_bias(model, q, qd)
        np.testing.assert_allclose(ours, oracle, rtol=2e-3, atol=2e-4)


def test_chain_step_trajectory_vs_oracle(rng):
    """Multi-step (q, qd) trajectories and site positions match the f64
    serial integrator to f32 tolerance on the 7-DOF arm."""
    model = _arm_model()
    q = jnp.asarray(rng.uniform(-0.5, 0.5, model.nv).astype(np.float32))
    qd = jnp.asarray(rng.uniform(-0.5, 0.5, model.nv).astype(np.float32))
    ctrl = jnp.asarray(rng.uniform(-0.4, 0.4, model.nv).astype(np.float32))
    qo, qdo = np.asarray(q, np.float64), np.asarray(qd, np.float64)
    step = jax.jit(lambda q, qd: rb.step(model, q, qd, ctrl, n_substeps=1))
    for t in range(40):
        q, qd = step(q, qd)
        qo, qdo = cpp_oracle.chain_step(model, qo, qdo, ctrl)
    np.testing.assert_allclose(np.asarray(q), qo, rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(np.asarray(qd), qdo, rtol=5e-3, atol=2e-3)
    site_j = np.asarray(rb.site_position(model, q))
    site_o = cpp_oracle.chain_site(model, qo)
    np.testing.assert_allclose(site_j, site_o, rtol=1e-3, atol=1e-4)


def test_chain_bias_vs_oracle_quaternion_tree(rng):
    """Floating-base RNEA vs the tangent-Lagrangian AD on the ACTUAL
    hand+free-pen model (12 hinges + free joint, gravity): the hardest
    mixed-layout case the engine runs in production."""
    from mjmpc_tpu.envs import pen as pen_env
    model = pen_env.build_model()
    q0 = np.asarray(model.neutral_qpos(), np.float64)
    for trial in range(4):
        q = q0.copy()
        q[:12] += rng.uniform(-0.6, 0.6, 12)
        q[12:15] += rng.uniform(-0.05, 0.05, 3)
        quat = rng.randn(4)
        q[15:19] = quat / np.linalg.norm(quat)
        qd = rng.uniform(-1.5, 1.5, model.nv)
        qj = jnp.asarray(q, jnp.float32)
        qdj = jnp.asarray(qd, jnp.float32)
        ours_b = np.asarray(rb.bias_forces(model, qj, qdj))
        oracle_b = cpp_oracle.chain_bias(model, q, qd)
        np.testing.assert_allclose(ours_b, oracle_b, rtol=3e-3, atol=3e-4)
        ours_m = np.asarray(rb.mass_matrix(model, qj))
        oracle_m = cpp_oracle.chain_mass_matrix(model, q)
        np.testing.assert_allclose(ours_m, oracle_m, rtol=3e-4, atol=2e-6)


def test_chain_step_trajectory_vs_oracle_free_body(rng):
    """Multi-step trajectories of a tumbling free body under gravity
    match the serial f64 integrator (quaternion retraction included)."""
    bodies = [dict(pos=(0, 0, 0), type="free", damping=0.01, armature=0.0,
                   gear=1.0, geoms=[rb.box_geom((0.03, 0.06, 0.09))])]
    model = rb.build_chain(bodies, dt=1e-3, site_body=0,
                           site_pos=(0, 0, 0), gravity=(0, 0, -9.81))
    q = np.asarray(model.neutral_qpos(), np.float64)
    qd = np.concatenate([rng.uniform(-0.5, 0.5, 3),
                         rng.uniform(-4, 4, 3)])
    ctrl = np.zeros(6)
    qj = jnp.asarray(q, jnp.float32)
    qdj = jnp.asarray(qd, jnp.float32)
    step = jax.jit(lambda q, qd: rb.step(model, q, qd,
                                         jnp.asarray(ctrl, jnp.float32)))
    qo, qdo = q.copy(), qd.copy()
    for _ in range(50):
        qj, qdj = step(qj, qdj)
        qo, qdo = cpp_oracle.chain_step(model, qo, qdo, ctrl)
    np.testing.assert_allclose(np.asarray(qj), qo, rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(np.asarray(qdj), qdo, rtol=5e-3, atol=3e-3)
