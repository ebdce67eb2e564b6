"""pen-v0: in-hand pen reorientation with the 24-DOF dexterous hand.

The reference's pen-v0 is the mj_envs Adroit task: a free 6-DOF pen held
by a multi-DOF hand, reward = orientation similarity between the pen's
long axis and a sampled target axis plus a position term, success when
the similarity exceeds 0.90 (README.md:33-35,
examples/configs/hand/pen-v0.yml "In-hand manipulation of a 6-DOF pen
with a 24-DOF Shadow Hand"). Here the hand is the 24-DOF five-digit
Adroit counterpart (`envs/adroit.py`: 2-DOF wrist, three 4-DOF
fingers, 5-DOF little finger, 5-DOF thumb — the Shadow Hand's exact
DOF allocation) and the pen is a genuine FREE body — 7 qpos (position
+ unit quaternion), 6 qvel — manipulated only through frictional
fingertip/palm contact: actions actuate hand joints exclusively. The
desired-orientation envelope is the FULL mj_envs range, ±1 rad on both
yaw and pitch: the pen rests on a raised cradle ridge (center z =
0.072) high enough that a ±1 rad pitch keeps both ends above the palm
plane, and the deeper 3-phalanx digits reach the steeply-pitched ends.

One kinematic forest, one jitted program: 24 hinge DOF (hand) + 1 free
joint (pen) => nq = 31, nv = 30; contact is 10 finger spheres vs the
pen capsule, the palm plane, and the static cradle ridge the pen
see-saws on (pitch authority), all through one batched `points_frame`
pass per substep.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..engine import chain as rb
from . import adroit, contact
from .base import Env

_DT = 0.002
_FRAME_SKIP = 5          # control dt 10 ms, mj_envs Adroit semantics
_PEN_R = 0.012
_PEN_HL = 0.065          # half-length
_PEN_BODY = adroit.N_HAND_BODIES         # body index 24
_PEN_Q = adroit.N_HAND_DOF               # qpos offset 20, qvel offset 20

# Static palm cradle: a ridge capsule across y at x=0 — the pen see-saws
# on it, so pressing one end down (the closing-curl direction of the
# digit tips) pitches the pen, and below-center pinches squeeze-lift it.
# Without it the pen lies flat on the palm and pitch authority vanishes.
# The ridge is RAISED (z = 0.048, rest center 0.072) so the full mj_envs
# ±1 rad pitch envelope is geometrically reachable: at pitch 1 rad the
# low end sits at z = 0.072 - 0.065*sin(1) = 0.017 > pen radius above
# nothing — still clear of the palm plane.
_RIDGE_R = 0.012
_RIDGE_A = np.array([0.0, -0.12, 0.048], np.float32)
_RIDGE_B = np.array([0.0, 0.12, 0.048], np.float32)
_REST_Z = 0.048 + _RIDGE_R + _PEN_R      # pen center at rest: 0.072
_DESIRED_POS = np.array([0.0, 0.0, _REST_Z], np.float32)


class PenParams(NamedTuple):
    model: rb.ChainModel
    kp: jax.Array
    kd: jax.Array
    mu: jax.Array
    pen_r: jax.Array    # pen capsule radius — the geom_size dyn-
                        # randomize leaf (contact only; inertia is baked)


class PenState(NamedTuple):
    qpos: jax.Array      # [31] = 24 hand hinges + pen (pos3, quat4)
    qvel: jax.Array      # [30]
    desired: jax.Array   # [3] unit target axis for the pen's long axis
    timestep: jax.Array


# Body specs and contact metadata are numpy/python only — importing this
# module never touches the JAX backend; build_chain runs lazily in make()
# (callers can still pin the platform first, per CLAUDE.md).
_BODIES_SPEC, _DIGITS = adroit.hand_bodies()
_BODIES_SPEC.append(dict(
    pos=(0.0, 0.0, 0.0), type="free", parent=-1,
    damping=0.005, armature=0.0, gear=0.0,
    geoms=[rb.capsule_geom(_PEN_R, (-_PEN_HL, 0, 0, _PEN_HL, 0, 0))]))


@functools.lru_cache(maxsize=1)
def build_model() -> rb.ChainModel:
    """The hand + free-pen ChainModel (cached; first call builds)."""
    return rb.build_chain(_BODIES_SPEC, dt=_DT, site_body=_PEN_BODY,
                          site_pos=(0.0, 0.0, 0.0),
                          gravity=(0.0, 0.0, -9.81))

# Contact batch: (tip, mid) per digit on the distal bodies, then the two
# pen capsule endpoints.
_C_BODIES = tuple(int(b) for (b, _, _) in _DIGITS for _ in range(2)) \
    + (_PEN_BODY, _PEN_BODY)
_C_POINTS = np.concatenate(
    [np.stack([tip, mid]) for (_, tip, mid) in _DIGITS]
    + [np.array([[-_PEN_HL, 0, 0], [_PEN_HL, 0, 0]], np.float32)])
_C_RADII = np.array([adroit.TIP_R, 0.008] * adroit.N_DIGITS, np.float32)


def _ext_forces(params: PenParams):
    model = params.model

    def fn(_, q, qd):
        pos, vel, apply = rb.points_frame(model, q, qd, _C_BODIES,
                                          jnp.asarray(_C_POINTS))
        n_tips = 2 * adroit.N_DIGITS
        cap_a, cap_b = pos[n_tips], pos[n_tips + 1]
        vcap_a, vcap_b = vel[n_tips], vel[n_tips + 1]
        forces = []
        f_cap_a = contact.sphere_plane_force(cap_a, vcap_a, params.pen_r,
                                             params.kp, params.kd, params.mu)
        f_cap_b = contact.sphere_plane_force(cap_b, vcap_b, params.pen_r,
                                             params.kp, params.kd, params.mu)
        # pen on the static cradle ridge
        f_ridge, sr = contact.capsule_capsule_force(
            cap_a, cap_b, vcap_a, vcap_b, params.pen_r,
            jnp.asarray(_RIDGE_A), jnp.asarray(_RIDGE_B), _RIDGE_R,
            params.kp, params.kd, params.mu)
        f_cap_a = f_cap_a + (1.0 - sr) * f_ridge
        f_cap_b = f_cap_b + sr * f_ridge
        for k in range(2 * adroit.N_DIGITS):
            f_pen, t = contact.sphere_segment_force(
                pos[k], vel[k], _C_RADII[k], cap_a, cap_b, vcap_a, vcap_b,
                params.pen_r, params.kp, params.kd, params.mu)
            # ONLY the finger-pen force reacts onto the pen; the palm
            # plane's push on the finger must not (the ground's reaction
            # belongs to the ground, not the free object).
            f_cap_a = f_cap_a - (1.0 - t) * f_pen
            f_cap_b = f_cap_b - t * f_pen
            # palm keeps fingers from punching through z = 0
            forces.append(f_pen + contact.sphere_plane_force(
                pos[k], vel[k], _C_RADII[k], params.kp, params.kd,
                params.mu))
        forces += [f_cap_a, f_cap_b]
        return apply(jnp.stack(forces))

    return fn


def _pen_frame(state: PenState):
    """(pen center, long axis, linear vel, body angular vel)."""
    q = state.qpos
    pen_pos = q[_PEN_Q:_PEN_Q + 3]
    quat = q[_PEN_Q + 3:_PEN_Q + 7]
    axis = rb._quat_to_mat(quat)[:, 0]
    return pen_pos, axis, state.qvel[_PEN_Q:_PEN_Q + 3], \
        state.qvel[_PEN_Q + 3:_PEN_Q + 6]


def _sample_desired(key) -> jax.Array:
    """Target long axis: yaw U(-1, 1) rad, pitch U(-1, 1) rad tilts of
    e_x — the FULL mj_envs pen_v0 desired-orientation envelope (the
    round-2 ±0.45 pitch narrowing is gone: the raised cradle plus the
    deeper five-digit hand reach the whole range)."""
    a = jax.random.uniform(key, (), jnp.float32, -1.0, 1.0)
    b = jax.random.uniform(jax.random.fold_in(key, 1), (), jnp.float32,
                           -1.0, 1.0)
    return jnp.stack([jnp.cos(a) * jnp.cos(b), jnp.sin(a) * jnp.cos(b),
                      -jnp.sin(b)])


def _init(params: PenParams, key: jax.Array) -> PenState:
    kd, _ = jax.random.split(key)
    qpos = jnp.asarray(params.model.neutral_qpos())
    qpos = qpos.at[_PEN_Q + 2].set(_REST_Z)  # balanced on the cradle
    return PenState(qpos=qpos, qvel=jnp.zeros(params.model.nv),
                    desired=_sample_desired(kd),
                    timestep=jnp.array(0, jnp.int32))


def _observe(params: PenParams, state: PenState) -> jax.Array:
    pen_pos, axis, lin_vel, ang_vel = _pen_frame(state)
    return jnp.concatenate([
        state.qpos[:adroit.N_HAND_DOF], state.qvel[:adroit.N_HAND_DOF],
        pen_pos, lin_vel, axis, ang_vel, state.desired,
        axis - state.desired, pen_pos - jnp.asarray(_DESIRED_POS)])
    # 69-dim: 24 qpos + 24 qvel + 21 object/target features (the mj_envs
    # pen obs is 45 with the 24-DOF hand emitting qpos only)


def _step(params: PenParams, state: PenState, action: jax.Array):
    ctrl = jnp.concatenate([jnp.clip(action, -1.0, 1.0),
                            jnp.zeros(6, action.dtype)])
    qpos, qvel = rb.step(params.model, state.qpos, state.qvel, ctrl,
                         n_substeps=_FRAME_SKIP,
                         ext_force_fn=_ext_forces(params))
    new = state._replace(qpos=qpos, qvel=qvel, timestep=state.timestep + 1)
    pen_pos, axis, _, _ = _pen_frame(new)
    pos_err = jnp.linalg.norm(pen_pos - jnp.asarray(_DESIRED_POS))
    orien = axis @ state.desired
    close = pos_err < 0.075
    # mj_envs pen reward shape: dense position + similarity terms, staged
    # bonuses at 0.90/0.95 similarity, drop penalty when the pen leaves
    # the hand region.
    dropped = jnp.linalg.norm(pen_pos[:2]) > 0.15
    reward = (-pos_err + orien
              + jnp.where(close & (orien > 0.90), 10.0, 0.0)
              + jnp.where(close & (orien > 0.95), 50.0, 0.0)
              - jnp.where(dropped, 5.0, 0.0))
    return new, _observe(params, new), reward, jnp.array(False)


def _success(params: PenParams, state: PenState) -> jax.Array:
    pen_pos, axis, _, _ = _pen_frame(state)
    close = jnp.linalg.norm(pen_pos - jnp.asarray(_DESIRED_POS)) < 0.075
    return (axis @ state.desired > 0.90) & close


def _build_fused_rollout(model: rb.ChainModel):
    """Fused Pallas rollout for pen-v0 (ops/pallas_forest.py): the whole
    N-particle H-step contact rollout — the wrist-rooted 24-DOF hand tree,
    the free quaternion pen, the 14-pair contact assembly of `_ext_forces`, and
    the pen cost — in ONE kernel. The XLA path sends every per-particle
    FK/contact intermediate through device memory; the kernel keeps all
    of it in registers. kp/kd/mu AND the pen radius ride
    the extras vector, so contact-gain sweeps and the reference's
    geom_friction/geom_size dynamics randomization
    (gym_env_wrapper.py:392-400) keep the fast path; only rigid-body
    model constants (masses, inertias, link geometry) are baked."""
    from ..ops import pallas_forest as pf

    n_tips = 2 * adroit.N_DIGITS
    points = [(int(b), np.asarray(p, np.float32))
              for (b, _, _), p in zip(
                  [d for d in _DIGITS for _ in range(2)],
                  _C_POINTS[:n_tips])]
    points += [(_PEN_BODY, np.array([-_PEN_HL, 0, 0], np.float32)),
               (_PEN_BODY, np.array([_PEN_HL, 0, 0], np.float32))]

    ridge_a = [np.float32(v) for v in _RIDGE_A]
    ridge_b = [np.float32(v) for v in _RIDGE_B]

    def force_fn(states, extras, rots, poss):
        kp, kd, mu, pen_r = extras[3], extras[4], extras[5], extras[6]
        (cap_a, vcap_a), (cap_b, vcap_b) = states[n_tips], states[n_tips + 1]
        f_cap_a = pf.sphere_plane_force(cap_a, vcap_a, pen_r, kp, kd, mu)
        f_cap_b = pf.sphere_plane_force(cap_b, vcap_b, pen_r, kp, kd, mu)
        f_ridge, sr = pf.capsule_capsule_force(
            cap_a, cap_b, vcap_a, vcap_b, pen_r,
            ridge_a, ridge_b, _RIDGE_R, kp, kd, mu)
        f_cap_a = pf._vadd(f_cap_a, pf._vscale(1.0 - sr, f_ridge))
        f_cap_b = pf._vadd(f_cap_b, pf._vscale(sr, f_ridge))
        forces = []
        for k in range(n_tips):
            p, v = states[k]
            f_pen, t = pf.sphere_segment_force(
                p, v, float(_C_RADII[k]), cap_a, cap_b, vcap_a, vcap_b,
                pen_r, kp, kd, mu)
            f_cap_a = pf._vsub(f_cap_a, pf._vscale(1.0 - t, f_pen))
            f_cap_b = pf._vsub(f_cap_b, pf._vscale(t, f_pen))
            forces.append(pf._vadd(f_pen, pf.sphere_plane_force(
                p, v, float(_C_RADII[k]), kp, kd, mu)))
        forces += [f_cap_a, f_cap_b]
        return forces

    force_fn.points = points
    desired_pos = [np.float32(v) for v in _DESIRED_POS]

    def cost_fn(q, qd, rots, poss, extras):
        desired = extras[:3]
        r = rots[_PEN_BODY]
        axis = [r[0], r[3], r[6]]
        diff = pf._vsub(poss[_PEN_BODY], desired_pos)
        pos_err = pf._vnorm(diff)
        orien = pf._vdot(axis, desired)
        close = pos_err < np.float32(0.075)
        pp = poss[_PEN_BODY]
        dropped = jnp.sqrt(pp[0] * pp[0] + pp[1] * pp[1]) > np.float32(0.15)
        reward = (-pos_err + orien
                  + jnp.where(close & (orien > 0.90), np.float32(10.0), 0.0)
                  + jnp.where(close & (orien > 0.95), np.float32(50.0), 0.0)
                  - jnp.where(dropped, np.float32(5.0), 0.0))
        return -reward

    roll = pf.build_forest_rollout(
        model, n_substeps=_FRAME_SKIP,
        act_bodies=list(range(adroit.N_HAND_DOF)),
        force_fn=force_fn, cost_fn=cost_fn, n_extras=7)

    def fused(params: PenParams, state: PenState, mean, noise):
        extras = jnp.concatenate([
            state.desired,
            jnp.stack([params.kp, params.kd, params.mu, params.pen_r])])
        return roll(state.qpos, state.qvel, extras, mean, noise)

    fused.substep_parts = roll.substep_parts   # FLOP accounting
    # (harness.forest_perf traces the substep outside pallas)
    fused.dynamic_fields = ("kp", "kd", "mu", "pen_r")   # param leaves the
    # kernel reads at CALL time (via extras) — dyn-randomizing only these
    # keeps the fused fast path (harness/episode.py:_fused_mode)
    return fused


def make() -> Env:
    # kp/kd sized for the light distal links at dt=0.002: the explicit
    # contact damper must keep kd·dt/m_eff « 2 (kd=12 diverges; kd=2 is
    # stable with bounded chatter — see tests/test_hand_suite.py).
    model = build_model()
    params = PenParams(model=model, kp=jnp.float32(800.0),
                       kd=jnp.float32(2.0), mu=jnp.float32(1.2),
                       pen_r=jnp.float32(_PEN_R))
    n = adroit.N_HAND_DOF
    return Env(name="pen-v0", d_obs=2 * n + 21, d_action=n,
               action_lows=np.full(n, -1.0, np.float32),
               action_highs=np.full(n, 1.0, np.float32),
               params=params, init=_init, step=_step, observe=_observe,
               success=_success, max_episode_steps=75,
               fused_rollout=_build_fused_rollout(model))


from .randomize import (register_names as _register_names,  # noqa: E402
                        register_param_paths as _register_param_paths)

_register_names("pen-v0", adroit.hand_joint_names() + ["Object"],
                # reference dyn-randomize names (dyn_randomize_configs/
                # hand/pen-v0.yml): Object = the pen body, pen = its geom
                extra={"pen": _PEN_BODY})
# geom_friction/geom_size perturb the contact model's OWN leaves (the
# reference perturbs mj geom_friction/geom_size rows,
# gym_env_wrapper.py:392-400); both ride the fused kernel's extras
# vector, so randomized planning stays on the fast path.
_register_param_paths("pen-v0", {"geom_friction": {"pen": "mu"},
                                 "geom_size": {"pen": "pen_r"}})
