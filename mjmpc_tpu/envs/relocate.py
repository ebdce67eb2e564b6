"""relocate-v0: grasp a free ball and carry it to a target in the air.

The reference's relocate-v0 is the mj_envs Adroit task — a 30-DOF
arm+hand picks a ball off a table and moves it to a sampled aerial
target; success when the ball is within 0.10 m of the target
(README.md:33-35, examples/configs/hand/relocate-v0.yml "Relocate object
from one position to another with a 24-DOF Shadow Hand"). Here the arm
is 3 translation DOF carrying the 24-DOF five-digit hand
(`envs/adroit.py`) — 27 actuated DOF — and the ball is a genuine FREE
body (quaternion state) manipulated only through frictional
fingertip/table contact: grasping is contact physics, not the round-1
proximity spring.

One kinematic forest: 3 slides + 24 hinges + 1 free joint => nq = 34,
nv = 33. Reward mirrors mj_envs relocate_v0.py: reach shaping, a lift
bonus once the ball leaves the table, target shaping on both palm and
ball, and staged bonuses inside 0.10 / 0.05 m.
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
_FRAME_SKIP = 5
_BALL_R = 0.035
_N_ARM = 3
_BALL_BODY = _N_ARM + adroit.N_HAND_BODIES   # body index 27
_BALL_Q = _N_ARM + adroit.N_HAND_DOF           # q/v offset 23
_N_ACT = _N_ARM + adroit.N_HAND_DOF            # 23
_N_TIPS = 2 * adroit.N_DIGITS
_PALM_LOCAL = np.asarray(adroit.PALM_LOCAL, np.float32)
_PALM_R = adroit.PALM_R   # small enough that the tips reach the ball
                          # equator before the pad caps the descent

class RelocateParams(NamedTuple):
    model: rb.ChainModel
    kp: jax.Array
    kd: jax.Array
    mu: jax.Array
    ball_r: jax.Array   # ball radius — the geom_size dyn-randomize leaf
                        # (contact only; inertia is baked)


class RelocateState(NamedTuple):
    qpos: jax.Array     # [34] = 3 slides + 24 hinges + ball (pos3, quat4)
    qvel: jax.Array     # [33]
    target: jax.Array   # [3] carry goal
    timestep: jax.Array


# numpy-only body specs — the backend is only touched when make() builds
# the ChainModel (lazy, cached).
_BODIES_SPEC, _DIGITS = adroit.arm_hand_bodies()
_BODIES_SPEC.append(dict(
    pos=(0.0, 0.0, 0.0), type="free", parent=-1,
    damping=0.01, armature=0.0, gear=0.0,
    geoms=[rb.sphere_geom(_BALL_R)]))


@functools.lru_cache(maxsize=1)
def build_model() -> rb.ChainModel:
    return rb.build_chain(_BODIES_SPEC, dt=_DT, site_body=_BALL_BODY,
                          site_pos=(0.0, 0.0, 0.0),
                          gravity=(0.0, 0.0, -9.81))

_C_BODIES = tuple(int(b) for (b, _, _) in _DIGITS for _ in range(2)) \
    + (_BALL_BODY, 2)
_C_POINTS = np.concatenate(
    [np.stack([tip, mid]) for (_, tip, mid) in _DIGITS]
    + [np.zeros((1, 3), np.float32), _PALM_LOCAL[None]])
_C_RADII = np.array([adroit.TIP_R, 0.008] * adroit.N_DIGITS, np.float32)


def _ext_forces(params: RelocateParams):
    model = params.model
    # exact gravity compensation on the arm slides (the z slide carries
    # the whole hand — without it zero action free-falls the hand onto
    # the table; mj_envs' arm actuators are position servos)
    hand_weight = 9.81 * jnp.sum(model.mass[:_BALL_BODY])

    def fn(_, q, qd):
        pos, vel, apply = rb.points_frame(model, q, qd, _C_BODIES,
                                          jnp.asarray(_C_POINTS))
        ball_p, ball_v = pos[_N_TIPS], vel[_N_TIPS]
        forces = []
        # ball on the table plane
        f_ball = contact.sphere_plane_force(ball_p, ball_v, params.ball_r,
                                            params.kp, params.kd, params.mu)
        for k in range(_N_TIPS):
            f_fb = contact.sphere_sphere_force(
                pos[k], vel[k], _C_RADII[k], ball_p, ball_v,
                params.ball_r, params.kp, params.kd, params.mu)
            # ONLY the finger-ball force reacts onto the ball — the
            # table's push on a finger must never be dumped on the free
            # object (a fingertip touching the table half a meter away
            # would otherwise slam the ball down).
            f_ball = f_ball - f_fb
            forces.append(f_fb + contact.sphere_plane_force(
                pos[k], vel[k], _C_RADII[k], params.kp, params.kd,
                params.mu))
        # palm pad vs ball (push/top support) and vs table
        f_palm = contact.sphere_sphere_force(
            pos[_N_TIPS + 1], vel[_N_TIPS + 1], _PALM_R, ball_p,
            ball_v, params.ball_r, params.kp, params.kd, params.mu)
        f_ball = f_ball - f_palm
        f_palm = f_palm + contact.sphere_plane_force(
            pos[_N_TIPS + 1], vel[_N_TIPS + 1], _PALM_R, params.kp,
            params.kd, params.mu)
        forces += [f_ball, f_palm]
        tau = apply(jnp.stack(forces))
        return tau.at[2].add(hand_weight)

    return fn


def _palm_and_ball(params: RelocateParams, qpos: jax.Array):
    rots, poss = rb.forward_kinematics(params.model, qpos)
    palm = poss[2] + rots[2] @ jnp.asarray(_PALM_LOCAL)
    return palm, qpos[_BALL_Q:_BALL_Q + 3]


def _init(params: RelocateParams, key: jax.Array) -> RelocateState:
    kb, kt = jax.random.split(key)
    qpos = jnp.asarray(params.model.neutral_qpos())
    # hand starts raised; ball on the table at a randomized xy
    qpos = qpos.at[2].set(0.18)
    ball_xy = jax.random.uniform(kb, (2,), jnp.float32, -0.10, 0.10)
    qpos = qpos.at[_BALL_Q:_BALL_Q + 2].set(ball_xy)
    qpos = qpos.at[_BALL_Q + 2].set(_BALL_R)
    target = jax.random.uniform(kt, (3,), jnp.float32,
                                jnp.array([-0.15, -0.15, 0.18]),
                                jnp.array([0.15, 0.15, 0.32]))
    return RelocateState(qpos=qpos, qvel=jnp.zeros(params.model.nv),
                         target=target, timestep=jnp.array(0, jnp.int32))


def _observe(params: RelocateParams, state: RelocateState) -> jax.Array:
    palm, ball = _palm_and_ball(params, state.qpos)
    return jnp.concatenate([
        state.qpos[:_N_ACT], state.qvel[:_N_ACT],
        ball, state.qvel[_BALL_Q:_BALL_Q + 3],
        palm - ball, ball - state.target, palm - state.target])
    # 69-dim: 27 qpos + 27 qvel + 15 object/target features


def _step(params: RelocateParams, state: RelocateState, action: jax.Array):
    ctrl = jnp.concatenate([jnp.clip(action, -1.0, 1.0),
                            jnp.zeros(6, action.dtype)])
    qpos, qvel = rb.step(params.model, state.qpos, state.qvel, ctrl,
                         n_substeps=_FRAME_SKIP,
                         ext_force_fn=_ext_forces(params))
    new = state._replace(qpos=qpos, qvel=qvel, timestep=state.timestep + 1)
    palm, ball = _palm_and_ball(params, qpos)
    reach = jnp.linalg.norm(palm - ball)
    carry = jnp.linalg.norm(ball - state.target)
    lifted = ball[2] > 0.04
    # mj_envs relocate_v0.py reward: reach shaping; once lifted, a bonus
    # plus target shaping on both palm and ball; staged target bonuses.
    reward = (-0.1 * reach
              + jnp.where(lifted,
                          1.0 - 0.5 * jnp.linalg.norm(palm - state.target)
                          - 0.5 * carry, 0.0)
              + jnp.where(carry < 0.10, 10.0, 0.0)
              + jnp.where(carry < 0.05, 20.0, 0.0))
    return new, _observe(params, new), reward, jnp.array(False)


def _success(params: RelocateParams, state: RelocateState) -> jax.Array:
    _, ball = _palm_and_ball(params, state.qpos)
    return jnp.linalg.norm(ball - state.target) < 0.10


def _build_fused_rollout(model: rb.ChainModel):
    """Fused Pallas rollout for relocate-v0 (ops/pallas_forest.py): the
    N-particle H-step contact rollout — arm slides + five digit trees,
    the free ball, the finger/palm/table contact assembly of
    `_ext_forces` (incl. the arm gravity compensation via
    joint_torque_fn), and the relocate cost — in ONE kernel. kp/kd/mu,
    the ball radius, and the carry target ride the extras vector, so
    geom_friction/geom_size dynamics randomization keeps the fast path;
    only rigid-body model constants are baked."""
    from ..ops import pallas_forest as pf

    points = [(int(b), np.asarray(p, np.float32))
              for (b, _, _), p in zip(
                  [d for d in _DIGITS for _ in range(2)],
                  _C_POINTS[:_N_TIPS])]
    points += [(_BALL_BODY, np.zeros(3, np.float32)),
               (2, _PALM_LOCAL)]
    hand_weight = float(9.81 * np.sum(np.asarray(model.mass)[:_BALL_BODY]))

    def force_fn(states, extras, rots, poss):
        kp, kd, mu, ball_r = extras[3], extras[4], extras[5], extras[6]
        (ball_p, ball_v) = states[_N_TIPS]
        (palm_p, palm_v) = states[_N_TIPS + 1]
        f_ball = pf.sphere_plane_force(ball_p, ball_v, ball_r, kp, kd, mu)
        forces = []
        for k in range(_N_TIPS):
            p, v = states[k]
            f_fb = pf.sphere_sphere_force(p, v, float(_C_RADII[k]),
                                          ball_p, ball_v, ball_r,
                                          kp, kd, mu)
            f_ball = pf._vsub(f_ball, f_fb)
            forces.append(pf._vadd(f_fb, pf.sphere_plane_force(
                p, v, float(_C_RADII[k]), kp, kd, mu)))
        f_palm = pf.sphere_sphere_force(palm_p, palm_v, _PALM_R,
                                        ball_p, ball_v, ball_r,
                                        kp, kd, mu)
        f_ball = pf._vsub(f_ball, f_palm)
        f_palm = pf._vadd(f_palm, pf.sphere_plane_force(
            palm_p, palm_v, _PALM_R, kp, kd, mu))
        forces += [f_ball, f_palm]
        return forces

    force_fn.points = points
    palm_local = [np.float32(v) for v in _PALM_LOCAL]

    def torque_fn(q, qd, extras, fk):
        return {2: np.float32(hand_weight)}

    def cost_fn(q, qd, rots, poss, extras):
        target = extras[:3]
        palm = pf._vadd(poss[2], pf._mv(rots[2], palm_local))
        ball = poss[_BALL_BODY]
        reach = pf._vnorm(pf._vsub(palm, ball))
        carry = pf._vnorm(pf._vsub(ball, target))
        palm_t = pf._vnorm(pf._vsub(palm, target))
        lifted = ball[2] > np.float32(0.04)
        reward = (np.float32(-0.1) * reach
                  + jnp.where(lifted,
                              np.float32(1.0) - np.float32(0.5) * palm_t
                              - np.float32(0.5) * carry, np.float32(0.0))
                  + jnp.where(carry < 0.10, np.float32(10.0), 0.0)
                  + jnp.where(carry < 0.05, np.float32(20.0), 0.0))
        return -reward

    roll = pf.build_forest_rollout(
        model, n_substeps=_FRAME_SKIP, act_bodies=list(range(_N_ACT)),
        force_fn=force_fn, cost_fn=cost_fn, n_extras=7,
        joint_torque_fn=torque_fn)

    def fused(params: RelocateParams, state: RelocateState, mean, noise):
        extras = jnp.concatenate([
            state.target,
            jnp.stack([params.kp, params.kd, params.mu, params.ball_r])])
        return roll(state.qpos, state.qvel, extras, mean, noise)

    fused.substep_parts = roll.substep_parts   # FLOP accounting
    # (harness.forest_perf traces the substep outside pallas)
    fused.dynamic_fields = ("kp", "kd", "mu", "ball_r")   # read at call
    # time via extras — dyn-randomizing only these keeps the fast path
    return fused


def make() -> Env:
    model = build_model()
    params = RelocateParams(model=model, kp=jnp.float32(800.0),
                            kd=jnp.float32(2.0), mu=jnp.float32(1.2),
                            ball_r=jnp.float32(_BALL_R))
    return Env(name="relocate-v0", d_obs=2 * _N_ACT + 15, d_action=_N_ACT,
               action_lows=np.full(_N_ACT, -1.0, np.float32),
               action_highs=np.full(_N_ACT, 1.0, np.float32),
               params=params, init=_init, step=_step, observe=_observe,
               success=_success, max_episode_steps=200,
               fused_rollout=_build_fused_rollout(model))


from .randomize import (register_names as _register_names,  # noqa: E402
                        register_param_paths as _register_param_paths)

_register_names(
    "relocate-v0",
    ["arm_x", "arm_y", "arm_z"] + adroit.hand_joint_names() + ["Object"],
    extra={"sphere": _BALL_BODY})
# contact-model leaves for the geom fields (reference
# gym_env_wrapper.py:392-400; 'sphere' is the mj_envs ball geom name)
_register_param_paths("relocate-v0", {"geom_friction": {"sphere": "mu"},
                                      "geom_size": {"sphere": "ball_r"}})
