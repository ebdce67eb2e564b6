"""hammer-v0: pick up a free hammer and drive a nail with it.

The reference's hammer-v0 is the mj_envs Adroit task — the hand grabs a
hammer from the table and hammers a nail into a board; success when the
nail is driven nearly flush (README.md:33-35,
examples/configs/hand/hammer-v0.yml "Hammering a nail with a 24-DOF
Shadow Hand"). Here the 3-slide arm + 24-DOF five-digit hand
(`envs/adroit.py`, as in relocate-v0) manipulates a FREE hammer body
(quaternion state, weighted head) purely through frictional contact, and
the nail is a 1-DOF slide with heavy damping plus a dry-friction
resistance — it only advances under real impact/press force from the
hammer head, never from the reward.

nq = 3 + 24 + 7 + 1 = 35, nv = 34. Reward mirrors mj_envs hammer_v0.py:
palm-to-hammer reach shaping, hammer-head-to-nail shaping, staged
bonuses at half / full drive depth; success = nail driven > 95% of its
travel.
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
_N_ARM = 3
_HAMMER_BODY = _N_ARM + adroit.N_HAND_BODIES  # body index 27
_NAIL_BODY = _HAMMER_BODY + 1                  # 28
_HAMMER_Q = _N_ARM + adroit.N_HAND_DOF         # qpos 27..33, qvel 27..32
_NAIL_Q = _HAMMER_Q + 7                        # qpos 34 (last)
_NAIL_V = _HAMMER_Q + 6                        # qvel 33
_N_ACT = _N_ARM + adroit.N_HAND_DOF            # 27
_N_TIPS = 2 * adroit.N_DIGITS

_HANDLE_R = 0.011
_HANDLE_HL = 0.06
_HEAD_R = 0.02
_HEAD_LOCAL = np.array([0.075, 0.0, 0.0], np.float32)
_PALM_LOCAL = np.asarray(adroit.PALM_LOCAL, np.float32)
_PALM_R = adroit.PALM_R

_NAIL_POS = np.array([0.22, 0.0, 0.09], np.float32)   # head at start
_NAIL_TRAVEL = 0.05
_NAIL_R = 0.015
_NAIL_RESIST = 10.0     # dry-friction resistance [N]



class HammerParams(NamedTuple):
    model: rb.ChainModel
    kp: jax.Array
    kd: jax.Array
    mu: jax.Array


class HammerState(NamedTuple):
    qpos: jax.Array     # [35] = 3 slides + 24 hinges + hammer (7) + nail
    qvel: jax.Array     # [34]
    timestep: jax.Array


# numpy-only body specs — build_chain runs lazily in make().
_BODIES_SPEC, _DIGITS = adroit.arm_hand_bodies()
_BODIES_SPEC.append(dict(   # the hammer: light handle, heavy head
    pos=(0.0, 0.0, 0.0), type="free", parent=-1,
    damping=0.01, armature=0.0, gear=0.0,
    geoms=[rb.capsule_geom(_HANDLE_R,
                           (-_HANDLE_HL, 0, 0, _HANDLE_HL, 0, 0)),
           rb.sphere_geom(_HEAD_R, tuple(_HEAD_LOCAL))]))
_BODIES_SPEC.append(dict(   # the nail: vertical slide, heavily damped
    pos=tuple(_NAIL_POS), axis=(0, 0, 1), type="slide",
    range=(-_NAIL_TRAVEL, 0.0), parent=-1, damping=25.0,
    armature=0.0, gear=0.0, geoms=[rb.sphere_geom(_NAIL_R)]))


@functools.lru_cache(maxsize=1)
def build_model() -> rb.ChainModel:
    return rb.build_chain(_BODIES_SPEC, dt=_DT, site_body=_HAMMER_BODY,
                          site_pos=tuple(_HEAD_LOCAL),
                          gravity=(0.0, 0.0, -9.81))

# Contact batch: 8 digit points, handle endpoints, hammer head, nail
# head, palm pad.
_C_BODIES = tuple(int(b) for (b, _, _) in _DIGITS for _ in range(2)) \
    + (_HAMMER_BODY, _HAMMER_BODY, _HAMMER_BODY, _NAIL_BODY, 2)
_C_POINTS = np.concatenate(
    [np.stack([tip, mid]) for (_, tip, mid) in _DIGITS]
    + [np.array([[-_HANDLE_HL, 0, 0], [_HANDLE_HL, 0, 0]], np.float32),
       _HEAD_LOCAL[None], np.zeros((1, 3), np.float32),
       _PALM_LOCAL[None]])
_C_RADII = np.array([adroit.TIP_R, 0.008] * adroit.N_DIGITS, np.float32)


def _ext_forces(params: HammerParams):
    model = params.model
    hand_weight = 9.81 * jnp.sum(model.mass[:_HAMMER_BODY])

    def fn(_, q, qd):
        pos, vel, apply = rb.points_frame(model, q, qd, _C_BODIES,
                                          jnp.asarray(_C_POINTS))
        cap_a, cap_b, head, nail, palm = (
            pos[_N_TIPS], pos[_N_TIPS + 1], pos[_N_TIPS + 2],
            pos[_N_TIPS + 3], pos[_N_TIPS + 4])
        vcap_a, vcap_b, vhead, vnail, vpalm = (
            vel[_N_TIPS], vel[_N_TIPS + 1], vel[_N_TIPS + 2],
            vel[_N_TIPS + 3], vel[_N_TIPS + 4])
        forces = []
        f_cap_a = contact.sphere_plane_force(cap_a, vcap_a, _HANDLE_R,
                                             params.kp, params.kd,
                                             params.mu)
        f_cap_b = contact.sphere_plane_force(cap_b, vcap_b, _HANDLE_R,
                                             params.kp, params.kd,
                                             params.mu)
        for k in range(_N_TIPS):
            f_fh, t = contact.sphere_segment_force(
                pos[k], vel[k], _C_RADII[k], cap_a, cap_b, vcap_a,
                vcap_b, _HANDLE_R, params.kp, params.kd, params.mu)
            # ONLY the finger-handle force reacts onto the hammer; the
            # table's push on a finger stays off the free object.
            f_cap_a = f_cap_a - (1.0 - t) * f_fh
            f_cap_b = f_cap_b - t * f_fh
            forces.append(f_fh + contact.sphere_plane_force(
                pos[k], vel[k], _C_RADII[k], params.kp, params.kd,
                params.mu))
        # hammer head: table support + strike transfer onto the nail head
        f_head = contact.sphere_plane_force(head, vhead, _HEAD_R,
                                            params.kp, params.kd,
                                            params.mu)
        f_strike = contact.sphere_sphere_force(
            head, vhead, _HEAD_R, nail, vnail, _NAIL_R,
            params.kp, params.kd, params.mu)
        f_head = f_head + f_strike
        f_nail = -f_strike
        # palm vs handle
        f_palm, tp = contact.sphere_segment_force(
            palm, vpalm, _PALM_R, cap_a, cap_b, vcap_a, vcap_b,
            _HANDLE_R, params.kp, params.kd, params.mu)
        f_cap_a = f_cap_a - (1.0 - tp) * f_palm
        f_cap_b = f_cap_b - tp * f_palm
        forces += [f_cap_a, f_cap_b, f_head, f_nail, f_palm]
        tau = apply(jnp.stack(forces))
        # nail dry friction: resists motion, never drives it
        tau = tau.at[_NAIL_V].add(
            -_NAIL_RESIST * jnp.tanh(qd[_NAIL_V] / 0.02))
        return tau.at[2].add(hand_weight)

    return fn


def _frames(params: HammerParams, qpos: jax.Array):
    rots, poss = rb.forward_kinematics(params.model, qpos)
    palm = poss[2] + rots[2] @ jnp.asarray(_PALM_LOCAL)
    hammer = qpos[_HAMMER_Q:_HAMMER_Q + 3]
    head = poss[_HAMMER_BODY] + rots[_HAMMER_BODY] @ jnp.asarray(_HEAD_LOCAL)
    nail = poss[_NAIL_BODY]
    return palm, hammer, head, nail


def _init(params: HammerParams, key: jax.Array) -> HammerState:
    kx, _ = jax.random.split(key)
    qpos = jnp.asarray(params.model.neutral_qpos())
    qpos = qpos.at[2].set(0.18)
    # hammer flat on the table, randomized along y
    hy = jax.random.uniform(kx, (), jnp.float32, -0.06, 0.06)
    qpos = qpos.at[_HAMMER_Q].set(-0.02)
    qpos = qpos.at[_HAMMER_Q + 1].set(hy)
    qpos = qpos.at[_HAMMER_Q + 2].set(_HANDLE_R + 0.001)
    return HammerState(qpos=qpos, qvel=jnp.zeros(params.model.nv),
                       timestep=jnp.array(0, jnp.int32))


def _observe(params: HammerParams, state: HammerState) -> jax.Array:
    palm, hammer, head, nail = _frames(params, state.qpos)
    return jnp.concatenate([
        state.qpos[:_N_ACT], state.qvel[:_N_ACT],
        hammer, state.qvel[_HAMMER_Q:_HAMMER_Q + 3],
        head, nail, palm - hammer, head - nail,
        state.qpos[_NAIL_Q:_NAIL_Q + 1]])
    # 73-dim


def _step(params: HammerParams, state: HammerState, action: jax.Array):
    ctrl = jnp.concatenate([jnp.clip(action, -1.0, 1.0),
                            jnp.zeros(7, action.dtype)])
    qpos, qvel = rb.step(params.model, state.qpos, state.qvel, ctrl,
                         n_substeps=_FRAME_SKIP,
                         ext_force_fn=_ext_forces(params))
    new = state._replace(qpos=qpos, qvel=qvel, timestep=state.timestep + 1)
    palm, hammer, head, nail = _frames(params, qpos)
    depth = -qpos[_NAIL_Q]
    # mj_envs hammer_v0.py: reach shaping on palm->tool and tool
    # head->nail, staged bonuses at half/full drive.
    reward = (-0.1 * jnp.linalg.norm(palm - hammer)
              - jnp.linalg.norm(head - nail)
              + 2.0 * depth / _NAIL_TRAVEL
              + jnp.where(depth > 0.5 * _NAIL_TRAVEL, 25.0, 0.0)
              + jnp.where(depth > 0.95 * _NAIL_TRAVEL, 75.0, 0.0))
    return new, _observe(params, new), reward, jnp.array(False)


def _success(params: HammerParams, state: HammerState) -> jax.Array:
    return -state.qpos[_NAIL_Q] > 0.95 * _NAIL_TRAVEL


def _build_fused_rollout(model: rb.ChainModel):
    """Fused Pallas rollout for hammer-v0 (ops/pallas_forest.py). The
    hammer's heavy head puts its com off the frame origin, so this env
    exercises the kernel's coupled 6x6 free-body solve; the nail's
    dry-friction law and the arm gravity compensation ride
    joint_torque_fn. kp/kd/mu ride extras; model constants are baked."""
    from ..ops import pallas_forest as pf

    points = [(int(b), np.asarray(p, np.float32))
              for (b, _, _), p in zip(
                  [d for d in _DIGITS for _ in range(2)],
                  _C_POINTS[:_N_TIPS])]
    points += [(_HAMMER_BODY, np.array([-_HANDLE_HL, 0, 0], np.float32)),
               (_HAMMER_BODY, np.array([_HANDLE_HL, 0, 0], np.float32)),
               (_HAMMER_BODY, _HEAD_LOCAL),
               (_NAIL_BODY, np.zeros(3, np.float32)),
               (2, _PALM_LOCAL)]
    hand_weight = float(9.81 * np.sum(np.asarray(model.mass)[:_HAMMER_BODY]))

    def force_fn(states, extras, rots, poss):
        kp, kd, mu = extras[0], extras[1], extras[2]
        (cap_a, vcap_a) = states[_N_TIPS]
        (cap_b, vcap_b) = states[_N_TIPS + 1]
        (head, vhead) = states[_N_TIPS + 2]
        (nail, vnail) = states[_N_TIPS + 3]
        (palm, vpalm) = states[_N_TIPS + 4]
        f_cap_a = pf.sphere_plane_force(cap_a, vcap_a, _HANDLE_R,
                                        kp, kd, mu)
        f_cap_b = pf.sphere_plane_force(cap_b, vcap_b, _HANDLE_R,
                                        kp, kd, mu)
        forces = []
        for k in range(_N_TIPS):
            p, v = states[k]
            f_fh, t = pf.sphere_segment_force(
                p, v, float(_C_RADII[k]), cap_a, cap_b, vcap_a, vcap_b,
                _HANDLE_R, kp, kd, mu)
            f_cap_a = pf._vsub(f_cap_a, pf._vscale(1.0 - t, f_fh))
            f_cap_b = pf._vsub(f_cap_b, pf._vscale(t, f_fh))
            forces.append(pf._vadd(f_fh, pf.sphere_plane_force(
                p, v, float(_C_RADII[k]), kp, kd, mu)))
        f_head = pf.sphere_plane_force(head, vhead, _HEAD_R, kp, kd, mu)
        f_strike = pf.sphere_sphere_force(head, vhead, _HEAD_R,
                                          nail, vnail, _NAIL_R,
                                          kp, kd, mu)
        f_head = pf._vadd(f_head, f_strike)
        f_nail = pf._vscale(np.float32(-1.0), f_strike)
        f_palm, tp = pf.sphere_segment_force(
            palm, vpalm, _PALM_R, cap_a, cap_b, vcap_a, vcap_b,
            _HANDLE_R, kp, kd, mu)
        f_cap_a = pf._vsub(f_cap_a, pf._vscale(1.0 - tp, f_palm))
        f_cap_b = pf._vsub(f_cap_b, pf._vscale(tp, f_palm))
        forces += [f_cap_a, f_cap_b, f_head, f_nail, f_palm]
        return forces

    force_fn.points = points
    palm_local = [np.float32(v) for v in _PALM_LOCAL]
    head_local = [np.float32(v) for v in _HEAD_LOCAL]

    def torque_fn(q, qd, extras, fk):
        return {2: np.float32(hand_weight),
                _NAIL_BODY: np.float32(-_NAIL_RESIST)
                * jnp.tanh(qd[_NAIL_BODY] / np.float32(0.02))}

    def cost_fn(q, qd, rots, poss, extras):
        palm = pf._vadd(poss[2], pf._mv(rots[2], palm_local))
        hammer = poss[_HAMMER_BODY]
        head = pf._vadd(hammer, pf._mv(rots[_HAMMER_BODY], head_local))
        nail = poss[_NAIL_BODY]
        depth = -q[_NAIL_BODY]
        reward = (np.float32(-0.1) * pf._vnorm(pf._vsub(palm, hammer))
                  - pf._vnorm(pf._vsub(head, nail))
                  + np.float32(2.0 / _NAIL_TRAVEL) * depth
                  + jnp.where(depth > 0.5 * _NAIL_TRAVEL,
                              np.float32(25.0), 0.0)
                  + jnp.where(depth > 0.95 * _NAIL_TRAVEL,
                              np.float32(75.0), 0.0))
        return -reward

    roll = pf.build_forest_rollout(
        model, n_substeps=_FRAME_SKIP, act_bodies=list(range(_N_ACT)),
        force_fn=force_fn, cost_fn=cost_fn, n_extras=3,
        joint_torque_fn=torque_fn)

    def fused(params: HammerParams, state: HammerState, mean, noise):
        extras = jnp.stack([params.kp, params.kd, params.mu])
        return roll(state.qpos, state.qvel, extras, mean, noise)

    fused.substep_parts = roll.substep_parts   # FLOP accounting
    # (harness.forest_perf traces the substep outside pallas)
    fused.dynamic_fields = ("kp", "kd", "mu")   # read at call time via
    # extras — dyn-randomizing only these keeps the fast path
    return fused


def make() -> Env:
    params = HammerParams(model=build_model(), kp=jnp.float32(800.0),
                          kd=jnp.float32(2.0), mu=jnp.float32(1.2))
    return Env(name="hammer-v0", d_obs=2 * _N_ACT + 19, d_action=_N_ACT,
               action_lows=np.full(_N_ACT, -1.0, np.float32),
               action_highs=np.full(_N_ACT, 1.0, np.float32),
               params=params, init=_init, step=_step, observe=_observe,
               success=_success, max_episode_steps=75,
               fused_rollout=_build_fused_rollout(build_model()))


from .randomize import register_names as _register_names  # noqa: E402

_register_names(
    "hammer-v0",
    ["arm_x", "arm_y", "arm_z"] + adroit.hand_joint_names()
    + ["Object", "nail"],
    extra={"hammer": _HAMMER_BODY})
