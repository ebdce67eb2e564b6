"""door-v0: turn a latched handle and pull a door open with the hand.

The reference's door-v0 is the mj_envs Adroit task — the hand undoes a
latch and swings the door open; success when the door hinge passes 1.35
rad (README.md:33-35, examples/configs/hand/door-v0.yml). Round 1
aliased this family to sawyer_door; this module is the hand-actuated
rebuild on the 3-slide arm + 24-DOF five-digit hand (`envs/adroit.py`),
matching the Adroit task structure:

- the DOOR is a vertical-axis hinge body, spring-loaded shut and BLOCKED
  by the latch: until the latch angle clears a threshold, a stiff gated
  restoring torque holds the door closed (the mj_envs latch mechanism as
  a smooth force law instead of a MuJoCo constraint);
- the LATCH is a hinge on the door carrying the handle bar; pressing the
  handle down rotates it against its return spring;
- the hand interacts only through frictional contact with the handle
  capsule (8 digit spheres + palm pad), exactly like pen/relocate/
  hammer.

nq = nv = 3 + 20 + 1 + 1 = 25 (all scalar joints — the free-object
machinery is not needed; the challenge is the latch-then-pull sequence).
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
_DOOR_BODY = _N_ARM + adroit.N_HAND_BODIES   # body index 27
_LATCH_BODY = _DOOR_BODY + 1                   # 24
_DOOR_Q = _N_ARM + adroit.N_HAND_DOF           # 23
_LATCH_Q = _DOOR_Q + 1                         # 24
_N_ACT = _N_ARM + adroit.N_HAND_DOF            # 23
_N_TIPS = 2 * adroit.N_DIGITS

# Door frame: hinge at x = 0.35, door panel extends toward -x; the
# handle bar sits on the latch at the panel's free edge, pointing -y so
# the descending digits can hook it.
_DOOR_HINGE_POS = (0.35, 0.25, 0.04)
_PANEL = (-0.30, -0.04, 0.0)          # latch pivot offset from the hinge
# The handle bar runs along X (the digit cage's pinch orientation — the
# same grasp geometry as the pen capsule), sticking out of the panel
# toward the hand.
_HANDLE_A = np.array([-0.01, 0.0, 0.0], np.float32)   # handle ends in the
_HANDLE_B = np.array([-0.12, 0.0, 0.0], np.float32)   # latch body frame
_HANDLE_R = 0.014
_PALM_LOCAL = np.asarray(adroit.PALM_LOCAL, np.float32)
_PALM_R = adroit.PALM_R

_LATCH_THRESH = 0.55      # rad the latch must turn before the door frees
_LATCH_SPRING = 0.3       # handle return spring
_DOOR_SPRING = 0.25       # door-closed spring
_BLOCK_K = 4.0            # strike-plate torque cap [N*m]



class DoorParams(NamedTuple):
    model: rb.ChainModel
    kp: jax.Array
    kd: jax.Array
    mu: jax.Array


class DoorState(NamedTuple):
    qpos: jax.Array     # [25]
    qvel: jax.Array     # [25]
    timestep: jax.Array


# numpy-only body specs — build_chain runs lazily in make().
_BODIES_SPEC, _DIGITS = adroit.arm_hand_bodies()
_BODIES_SPEC.append(dict(   # door panel on a vertical hinge
    pos=_DOOR_HINGE_POS, axis=(0, 0, 1), range=(0.0, 1.8),
    parent=-1, damping=1.2, armature=0.05, gear=0.0,
    geoms=[rb.box_geom((0.14, 0.015, 0.10), (-0.15, 0.0, 0.0))]))
_BODIES_SPEC.append(dict(   # latch hinge carrying the handle bar
    pos=_PANEL, axis=(0, -1, 0), range=(0.0, 1.5),
    parent=_DOOR_BODY, damping=0.15, armature=0.01, gear=0.0,
    geoms=[rb.capsule_geom(_HANDLE_R,
                           tuple(_HANDLE_A) + tuple(_HANDLE_B))]))


@functools.lru_cache(maxsize=1)
def build_model() -> rb.ChainModel:
    return rb.build_chain(_BODIES_SPEC, dt=_DT, site_body=_LATCH_BODY,
                          site_pos=tuple(0.5 * (_HANDLE_A + _HANDLE_B)),
                          gravity=(0.0, 0.0, -9.81))

_C_BODIES = tuple(int(b) for (b, _, _) in _DIGITS for _ in range(2)) \
    + (_LATCH_BODY, _LATCH_BODY, 2)
_C_POINTS = np.concatenate(
    [np.stack([tip, mid]) for (_, tip, mid) in _DIGITS]
    + [_HANDLE_A[None], _HANDLE_B[None], _PALM_LOCAL[None]])
_C_RADII = np.array([adroit.TIP_R, 0.008] * adroit.N_DIGITS, np.float32)


def _ext_forces(params: DoorParams):
    model = params.model
    hand_weight = 9.81 * jnp.sum(model.mass[:_DOOR_BODY])

    def fn(_, q, qd):
        pos, vel, apply = rb.points_frame(model, q, qd, _C_BODIES,
                                          jnp.asarray(_C_POINTS))
        ha, hb, palm = pos[_N_TIPS], pos[_N_TIPS + 1], pos[_N_TIPS + 2]
        vha, vhb, vpalm = vel[_N_TIPS], vel[_N_TIPS + 1], vel[_N_TIPS + 2]
        forces = []
        f_ha = jnp.zeros(3, q.dtype)
        f_hb = jnp.zeros(3, q.dtype)
        for k in range(_N_TIPS):
            f, t = contact.sphere_segment_force(
                pos[k], vel[k], _C_RADII[k], ha, hb, vha, vhb,
                _HANDLE_R, params.kp, params.kd, params.mu)
            forces.append(f)
            f_ha = f_ha - (1.0 - t) * f
            f_hb = f_hb - t * f
        f_palm, tp = contact.sphere_segment_force(
            palm, vpalm, _PALM_R, ha, hb, vha, vhb, _HANDLE_R,
            params.kp, params.kd, params.mu)
        f_ha = f_ha - (1.0 - tp) * f_palm
        f_hb = f_hb - tp * f_palm
        forces += [f_ha, f_hb, f_palm]
        tau = apply(jnp.stack(forces))
        # latch return spring + strike-plate blocking: the door is held
        # shut by a SATURATING torque that engages only while the door is
        # near closed AND the latch is below threshold (a real strike
        # plate stops mattering once the door clears the frame — without
        # the door-angle gate, releasing the latch mid-swing would slam
        # the door shut). Smooth gates keep it differentiable.
        gate = (jax.nn.sigmoid((_LATCH_THRESH - q[_LATCH_Q]) / 0.05)
                * jax.nn.sigmoid((0.12 - q[_DOOR_Q]) / 0.04))
        tau = tau.at[_LATCH_Q].add(-_LATCH_SPRING * q[_LATCH_Q])
        tau = tau.at[_DOOR_Q].add(
            -_DOOR_SPRING * q[_DOOR_Q]
            - _BLOCK_K * jnp.tanh(q[_DOOR_Q] / 0.03) * gate)
        return tau.at[2].add(hand_weight)

    return fn


def _handle_pos(params: DoorParams, qpos: jax.Array) -> jax.Array:
    return rb.site_position(params.model, qpos)


def _palm_pos(params: DoorParams, qpos: jax.Array) -> jax.Array:
    rots, poss = rb.forward_kinematics(params.model, qpos)
    return poss[2] + rots[2] @ jnp.asarray(_PALM_LOCAL)


def _init(params: DoorParams, key: jax.Array) -> DoorState:
    ky, _ = jax.random.split(key)
    qpos = jnp.asarray(params.model.neutral_qpos())
    qpos = qpos.at[2].set(0.10)
    # randomize the hand's start along y (mj_envs randomizes the door
    # frame position; same relative-geometry effect)
    qpos = qpos.at[1].set(jax.random.uniform(ky, (), jnp.float32,
                                             -0.05, 0.05))
    return DoorState(qpos=qpos, qvel=jnp.zeros(params.model.nv),
                     timestep=jnp.array(0, jnp.int32))


def _observe(params: DoorParams, state: DoorState) -> jax.Array:
    handle = _handle_pos(params, state.qpos)
    palm = _palm_pos(params, state.qpos)
    return jnp.concatenate([
        state.qpos[:_N_ACT], state.qvel[:_N_ACT],
        handle, palm - handle,
        state.qpos[_DOOR_Q:_LATCH_Q + 1],
        state.qvel[_DOOR_Q:_LATCH_Q + 1]])
    # 64-dim


def _step(params: DoorParams, state: DoorState, action: jax.Array):
    ctrl = jnp.concatenate([jnp.clip(action, -1.0, 1.0),
                            jnp.zeros(2, action.dtype)])
    qpos, qvel = rb.step(params.model, state.qpos, state.qvel, ctrl,
                         n_substeps=_FRAME_SKIP,
                         ext_force_fn=_ext_forces(params))
    new = state._replace(qpos=qpos, qvel=qvel, timestep=state.timestep + 1)
    handle = _handle_pos(params, qpos)
    palm = _palm_pos(params, qpos)
    door = qpos[_DOOR_Q]
    latch = qpos[_LATCH_Q]
    # mj_envs door_v0.py: palm-to-handle shaping + staged door-angle
    # bonuses (0.2 / 1.0 / 1.35 rad); latch progress shaped so the
    # turn-then-pull sequence has gradient everywhere.
    reward = (-0.1 * jnp.linalg.norm(palm - handle)
              + 0.5 * latch + 2.0 * door
              + jnp.where(door > 0.2, 2.0, 0.0)
              + jnp.where(door > 1.0, 8.0, 0.0)
              + jnp.where(door > 1.35, 10.0, 0.0))
    return new, _observe(params, new), reward, jnp.array(False)


def _success(params: DoorParams, state: DoorState) -> jax.Array:
    return state.qpos[_DOOR_Q] > 1.35


def _build_fused_rollout(model: rb.ChainModel):
    """Fused Pallas rollout for door-v0 (ops/pallas_forest.py). All
    scalar joints — the door+latch form one 2-DOF tree; the latch return
    spring, the gated strike-plate blocking torque, and the arm gravity
    compensation ride joint_torque_fn. kp/kd/mu ride extras; model
    constants are baked."""
    from ..ops import pallas_forest as pf

    points = [(int(b), np.asarray(p, np.float32))
              for (b, _, _), p in zip(
                  [d for d in _DIGITS for _ in range(2)],
                  _C_POINTS[:_N_TIPS])]
    points += [(_LATCH_BODY, _HANDLE_A), (_LATCH_BODY, _HANDLE_B),
               (2, _PALM_LOCAL)]
    hand_weight = float(9.81 * np.sum(np.asarray(model.mass)[:_DOOR_BODY]))

    def force_fn(states, extras, rots, poss):
        kp, kd, mu = extras[0], extras[1], extras[2]
        (ha, vha) = states[_N_TIPS]
        (hb, vhb) = states[_N_TIPS + 1]
        (palm, vpalm) = states[_N_TIPS + 2]
        zero = jnp.zeros_like(ha[0])
        f_ha, f_hb = [zero] * 3, [zero] * 3
        forces = []
        for k in range(_N_TIPS):
            p, v = states[k]
            f, t = pf.sphere_segment_force(
                p, v, float(_C_RADII[k]), ha, hb, vha, vhb,
                _HANDLE_R, kp, kd, mu)
            forces.append(f)
            f_ha = pf._vsub(f_ha, pf._vscale(1.0 - t, f))
            f_hb = pf._vsub(f_hb, pf._vscale(t, f))
        f_palm, tp = pf.sphere_segment_force(
            palm, vpalm, _PALM_R, ha, hb, vha, vhb, _HANDLE_R,
            kp, kd, mu)
        f_ha = pf._vsub(f_ha, pf._vscale(1.0 - tp, f_palm))
        f_hb = pf._vsub(f_hb, pf._vscale(tp, f_palm))
        forces += [f_ha, f_hb, f_palm]
        return forces

    force_fn.points = points
    palm_local = [np.float32(v) for v in _PALM_LOCAL]
    mid_local = [np.float32(v) for v in 0.5 * (_HANDLE_A + _HANDLE_B)]

    def torque_fn(q, qd, extras, fk):
        gate = (jax.nn.sigmoid((np.float32(_LATCH_THRESH)
                                - q[_LATCH_BODY]) / np.float32(0.05))
                * jax.nn.sigmoid((np.float32(0.12)
                                  - q[_DOOR_BODY]) / np.float32(0.04)))
        return {
            2: np.float32(hand_weight),
            _LATCH_BODY: np.float32(-_LATCH_SPRING) * q[_LATCH_BODY],
            _DOOR_BODY: (np.float32(-_DOOR_SPRING) * q[_DOOR_BODY]
                         - np.float32(_BLOCK_K)
                         * jnp.tanh(q[_DOOR_BODY] / np.float32(0.03))
                         * gate),
        }

    def cost_fn(q, qd, rots, poss, extras):
        handle = pf._vadd(poss[_LATCH_BODY],
                          pf._mv(rots[_LATCH_BODY], mid_local))
        palm = pf._vadd(poss[2], pf._mv(rots[2], palm_local))
        door, latch = q[_DOOR_BODY], q[_LATCH_BODY]
        reward = (np.float32(-0.1) * pf._vnorm(pf._vsub(palm, handle))
                  + np.float32(0.5) * latch + np.float32(2.0) * door
                  + jnp.where(door > 0.2, np.float32(2.0), 0.0)
                  + jnp.where(door > 1.0, np.float32(8.0), 0.0)
                  + jnp.where(door > 1.35, np.float32(10.0), 0.0))
        return -reward

    roll = pf.build_forest_rollout(
        model, n_substeps=_FRAME_SKIP, act_bodies=list(range(_N_ACT)),
        force_fn=force_fn, cost_fn=cost_fn, n_extras=3,
        joint_torque_fn=torque_fn)

    def fused(params: DoorParams, state: DoorState, mean, noise):
        extras = jnp.stack([params.kp, params.kd, params.mu])
        return roll(state.qpos, state.qvel, extras, mean, noise)

    fused.substep_parts = roll.substep_parts   # FLOP accounting
    # (harness.forest_perf traces the substep outside pallas)
    fused.dynamic_fields = ("kp", "kd", "mu")   # read at call time via
    # extras — dyn-randomizing only these keeps the fast path
    return fused


def make() -> Env:
    model = build_model()
    params = DoorParams(model=model, kp=jnp.float32(800.0),
                        kd=jnp.float32(2.0), mu=jnp.float32(1.2))
    return Env(name="door-v0", d_obs=2 * _N_ACT + 10, d_action=_N_ACT,
               action_lows=np.full(_N_ACT, -1.0, np.float32),
               action_highs=np.full(_N_ACT, 1.0, np.float32),
               params=params, init=_init, step=_step, observe=_observe,
               success=_success, max_episode_steps=150,
               fused_rollout=_build_fused_rollout(model))


from .randomize import register_names as _register_names  # noqa: E402

_register_names(
    "door-v0",
    ["arm_x", "arm_y", "arm_z"] + adroit.hand_joint_names()
    + ["frame", "latch"],
    extra={"door_hinge": _DOOR_BODY, "handle": _LATCH_BODY})
