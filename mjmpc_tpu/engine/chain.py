"""Rigid-body dynamics for kinematic trees, as pure JAX functions.

This is the framework's replacement for the reference's external native
simulator (mujoco_py; SURVEY.md §2.9): an articulated-body engine
sufficient for the reference's arm tasks (sawyer.xml — 7 hinge joints;
/root/reference/mjmpc/envs/assets/xml/sawyer.xml) AND the
hand-manipulation suite's free-floating objects (mj_envs Adroit pen /
relocate objects — quaternion orientation state, README.md:33-35).

Joint types:
    hinge  — 1 qpos / 1 qvel, rotation about a body-frame axis
    slide  — 1 qpos / 1 qvel, translation along a body-frame axis
    ball   — 4 qpos (unit quaternion, wxyz) / 3 qvel (body-frame angular
             velocity), MuJoCo ball-joint semantics
    free   — 7 qpos (parent-frame position + unit quaternion) / 6 qvel
             (parent-frame linear velocity + body-frame angular velocity)

Design, accelerator-first:
- everything is fixed-shape dense linear algebra over [nv]-sized arrays,
  vmapped over thousands of particles — no per-body Python objects, no
  dynamic control flow; topology (qpos/qvel layout included) is static
  metadata, so kinematics unrolls with real branching at trace time;
- the mass matrix comes from velocity-Jacobian composition
  (M = Σ Jᵥᵀ m Jᵥ + Jωᵀ I Jω) over per-DOF world axes — a batched
  small-matmul formulation that XLA maps well;
- Coriolis/centrifugal/gyroscopic bias is derived from the SAME
  kinematics by automatic differentiation via a TANGENT-SPACE Lagrangian:
  local coordinates δ ∈ R^nv are placed at the current configuration
  (additive for scalar joints, right-multiplied exp-map for rotation
  blocks), the tangent mass matrix M_t(q, δ) carries the right Jacobian
  J_r(δ) of the SO(3) exponential, and
        bias = (∂M_t/∂δ · v) v − ∇_δ [KE − V] |_{δ=0}
  — exact Boltzmann-Hamel dynamics by construction (for a single free
  body this reproduces Euler's equations I ω̇ + ω × I ω = τ; see
  tests/test_engine_free.py), with no hand-derived RNEA to drift out of
  sync;
- integration mirrors MuJoCo's 'Euler' semantics: semi-implicit Euler
  with implicit joint damping — solve (M + dt·D) v̇ = τ − bias − D v,
  then v += dt v̇ and retract q by dt·v (additive / quaternion exp).

Joint limits (scalar joints only) are enforced by projection (clamp
qpos, zero the outward velocity) rather than MuJoCo's soft constraint
solver; the reference tasks operate away from the limits and BASELINE
parity is defined on (qpos, qvel, target) state equivalence (SURVEY.md
§7 'hard parts').
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_JOINT_NQ = {"hinge": 1, "slide": 1, "ball": 4, "free": 7}
_JOINT_NV = {"hinge": 1, "slide": 1, "ball": 3, "free": 6}


@functools.partial(jax.tree_util.register_dataclass)
@dataclasses.dataclass(frozen=True)
class ChainModel:
    """Static description of a kinematic tree (n joints == n bodies).

    Body i's frame is offset `body_pos[i]` from its parent's frame
    (`parent[i]`, -1 = world); each joint moves body i's frame per its
    type. Free planar bases (swimmer, half-cheetah) are modeled
    MuJoCo-style as slide+slide+hinge virtual joints on massless proximal
    bodies; branches (cheetah legs, hand fingers) via the parent table.
    Fused (joint-less) bodies are pre-merged into their jointed parent at
    model-build time.

    Topology (`parent`, `joint_types`, `dt`, `site_body`) is static
    metadata — python values at trace time, so kinematics unrolls with
    real branching and no masked blends; the physical parameters are
    traced array leaves (vmappable, randomizable, donatable).

    Per-DOF arrays (`armature`, `damping`, `stiffness`, `gear`) have
    length nv; `qpos_low`/`qpos_high` have length nq (quaternion entries
    are unbounded). For scalar-joint-only chains nq == nv == n and every
    array matches the round-1 per-joint layout exactly.
    """
    joint_axis: jax.Array   # [n, 3] unit axes, child-body frame
                            # (hinge/slide only; ignored for ball/free)
    body_pos: jax.Array     # [n, 3] frame offset from parent frame
    mass: jax.Array         # [n]
    com: jax.Array          # [n, 3] body-frame COM
    inertia: jax.Array      # [n, 3, 3] about COM, body frame
    armature: jax.Array     # [nv] rotor inertia added to M diagonal
    damping: jax.Array      # [nv] viscous joint damping
    frictionloss: jax.Array  # [nv] Coulomb joint friction torque
                             # (MuJoCo dof_frictionloss; smooth tanh law)
    stiffness: jax.Array    # [nv] joint spring stiffness (rest at q = 0,
                            # scalar joints only)
    gear: jax.Array         # [nv] actuator torque scaling
    qpos_low: jax.Array     # [nq]
    qpos_high: jax.Array    # [nq]
    gravity: jax.Array      # [3] world gravity vector
    site_pos: jax.Array     # [3] site offset in site_body's frame
    parent: Tuple[int, ...] = dataclasses.field(
        metadata=dict(static=True))
    joint_types: Tuple[str, ...] = dataclasses.field(
        metadata=dict(static=True))
    dt: float = dataclasses.field(metadata=dict(static=True))
    site_body: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_joints(self) -> int:
        return len(self.parent)

    @property
    def nq(self) -> int:
        return sum(_JOINT_NQ[t] for t in self.joint_types)

    @property
    def nv(self) -> int:
        return sum(_JOINT_NV[t] for t in self.joint_types)

    @property
    def q_offsets(self) -> Tuple[int, ...]:
        return _offsets(self.joint_types, "q")

    @property
    def v_offsets(self) -> Tuple[int, ...]:
        return _offsets(self.joint_types, "v")

    def ancestor_mask(self) -> np.ndarray:
        """mask[i, k] = 1 if velocity DOF k moves body i (k's joint on
        i's root path)."""
        return _dof_ancestor_mask(self.parent, self.joint_types)

    def neutral_qpos(self) -> jax.Array:
        """All-zero scalar joints; identity quaternions."""
        return jnp.asarray(_neutral_qpos(self.joint_types))

    def _replace(self, **kw) -> "ChainModel":
        return dataclasses.replace(self, **kw)


@functools.lru_cache(maxsize=None)
def _offsets(joint_types: Tuple[str, ...], kind: str) -> Tuple[int, ...]:
    sizes = _JOINT_NQ if kind == "q" else _JOINT_NV
    out, acc = [], 0
    for t in joint_types:
        out.append(acc)
        acc += sizes[t]
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _body_ancestor_mask(parent: Tuple[int, ...]) -> np.ndarray:
    n = len(parent)
    mask = np.zeros((n, n), np.float32)
    for i in range(n):
        k = i
        while k >= 0:
            mask[i, k] = 1.0
            k = parent[k]
    return mask


@functools.lru_cache(maxsize=None)
def _dof_ancestor_mask(parent: Tuple[int, ...],
                       joint_types: Tuple[str, ...]) -> np.ndarray:
    body = _body_ancestor_mask(parent)
    voff = _offsets(joint_types, "v")
    nv = sum(_JOINT_NV[t] for t in joint_types)
    mask = np.zeros((len(parent), nv), np.float32)
    for j, t in enumerate(joint_types):
        mask[:, voff[j]:voff[j] + _JOINT_NV[t]] = body[:, j:j + 1]
    return mask


@functools.lru_cache(maxsize=None)
def _rot_dof_mask(joint_types: Tuple[str, ...]) -> np.ndarray:
    """[nv] 1.0 where the velocity DOF is rotational."""
    out = []
    for t in joint_types:
        if t == "hinge":
            out.append([1.0])
        elif t == "slide":
            out.append([0.0])
        elif t == "ball":
            out.append([1.0] * 3)
        else:  # free: 3 translational then 3 rotational
            out.append([0.0] * 3 + [1.0] * 3)
    return np.concatenate(out).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _scalar_maps(joint_types: Tuple[str, ...]):
    """(q indices, v indices) of the 1-DOF joints — the limit/stiffness
    projection set."""
    qoff, voff = (_offsets(joint_types, "q"), _offsets(joint_types, "v"))
    qi = [qoff[j] for j, t in enumerate(joint_types) if t in ("hinge", "slide")]
    vi = [voff[j] for j, t in enumerate(joint_types) if t in ("hinge", "slide")]
    return np.asarray(qi, np.int32), np.asarray(vi, np.int32)


@functools.lru_cache(maxsize=None)
def _neutral_qpos(joint_types: Tuple[str, ...]) -> np.ndarray:
    out = []
    for t in joint_types:
        if t in ("hinge", "slide"):
            out.append([0.0])
        elif t == "ball":
            out.append([1.0, 0.0, 0.0, 0.0])
        else:
            out.append([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0])
    return np.concatenate(out).astype(np.float32)


# ---------------------------------------------------------------------------
# SO(3) primitives — branch-free, differentiable at the identity (the
# tangent-Lagrangian evaluates everything AT delta = 0, so every guarded
# branch keeps finite values/derivatives there).
# ---------------------------------------------------------------------------

def _skew(v: jax.Array) -> jax.Array:
    x, y, z = v[0], v[1], v[2]
    z0 = jnp.zeros((), v.dtype)
    return jnp.stack([jnp.stack([z0, -z, y]),
                      jnp.stack([z, z0, -x]),
                      jnp.stack([-y, x, z0])])


def _rodrigues(axis: jax.Array, angle: jax.Array) -> jax.Array:
    """Rotation about a unit axis (no small-angle issue: axis is given)."""
    k = _skew(axis)
    s, c = jnp.sin(angle), jnp.cos(angle)
    return jnp.eye(3, dtype=axis.dtype) + s * k + (1.0 - c) * (k @ k)


def _sincc(t2: jax.Array):
    """(sin t / t, (1 - cos t) / t², (t - sin t) / t³) from t², with
    Taylor forms near 0 — differentiable at t2 = 0."""
    small = t2 < 1e-8
    safe = jnp.where(small, 1.0, t2)
    t = jnp.sqrt(safe)
    s = jnp.where(small, 1.0 - t2 / 6.0, jnp.sin(t) / t)
    c = jnp.where(small, 0.5 - t2 / 24.0, (1.0 - jnp.cos(t)) / safe)
    d = jnp.where(small, 1.0 / 6.0 - t2 / 120.0, (t - jnp.sin(t)) / (safe * t))
    return s, c, d


def _exp_so3(w: jax.Array) -> jax.Array:
    """exp(ŵ) — rotation matrix of the axis-angle vector w."""
    s, c, _ = _sincc(w @ w)
    k = _skew(w)
    return jnp.eye(3, dtype=w.dtype) + s * k + c * (k @ k)


def _so3_right_jacobian(w: jax.Array) -> jax.Array:
    """J_r(w): body angular velocity = J_r(w) ẇ for R(t) = R₀ exp(ŵ(t)).
    J_r(0) = I; its first-order term −½ŵ is what feeds the gyroscopic
    force through the tangent Lagrangian."""
    _, c, d = _sincc(w @ w)
    k = _skew(w)
    return jnp.eye(3, dtype=w.dtype) - c * k + d * (k @ k)


def _quat_to_mat(q: jax.Array) -> jax.Array:
    """Unit quaternion (w, x, y, z) -> rotation matrix (normalizes)."""
    q = q / jnp.linalg.norm(q)
    w, x, y, z = q[0], q[1], q[2], q[3]
    return jnp.stack([
        jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
        jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
        jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
    ])


def _quat_mul(a: jax.Array, b: jax.Array) -> jax.Array:
    aw, ax, ay, az = a[0], a[1], a[2], a[3]
    bw, bx, by, bz = b[0], b[1], b[2], b[3]
    return jnp.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def _exp_quat(w: jax.Array) -> jax.Array:
    """Axis-angle vector -> unit quaternion exp(ŵ/2)."""
    t2 = w @ w
    small = t2 < 1e-8
    safe = jnp.where(small, 1.0, t2)
    t = jnp.sqrt(safe)
    half = 0.5 * t
    sinc_half = jnp.where(small, 0.5 - t2 / 48.0, jnp.sin(half) / t)
    cos_half = jnp.where(small, 1.0 - t2 / 8.0, jnp.cos(half))
    return jnp.concatenate([cos_half[None], sinc_half * w])


# ---------------------------------------------------------------------------
# Kinematics
# ---------------------------------------------------------------------------

def _fk_dofs(model: ChainModel, q: jax.Array,
             delta: Optional[jax.Array] = None):
    """Forward kinematics at q ⊕ δ, plus per-velocity-DOF world axes.

    Returns (rots [n,3,3] body->world, poss [n,3] frame origins,
    axes [nv,3] world DOF directions, origins [nv,3] world DOF anchor
    points). For rotation blocks the DOF axes carry the right Jacobian
    J_r(δ) — required for the tangent-Lagrangian bias to be exact.

    Static unroll over the (small, fixed) tree: topology is python-level
    metadata, so branching and joint-type selection happen at trace time
    and the whole kinematics fuses into one XLA computation — a lax.scan
    here would serialize tiny kernels and dominate latency. HIGHEST
    matmul precision: at a reduced default (bf16 passes, or TF32 on a
    GPU) the composed rotations drift ~0.2% and the error compounds through the mass
    matrix, AD bias, and every integration substep.
    """
    n = model.n_joints
    eye = jnp.eye(3, dtype=q.dtype)
    zero = jnp.zeros(3, q.dtype)
    qoff, voff = model.q_offsets, model.v_offsets
    rots, poss = [], []
    axes = [None] * model.nv
    origins = [None] * model.nv
    with jax.default_matmul_precision("highest"):
        for i in range(n):
            pi = model.parent[i]
            r_p = eye if pi < 0 else rots[pi]
            p_p = zero if pi < 0 else poss[pi]
            t = model.joint_types[i]
            qi, vi = qoff[i], voff[i]
            if t == "slide":
                disp = q[qi] if delta is None else q[qi] + delta[vi]
                axis_w = r_p @ model.joint_axis[i]
                p = p_p + r_p @ model.body_pos[i] + axis_w * disp
                r = r_p
                axes[vi] = axis_w
                origins[vi] = p
            elif t == "hinge":
                ang = q[qi] if delta is None else q[qi] + delta[vi]
                p = p_p + r_p @ model.body_pos[i]
                r = r_p @ _rodrigues(model.joint_axis[i], ang)
                axes[vi] = r @ model.joint_axis[i]
                origins[vi] = p
            elif t == "ball":
                p = p_p + r_p @ model.body_pos[i]
                r = r_p @ _quat_to_mat(q[qi:qi + 4])
                if delta is None:
                    jr = r
                else:
                    d = delta[vi:vi + 3]
                    r = r @ _exp_so3(d)
                    jr = r @ _so3_right_jacobian(d)
                for k in range(3):
                    axes[vi + k] = jr[:, k]
                    origins[vi + k] = p
            elif t == "free":
                trans = q[qi:qi + 3]
                if delta is not None:
                    trans = trans + delta[vi:vi + 3]
                p = p_p + r_p @ (model.body_pos[i] + trans)
                r = r_p @ _quat_to_mat(q[qi + 3:qi + 7])
                if delta is None:
                    jr = r
                else:
                    d = delta[vi + 3:vi + 6]
                    r = r @ _exp_so3(d)
                    jr = r @ _so3_right_jacobian(d)
                for k in range(3):
                    axes[vi + k] = r_p[:, k]        # parent-frame slide
                    origins[vi + k] = p
                    axes[vi + 3 + k] = jr[:, k]
                    origins[vi + 3 + k] = p
            else:
                raise ValueError(f"unknown joint type {t!r}")
            rots.append(r)
            poss.append(p)
    return (jnp.stack(rots), jnp.stack(poss),
            jnp.stack(axes), jnp.stack(origins))


def forward_kinematics(model: ChainModel, q: jax.Array):
    """World-frame pose of every body frame.

    Returns (rot [n,3,3] body->world, pos [n,3] frame origins).
    """
    rots, poss, _, _ = _fk_dofs(model, q)
    return rots, poss


def site_position(model: ChainModel, q: jax.Array) -> jax.Array:
    """World position of the end-effector site (reference 'finger' site)."""
    rots, poss = forward_kinematics(model, q)
    return poss[model.site_body] + rots[model.site_body] @ model.site_pos


def _mass_matrix_at(model: ChainModel, q: jax.Array,
                    delta: Optional[jax.Array]) -> jax.Array:
    """Joint-space inertia M [nv, nv] via velocity-Jacobian composition
    at configuration q ⊕ δ.

    For each body i with world COM c_i: rotational DOF k contributes
    velocity column a_k × (c_i − p_k) and angular column a_k;
    translational DOF k contributes velocity column a_k. Triangularity is
    a static mask (compiler-friendly — no ragged loops).
    """
    n = model.n_joints
    nv = model.nv
    prec = jax.lax.Precision.HIGHEST
    rots, poss, axes_w, origins = _fk_dofs(model, q, delta)
    coms_w = poss + jnp.einsum("nij,nj->ni", rots, model.com,
                               precision=prec)                   # [n,3]

    mask = jnp.asarray(model.ancestor_mask(), q.dtype)           # [n,nv]
    rot = jnp.asarray(_rot_dof_mask(model.joint_types),
                      q.dtype)[None, :, None]                    # [1,nv,1]
    arm = coms_w[:, None, :] - origins[None, :, :]               # [n,nv,3]
    axes_b = jnp.broadcast_to(axes_w[None, :, :], (n, nv, 3))
    jv = (rot * jnp.cross(axes_b, arm) + (1.0 - rot) * axes_b) \
        * mask[..., None]
    jw = rot * axes_b * mask[..., None]

    iw = jnp.einsum("nab,nbc,ndc->nad", rots, model.inertia, rots,
                    precision=prec)                              # [n,3,3]
    m_lin = jnp.einsum("n,nka,nla->kl", model.mass, jv, jv,
                       precision=prec)
    m_ang = jnp.einsum("nka,nab,nlb->kl", jw, iw, jw, precision=prec)
    return m_lin + m_ang


def mass_matrix(model: ChainModel, q: jax.Array) -> jax.Array:
    return _mass_matrix_at(model, q, None)


def kinetic_energy(model: ChainModel, q: jax.Array, qd: jax.Array) -> jax.Array:
    return 0.5 * qd @ mass_matrix(model, q) @ qd


def _potential_energy_at(model: ChainModel, q: jax.Array,
                         delta: Optional[jax.Array]) -> jax.Array:
    rots, poss, _, _ = _fk_dofs(model, q, delta)
    coms_w = poss + jnp.einsum("nij,nj->ni", rots, model.com,
                               precision=jax.lax.Precision.HIGHEST)
    return -jnp.sum(model.mass * (coms_w @ model.gravity))


def potential_energy(model: ChainModel, q: jax.Array) -> jax.Array:
    """V(q) = -Σ m_i g·c_i(q) (zero when model.gravity is zero, as in the
    reference arm model: sawyer.xml <option gravity="0 0 0">)."""
    return _potential_energy_at(model, q, None)


def bias_forces(model: ChainModel, q: jax.Array, qd: jax.Array) -> jax.Array:
    """Coriolis/centrifugal/gyroscopic + gravity generalized forces.

    Tangent-space Lagrangian identity: with local coordinates δ (additive
    for scalar joints, right exp-map for rotation blocks — whose tangent
    mass matrix carries J_r(δ)),
        bias = (∂M_t/∂δ · q̇) q̇ − ∇_δ KE + ∇_δ V   at δ = 0,
    computed as a jvp of δ ↦ M_t(q, δ) q̇ along q̇ plus gradients of the
    energies — exact (Boltzmann-Hamel in quasi-coordinates; reduces to
    the classic Ṁq̇ − ∇_q L for scalar chains, and to Euler's ω × Iω for
    a free body), and always consistent with the mass matrix.
    """
    zero = jnp.zeros((model.nv,), q.dtype)
    mdot_qd = jax.jvp(lambda d: _mass_matrix_at(model, q, d) @ qd,
                      (zero,), (qd,))[1]

    def lagrangian(d):
        ke = 0.5 * qd @ _mass_matrix_at(model, q, d) @ qd
        return ke - _potential_energy_at(model, q, d)

    return mdot_qd - jax.grad(lagrangian)(zero)


def point_force_to_generalized(model: ChainModel, q: jax.Array,
                               body: int, point_local: jax.Array,
                               force_world: jax.Array) -> jax.Array:
    """Generalized force J_pᵀ f for a world-frame force applied at a
    body-local point — via vjp of the point's world position IN TANGENT
    COORDINATES (the AD equivalent of building the point Jacobian, valid
    for quaternion joints too). Used by contact and drag models."""
    def world_point(delta):
        rots, poss, _, _ = _fk_dofs(model, q, delta)
        return poss[body] + rots[body] @ point_local

    zero = jnp.zeros((model.nv,), q.dtype)
    _, vjp = jax.vjp(world_point, zero)
    return vjp(force_world)[0]


def point_state(model: ChainModel, q: jax.Array, qd: jax.Array,
                body: int, point_local: jax.Array):
    """(world position, world velocity) of a body-local point — velocity
    via jvp in TANGENT coordinates along q̇ (valid for quaternion joints,
    where a jvp over qpos itself would be dimension-mismatched). The
    contact models' kinematic front end."""
    def world_point(delta):
        rots, poss, _, _ = _fk_dofs(model, q, delta)
        return poss[body] + rots[body] @ point_local

    zero = jnp.zeros((model.nv,), q.dtype)
    return jax.jvp(world_point, (zero,), (qd,))


def points_frame(model: ChainModel, q: jax.Array, qd: jax.Array,
                 bodies: Tuple[int, ...], points_local: jax.Array):
    """Batched kinematic front/back end for contact models.

    For K body-local points (static `bodies` tuple, `points_local` [K,3])
    returns (pos [K,3], vel [K,3], apply) where apply(forces [K,3]) ->
    generalized force [nv] = Σ_k J_kᵀ f_k. One jax.linearize of the
    batched point kinematics provides the primal positions, every point
    velocity (the linear map applied to q̇), and — via linear_transpose —
    the force scatter, so the whole contact pass costs ONE trace of the
    kinematics regardless of K."""
    idx = np.asarray(bodies)

    def world(delta):
        rots, poss, _, _ = _fk_dofs(model, q, delta)
        return poss[idx] + jnp.einsum("kij,kj->ki", rots[idx], points_local)

    zero = jnp.zeros((model.nv,), q.dtype)
    # linearize once: the primal FK, the jvp (point velocities), and the
    # transposed linear map (force scatter) all come from ONE trace of
    # `world` instead of separate jvp + vjp retraces.
    pos, lin = jax.linearize(world, zero)
    vel = lin(qd)
    scatter = jax.linear_transpose(lin, zero)
    return pos, vel, lambda forces: scatter(forces)[0]


def integrate_qpos(model: ChainModel, q: jax.Array, qd: jax.Array,
                   dt: float) -> jax.Array:
    """Retract q by dt·q̇: additive for scalar joints and free-joint
    translations, quaternion right-multiplication by exp(ω dt) for
    rotation blocks (body-frame angular velocity — MuJoCo semantics)."""
    qoff, voff = model.q_offsets, model.v_offsets
    parts = []
    for i, t in enumerate(model.joint_types):
        qi, vi = qoff[i], voff[i]
        if t in ("hinge", "slide"):
            parts.append((q[qi] + dt * qd[vi])[None])
        elif t == "ball":
            quat = _quat_mul(q[qi:qi + 4], _exp_quat(dt * qd[vi:vi + 3]))
            parts.append(quat / jnp.linalg.norm(quat))
        else:  # free
            parts.append(q[qi:qi + 3] + dt * qd[vi:vi + 3])
            quat = _quat_mul(q[qi + 3:qi + 7],
                             _exp_quat(dt * qd[vi + 3:vi + 6]))
            parts.append(quat / jnp.linalg.norm(quat))
    return jnp.concatenate(parts)


def _scalar_stiffness_force(model: ChainModel, q: jax.Array) -> jax.Array:
    """-k q restoring force on scalar joints, scattered into v-space."""
    qi, vi = _scalar_maps(model.joint_types)
    if len(qi) == 0:
        return jnp.zeros((model.nv,), q.dtype)
    force = jnp.zeros((model.nv,), q.dtype)
    return force.at[vi].set(-model.stiffness[vi] * q[qi])


def _project_limits(model: ChainModel, q: jax.Array, qd: jax.Array):
    """Clamp scalar-joint positions to their range and zero the outward
    velocity; quaternion blocks are unlimited (normalized in the
    integrator)."""
    qi, vi = _scalar_maps(model.joint_types)
    if len(qi) == 0:
        return q, qd
    qs = q[qi]
    clamped = jnp.clip(qs, model.qpos_low[qi], model.qpos_high[qi])
    q = q.at[qi].set(clamped)
    qd = qd.at[vi].set(jnp.where(clamped == qs, qd[vi], 0.0))
    return q, qd


def step(model: ChainModel, q: jax.Array, qd: jax.Array, ctrl: jax.Array,
         n_substeps: int = 1, ext_force_fn=None) -> Tuple[jax.Array, jax.Array]:
    """Advance (q [nq], q̇ [nv]) by n_substeps of dt under motor controls
    (ctrl [nv]).

    Mirrors MuJoCo Euler + frame_skip: τ = gear·ctrl; implicit damping
    folded into the LHS; armature on the M diagonal. ext_force_fn(model,
    q, qd) -> generalized force [nv] adds environment forces (fluid
    drag, contact) per substep.
    """
    tau = model.gear * ctrl

    def sub(carry, _):
        q, qd = carry
        m = mass_matrix(model, q)
        m = m + jnp.diag(model.armature + model.dt * model.damping)
        rhs = (tau - bias_forces(model, q, qd) - model.damping * qd
               - model.frictionloss * jnp.tanh(qd / 0.02)
               + _scalar_stiffness_force(model, q))
        if ext_force_fn is not None:
            rhs = rhs + ext_force_fn(model, q, qd)
        qacc = jax.scipy.linalg.cho_solve(
            (jnp.linalg.cholesky(m), True), rhs)
        qd = qd + model.dt * qacc
        q = integrate_qpos(model, q, qd, model.dt)
        q, qd = _project_limits(model, q, qd)
        return (q, qd), None

    (q, qd), _ = jax.lax.scan(sub, (q, qd), None, length=n_substeps)
    return q, qd


# ---------------------------------------------------------------------------
# Model construction from geom primitives (MuJoCo inertiafromgeom semantics,
# density 1000 kg/m^3).
# ---------------------------------------------------------------------------

_DENSITY = 1000.0


def sphere_geom(radius: float, pos=(0.0, 0.0, 0.0)):
    m = _DENSITY * 4.0 / 3.0 * np.pi * radius ** 3
    i = 0.4 * m * radius ** 2
    return dict(mass=m, com=np.asarray(pos, np.float64),
                inertia=np.diag([i, i, i]))


def box_geom(half_extents, pos=(0.0, 0.0, 0.0)):
    hx, hy, hz = half_extents
    m = _DENSITY * 8.0 * hx * hy * hz
    return dict(mass=m, com=np.asarray(pos, np.float64),
                inertia=np.diag([m / 3.0 * (hy ** 2 + hz ** 2),
                                 m / 3.0 * (hx ** 2 + hz ** 2),
                                 m / 3.0 * (hx ** 2 + hy ** 2)]))


def capsule_geom(radius: float, fromto):
    """Capsule between two points: cylinder + two hemispherical caps.

    Exact rigid-body values (the hemisphere perpendicular term reduces to
    0.4 r^2 + h^2 + 0.75 r h about the capsule center).
    """
    a = np.asarray(fromto[:3], np.float64)
    b = np.asarray(fromto[3:], np.float64)
    center = 0.5 * (a + b)
    d = b - a
    length = np.linalg.norm(d)
    h = length / 2.0
    axis = d / length if length > 0 else np.array([0.0, 0.0, 1.0])

    m_cyl = _DENSITY * np.pi * radius ** 2 * length
    m_sph = _DENSITY * 4.0 / 3.0 * np.pi * radius ** 3
    m = m_cyl + m_sph
    i_ax = m_cyl * radius ** 2 / 2.0 + m_sph * 0.4 * radius ** 2
    i_perp = (m_cyl * (radius ** 2 / 4.0 + length ** 2 / 12.0)
              + m_sph * (0.4 * radius ** 2 + h ** 2 + 0.75 * radius * h))

    # Rotate the axis-aligned inertia into the body frame.
    z = np.array([0.0, 0.0, 1.0])
    v = np.cross(z, axis)
    c = float(z @ axis)
    if np.linalg.norm(v) < 1e-12:
        r = np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    else:
        k = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        r = np.eye(3) + k + k @ k / (1.0 + c)
    i_local = np.diag([i_perp, i_perp, i_ax])
    return dict(mass=m, com=center, inertia=r @ i_local @ r.T)


def combine_geoms(geoms: Sequence[dict]):
    """Merge geoms into one (mass, com, inertia-about-com) body."""
    mass = sum(g["mass"] for g in geoms)
    com = sum(g["mass"] * g["com"] for g in geoms) / mass
    inertia = np.zeros((3, 3))
    for g in geoms:
        d = g["com"] - com
        shift = g["mass"] * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
        inertia = inertia + g["inertia"] + shift
    return mass, com, inertia


def build_chain(bodies: Sequence[dict], dt: float, site_body: int,
                site_pos, gravity=(0.0, 0.0, 0.0)) -> ChainModel:
    """Assemble a ChainModel from per-body dicts:
    {pos, axis, geoms, damping, armature, gear, range, type, parent}.
    type: 'hinge' (default), 'slide', 'ball', or 'free'; parent: body
    index (default i-1, -1 = world). Bodies with geoms=[] are massless
    virtual links (free-base decomposition). Per-body scalar
    damping/armature/gear/stiffness broadcast over the joint's velocity
    DOF; `range` applies to scalar joints only.
    """
    n = len(bodies)
    mass = np.zeros(n)
    com = np.zeros((n, 3))
    inertia = np.zeros((n, 3, 3))
    for i, b in enumerate(bodies):
        if b.get("geoms"):
            mass[i], com[i], inertia[i] = combine_geoms(b["geoms"])
        else:
            # Massless virtual body: tiny regularizing mass keeps the
            # joint-space inertia positive definite (armature usually
            # covers the diagonal anyway).
            mass[i] = 1e-6
            inertia[i] = 1e-9 * np.eye(3)

    types = tuple(b.get("type", "hinge") for b in bodies)
    armature, damping, stiffness, gear, floss = [], [], [], [], []
    qlow, qhigh = [], []
    for i, b in enumerate(bodies):
        nvi, nqi = _JOINT_NV[types[i]], _JOINT_NQ[types[i]]
        armature += [b.get("armature", 0.0)] * nvi
        damping += [b.get("damping", 0.0)] * nvi
        stiffness += [b.get("stiffness", 0.0)] * nvi
        gear += [b.get("gear", 1.0)] * nvi
        floss += [b.get("frictionloss", 0.0)] * nvi
        if types[i] in ("hinge", "slide"):
            lo, hi = b["range"]
            qlow.append(lo)
            qhigh.append(hi)
        else:
            qlow += [-1e9] * nqi
            qhigh += [1e9] * nqi

    f32 = lambda x: jnp.asarray(np.asarray(x), jnp.float32)
    return ChainModel(
        joint_axis=f32([b.get("axis", (0, 0, 1)) for b in bodies]),
        body_pos=f32([b["pos"] for b in bodies]),
        mass=f32(mass), com=f32(com), inertia=f32(inertia),
        armature=f32(armature), damping=f32(damping),
        frictionloss=f32(floss),
        stiffness=f32(stiffness), gear=f32(gear),
        qpos_low=f32(qlow), qpos_high=f32(qhigh),
        gravity=f32(gravity),
        site_pos=f32(site_pos),
        parent=tuple(int(b.get("parent", i - 1))
                     for i, b in enumerate(bodies)),
        joint_types=types,
        dt=float(dt), site_body=int(site_body))
