"""Fused Pallas rollout kernel for forest models: scalar-joint chains
plus root-level FREE (quaternion) bodies with penalty contact.

This generalizes `ops/pallas_chain.py` (scalar-joint arms) to the
hand-manipulation family: a kinematic FOREST of hinge/slide trees (the
digits, an optional slide arm) plus free rigid bodies (the pen / ball /
hammer) whose only coupling to the actuated trees is the explicit
contact force — exactly `engine.chain.step` with an `ext_force_fn`
(envs/pen.py:_ext_forces and friends), fused into ONE kernel.

WHY: the XLA path runs every substep as many kernels over [N, ...]
arrays and sends every per-particle FK/mass/contact intermediate
through device memory between them. Here each GPU thread keeps one
particle's q, qd and all intermediates in registers for the whole
H-step rollout: device-memory traffic is noise-in + costs-out.

The physics exploits the forest block structure the XLA path cannot:
the joint-space mass matrix is BLOCK-DIAGONAL (one block per tree —
digits never couple through inertia, only through contact forces), so
the nv x nv Cholesky factorizes into five 4x4 solves plus per-free-body
closed forms (M_lin = (m + reg) I; M_ang = I_body + reg I, constant in
body coordinates because the tangent parameterization is
right-trivialized — engine/chain.py:395-426).

Free bodies must be roots (parent -1) and childless. With com at the
joint origin (pen capsule, relocate ball) the dynamics decouple into the
exact Euler equations
    m v̇ = f_ext + m g,      I_b ω̇ + ω x I_b ω = τ_ext(body)
; with an OFFSET com (the hammer's weighted head) the kernel solves the
coupled symmetric 6x6 system in (world-linear, body-angular) tangent
coordinates,
    [[ (m+reg) I , -m R [c]x ],  [[v̇],  = [[Q_v - m R(ω x (ω x c))],
     [ m [c]x R^T, I_o + reg I]]  [ω̇]]    [Q_ω - m c x (ω x (ω x c))
                                                 - ω x I_c ω]]
(I_o = I_c - m [c]x[c]x, gravity entering Q_ω as c x R^T(m g)) — the
same dynamics `engine.chain.bias_forces`' tangent-space Lagrangian
produces for a free joint (validated against it in
tests/test_pallas_forest.py, and the engine itself against the C++
floating-base RNEA oracle).

Contact callbacks are written in the kernel's lane dialect (a 3-vector
is a python list of three [block_n] arrays): the generic builder
computes every contact point's world position/velocity and hands them
to an env-supplied `force_fn`; the returned per-point forces are
scattered through the point Jacobians (hinge/slide: a_d x (p - o_d);
free: tau_lin = f, tau_ang = l x R^T f — the transpose of the
right-trivialized point velocity map, engine/chain.py:504-528).

Matches `engine.chain.step` + env cost to f32 tolerance; the kernel is
compiled through Pallas's Triton route on the GPU and runs in the
Pallas interpreter on the CPU, where the parity tests run
(tests/test_pallas_forest.py).
"""
from __future__ import annotations

from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .kernel_path import rollout_call
from .pallas_chain import (_const_vec, _mm, _mtv, _mv, _rodrigues, _vadd,
                           _vcross, _vdot, _vscale, _vsub, _world_inertia)

# ---------------------------------------------------------------------------
# Lane-dialect quaternion / contact helpers
# ---------------------------------------------------------------------------


def _quat_to_mat(q):
    """Unit quaternion [w,x,y,z] (4 lane arrays) -> row-major 3x3."""
    w, x, y, z = q
    return [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]


def _quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return [aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw]


def _exp_quat(w):
    """Axis-angle lane vector -> unit quaternion exp(w/2), the small-angle
    series matching engine/chain.py:283-292."""
    t2 = _vdot(w, w)
    small = t2 < np.float32(1e-8)
    safe = jnp.where(small, np.float32(1.0), t2)
    t = jnp.sqrt(safe)
    half = np.float32(0.5) * t
    sinc_half = jnp.where(small, np.float32(0.5) - t2 / np.float32(48.0),
                          jnp.sin(half) / t)
    cos_half = jnp.where(small, np.float32(1.0) - t2 / np.float32(8.0),
                         jnp.cos(half))
    return [cos_half] + _vscale(sinc_half, w)


def _vnorm(v, eps=0.0):
    return jnp.sqrt(_vdot(v, v) + np.float32(eps))


def _sf(x):
    """Scalar that is either a baked python float or a traced lane value
    (dyn-randomized geom radii ride the extras vector — the reference
    perturbs mj geom_size rows, gym_env_wrapper.py:392-400, and the
    kernel must keep its fast path under that perturbation)."""
    return np.float32(x) if isinstance(x, (int, float, np.floating)) else x


def force_along(n, overlap, rel_vel, kp, kd, mu, v_slip=0.02):
    """Lane-dialect twin of envs/contact.py:force_along (spring-damper
    normal + saturated Coulomb friction, branch-free)."""
    vn = _vdot(rel_vel, n)
    fn = jnp.where(overlap > 0.0,
                   jnp.maximum(kp * overlap - kd * vn, np.float32(0.0)),
                   np.float32(0.0))
    vt = _vsub(rel_vel, _vscale(vn, n))
    scale = -mu * fn / (_vnorm(vt) + np.float32(v_slip))
    return _vadd(_vscale(fn, n), _vscale(scale, vt))


def penalty_force(sep, rel_vel, overlap, kp, kd, mu, v_slip=0.02):
    n = _vscale(np.float32(1.0) / (_vnorm(sep) + np.float32(1e-9)), sep)
    return force_along(n, overlap, rel_vel, kp, kd, mu, v_slip)


def sphere_plane_force(p, v, r_sphere, kp, kd, mu, z_plane=0.0):
    """envs/contact.py:69-78: fixed +z normal."""
    overlap = _sf(r_sphere) - (p[2] - np.float32(z_plane))
    zero = jnp.zeros_like(p[0])
    one = jnp.ones_like(p[0])
    return force_along([zero, zero, one], overlap, v, kp, kd, mu)


def closest_on_segment(p, a, b):
    d = _vsub(b, a)
    t = jnp.clip(_vdot(_vsub(p, a), d) / (_vdot(d, d) + np.float32(1e-12)),
                 0.0, 1.0)
    return _vadd(a, _vscale(t, d)), t


def sphere_segment_force(p, v, r_sphere, seg_a, seg_b, v_a, v_b, r_seg,
                         kp, kd, mu):
    """envs/contact.py:51-66 — returns (force on the sphere, lerp t)."""
    c, t = closest_on_segment(p, seg_a, seg_b)
    v_c = _vadd(_vscale(1.0 - t, v_a), _vscale(t, v_b))
    sep = _vsub(p, c)
    overlap = _sf(r_sphere) + _sf(r_seg) - _vnorm(sep)
    return penalty_force(sep, _vsub(v, v_c), overlap, kp, kd, mu), t


def segment_segment_closest(a0, a1, b0, b1):
    d1, d2, r = _vsub(a1, a0), _vsub(b1, b0), _vsub(a0, b0)
    a = _vdot(d1, d1) + np.float32(1e-12)
    e = _vdot(d2, d2) + np.float32(1e-12)
    b = _vdot(d1, d2)
    c, f = _vdot(d1, r), _vdot(d2, r)
    denom = a * e - b * b
    s = jnp.clip(jnp.where(denom > np.float32(1e-12),
                           (b * f - c * e) / denom, np.float32(0.0)),
                 0.0, 1.0)
    t = jnp.clip((b * s + f) / e, 0.0, 1.0)
    s = jnp.clip((b * t - c) / a, 0.0, 1.0)
    return _vadd(a0, _vscale(s, d1)), _vadd(b0, _vscale(t, d2)), s, t


def capsule_capsule_force(a0, a1, v_a0, v_a1, r_a, b0, b1, r_b,
                          kp, kd, mu):
    """envs/contact.py:97-106 — moving capsule A vs STATIC capsule B."""
    p_a, p_b, s, _ = segment_segment_closest(a0, a1, b0, b1)
    v = _vadd(_vscale(1.0 - s, v_a0), _vscale(s, v_a1))
    sep = _vsub(p_a, p_b)
    overlap = _sf(r_a) + _sf(r_b) - _vnorm(sep)
    return penalty_force(sep, v, overlap, kp, kd, mu), s


def sphere_sphere_force(p_a, v_a, r_a, p_b, v_b, r_b, kp, kd, mu):
    sep = _vsub(p_a, p_b)
    overlap = _sf(r_a) + _sf(r_b) - _vnorm(sep)
    return penalty_force(sep, _vsub(v_a, v_b), overlap, kp, kd, mu)


# ---------------------------------------------------------------------------
# Model constants: forest topology with scalar trees + root free bodies
# ---------------------------------------------------------------------------


def _forest_consts(model) -> dict:
    """Bake the ChainModel's static data; classify bodies into scalar
    trees and free roots. Raises for unsupported topology (ball joints,
    non-root free bodies, free bodies with children or offset com)."""
    types = list(model.joint_types)
    parent = [int(p) for p in model.parent]
    n = len(types)
    jtype = []
    for i, t in enumerate(types):
        if t == "hinge":
            jtype.append(0)
        elif t == "slide":
            jtype.append(1)
        elif t == "free":
            if parent[i] >= 0:
                raise ValueError("free bodies must be forest roots")
            if any(parent[k] == i for k in range(n)):
                raise ValueError("free bodies must be childless")
            jtype.append(2)
        else:
            raise ValueError(f"pallas forest rollout: unsupported {t!r}")

    # connected components over scalar bodies
    tree_of = [-1] * n
    trees: List[List[int]] = []
    for i in range(n):
        if jtype[i] == 2:
            continue
        if parent[i] < 0:
            tree_of[i] = len(trees)
            trees.append([i])
        else:
            tree_of[i] = tree_of[parent[i]]
            trees[tree_of[i]].append(i)

    qoff = [int(o) for o in model.q_offsets]
    voff = [int(o) for o in model.v_offsets]
    return dict(
        n=n, parent=parent, jtype=jtype, trees=trees, tree_of=tree_of,
        qoff=qoff, voff=voff, nq=int(model.nq), nv=int(model.nv),
        free=[i for i in range(n) if jtype[i] == 2],
        axis=np.asarray(model.joint_axis, np.float32),
        body_pos=np.asarray(model.body_pos, np.float32),
        mass=np.asarray(model.mass, np.float32),
        com=np.asarray(model.com, np.float32),
        inertia=np.asarray(model.inertia, np.float32),
        armature=np.asarray(model.armature, np.float32),
        damping=np.asarray(model.damping, np.float32),
        frictionloss=np.asarray(model.frictionloss, np.float32),
        stiffness=np.asarray(model.stiffness, np.float32),
        gear=np.asarray(model.gear, np.float32),
        qlow=np.asarray(model.qpos_low, np.float32),
        qhigh=np.asarray(model.qpos_high, np.float32),
        gravity=np.asarray(model.gravity, np.float32),
        dt=float(model.dt),
    )


# ---------------------------------------------------------------------------
# Block state: dict body index -> per-joint lane state
#   scalar body i: q[i] = lane array, qd[i] = lane array
#   free body i:   q[i] = (pos 3-vec, quat 4-list), qd[i] = (v 3, w_body 3)
# ---------------------------------------------------------------------------


def _fk(mc, q):
    """FK over the forest. Returns (rots, poss, axes, origins) lists per
    body; for free bodies axes/origins are None (their Jacobian is
    closed-form in the scatter)."""
    n = mc["n"]
    rots, poss, axes, origins = [], [], [], []
    eye = [np.float32(1), np.float32(0), np.float32(0),
           np.float32(0), np.float32(1), np.float32(0),
           np.float32(0), np.float32(0), np.float32(1)]
    for i in range(n):
        pi = mc["parent"][i]
        r_p = eye if pi < 0 else rots[pi]
        p_p = [np.float32(0)] * 3 if pi < 0 else poss[pi]
        bp = _const_vec(mc["body_pos"][i])
        jt = mc["jtype"][i]
        if jt == 0:      # hinge
            p = _vadd(p_p, _mv(r_p, bp))
            r = _mm(r_p, _rodrigues(mc["axis"][i], q[i]))
            axes.append(_mv(r, _const_vec(mc["axis"][i])))
            origins.append(p)
        elif jt == 1:    # slide
            aw = _mv(r_p, _const_vec(mc["axis"][i]))
            p = _vadd(_vadd(p_p, _mv(r_p, bp)), _vscale(q[i], aw))
            r = r_p
            axes.append(aw)
            origins.append(p)
        else:            # free root: p = body_pos + trans, R = quat mat
            pos, quat = q[i]
            p = _vadd(bp, pos)
            r = _quat_to_mat(quat)
            axes.append(None)
            origins.append(None)
        rots.append(r)
        poss.append(p)
    return rots, poss, axes, origins


def _ancestor_dofs(mc, i):
    out = []
    k = i
    while k >= 0:
        out.append(k)
        k = mc["parent"][k]
    return out[::-1]


def _tree_mass_and_bias(mc, tree, rots, poss, axes, origins, qd):
    """Mass-matrix entries (upper-tri dict over tree body indices) and
    RNEA bias for ONE scalar tree — pallas_chain.py:_mass_and_bias
    restricted to the tree (the forest mass matrix is block-diagonal)."""
    g = _const_vec(mc["gravity"])
    m_out = {}
    iws = {}
    for i in tree:
        ci = _vadd(poss[i], _mv(rots[i], _const_vec(mc["com"][i])))
        iw = _world_inertia(rots[i], mc["inertia"][i])
        iws[i] = iw
        dofs = _ancestor_dofs(mc, i)
        jv, jw = {}, {}
        for d in dofs:
            if mc["jtype"][d] == 0:
                jv[d] = _vcross(axes[d], _vsub(ci, origins[d]))
                jw[d] = axes[d]
            else:
                jv[d] = axes[d]
                jw[d] = None
        mass_i = np.float32(mc["mass"][i])
        # hoist the per-dof products out of the pair loop: m*jv and
        # I_w*jw are O(depth) here vs O(depth^2) inline — on the 23-DOF
        # arm+hand trees this more than halves the kernel's op count
        mjv = {d: _vscale(mass_i, jv[d]) for d in dofs}
        iwjw = {d: _mv(iw, jw[d]) for d in dofs if jw[d] is not None}
        for ai, a in enumerate(dofs):
            for b in dofs[ai:]:
                term = _vdot(jv[a], mjv[b])
                if jw[a] is not None and jw[b] is not None:
                    term = term + _vdot(jw[a], iwjw[b])
                m_out[(a, b)] = m_out.get((a, b), 0.0) + term
    # forward velocity/acceleration recursion at qdd = 0
    w, dw, vo, ao, fc, nc = {}, {}, {}, {}, {}, {}
    zero = [jnp.zeros_like(qd[tree[0]])] * 3
    for i in tree:
        pi = mc["parent"][i]
        wp = w[pi] if pi >= 0 else zero
        dwp = dw[pi] if pi >= 0 else zero
        vp = vo[pi] if pi >= 0 else zero
        ap = ao[pi] if pi >= 0 else zero
        pp = poss[pi] if pi >= 0 else [np.float32(0)] * 3
        r = _vsub(poss[i], pp)
        if mc["jtype"][i] == 0:
            wj, vj = _vscale(qd[i], axes[i]), zero
        else:
            wj, vj = zero, _vscale(qd[i], axes[i])
        w[i] = _vadd(wp, wj)
        dw[i] = _vadd(dwp, _vcross(wp, wj))
        vo[i] = _vadd(_vadd(vp, _vcross(wp, r)), vj)
        ao[i] = _vadd(
            _vadd(ap, _vcross(dwp, r)),
            _vadd(_vcross(wp, _vcross(wp, r)),
                  _vscale(np.float32(2.0), _vcross(wp, vj))))
        rc = _mv(rots[i], _const_vec(mc["com"][i]))
        acc_c = _vadd(ao[i], _vadd(_vcross(dw[i], rc),
                                   _vcross(w[i], _vcross(w[i], rc))))
        fc[i] = _vscale(np.float32(mc["mass"][i]), _vsub(acc_c, g))
        nc[i] = _vadd(_mv(iws[i], dw[i]), _vcross(w[i], _mv(iws[i], w[i])))
    bias = {}
    fa = {i: [jnp.zeros_like(qd[tree[0]])] * 3 for i in tree}
    na = {i: [jnp.zeros_like(qd[tree[0]])] * 3 for i in tree}
    for i in reversed(tree):
        pi = mc["parent"][i]
        rc = _mv(rots[i], _const_vec(mc["com"][i]))
        f = _vadd(fc[i], fa[i])
        nmom = _vadd(_vadd(nc[i], _vcross(rc, fc[i])), na[i])
        bias[i] = (_vdot(axes[i], nmom) if mc["jtype"][i] == 0
                   else _vdot(axes[i], f))
        if pi >= 0:
            fa[pi] = _vadd(fa[pi], f)
            na[pi] = _vadd(na[pi],
                           _vadd(nmom, _vcross(_vsub(poss[i], poss[pi]), f)))
    return m_out, bias


def _tree_chol_solve(tree, m_out, rhs, anc=None):
    """Unrolled Cholesky solve of one tree's SPD block (dict-indexed by
    tree body order). `anc[i]` = i's ordered ancestor list (root first,
    excluding i): for a tree-topology mass matrix ordered
    ancestors-first the factor has NO fill-in outside ancestor pairs
    (the classic sparse-LTDL property MuJoCo exploits), so branched
    hand trees cost O(sum path^2), not O(n^3). anc=None solves dense
    (the free-body 6x6 block)."""
    idx = list(tree)
    if anc is None:
        anc = {i: idx[:a] for a, i in enumerate(idx)}
    low, y, x = {}, {}, {}
    for i in idx:
        for j in anc[i]:
            s = m_out.get((j, i), m_out.get((i, j)))
            for k in anc[j]:
                s = s - low[(i, k)] * low[(j, k)]
            low[(i, j)] = s / low[(j, j)]
        s = m_out[(i, i)]
        for k in anc[i]:
            s = s - low[(i, k)] * low[(i, k)]
        low[(i, i)] = jnp.sqrt(s)
    for i in idx:
        s = rhs[i]
        for k in anc[i]:
            s = s - low[(i, k)] * y[k]
        y[i] = s / low[(i, i)]
    for a in range(len(idx) - 1, -1, -1):
        i = idx[a]
        s = y[i]
        for k in idx[a + 1:]:
            if (k, i) in low:
                s = s - low[(k, i)] * x[k]
        x[i] = s / low[(i, i)]
    return x


def _chol3_solve(m, rhs):
    """3x3 SPD solve (row-major lane matrix) — the free-body angular
    block I_b + reg I (constant but per-lane math is identical)."""
    l00 = jnp.sqrt(m[0])
    l10, l20 = m[3] / l00, m[6] / l00
    l11 = jnp.sqrt(m[4] - l10 * l10)
    l21 = (m[7] - l20 * l10) / l11
    l22 = jnp.sqrt(m[8] - l20 * l20 - l21 * l21)
    y0 = rhs[0] / l00
    y1 = (rhs[1] - l10 * y0) / l11
    y2 = (rhs[2] - l20 * y0 - l21 * y1) / l22
    x2 = y2 / l22
    x1 = (y1 - l21 * x2) / l11
    x0 = (y0 - l10 * x1 - l20 * x2) / l00
    return [x0, x1, x2]


# ---------------------------------------------------------------------------
# Contact plumbing: world state of declared points + force scatter
# ---------------------------------------------------------------------------


def _point_states(mc, points, rots, poss, axes, origins, qd):
    """(pos, vel) lane vectors for each (body, local) contact point,
    plus the per-point scalar-joint Jacobian columns (reused verbatim by
    `_scatter_forces` — the J of v = J qd IS the J of tau = J^T f)."""
    out, jacs = [], []
    for body, local in points:
        lw = _mv(rots[body], _const_vec(local))
        p = _vadd(poss[body], lw)
        if mc["jtype"][body] == 2:
            v_lin, w_b = qd[body]
            v = _vadd(v_lin, _mv(rots[body], _vcross(w_b,
                                                     _const_vec(local))))
            jacs.append(None)
        else:
            v = [jnp.zeros_like(qd[body])] * 3
            jac = {}
            for d in _ancestor_dofs(mc, body):
                if mc["jtype"][d] == 0:
                    jv = _vcross(axes[d], _vsub(p, origins[d]))
                else:
                    jv = axes[d]
                jac[d] = jv
                v = _vadd(v, _vscale(qd[d], jv))
            jacs.append(jac)
        out.append((p, v))
    return out, jacs


def _scatter_forces(mc, points, forces, jacs, rots,
                    tau_scal, tau_free):
    """tau += J^T f for each contact point; mutates the per-body scalar
    torque dict and the free-body (f_lin, tau_body) dict. Free-body
    angular torque is l x R^T f — the transpose of the right-trivialized
    point-velocity map (engine/chain.py:504-528 via linear_transpose).
    Scalar-joint columns come precomputed from `_point_states`."""
    for (body, local), f, jac in zip(points, forces, jacs):
        if mc["jtype"][body] == 2:
            fl, tb = tau_free[body]
            rtf = _mtv(rots[body], f)   # R^T f
            tau_free[body] = (_vadd(fl, f),
                              _vadd(tb, _vcross(_const_vec(local), rtf)))
        else:
            for d, jv in jac.items():
                tau_scal[d] = tau_scal[d] + _vdot(jv, f)


# ---------------------------------------------------------------------------
# The kernel builder
# ---------------------------------------------------------------------------


def _substep(mc, q, qd, u, force_fn, extras, joint_torque_fn=None):
    """One semi-implicit Euler substep for the forest block — the
    engine.chain.step body (chain.py:576-604) with block-wise solves."""
    dt = np.float32(mc["dt"])
    rots, poss, axes, origins = _fk(mc, q)

    # contact: point states -> env force callback -> generalized forces
    tau_scal = {i: jnp.zeros_like(qd[i]) if mc["jtype"][i] != 2 else None
                for i in range(mc["n"])}
    tau_free = {}
    for i in mc["free"]:
        z = [jnp.zeros_like(qd[i][0][0])] * 3
        tau_free[i] = (z, list(z))
    if force_fn is not None:
        points = force_fn.points
        states, jacs = _point_states(mc, points, rots, poss, axes,
                                     origins, qd)
        forces = force_fn(states, extras, rots, poss)
        _scatter_forces(mc, points, forces, jacs, rots,
                        tau_scal, tau_free)
    if joint_torque_fn is not None:
        # env torques on scalar joints (gravity compensation on arm
        # slides/joints, nail dry friction, latch springs / strike-plate
        # gating — the `tau.at[dof].add(...)` tail of every _ext_forces
        # fn). The fk tuple (rots, poss, axes, origins) serves
        # configuration-dependent laws (panda gravity feedforward).
        for i, t in joint_torque_fn(q, qd, extras,
                                    (rots, poss, axes, origins)).items():
            tau_scal[i] = tau_scal[i] + t

    q_new, qd_new = {}, {}
    # scalar trees: block mass + RNEA bias + Cholesky
    for tree in mc["trees"]:
        m_out, bias = _tree_mass_and_bias(mc, tree, rots, poss, axes,
                                          origins, qd)
        rhs = {}
        for i in tree:
            vi = mc["voff"][i]
            arm = np.float32(mc["armature"][vi])
            damp = np.float32(mc["damping"][vi])
            stiff = np.float32(mc["stiffness"][vi])
            gear = np.float32(mc["gear"][vi])
            fl = np.float32(mc["frictionloss"][vi])
            m_out[(i, i)] = m_out[(i, i)] + (arm + dt * damp)
            rhs[i] = (gear * u.get(i, np.float32(0.0)) - bias[i]
                      - damp * qd[i] - stiff * q[i] + tau_scal[i])
            if fl != 0.0:   # smooth Coulomb (engine.chain.step law)
                rhs[i] = rhs[i] - fl * jnp.tanh(qd[i] * np.float32(50.0))
        anc = {i: _ancestor_dofs(mc, i)[:-1] for i in tree}
        acc = _tree_chol_solve(tree, m_out, rhs, anc)
        for i in tree:
            vi, qi = mc["voff"][i], mc["qoff"][i]
            qdn = qd[i] + dt * acc[i]
            qn = q[i] + dt * qdn
            lo = np.float32(mc["qlow"][qi])
            hi = np.float32(mc["qhigh"][qi])
            clamped = jnp.clip(qn, lo, hi)
            qd_new[i] = jnp.where(clamped == qn, qdn, np.float32(0.0))
            q_new[i] = clamped

    # free bodies: Euler equations in tangent (world-linear, body-angular)
    # coordinates — decoupled 3x3 solves at com == origin, the coupled
    # symmetric 6x6 otherwise (module docstring derivation)
    g = _const_vec(mc["gravity"])
    for i in mc["free"]:
        vi = mc["voff"][i]
        pos, quat = q[i]
        v_lin, w_b = qd[i]
        mass = np.float32(mc["mass"][i])
        f_lin, tau_b = tau_free[i]
        arm_l = np.float32(mc["armature"][vi])
        damp_l = np.float32(mc["damping"][vi])
        arm_a = np.float32(mc["armature"][vi + 3])
        damp_a = np.float32(mc["damping"][vi + 3])
        reg_l = arm_l + dt * damp_l
        reg_a = arm_a + dt * damp_a
        i_c = np.asarray(mc["inertia"][i], np.float64)
        com = np.asarray(mc["com"][i], np.float64)
        i_b = [np.float32(x) for x in i_c.reshape(-1)]
        if float(np.abs(com).max()) < 1e-9:
            # fast path: (m + reg) a = f_ext + m g - damp v;
            # (I_c + reg I) dw = tau_b - w x I_c w - damp w
            inv_ml = np.float32(1.0) / (mass + reg_l)
            acc_l = [(f_lin[k] + mass * g[k] - damp_l * v_lin[k]) * inv_ml
                     for k in range(3)]
            m_ang = list(i_b)
            for k in range(3):
                m_ang[4 * k] = m_ang[4 * k] + reg_a
            rhs_a = _vsub(_vsub(tau_b, _vcross(w_b, _mv(i_b, w_b))),
                          _vscale(damp_a, w_b))
            acc_a = _chol3_solve(m_ang, rhs_a)
        else:
            cv = _const_vec(np.asarray(com, np.float32))
            skew = np.array([[0, -com[2], com[1]],
                             [com[2], 0, -com[0]],
                             [-com[1], com[0], 0]], np.float64)
            i_o = np.asarray(i_c - float(mass) * skew @ skew, np.float32)
            # Q_v = f_ext + m g - damp_l v
            q_v = [f_lin[k] + mass * g[k] - damp_l * v_lin[k]
                   for k in range(3)]
            # Q_w = tau_ext(body) + c x R^T(m g) - damp_a w
            rtg = _mtv(rots[i], [mass * g[0], mass * g[1], mass * g[2]])
            q_w = _vadd(_vsub(tau_b, _vscale(damp_a, w_b)),
                        _vcross(cv, rtg))
            wwc = _vcross(w_b, _vcross(w_b, cv))
            rhs_v = _vsub(q_v, _vscale(mass, _mv(rots[i], wwc)))
            rhs_w = _vsub(_vsub(q_w, _vscale(mass, _vcross(cv, wwc))),
                          _vcross(w_b, _mv(i_b, w_b)))
            # B = -m R [c]x  (top-right block; per-lane via R)
            mskew = np.asarray(-float(mass) * skew, np.float32)
            r = rots[i]
            b_blk = [sum(r[3 * a + k] * np.float32(mskew[k, bb])
                         for k in range(3))
                     for a in range(3) for bb in range(3)]
            m_out, rhs = {}, {}
            for a in range(3):
                for bb in range(a, 3):
                    m_out[(a, bb)] = (np.float32(mass + reg_l)
                                      if a == bb else np.float32(0.0))
                for bb in range(3):
                    m_out[(a, 3 + bb)] = b_blk[3 * a + bb]
            for a in range(3):
                for bb in range(a, 3):
                    m_out[(3 + a, 3 + bb)] = np.float32(
                        i_o[a, bb] + (reg_a if a == bb else 0.0))
                rhs[a] = rhs_v[a]
                rhs[3 + a] = rhs_w[a]
            acc = _tree_chol_solve(list(range(6)), m_out, rhs)
            acc_l = [acc[0], acc[1], acc[2]]
            acc_a = [acc[3], acc[4], acc[5]]
        v_new = _vadd(v_lin, _vscale(dt, acc_l))
        w_new = _vadd(w_b, _vscale(dt, acc_a))
        pos_new = _vadd(pos, _vscale(dt, v_new))
        quat_new = _quat_mul(quat, _exp_quat(_vscale(dt, w_new)))
        norm = jnp.sqrt(quat_new[0] ** 2 + quat_new[1] ** 2
                        + quat_new[2] ** 2 + quat_new[3] ** 2)
        quat_new = [c / norm for c in quat_new]
        q_new[i] = (pos_new, quat_new)
        qd_new[i] = (v_new, w_new)
    return q_new, qd_new


def build_forest_rollout(model, n_substeps: int, act_bodies: Sequence[int],
                         force_fn, cost_fn, n_extras: int,
                         joint_torque_fn=None,
                         ulow: float = -1.0, uhigh: float = 1.0,
                         block_n: int = None):
    """Fused rollout builder for a forest ChainModel with contact.

    act_bodies: body indices receiving u[:, j] (order = action layout);
        every other DOF gets zero control (the hand envs actuate hand
        joints only — envs/pen.py:182-183).
    force_fn: lane-dialect contact assembly with a `.points` attribute
        (list of (body, local np[3]) pairs). Called as
        force_fn(states, extras, rots, poss) -> per-point force list;
        `states` pairs (pos, vel) per point.
    cost_fn(q, qd, rots, poss, extras) -> lane cost, evaluated on the
        post-step state (costs are negated rewards, rollout/engine.py).
    n_extras: number of scalar extras (e.g. the desired axis) packed
        after qpos/qvel in the state vector.
    joint_torque_fn: optional fn(q, qd, extras, fk) -> {body: lane
        torque} added to scalar-joint generalized forces each substep —
        the non-contact tail of the env's ext_force_fn (arm gravity
        compensation, nail dry friction, door latch/strike-plate laws).
        fk = (rots, poss, axes, origins) at the current q.

    block_n: particles per kernel program (kernel_path.block_size).

    Returns rollout(qpos [nq], qvel [nv], extras [n_extras],
                    mean [H, dA], noise [N, H, dA]) -> costs [N, H].
    """
    mc = _forest_consts(model)
    nq, nv = mc["nq"], mc["nv"]

    def kernel(state_ref, mean_ref, noise_ref, costs_ref):
        block = costs_ref.shape[-1:]

        def bc(x):
            return jnp.broadcast_to(x, block)

        q, qd = {}, {}
        for i in range(mc["n"]):
            qi, vi = mc["qoff"][i], mc["voff"][i]
            if mc["jtype"][i] == 2:
                pos = [bc(state_ref[0, qi + k]) for k in range(3)]
                quat = [bc(state_ref[0, qi + 3 + k]) for k in range(4)]
                v = [bc(state_ref[1, vi + k]) for k in range(3)]
                w = [bc(state_ref[1, vi + 3 + k]) for k in range(3)]
                q[i] = (pos, quat)
                qd[i] = (v, w)
            else:
                q[i] = bc(state_ref[0, qi])
                qd[i] = bc(state_ref[1, vi])
        extras = [bc(state_ref[2, k]) for k in range(n_extras)]

        def flatten(q, qd):
            flat = []
            for i in range(mc["n"]):
                if mc["jtype"][i] == 2:
                    flat += list(q[i][0]) + list(q[i][1])
                    flat += list(qd[i][0]) + list(qd[i][1])
                else:
                    flat.append(q[i])
                    flat.append(qd[i])
            return tuple(flat)

        def unflatten(flat):
            q, qd, k = {}, {}, 0
            for i in range(mc["n"]):
                if mc["jtype"][i] == 2:
                    q[i] = ([flat[k], flat[k + 1], flat[k + 2]],
                            [flat[k + 3], flat[k + 4], flat[k + 5],
                             flat[k + 6]])
                    qd[i] = ([flat[k + 7], flat[k + 8], flat[k + 9]],
                             [flat[k + 10], flat[k + 11], flat[k + 12]])
                    k += 13
                else:
                    q[i], qd[i] = flat[k], flat[k + 1]
                    k += 2
            return q, qd

        def outer(t, carry):
            q, qd = unflatten(carry)
            u = {}
            for j, body in enumerate(act_bodies):
                uj = mean_ref[t, j] + noise_ref[t, j]
                u[body] = jnp.clip(uj, np.float32(ulow), np.float32(uhigh))

            def inner(_, c):
                qi, qdi = unflatten(c)
                qn, qdn = _substep(mc, qi, qdi, u, force_fn, extras,
                                   joint_torque_fn)
                return flatten(qn, qdn)

            flat = jax.lax.fori_loop(0, n_substeps, inner,
                                     flatten(q, qd))
            q, qd = unflatten(flat)
            rots, poss, _, _ = _fk(mc, q)
            costs_ref[t, 0] = cost_fn(q, qd, rots, poss, extras)
            return flat

        jax.lax.fori_loop(0, mean_ref.shape[0], outer, flatten(q, qd))

    def rollout(qpos, qvel, extras, mean, noise):
        width = max(nq, nv, n_extras)
        state = jnp.zeros((3, width), jnp.float32)
        state = state.at[0, :nq].set(jnp.asarray(qpos, jnp.float32))
        state = state.at[1, :nv].set(jnp.asarray(qvel, jnp.float32))
        if n_extras:
            state = state.at[2, :n_extras].set(
                jnp.asarray(extras, jnp.float32))
        (costs,) = rollout_call(kernel, [state, mean], noise, [1],
                                name="forest_rollout", block_n=block_n)
        return costs

    # FLOP-accounting hook (harness.forest_perf): the kernel's per-substep
    # lane function and its callbacks, traceable OUTSIDE pallas via
    # jax.make_jaxpr for an exact primitive-level op count.
    rollout.substep_parts = dict(mc=mc, force_fn=force_fn, cost_fn=cost_fn,
                                 joint_torque_fn=joint_torque_fn,
                                 n_substeps=n_substeps,
                                 act_bodies=tuple(act_bodies))
    return rollout
