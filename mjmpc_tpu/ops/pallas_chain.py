"""Fused Pallas rollout kernels for scalar-joint chain models.

The general path, `rollout/engine.py`'s vmap(scan(chain.step)), runs
every substep as several XLA kernels over [N, ...] arrays and sends the
whole per-particle state and its FK/dynamics intermediates through
device memory between them: H * n_substeps substeps, several launches
each, per solve. Here the WHOLE rollout of a particle runs in one
kernel: each GPU thread keeps one particle's q, qd and every
FK/dynamics intermediate in registers across all H * n_substeps steps,
and device-memory traffic is noise-in + costs-out. The physics is the
same algorithm as the serial C++ oracle (oracle/cpp/oracle.cpp
mass_matrix_impl/bias_impl/chain_step): explicit FK + Jacobian-
composition mass matrix + zero-qdd RNEA bias + unrolled Cholesky +
semi-implicit Euler with implicit joint damping and limit projection —
scalar joints (hinge/slide) only, which covers the reacher/sawyer arm
family (the headline benchmark env) and, with external forces, the
swimmer / half-cheetah locomotion family. Model parameters are baked as
compile-time constants (the dyn-randomization path keeps the general
XLA engine).

Layout (ops/kernel_path.py): a kernel program owns a 1-D block of
particles; every per-particle scalar is a [block_n] array, bodies and
joints are python-unrolled at trace time, and the horizon is a
fori_loop whose body is one fused control step. Kernels are compiled
through Pallas's Triton route on the GPU and interpreted on the CPU.

Matches `engine.chain.step` + the reacher cost to f32 tolerance
(tests/test_pallas_chain.py runs the kernel in interpreter mode on the
CPU against the engine and the f64 C++ oracle).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl

from .kernel_path import rollout_call


# ---------------------------------------------------------------------------
# Per-lane 3-vector / 3x3-matrix helpers: a vector is a python list of
# three [block_n] arrays, a matrix a list of 9 (row-major). Python-level
# structure, vector-register math.
# ---------------------------------------------------------------------------

def _vadd(a, b):
    return [a[i] + b[i] for i in range(3)]


def _vsub(a, b):
    return [a[i] - b[i] for i in range(3)]


def _vscale(s, a):
    return [s * a[i] for i in range(3)]


def _vdot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _vcross(a, b):
    return [a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def _mv(m, v):
    return [m[0] * v[0] + m[1] * v[1] + m[2] * v[2],
            m[3] * v[0] + m[4] * v[1] + m[5] * v[2],
            m[6] * v[0] + m[7] * v[1] + m[8] * v[2]]


def _mtv(m, v):
    """m^T v."""
    return [m[0] * v[0] + m[3] * v[1] + m[6] * v[2],
            m[1] * v[0] + m[4] * v[1] + m[7] * v[2],
            m[2] * v[0] + m[5] * v[1] + m[8] * v[2]]


def _mm(a, b):
    out = []
    for i in range(3):
        for j in range(3):
            out.append(a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j]
                       + a[3 * i + 2] * b[6 + j])
    return out


def _const_vec(v):
    return [np.float32(v[0]), np.float32(v[1]), np.float32(v[2])]


def _rodrigues(axis, ang):
    """Rotation about a CONSTANT unit axis by per-lane angle [block_n]."""
    c, s = jnp.cos(ang), jnp.sin(ang)
    x, y, z = (np.float32(axis[0]), np.float32(axis[1]),
               np.float32(axis[2]))
    one_c = 1.0 - c
    return [c + x * x * one_c, x * y * one_c - z * s, x * z * one_c + y * s,
            y * x * one_c + z * s, c + y * y * one_c, y * z * one_c - x * s,
            z * x * one_c - y * s, z * y * one_c + x * s, c + z * z * one_c]


def _world_inertia(r, inertia_const):
    """R I R^T with I a constant 3x3 (row-major numpy)."""
    i_c = [np.float32(v) for v in inertia_const.reshape(-1)]
    ri = _mm(r, i_c)
    # (R I) R^T
    out = []
    for a in range(3):
        for b in range(3):
            out.append(ri[3 * a] * r[3 * b] + ri[3 * a + 1] * r[3 * b + 1]
                       + ri[3 * a + 2] * r[3 * b + 2])
    return out


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

def _fk(mc, q):
    """FK for the particle block: returns (R[i] 3x3 lists, P[i] vectors,
    world dof axes A[i], dof anchor origins O[i]).  q: list of [block_n]
    per scalar joint."""
    n = mc["n"]
    rots, poss, axes, origins = [], [], [], []
    for i in range(n):
        pi = mc["parent"][i]
        if pi < 0:
            r_p = [np.float32(1), np.float32(0), np.float32(0),
                   np.float32(0), np.float32(1), np.float32(0),
                   np.float32(0), np.float32(0), np.float32(1)]
            p_p = [np.float32(0)] * 3
        else:
            r_p, p_p = rots[pi], poss[pi]
        bp = _const_vec(mc["body_pos"][i])
        if mc["jtype"][i] == 0:   # hinge
            p = _vadd(p_p, _mv(r_p, bp))
            r = _mm(r_p, _rodrigues(mc["axis"][i], q[i]))
            axes.append(_mv(r, _const_vec(mc["axis"][i])))
            origins.append(p)
        else:                     # slide
            aw = _mv(r_p, _const_vec(mc["axis"][i]))
            p = _vadd(_vadd(p_p, _mv(r_p, bp)), _vscale(q[i], aw))
            r = r_p
            axes.append(aw)
            origins.append(p)
        rots.append(r)
        poss.append(p)
    return rots, poss, axes, origins


def _ancestors(mc, i):
    out = []
    k = i
    while k >= 0:
        out.append(k)
        k = mc["parent"][k]
    return out[::-1]


def _mass_and_bias(mc, rots, poss, axes, origins, qd):
    """Joint-space mass matrix (upper triangle, dict) and RNEA bias
    (zero qdd) for the particle block — oracle.cpp mass_matrix_impl +
    bias_impl, hinge/slide only, python-unrolled."""
    n = mc["n"]
    g = _const_vec(mc["gravity"])
    m_out = {}
    # mass matrix
    coms_w, iws = [], []
    for i in range(n):
        ci = _vadd(poss[i], _mv(rots[i], _const_vec(mc["com"][i])))
        iw = _world_inertia(rots[i], mc["inertia"][i])
        coms_w.append(ci)
        iws.append(iw)
        dofs = _ancestors(mc, i)
        jv, jw = {}, {}
        for d in dofs:
            if mc["jtype"][d] == 0:
                jv[d] = _vcross(axes[d], _vsub(ci, origins[d]))
                jw[d] = axes[d]
            else:
                jv[d] = axes[d]
                jw[d] = None
        mass_i = np.float32(mc["mass"][i])
        for ai, a in enumerate(dofs):
            for b in dofs[ai:]:
                term = mass_i * _vdot(jv[a], jv[b])
                if jw[a] is not None and jw[b] is not None:
                    term = term + _vdot(jw[a], _mv(iw, jw[b]))
                m_out[(a, b)] = m_out.get((a, b), 0.0) + term
    # bias: forward velocity/acceleration recursion at qdd = 0
    w, dw, vo, ao = [], [], [], []
    fc, nc = [], []
    for i in range(n):
        pi = mc["parent"][i]
        zero = [jnp.zeros_like(qd[0])] * 3
        wp = w[pi] if pi >= 0 else zero
        dwp = dw[pi] if pi >= 0 else zero
        vp = vo[pi] if pi >= 0 else zero
        ap = ao[pi] if pi >= 0 else zero
        pp = poss[pi] if pi >= 0 else [np.float32(0)] * 3
        r = _vsub(poss[i], pp)
        if mc["jtype"][i] == 0:
            wj = _vscale(qd[i], axes[i])
            vj = zero
        else:
            wj = zero
            vj = _vscale(qd[i], axes[i])
        w.append(_vadd(wp, wj))
        dw.append(_vadd(dwp, _vcross(wp, wj)))
        vo.append(_vadd(_vadd(vp, _vcross(wp, r)), vj))
        ao.append(_vadd(
            _vadd(ap, _vcross(dwp, r)),
            _vadd(_vcross(wp, _vcross(wp, r)),
                  _vscale(np.float32(2.0), _vcross(wp, vj)))))
        rc = _mv(rots[i], _const_vec(mc["com"][i]))
        acc_c = _vadd(ao[i], _vadd(_vcross(dw[i], rc),
                                   _vcross(w[i], _vcross(w[i], rc))))
        fc.append(_vscale(np.float32(mc["mass"][i]), _vsub(acc_c, g)))
        nc.append(_vadd(_mv(iws[i], dw[i]),
                        _vcross(w[i], _mv(iws[i], w[i]))))
    # backward force recursion
    bias = [None] * n
    fa = [[jnp.zeros_like(qd[0])] * 3 for _ in range(n)]
    na = [[jnp.zeros_like(qd[0])] * 3 for _ in range(n)]
    for i in range(n - 1, -1, -1):
        pi = mc["parent"][i]
        rc = _mv(rots[i], _const_vec(mc["com"][i]))
        f = _vadd(fc[i], fa[i])
        nmom = _vadd(_vadd(nc[i], _vcross(rc, fc[i])), na[i])
        if mc["jtype"][i] == 0:
            bias[i] = _vdot(axes[i], nmom)
        else:
            bias[i] = _vdot(axes[i], f)
        if pi >= 0:
            fa[pi] = _vadd(fa[pi], f)
            pp = poss[pi]
            na[pi] = _vadd(na[pi],
                           _vadd(nmom, _vcross(_vsub(poss[i], pp), f)))
    return m_out, bias


def _chol_solve(mc, m_out, rhs):
    """Unrolled per-lane Cholesky solve of the nv x nv SPD system."""
    n = mc["n"]
    low = {}
    for i in range(n):
        for j in range(i + 1):
            # cross-branch dof pairs of a tree never share a descendant
            # body: their M entry is structurally zero (absent from the
            # dict)
            s = m_out.get((j, i), m_out.get((i, j), np.float32(0.0)))
            for k in range(j):
                s = s - low[(i, k)] * low[(j, k)]
            if i == j:
                low[(i, j)] = jnp.sqrt(s)
            else:
                low[(i, j)] = s / low[(j, j)]
    y = {}
    for i in range(n):
        s = rhs[i]
        for k in range(i):
            s = s - low[(i, k)] * y[k]
        y[i] = s / low[(i, i)]
    x = {}
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - low[(k, i)] * x[k]
        x[i] = s / low[(i, i)]
    return [x[i] for i in range(n)]


def _substep(mc, q, qd, u, fk=None, ext=None):
    """One semi-implicit Euler substep for the particle block — the
    engine.chain.step body with everything resident in registers.
    `fk` lets the caller pass a precomputed _fk(mc, q) (the cost of the
    previous control step evaluates FK at exactly this q); `ext` is an
    optional list of n generalized-force lane vectors added to the rhs
    (engine.chain.step's ext_force_fn slot — fluid drag, contact)."""
    n = mc["n"]
    dt = np.float32(mc["dt"])
    rots, poss, axes, origins = fk if fk is not None else _fk(mc, q)
    m_out, bias = _mass_and_bias(mc, rots, poss, axes, origins, qd)
    rhs = []
    for i in range(n):
        arm = np.float32(mc["armature"][i])
        damp = np.float32(mc["damping"][i])
        stiff = np.float32(mc["stiffness"][i])
        gear = np.float32(mc["gear"][i])
        fl = np.float32(mc["frictionloss"][i])
        m_out[(i, i)] = m_out[(i, i)] + (arm + dt * damp)
        r = gear * u[i] - bias[i] - damp * qd[i] - stiff * q[i]
        if fl != 0.0:   # smooth Coulomb friction (engine.chain.step law)
            r = r - fl * jnp.tanh(qd[i] * np.float32(50.0))
        if ext is not None:
            r = r + ext[i]
        rhs.append(r)
    acc = _chol_solve(mc, m_out, rhs)
    q_new, qd_new = [], []
    for i in range(n):
        qdn = qd[i] + dt * acc[i]
        qn = q[i] + dt * qdn
        lo, hi = np.float32(mc["qlow"][i]), np.float32(mc["qhigh"][i])
        clamped = jnp.clip(qn, lo, hi)
        qd_new.append(jnp.where(clamped == qn, qdn, 0.0))
        q_new.append(clamped)
    return q_new, qd_new


def _substeps(mc, q, qd, u, n_substeps: int, ext_fn=None):
    """One control step: n_substeps substeps under the held action u, in
    a fori_loop. A loop body of one substep keeps the compiled kernel's
    basic blocks small (GPU compile time grows steeply with their size).
    ext_fn(mc, q, qd, fk) -> [n] generalized forces, per substep."""
    def sub(_, c):
        q, qd = list(c[0]), list(c[1])
        fk = _fk(mc, q)
        ext = ext_fn(mc, q, qd, fk) if ext_fn is not None else None
        qn, qdn = _substep(mc, q, qd, u, fk=fk, ext=ext)
        return tuple(qn), tuple(qdn)

    return jax.lax.fori_loop(0, n_substeps, sub, (tuple(q), tuple(qd)))


def _site_cost(mc, q, target, fk=None):
    """Reacher family cost: l1 + 5*l2 of (site - target)
    (reacher_env.py:29-39 negated reward)."""
    rots, poss, _, _ = fk if fk is not None else _fk(mc, q)
    sb = mc["site_body"]
    site = _vadd(poss[sb], _mv(rots[sb], _const_vec(mc["site_pos"])))
    diff = _vsub(site, target)
    l1 = jnp.abs(diff[0]) + jnp.abs(diff[1]) + jnp.abs(diff[2])
    l2 = jnp.sqrt(diff[0] * diff[0] + diff[1] * diff[1]
                  + diff[2] * diff[2] + np.float32(1e-12))
    return l1 + 5.0 * l2


def _chain_kernel(state_ref, target_ref, mean_ref, noise_ref, costs_ref,
                  *, mc, horizon: int, n_substeps: int,
                  ulow: float, uhigh: float):
    n = mc["n"]
    block = costs_ref.shape[-1:]
    q = tuple(jnp.broadcast_to(state_ref[0, i], block)
              for i in range(n))
    qd = tuple(jnp.broadcast_to(state_ref[1, i], block)
               for i in range(n))
    target = [jnp.broadcast_to(target_ref[0, i], block)
              for i in range(3)]

    def body(t, carry):
        u = []
        for j in range(n):
            uj = mean_ref[t, j] + noise_ref[t, j]
            u.append(jnp.clip(uj, np.float32(ulow), np.float32(uhigh)))
        q, qd = _substeps(mc, carry[0], carry[1], u, n_substeps)
        costs_ref[t, 0] = _site_cost(mc, list(q), target)
        return q, qd

    jax.lax.fori_loop(0, horizon, body, (q, qd))


def _model_consts(model) -> dict:
    """Bake the ChainModel's static data as python/numpy constants."""
    types = list(model.joint_types)
    for t in types:
        if t not in ("hinge", "slide"):
            raise ValueError(
                f"pallas chain rollout supports scalar joints only, got {t}")
    return dict(
        n=len(types),
        parent=[int(p) for p in model.parent],
        jtype=[0 if t == "hinge" else 1 for t in types],
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
        site_body=int(model.site_body),
        site_pos=np.asarray(model.site_pos, np.float32),
    )


def build_chain_rollout(model, n_substeps: int, ulow: float = -1.0,
                        uhigh: float = 1.0, block_n: int = None):
    """Fused rollout builder for a scalar-joint ChainModel.

    Returns rollout(q0 [nv], qd0 [nv], target [3], mean [H, nv],
    noise [N, H, nv]) -> costs [N, H] with
    cost[b, t] = l1 + 5*l2 of (site(q after step t) - target) and
    u[b, t] = clip(mean[t] + noise[b, t], ulow, uhigh) — identical
    semantics to rollout_open_loop over the reacher/sawyer-arm envs.
    block_n: particles per kernel program (kernel_path.block_size).
    """
    mc = _model_consts(model)

    def rollout(q0, qd0, target, mean, noise):
        kernel = functools.partial(
            _chain_kernel, mc=mc, horizon=noise.shape[1],
            n_substeps=n_substeps, ulow=ulow, uhigh=uhigh)
        state = jnp.stack([jnp.asarray(q0, jnp.float32),
                           jnp.asarray(qd0, jnp.float32)])      # [2, nv]
        (costs,) = rollout_call(
            kernel, [state, jnp.reshape(target, (1, 3)), mean], noise,
            [1], name="chain_rollout", block_n=block_n)
        return costs

    return rollout


# ---------------------------------------------------------------------------
# Closed-loop-linear variant: the policy u = W.T [obs; 1] + eps runs
# INSIDE the kernel (obs computed in registers from the lane state), so
# the whole Reinforce/CL-MPC rollout — N particles, H steps, policy
# matmul, physics, cost, and the obs/action records the policy-gradient
# update consumes — is one device program. This is the read-verified
# fast path for the closed-loop blending row (reference
# clgaussian_mpc.py:63-73 'closed_loop_linear' rollout mode).
# ---------------------------------------------------------------------------


def _reacher_obs(mc, q, qd, extras, fk):
    """Reacher-family observation in lane dialect:
    [qpos, qvel, hand, hand - target] (envs/reacher_7dof.py:127-130,
    matching mj_envs sawyer reacher obs layout). d_obs = 2n + 6;
    extras = target [3]."""
    rots, poss, _, _ = fk
    sb = mc["site_body"]
    site = _vadd(poss[sb], _mv(rots[sb], _const_vec(mc["site_pos"])))
    diff = _vsub(site, extras[0:3])
    return list(q) + list(qd) + list(site) + list(diff)


def _chain_cl_kernel(state_ref, extras_ref, w_ref, noise_ref,
                     costs_ref, obs_ref, acts_ref, *, mc, horizon: int,
                     n_substeps: int, ulow: float, uhigh: float,
                     d_obs: int, obs_fn, cost_fn, n_extras: int):
    n = mc["n"]
    block = costs_ref.shape[-1:]
    q = tuple(jnp.broadcast_to(state_ref[0, i], block)
              for i in range(n))
    qd = tuple(jnp.broadcast_to(state_ref[1, i], block)
               for i in range(n))
    extras = [jnp.broadcast_to(extras_ref[0, i], block)
              for i in range(n_extras)]

    def body(t, carry):
        q, qd = carry
        # one FK serves the previous step's cost and this step's obs
        fk = _fk(mc, list(q))

        @pl.when(t > 0)
        def _write_prev_cost():
            costs_ref[t - 1, 0] = cost_fn(mc, list(q), list(qd), extras,
                                          fk)

        obs = obs_fn(mc, q, qd, extras, fk)
        for j in range(d_obs):
            obs_ref[t, j] = obs[j]

        u = []
        for i in range(n):
            acc = w_ref[d_obs, i] + noise_ref[t, i]   # bias row + eps
            for j in range(d_obs):
                acc = acc + w_ref[j, i] * obs[j]
            # recorded actions are the PRE-clip commanded actions
            # (gym_env_wrapper.py:151 act_vec semantics); the env clips
            # internally before integrating
            acts_ref[t, i] = acc
            u.append(jnp.clip(acc, np.float32(ulow), np.float32(uhigh)))
        return _substeps(mc, q, qd, u, n_substeps)

    q, qd = jax.lax.fori_loop(0, horizon, body, (q, qd))
    fk = _fk(mc, list(q))
    costs_ref[horizon - 1, 0] = cost_fn(mc, list(q), list(qd), extras, fk)


def _reacher_cl_cost(mc, q, qd, extras, fk):
    return _site_cost(mc, q, extras[0:3], fk=fk)


def _chain_obs_kernel(state_ref, extras_ref, mean_ref, noise_ref,
                      costs_ref, obs_ref, *, mc, horizon: int,
                      n_substeps: int, ulow: float, uhigh: float,
                      d_obs: int, obs_fn, cost_fn, n_extras: int):
    """Open-loop actions (mean[t] + eps, the _chain_kernel law) PLUS
    per-step observation emission — the rollout for observation-hungry
    open-loop solvers (MPPIQ with a plugged Q)."""
    n = mc["n"]
    block = costs_ref.shape[-1:]
    q = tuple(jnp.broadcast_to(state_ref[0, i], block)
              for i in range(n))
    qd = tuple(jnp.broadcast_to(state_ref[1, i], block)
               for i in range(n))
    extras = [jnp.broadcast_to(extras_ref[0, i], block)
              for i in range(n_extras)]

    def body(t, carry):
        q, qd = carry
        fk = _fk(mc, list(q))

        @pl.when(t > 0)
        def _write_prev_cost():
            costs_ref[t - 1, 0] = cost_fn(mc, list(q), list(qd), extras,
                                          fk)

        obs = obs_fn(mc, q, qd, extras, fk)
        for j in range(d_obs):
            obs_ref[t, j] = obs[j]

        u = []
        for i in range(n):
            ui = mean_ref[t, i] + noise_ref[t, i]
            u.append(jnp.clip(ui, np.float32(ulow), np.float32(uhigh)))
        return _substeps(mc, q, qd, u, n_substeps)

    q, qd = jax.lax.fori_loop(0, horizon, body, (q, qd))
    fk = _fk(mc, list(q))
    costs_ref[horizon - 1, 0] = cost_fn(mc, list(q), list(qd), extras, fk)


def build_chain_obs_rollout(model, n_substeps: int, ulow: float = -1.0,
                            uhigh: float = 1.0, block_n: int = None,
                            obs_fn=_reacher_obs,
                            cost_fn=_reacher_cl_cost,
                            d_obs: int = None, n_extras: int = 3):
    """Open-loop fused rollout that ALSO emits per-step observations.

    Returns rollout(q0 [nv], qd0 [nv], extras [n_extras], mean [H, nv],
    noise [N, H, nv]) -> (obs [N, H, d_obs], costs [N, H]); identical
    cost/action semantics to build_chain_rollout, identical obs
    semantics to the closed-loop builder (obs at the PRE-step state,
    matching rollout_open_loop's Trajectories.observations). Recorded
    actions are mean + noise, which the caller reconstructs in XLA."""
    mc = _model_consts(model)
    if d_obs is None:
        d_obs = 2 * mc["n"] + 6

    def rollout(q0, qd0, extras_in, mean, noise):
        kernel = functools.partial(
            _chain_obs_kernel, mc=mc, horizon=noise.shape[1],
            n_substeps=n_substeps, ulow=ulow, uhigh=uhigh,
            d_obs=d_obs, obs_fn=obs_fn, cost_fn=cost_fn,
            n_extras=n_extras)
        state = jnp.stack([jnp.asarray(q0, jnp.float32),
                           jnp.asarray(qd0, jnp.float32)])
        costs, obs = rollout_call(
            kernel, [state, jnp.reshape(extras_in, (1, n_extras)), mean],
            noise, [1, d_obs], name="chain_obs_rollout", block_n=block_n)
        return obs, costs

    return rollout


def build_chain_cl_rollout(model, n_substeps: int, ulow: float = -1.0,
                           uhigh: float = 1.0, block_n: int = None,
                           obs_fn=_reacher_obs, cost_fn=_reacher_cl_cost,
                           d_obs: int = None, n_extras: int = 3):
    """Fused closed-loop-linear rollout builder for a scalar-joint
    ChainModel. Defaults to the reacher-family obs/cost (extras =
    target [3]); pass obs_fn / cost_fn / d_obs / n_extras for other
    chain tasks (e.g. peg insertion, whose hole params ride extras).

    obs_fn(mc, q, qd, extras, fk) -> list of d_obs lane vectors at the
    PRE-step state; cost_fn(mc, q, qd, extras, fk) -> lane vector at
    the POST-step state.

    Returns rollout(q0 [nv], qd0 [nv], extras [n_extras],
    weights [d_obs + 1, nv], noise [N, H, nv]) ->
    (obs [N, H, d_obs], actions [N, H, nv], costs [N, H]) — identical
    semantics to rollout_closed_loop_linear
    (u[b, t] = W.T [obs_b(t); 1] + noise[b, t], obs at the pre-step
    state, cost/action records as the engine produces them)."""
    mc = _model_consts(model)
    n = mc["n"]
    if d_obs is None:
        d_obs = 2 * n + 6

    def rollout(q0, qd0, extras_in, weights, noise):
        kernel = functools.partial(
            _chain_cl_kernel, mc=mc, horizon=noise.shape[1],
            n_substeps=n_substeps, ulow=ulow, uhigh=uhigh,
            d_obs=d_obs, obs_fn=obs_fn, cost_fn=cost_fn,
            n_extras=n_extras)
        state = jnp.stack([jnp.asarray(q0, jnp.float32),
                           jnp.asarray(qd0, jnp.float32)])      # [2, nv]
        costs, obs, acts = rollout_call(
            kernel,
            [state, jnp.reshape(extras_in, (1, n_extras)), weights],
            noise, [1, d_obs, n], name="chain_cl_rollout",
            block_n=block_n)
        return obs, acts, costs

    return rollout


# ---------------------------------------------------------------------------
# Locomotion variant: external generalized forces (fluid drag, ground
# contact) evaluated per substep INSIDE the kernel, plus a per-control-
# step cost law over (state-in, state-out, action) — the fused fast path
# for the swimmer / half-cheetah family, whose XLA rollout pays the same
# device-memory round trips as the arm family's (header comment). The
# tree recursions (_fk / _ancestors / _mass_and_bias) already handle
# branched parent arrays, so this covers the cheetah's legged tree too.
# ---------------------------------------------------------------------------


def _point_jac_cols(mc, body, pt_w, axes, origins):
    """Translational point-Jacobian columns J_d for body's ancestor dofs
    at world point pt_w (lane dialect): hinge -> a_d x (pt - o_d), slide
    -> a_d. The analytic form of engine.chain.point_force_to_generalized
    / point_state's AD Jacobian, exact for scalar joints."""
    cols = {}
    for d in _ancestors(mc, body):
        if mc["jtype"][d] == 0:
            cols[d] = _vcross(axes[d], _vsub(pt_w, origins[d]))
        else:
            cols[d] = axes[d]
    return cols


def make_capsule_drag(link_bodies, sample_offsets, drag_perp, drag_par,
                      vcap: float = 4.0):
    """Slender-body anisotropic quadratic drag for x-aligned capsule
    links — envs/swimmer.py _ext_forces in lane dialect: at each sample
    point s along the link axis, F = -c_perp/2 * min(|v_n|, vcap) * v_n
    - c_par/2 * min(|v_t|, vcap) * v_t, mapped through the point
    Jacobian. Returns ext_fn(mc, q, qd, fk) -> [n] lane vectors."""
    link_bodies = list(link_bodies)
    sample_offsets = [np.float32(s) for s in sample_offsets]
    drag_perp = [np.float32(c) for c in np.asarray(drag_perp)]
    drag_par = [np.float32(c) for c in np.asarray(drag_par)]

    def ext_fn(mc, q, qd, fk):
        rots, poss, axes, origins = fk
        tau = [jnp.zeros_like(qd[0]) for _ in range(mc["n"])]
        for li, b in enumerate(link_bodies):
            r = rots[b]
            axis_w = [r[0], r[3], r[6]]          # R @ e_x (unit column)
            cp = np.float32(0.5 * drag_perp[li])
            cl = np.float32(0.5 * drag_par[li])
            for s in sample_offsets:
                pt_w = _vadd(poss[b], _vscale(s, axis_w))
                cols = _point_jac_cols(mc, b, pt_w, axes, origins)
                v = [jnp.zeros_like(qd[0])] * 3
                for d, col in cols.items():
                    v = _vadd(v, _vscale(qd[d], col))
                v_ax = _vdot(v, axis_w)
                v_par = _vscale(v_ax, axis_w)
                v_perp = _vsub(v, v_par)
                n_perp = jnp.sqrt(_vdot(v_perp, v_perp))
                n_par = jnp.abs(v_ax)
                f = _vadd(
                    _vscale(-cp * jnp.minimum(n_perp, np.float32(vcap)),
                            v_perp),
                    _vscale(-cl * jnp.minimum(n_par, np.float32(vcap)),
                            v_par))
                for d, col in cols.items():
                    tau[d] = tau[d] + _vdot(col, f)
        return tau

    return ext_fn


def make_ground_contact(contacts, radius: float, kp: float, kd: float,
                        mu: float, slip_vel: float = 0.1):
    """Planar compliant ground contact at body-local sample points —
    envs/half_cheetah.py _ext_forces in lane dialect: spring-damper
    normal force below z = radius, saturated Coulomb friction
    -mu * f_n * tanh(v_x / slip_vel) opposing x slip. Contact gains are
    baked constants (pass fused=False to build_solve_fn when
    randomizing them). Returns ext_fn(mc, q, qd, fk)."""
    contacts = [(int(b), np.asarray(p, np.float32)) for b, p in contacts]
    radius, kp, kd = np.float32(radius), np.float32(kp), np.float32(kd)
    mu, inv_slip = np.float32(mu), np.float32(1.0 / slip_vel)

    def ext_fn(mc, q, qd, fk):
        rots, poss, axes, origins = fk
        tau = [jnp.zeros_like(qd[0]) for _ in range(mc["n"])]
        for b, pt in contacts:
            pt_w = _vadd(poss[b], _mv(rots[b], _const_vec(pt)))
            cols = _point_jac_cols(mc, b, pt_w, axes, origins)
            v = [jnp.zeros_like(qd[0])] * 3
            for d, col in cols.items():
                v = _vadd(v, _vscale(qd[d], col))
            depth = radius - pt_w[2]
            fn_mag = jnp.where(
                depth > 0.0,
                jnp.maximum(kp * depth - kd * v[2], 0.0), 0.0)
            ft = -mu * fn_mag * jnp.tanh(v[0] * inv_slip)
            for d, col in cols.items():
                tau[d] = tau[d] + col[0] * ft + col[2] * fn_mag
        return tau

    return ext_fn


def _chain_ext_kernel(state_ref, mean_ref, noise_ref, costs_ref, *, mc,
                      horizon: int, n_substeps: int, ulow: float,
                      uhigh: float, ext_fn, step_cost_fn, vel_limit):
    n = mc["n"]
    block = costs_ref.shape[-1:]
    q = tuple(jnp.broadcast_to(state_ref[0, i], block)
              for i in range(n))
    qd = tuple(jnp.broadcast_to(state_ref[1, i], block)
               for i in range(n))

    def body(t, carry):
        q, qd = carry
        q_in = q
        u = []
        for j in range(n):
            uj = mean_ref[t, j] + noise_ref[t, j]
            u.append(jnp.clip(uj, np.float32(ulow), np.float32(uhigh)))

        q, qd = _substeps(mc, q, qd, u, n_substeps, ext_fn)
        if vel_limit is not None:
            qd = tuple(jnp.clip(qd[i], -np.float32(vel_limit[i]),
                                np.float32(vel_limit[i]))
                       for i in range(n))
        costs_ref[t, 0] = step_cost_fn(mc, list(q_in), list(q), list(qd),
                                       u)
        return (q, qd)

    jax.lax.fori_loop(0, horizon, body, (q, qd))


def build_chain_ext_rollout(model, n_substeps: int, ext_fn=None,
                            step_cost_fn=None, vel_limit=None,
                            ulow: float = -1.0, uhigh: float = 1.0,
                            block_n: int = None):
    """Fused rollout builder for scalar-joint models with per-substep
    external forces and a control-step cost law (the locomotion family).

    ext_fn(mc, q, qd, fk) -> [n] generalized-force lane vectors,
    evaluated at every substep (engine.chain.step ext_force_fn
    semantics). step_cost_fn(mc, q_in, q_out, qd_out, u) -> cost lane
    vector for one control step (u is the CLIPPED action the env
    integrates — the cost = -reward convention of rollout_open_loop).
    vel_limit: optional per-dof |qd| clamp applied once per control
    step, after the substeps (envs/swimmer.py _VEL_LIMIT semantics).

    Returns rollout(q0 [nv], qd0 [nv], mean [H, nv], noise [N, H, nv])
    -> costs [N, H]. Actions for unactuated base dofs must arrive as
    zeros (mean and noise padded by the env wrapper — gear * 0 = 0
    matches the env's zero-concat ctrl layout)."""
    mc = _model_consts(model)
    if vel_limit is not None:
        vel_limit = [float(v) for v in np.asarray(vel_limit)]

    def rollout(q0, qd0, mean, noise):
        kernel = functools.partial(
            _chain_ext_kernel, mc=mc, horizon=noise.shape[1],
            n_substeps=n_substeps, ulow=ulow, uhigh=uhigh,
            ext_fn=ext_fn, step_cost_fn=step_cost_fn,
            vel_limit=vel_limit)
        state = jnp.stack([jnp.asarray(q0, jnp.float32),
                           jnp.asarray(qd0, jnp.float32)])      # [2, nv]
        (costs,) = rollout_call(kernel, [state, mean], noise, [1],
                                name="chain_ext_rollout", block_n=block_n)
        return costs

    return rollout
