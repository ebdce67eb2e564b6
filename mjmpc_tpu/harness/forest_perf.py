"""Forest-kernel (hand suite) performance accounting: FLOPs + timings.

For the contact-forest kernels (ops/pallas_forest.py — pen/relocate/
hammer/door) this driver reports:

1. **Exact FLOP count per particle-substep**, by tracing the kernel's own
   per-substep lane function (`rollout.substep_parts`) OUTSIDE pallas
   with jax.make_jaxpr and counting primitive output elements. This is
   the kernel's real arithmetic — the block-sparse tree Cholesky, the
   5-tree mass/RNEA blocks, the contact assembly — not a dense-path
   estimate. Transcendentals (sin/cos/tanh/sqrt/rsqrt) are counted as 1
   FLOP each, so the FLOP figure is a LOWER bound on the work.
2. **Read-verified rollout timings** at the reference config shape
   (N=100) and at batch scale (N=1024), H=32, on the current device:
   the median of several windows after a discarded warm-up window.
3. Sustained FLOP/s (particle-substeps/s x FLOP/substep) and the
   device-memory traffic per rollout (noise in + costs out).

Usage:
  python -m mjmpc_tpu.harness.forest_perf [--envs pen-v0,...] [--flops-only]
Prints one JSON line per row (same contract as harness.benchmark).
"""
from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from .. import envs
from ..utils import runtime

_BLOCK = (128,)   # a particle block for tracing; the jaxpr counts
                  # ELEMENTS, so the block size cancels out

# primitive -> FLOPs per output element (elementwise view; integer/
# layout/control primitives count 0)
_FLOP_PRIMS = {
    "add": 1, "sub": 1, "mul": 1, "div": 1, "max": 1, "min": 1,
    "neg": 1, "abs": 1, "sign": 1, "floor": 1, "ceil": 1,
    "sqrt": 1, "rsqrt": 1, "sin": 1, "cos": 1, "tan": 1, "tanh": 1,
    "exp": 1, "log": 1, "pow": 1, "integer_pow": 1, "logistic": 1,
    "select_n": 1, "clamp": 2, "atan2": 1,
    # comparisons feed selects; count them (they occupy issue slots)
    "lt": 1, "le": 1, "gt": 1, "ge": 1, "eq": 1, "ne": 1,
}


def _count_jaxpr_flops(jaxpr) -> float:
    total = 0.0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name in ("pjit", "closed_call", "custom_jvp_call",
                    "custom_vjp_call", "remat", "checkpoint"):
            inner = eqn.params.get("jaxpr") or eqn.params.get("call_jaxpr")
            if inner is not None:
                total += _count_jaxpr_flops(
                    inner.jaxpr if hasattr(inner, "jaxpr") else inner)
            continue
        w = _FLOP_PRIMS.get(name)
        if not w:
            continue
        for var in eqn.outvars:
            aval = var.aval
            total += w * int(np.prod(aval.shape)) if aval.shape else w
    return total


def substep_flops(env) -> dict:
    """Exact per-particle-substep FLOPs of the env's forest kernel."""
    parts = getattr(env.fused_rollout, "substep_parts", None)
    if parts is None:
        raise ValueError(f"{env.name}: fused_rollout has no substep_parts")
    from ..ops import pallas_forest as pf
    mc = parts["mc"]

    def build_state():
        q, qd = {}, {}
        for i in range(mc["n"]):
            if mc["jtype"][i] == 2:
                q[i] = ([jnp.zeros(_BLOCK) for _ in range(3)],
                        [jnp.ones(_BLOCK)] + [jnp.zeros(_BLOCK)] * 3)
                qd[i] = ([jnp.zeros(_BLOCK) for _ in range(3)],
                         [jnp.zeros(_BLOCK) for _ in range(3)])
            else:
                q[i] = jnp.zeros(_BLOCK)
                qd[i] = jnp.zeros(_BLOCK)
        return q, qd

    n_extras = 8   # upper bound; extras indexing is python-level
    u = {b: jnp.zeros(_BLOCK) for b in parts["act_bodies"]}

    def one_substep(q, qd, u, extras):
        return pf._substep(mc, q, qd, u, parts["force_fn"], extras,
                           parts["joint_torque_fn"])

    q, qd = build_state()
    extras = [jnp.zeros(_BLOCK) for _ in range(n_extras)]
    jaxpr = jax.make_jaxpr(one_substep)(q, qd, u, extras)
    flops_block = _count_jaxpr_flops(jaxpr.jaxpr)
    per_particle = flops_block / float(np.prod(_BLOCK))
    # cost_fn + its FK run once per control step (after n_substeps)
    def cost_step(q, qd, extras):
        rots, poss, _, _ = pf._fk(mc, q)
        return parts["cost_fn"](q, qd, rots, poss, extras)
    cost_jaxpr = jax.make_jaxpr(cost_step)(q, qd, extras)
    cost_pp = _count_jaxpr_flops(cost_jaxpr.jaxpr) / float(np.prod(_BLOCK))
    return dict(flops_per_particle_substep=round(per_particle, 1),
                cost_flops_per_particle_step=round(cost_pp, 1),
                n_substeps=parts["n_substeps"])


def time_rollout(env, n: int, horizon: int, iters: int = 20,
                 windows: int = 3) -> float:
    """Read-verified seconds per fused rollout call: the median over
    `windows` timing windows after one discarded warm-up window."""
    rng = np.random.default_rng(0)
    d = env.d_action
    mean = jnp.asarray(rng.normal(size=(horizon, d)) * 0.1, jnp.float32)
    noise = jnp.asarray(rng.normal(size=(n, horizon, d)) * 0.2, jnp.float32)
    state = env.init(env.params, jax.random.PRNGKey(0))
    roll = jax.jit(env.fused_rollout)
    times = []
    for w in range(windows + 1):   # window 0 is the warmup, discarded
        acc = None
        start = time.perf_counter()
        for _ in range(iters):
            out = roll(env.params, state, mean, noise)
            acc = out if acc is None else acc + out
        val = float(jnp.sum(acc))   # data-depends on every call
        dt = (time.perf_counter() - start) / iters
        if not np.isfinite(val):
            raise RuntimeError(f"{env.name}: non-finite rollout costs")
        if w > 0:
            times.append(dt)
    return float(np.median(times))


_DEFAULT_ENVS = ("pen-v0", "relocate-v0", "hammer-v0", "door-v0")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--envs", default=",".join(_DEFAULT_ENVS))
    p.add_argument("--flops-only", action="store_true",
                   help="skip device timings (CPU-safe)")
    p.add_argument("--horizon", type=int, default=32)
    args = p.parse_args(argv)
    runtime.enable_compile_cache()
    device = runtime.device_info()

    rows = []
    for name in args.envs.split(","):
        name = name.strip()
        env = envs.make(name)
        row = dict(metric=f"forest_kernel[{name}]", unit="report",
                   **device)
        row.update(substep_flops(env))
        if not args.flops_only:
            for n in (100, 1024):
                dt = time_rollout(env, n, args.horizon)
                rate = n * args.horizon * row["n_substeps"] / dt
                fl = row["flops_per_particle_substep"]
                row[f"rollout_ms_N{n}"] = dt * 1e3
                row[f"particle_substeps_per_s_N{n}"] = rate
                row[f"sustained_tflops_N{n}"] = rate * fl / 1e12
                # device memory: noise in [N,H,dA] f32 + costs out [N,H]
                nbytes = 4.0 * (n * args.horizon * (env.d_action + 1))
                row[f"memory_gb_per_s_N{n}"] = nbytes / dt / 1e9
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
