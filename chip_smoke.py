"""Chip smoke test: drive the MPC solve on a GPU, once, end to end.

    python chip_smoke.py           # one card
    python chip_smoke.py --multi   # four cards: sharded solves vs one card

Phases (one card), all in this one process:
  1. device   — JAX's devices and the card's name and power limit; exits
                non-zero unless JAX finds a GPU.
  2. kernels  — every fused rollout kernel compiled through Pallas's
                Triton route at its benchmark width, compared once with
                the plain engine (`rollout/engine.py`, matmuls at
                HIGHEST precision) within the bound that
                `harness/kernel_check.py` states per family.
  3. main     — 20+ chained headline solves (reacher_7dof-v0 MPPI, H=32,
                N=4096) through `solvers.make_solve_fn`, then the CLI
                driver `harness.run_mpc.main` on the reacher config at the
                reference's scale; actions and rewards must be finite.
  4. timing   — informational: read-verified headline solves/s, and for
                each kernel case the rollout time of the kernel against
                the plain XLA engine (the executables phase 2 compiled).
With --multi only the four-card phase runs: reacher MPPI (H=32,
N=4x4096), PFMPC and full-covariance CEM solves with the particle axis
sharded over a 1x4 (episodes, particles) mesh, each compared with the
same solve on one card.

A failing phase raises: the script then exits non-zero and prints no
ok line. The last line of a passing run is one JSON object,
{"ok": true, "device": {"platform", "kind", "count"}}.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

HEADLINE = ("reacher_7dof-v0", 32, 4096)      # env, H, N
HEADLINE_SOLVES = 24


def _log(*parts):
    print(*parts, flush=True)


# ---------------------------------------------------------------- phase 1

def phase_device(want: int):
    import jax
    from mjmpc_tpu.utils import runtime

    devices = jax.devices()
    _log("devices:", devices)
    _log("device_kind:", devices[0].device_kind)
    if devices[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX platform is {devices[0].platform!r}")
    if len(devices) < want:
        raise SystemExit(f"need {want} GPUs, JAX found {len(devices)}")
    _log("card:", runtime.card_line())
    _log("compile cache:", runtime.enable_compile_cache())
    return devices


def make_solver(kind: str, env, horizon: int, n: int):
    from mjmpc_tpu import solvers

    common = dict(d_action=env.d_action, horizon=horizon,
                  num_particles=n, filter_coeffs=(0.25, 0.8, 0.0))
    if kind == "mppi":
        return solvers.MPPI(lam=0.01, init_cov=3.0, step_size=0.55,
                            gamma=1.0, base_action="repeat", **common)
    if kind == "cem":
        return solvers.CEM(elite_frac=0.2, beta=0.3, step_size=0.9,
                           init_cov=0.5, cov_type="full", **common)
    if kind == "pfmpc":
        return solvers.PFMPC(lam=0.6, cov_shift=0.1, cov_resample=1.0,
                             **common)
    raise ValueError(kind)


# ---------------------------------------------------------------- phase 2

def _memory(compiled) -> dict:
    m = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k: getattr(m, k) for k in keys if hasattr(m, k)}


def compile_case(case):
    """Compile one kernel case and its plain-engine reference (matmuls at
    HIGHEST). Returns (kernel exe, reference exe, args, compile s)."""
    import jax
    from mjmpc_tpu import envs
    from mjmpc_tpu.harness import kernel_check

    family, env_name, attr, horizon, n = case
    env = envs.make(env_name)
    args = kernel_check.kernel_inputs(env, attr, horizon, n)
    t0 = time.perf_counter()
    kernel = jax.jit(getattr(env, attr)).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(kernel_check.reference_rollout(env, attr)).lower(
            *args).compile()
    return kernel, ref, args, compile_s


def compile_all(cases, workers: int = 8):
    """XLA and the Triton compiler release the GIL: compile the cases in
    parallel threads (the kernels' GPU compiles take tens of seconds
    each)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(compile_case, cases))


def check_kernel(case, compiled):
    """Compare one compiled kernel with the engine; returns the row
    printed. Raises when the error exceeds the family's bound."""
    from mjmpc_tpu.harness import kernel_check

    family, env_name, _, horizon, n = case
    kernel, ref, args, compile_s = compiled
    worst, excess = kernel_check.compare(kernel(*args), ref(*args),
                                         family)
    atol, rtol = kernel_check.BOUNDS[family]
    row = dict(phase="kernel", family=family, env=env_name, H=horizon, N=n,
               max_abs_err=worst, bound=f"{atol} + {rtol}*|ref|",
               within_bound=bool(excess <= 0.0),
               compile_s=round(compile_s, 2), memory=_memory(kernel))
    _log(json.dumps(row))
    if excess > 0.0:
        raise AssertionError(f"{family}/{env_name} H={horizon} N={n}: "
                             f"kernel differs from the engine beyond "
                             f"{atol} + {rtol}*|ref| (max err {worst})")
    return row


def phase_kernels():
    from mjmpc_tpu.harness.kernel_check import KERNEL_CASES

    compiled = compile_all(KERNEL_CASES)
    for case, exe in zip(KERNEL_CASES, compiled):
        check_kernel(case, exe)
    return compiled


# ---------------------------------------------------------------- phase 3

def solve_chain(solver, env, fused, k: int, warm: int = 2):
    """k chained solves (donated state), timed through a READ of the last
    action. Returns (solves/s, last action, compile+first-solve s)."""
    import jax
    from mjmpc_tpu import solvers

    solve = jax.jit(solvers.make_solve_fn(solver, env, fused=fused),
                    donate_argnums=(2,))
    s = solver.init_state(jax.random.PRNGKey(0))
    es = env.init(env.params, jax.random.PRNGKey(1))
    t0 = time.perf_counter()
    for _ in range(warm):
        action, _, s = solve(env.params, es, s)
    np.asarray(action)
    first_s = time.perf_counter() - t0
    start = time.perf_counter()
    for _ in range(k):
        action, _, s = solve(env.params, es, s)
    action = np.asarray(action)
    rate = k / (time.perf_counter() - start)
    if not np.isfinite(action).all():
        raise AssertionError(f"{env.name}: non-finite action {action}")
    return rate, action, first_s


def phase_main(save_dir: str):
    from mjmpc_tpu import envs
    from mjmpc_tpu.harness import run_mpc

    name, horizon, n = HEADLINE
    env = envs.make(name)
    solver = make_solver("mppi", env, horizon, n)
    rate, action, first_s = solve_chain(solver, env, "auto",
                                        HEADLINE_SOLVES)
    _log(json.dumps(dict(phase="main", what="headline solves", env=name,
                         H=horizon, N=n, solves=HEADLINE_SOLVES,
                         action=action.tolist(),
                         compile_and_warmup_s=round(first_s, 2))))
    out = run_mpc.main(["--config", "configs/reacher_7dof-v0.yml",
                        "--controller", "mppi", "--save_dir", save_dir])
    res = out["mppi"]
    rewards = np.asarray(res["rewards"])
    if not np.isfinite(rewards).all():
        raise AssertionError("run_mpc produced non-finite rewards")
    _log(json.dumps(dict(phase="main", what="run_mpc", env=name,
                         rewards_shape=list(rewards.shape),
                         average_reward=float(res["average_reward"]))))
    return rate


# ---------------------------------------------------------------- phase 4

def time_call(exe, args, iters: int = 20) -> float:
    """Seconds per call of a compiled executable: `iters` calls whose
    first outputs are summed and READ, so the window covers device
    execution of every call. The warm-up also compiles the summing add,
    which would otherwise compile inside the window."""
    import jax
    import jax.numpy as jnp

    leaf = jax.tree_util.tree_leaves(exe(*args))[0]
    float(jnp.sum(leaf + leaf))
    start = time.perf_counter()
    acc = None
    for _ in range(iters):
        leaf = jax.tree_util.tree_leaves(exe(*args))[0]
        acc = leaf if acc is None else acc + leaf
    float(jnp.sum(acc))
    return (time.perf_counter() - start) / iters


def phase_timing(headline_rate: float, compiled):
    name, horizon, n = HEADLINE
    _log(json.dumps(dict(phase="timing", what="headline solves/s",
                         env=name, H=horizon, N=n,
                         solves_per_s=headline_rate,
                         path="fused kernel (fused='auto')")))
    from mjmpc_tpu.harness.kernel_check import KERNEL_CASES

    rows = []
    for case, (kernel, ref, args, _) in zip(KERNEL_CASES, compiled):
        family, env_name, _, horizon, n = case
        row = dict(phase="timing", what="rollout ms, kernel vs plain XLA",
                   family=family, env=env_name, H=horizon, N=n,
                   kernel_ms=time_call(kernel, args) * 1e3,
                   plain_ms=time_call(ref, args) * 1e3)
        _log(json.dumps(row))
        rows.append(row)
    return rows


# ---------------------------------------------------------- four cards

# (solver, env, H, N, bound on |action(sharded) - action(one card)|
# after three chained solves). Sharded and one-card solves run the same
# plain engine (the kernel stays off under sharding), so the rollout
# costs agree; only the cross-device reductions run in another order.
# MPPI and CEM reduce weighted sums and elite statistics: f32 rounding,
# which MPPI's exp(-cost / lam) at lam = 0.01 amplifies 100-fold. PFMPC
# resamples particle INDICES by searchsorted on a prefix sum of the
# weights; a rounding change in that global cumsum can flip an index at
# a boundary, and each flip moves the mean action by O(|sample| / N),
# about 1e-3 at N = 4096.
MULTI_CASES = [
    ("mppi", "reacher_7dof-v0", 32, 4 * 4096, 1e-3),
    ("pfmpc", "reacher_7dof-v0", 16, 4096, 1e-2),
    ("cem", "reacher_7dof-v0", 16, 4096, 1e-3),
]


def compile_sharded(case, devices):
    """(sharded exe, one-card exe, args) for one MULTI_CASES entry."""
    import jax
    from mjmpc_tpu import envs, parallel, solvers

    kind, env_name, horizon, n, _ = case
    env = envs.make(env_name)
    solver = make_solver(kind, env, horizon, n)
    mesh = parallel.make_mesh(episodes=1, particles=len(devices),
                              devices=devices)
    args = (env.params, env.init(env.params, jax.random.PRNGKey(1)),
            solver.init_state(jax.random.PRNGKey(0)))
    sharded = parallel.build_sharded_solve_fn(solver, env, mesh)
    single = jax.jit(solvers.make_solve_fn(solver, env, fused=False))
    return (sharded.lower(*args).compile(), single.lower(*args).compile(),
            args, dict(mesh.shape))


def check_sharded(case, compiled):
    kind, env_name, horizon, n, bound = case
    sharded, single, (params, es, s0), mesh_shape = compiled
    s_m, s_1 = s0, s0
    for _ in range(3):    # three chained solves: the state carries over
        a_m, _, s_m = sharded(params, es, s_m)
        a_1, _, s_1 = single(params, es, s_1)
    a_m, a_1 = np.asarray(a_m), np.asarray(a_1)
    err = float(np.abs(a_m - a_1).max())
    rates = {}
    for label, exe, s in (("sharded", sharded, s_m), ("one_card", single,
                                                       s_1)):
        start = time.perf_counter()
        for _ in range(10):
            a, _, s = exe(params, es, s)
        np.asarray(a)
        rates[f"{label}_solves_per_s"] = 10 / (time.perf_counter() - start)
    row = dict(phase="multi", solver=kind, env=env_name, H=horizon, N=n,
               mesh=mesh_shape, max_abs_action_err=err, bound=bound,
               **rates)
    _log(json.dumps(row))
    if not (np.isfinite(a_m).all() and err <= bound):
        raise AssertionError(f"sharded {kind} differs from one card: {err}")
    return row


def phase_multi(devices):
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(MULTI_CASES)) as pool:
        compiled = list(pool.map(lambda c: compile_sharded(c, devices),
                                 MULTI_CASES))
    return [check_sharded(c, exe) for c, exe in zip(MULTI_CASES, compiled)]


# ---------------------------------------------------------------- main

def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--multi", action="store_true",
                   help="run only the four-card sharded phase")
    p.add_argument("--save-dir", default="smoke_runs",
                   help="run_mpc log directory (git-ignored)")
    args = p.parse_args(argv)

    devices = phase_device(4 if args.multi else 1)
    if args.multi:
        phase_multi(devices[:4])
    else:
        compiled = phase_kernels()
        rate = phase_main(args.save_dir)
        phase_timing(rate, compiled)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
