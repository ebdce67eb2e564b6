"""Benchmark runner: solves/s and op microbenchmarks.

The reference has no benchmark suite (SURVEY.md §6 — batch_timing_test.py
is empty); this implements the BASELINE.md benchmark configs: MPPI on
reacher_7dof, random_shooting/CEM on the classic tasks, PFMPC, plus op
microbenches (noise sampler, cost-to-go). Every row names the device it
ran on (platform, device_kind, device_count, card, power_limit), and a
failing row stops the run.

Usage: python -m mjmpc_tpu.harness.benchmark [--quick] [--json PATH]
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, List

import jax
import jax.numpy as jnp
import numpy as np

from .. import envs, ops, solvers
from ..utils import runtime


def _finite_read(out) -> float:
    """Read (device->host) a scalar that data-depends on `out` and check
    it is finite: the timed window then covers device execution of
    everything `out` depends on, not the host's enqueue."""
    leaf = jax.tree_util.tree_leaves(out)[0]
    val = float(jnp.sum(jnp.asarray(leaf, jnp.float32)))
    if not np.isfinite(val):
        raise RuntimeError(f"non-finite benchmark output: {val}")
    return val


def _time(fn, *args, iters: int = 50, warmup: int = 2) -> float:
    """Steady-state seconds/call. Each iteration's first output leaf is
    accumulated and the window ends by READING the accumulator, so the
    measured span data-depends on every timed call (the small on-device
    add per call is included in the rate — conservative). The warm-up
    also compiles that add, which would otherwise compile inside the
    window."""
    for _ in range(warmup):
        out = fn(*args)
    leaf = jax.tree_util.tree_leaves(out)[0]
    _finite_read(leaf + leaf)
    acc = None
    start = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
        leaf = jax.tree_util.tree_leaves(out)[0]
        acc = leaf if acc is None else acc + leaf
    val = float(jnp.sum(jnp.asarray(acc, jnp.float32)))
    dt = (time.perf_counter() - start) / iters
    if not np.isfinite(val):
        raise RuntimeError(f"non-finite benchmark output: {val}")
    return dt


def bench_solver(env_name: str, controller: str, horizon: int,
                 num_particles: int, iters: int = 50,
                 **solver_kwargs) -> Dict[str, Any]:
    env = envs.make(env_name)
    defaults = dict(d_action=env.d_action, horizon=horizon,
                    num_particles=num_particles, gamma=1.0,
                    filter_coeffs=(0.25, 0.8, 0.0))
    if controller == "mppi":
        defaults.update(lam=0.01, init_cov=3.0, step_size=0.55,
                        base_action="repeat")
    elif controller == "cem":
        defaults.update(elite_frac=0.2, beta=0.3, step_size=0.9)
    elif controller == "pfmpc":
        defaults = dict(d_action=env.d_action, horizon=horizon,
                        num_particles=num_particles, lam=0.1,
                        cov_shift=0.1, cov_resample=1.0)
    solver = solvers.make_solver(controller, **{**defaults, **solver_kwargs})

    solve = jax.jit(solvers.make_solve_fn(solver, env))
    sstate = solver.init_state(jax.random.PRNGKey(0))
    estate = env.init(env.params, jax.random.PRNGKey(1))

    # chained-state timing: the production control loop. The final
    # action data-depends on every solve through the chained solver
    # state, so ONE read at the end verifies the whole window.
    for _ in range(2):
        a, _, sstate = solve(env.params, estate, sstate)
    _finite_read(a)
    start = time.perf_counter()
    s = sstate
    for _ in range(iters):
        a, _, s = solve(env.params, estate, s)
    _finite_read(a)
    dt = (time.perf_counter() - start) / iters

    return dict(metric=f"{controller}_solves_per_s"
                       f"[{env_name},H={horizon},N={num_particles}]",
                value=1.0 / dt, unit="solves/s")


def bench_ops(num_particles: int = 4096, horizon: int = 32,
              d_action: int = 7) -> List[Dict[str, Any]]:
    rows = []
    key = jax.random.PRNGKey(0)
    cov = jnp.eye(d_action)
    coeffs = (0.25, 0.8, 0.0)

    nz = jax.jit(lambda k: ops.filtered_noise(
        k, cov, (num_particles, horizon), coeffs))
    dt = _time(nz, key)
    rows.append(dict(metric="filtered_noise_xla_us", value=dt * 1e6,
                     unit="us"))

    costs = jax.random.uniform(key, (num_particles, horizon))
    gseq = ops.gamma_sequence(0.99, horizon)
    ctg = jax.jit(lambda c: ops.cost_to_go(c, gseq))
    dt = _time(ctg, costs)
    rows.append(dict(metric="cost_to_go_us", value=dt * 1e6, unit="us"))
    return rows


DEFAULT_SUITE = [
    ("reacher_7dof-v0", "mppi", 32, 4096),
    ("reacher_7dof-v0", "mppi", 32, 16384),
    ("SimplePendulum-v0", "mppi", 32, 4096),
    ("SimplePendulum-v0", "random_shooting", 32, 4096),
    ("SimplePendulum-v0", "cem", 32, 4096),
    ("reacher_7dof-v0", "cem", 16, 4096),
    ("SimplePendulum-v0", "pfmpc", 32, 4096),
    # contact-rich hand suite: free quaternion object + 14 contact pairs
    # per substep through the batched points_frame path
    ("pen-v0", "mppi", 32, 1024),
    # locomotion family through the fused drag/contact kernel
    # (ops/pallas_chain.build_chain_ext_rollout)
    ("Swimmer-v0", "mppi", 32, 4096),
    ("HalfCheetah-v0", "mppi", 32, 1024),
]


def bench_latency(env_name: str = "reacher_7dof-v0", horizon: int = 32,
                  num_particles: int = 4096, iters: int = 30):
    """Blocked per-solve latency — the real-time control metric (one MPC
    solve per control step; reference pays an IPC round trip here)."""
    env = envs.make(env_name)
    solver = solvers.MPPI(
        d_action=env.d_action, horizon=horizon, num_particles=num_particles,
        lam=0.01, init_cov=3.0, step_size=0.55, gamma=1.0,
        filter_coeffs=(0.25, 0.8, 0.0), base_action="repeat")
    solve = jax.jit(solvers.make_solve_fn(solver, env))
    s = solver.init_state(jax.random.PRNGKey(0))
    est = env.init(env.params, jax.random.PRNGKey(1))
    out = solve(env.params, est, s)
    _finite_read(out)
    lats = []
    for _ in range(iters):
        start = time.perf_counter()
        out = solve(env.params, est, s)
        _finite_read(out)   # device->host action readback IS part of
        lats.append(time.perf_counter() - start)   # real control latency
    med = float(np.median(lats))
    return dict(metric=f"mppi_solve_latency_ms"
                       f"[{env_name},H={horizon},N={num_particles}]",
                value=med * 1e3, unit="ms")


def bench_sharded(horizon: int = 32, particles_per_device: int = 4096,
                  iters: int = 30):
    """Weak-scaling probe: sharded solve with N scaled by device count
    (run on a pod slice for the BASELINE 1->2 host numbers)."""
    from .. import parallel
    n_dev = len(jax.devices())
    mesh = parallel.make_mesh()
    env = envs.make("reacher_7dof-v0")
    n = particles_per_device * n_dev
    solver = solvers.MPPI(
        d_action=env.d_action, horizon=horizon, num_particles=n,
        lam=0.01, init_cov=3.0, step_size=0.55, gamma=1.0,
        filter_coeffs=(0.25, 0.8, 0.0), base_action="repeat")
    solve = parallel.build_sharded_solve_fn(solver, env, mesh)
    s = solver.init_state(jax.random.PRNGKey(0))
    est = env.init(env.params, jax.random.PRNGKey(1))
    a, _, s = solve(env.params, est, s)
    _finite_read(a)
    start = time.perf_counter()
    for _ in range(iters):
        a, _, s = solve(env.params, est, s)
    _finite_read(a)
    dt = (time.perf_counter() - start) / iters
    return dict(metric=f"sharded_mppi_solves_per_s"
                       f"[{env.name},H={horizon},N={n},devices={n_dev}]",
                value=1.0 / dt, unit="solves/s")


def bench_aggregate(env_name: str = "reacher_7dof-v0", horizon: int = 32,
                    num_particles: int = 4096, batches=(1, 2, 4, 8),
                    iters: int = 10) -> List[Dict[str, Any]]:
    """Aggregate throughput: B independent MPC solves batched into ONE
    dispatch (vmap over env/solver states; on the fused kernel path the
    batch lifts into the pallas grid). The one-card utilization probe:
    if B doubles aggregate solves/s, the single-stream headline is
    dispatch/occupancy-bound, not compute-bound."""
    env = envs.make(env_name)
    solver = solvers.MPPI(
        d_action=env.d_action, horizon=horizon, num_particles=num_particles,
        lam=0.01, init_cov=3.0, step_size=0.55, gamma=1.0,
        filter_coeffs=(0.25, 0.8, 0.0), base_action="repeat")
    solve = solvers.build_solve_fn(solver, env)
    vsolve = jax.jit(jax.vmap(solve, in_axes=(None, 0, 0)))
    rows = []
    for b in batches:
        est = jax.vmap(env.init, in_axes=(None, 0))(
            env.params, jax.random.split(jax.random.PRNGKey(1), b))
        s = jax.vmap(solver.init_state)(
            jax.random.split(jax.random.PRNGKey(0), b))
        for _ in range(2):
            a, _, s = vsolve(env.params, est, s)
        _finite_read(a)
        start = time.perf_counter()
        for _ in range(iters):
            a, _, s = vsolve(env.params, est, s)
        _finite_read(a)   # chained solver state: one read covers all
        dt = (time.perf_counter() - start) / iters
        rows.append(dict(
            metric=f"aggregate_mppi_solves_per_s"
                   f"[{env_name},H={horizon},N={num_particles},B={b}]",
            value=b / dt, unit="solves/s",
            ms_per_dispatch=dt * 1e3))
    return rows


def bench_weak_scaling(horizon: int = 32, particles_per_device: int = 512,
                       iters: int = 20):
    """Weak-scaling trend over 1/2/4/8-device sub-meshes with FIXED
    particles per device. On the CPU virtual mesh
    (JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8)
    this measures partitioning/collective overhead trends only; the
    cards' numbers need the four-GPU machine."""
    from .. import parallel
    rows = []
    all_dev = jax.devices()
    base_rate = None
    for nd in (1, 2, 4, 8):
        if nd > len(all_dev):
            break
        mesh = parallel.make_mesh(episodes=1, particles=nd,
                                  devices=all_dev[:nd])
        env = envs.make("reacher_7dof-v0")
        n = particles_per_device * nd
        solver = solvers.MPPI(
            d_action=env.d_action, horizon=horizon, num_particles=n,
            lam=0.01, init_cov=3.0, step_size=0.55, gamma=1.0,
            filter_coeffs=(0.25, 0.8, 0.0), base_action="repeat")
        solve = parallel.build_sharded_solve_fn(solver, env, mesh)
        s = solver.init_state(jax.random.PRNGKey(0))
        est = env.init(env.params, jax.random.PRNGKey(1))
        dt = _time(lambda: solve(env.params, est, s), iters=iters)
        rate = 1.0 / dt
        if base_rate is None:
            base_rate = rate
        rows.append(dict(
            metric=f"weak_scaling[devices={nd},N={n}]",
            value=rate, unit="solves/s",
            efficiency_pct=100.0 * rate / base_rate))
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true",
                        help="fewer iterations / smaller suite")
    parser.add_argument("--json", type=str, default=None,
                        help="also write results to this file")
    parser.add_argument("--profile", type=str, default=None,
                        help="capture a jax.profiler trace to this dir")
    parser.add_argument("--weak-scaling", action="store_true",
                        help="only run the 1/2/4/8-device weak-scaling "
                             "trend")
    args = parser.parse_args(argv)
    runtime.enable_compile_cache()
    device = runtime.device_info()
    rows = []

    def emit(out):
        for row in (out if isinstance(out, list) else [out]):
            row.update(device)
            rows.append(row)
            print(json.dumps(row), flush=True)

    if args.weak_scaling:
        emit(bench_weak_scaling())
    else:
        suite = DEFAULT_SUITE[:3] if args.quick else DEFAULT_SUITE
        iters = 10 if args.quick else 50
        for env_name, controller, horizon, n in suite:
            emit(bench_solver(env_name, controller, horizon, n,
                              iters=iters))
        emit(bench_latency())
        emit(bench_aggregate(batches=(1, 2) if args.quick else (1, 2, 4, 8),
                             iters=iters // 5 or 2))
        if len(jax.devices()) > 1:
            emit(bench_sharded())
        emit(bench_ops())

        if args.profile:
            with jax.profiler.trace(args.profile):
                bench_latency(iters=5)
            emit(dict(metric="profile_trace", value=args.profile,
                      unit="path"))

    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=2)
    return rows


if __name__ == "__main__":
    main()
