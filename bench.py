"""Headline benchmark: MPPI solves/s at H=32, N=4096 on reacher_7dof-v0.

Prints ONE JSON line: {"metric", "value", "unit", ...} plus the device
it ran on (platform, device_kind, device_count, card, power_limit) and
the rollout path that actually ran ("fused kernel" or "plain engine").

Measurement: every timing window ends by READING a value that
data-depends on every solve in the window (the chained solver state),
so the window covers device execution, not the host's enqueue.

Fields:
  value        — median over WINDOWS read-verified timing windows
  windows_p25/p50/p75, spread_pct — the window-rate distribution
                 (spread = (p75 - p25) / median * 100)
  path         — the rollout path the solve compiled
  particle_substeps_per_s — N * H * ENGINE_SUBSTEPS * solves/s
                 (reacher_7dof runs frame_skip=2 engine substeps per
                 control step)

`--smoke` times the chain and forest kernel paths at N=1024 against the
floors in bench_floors.json (exit 1 on a drop of more than 30%);
`--record-floors` re-records them on the current card.
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import time

import jax

from mjmpc_tpu import envs, solvers
from mjmpc_tpu.ops.kernel_path import auto_fused
from mjmpc_tpu.utils import runtime

ENV_NAME = "reacher_7dof-v0"
HORIZON = 32
NUM_PARTICLES = 4096
WINDOWS = 9
TARGET_WINDOW_S = 0.5      # solves per window sized from a probe run
ENGINE_SUBSTEPS = 2        # reacher frame_skip


def _quartiles(rates):
    rates = sorted(rates)
    median = statistics.median(rates)
    q1 = rates[len(rates) // 4]
    q3 = rates[(3 * len(rates)) // 4]
    return q1, median, q3, 100.0 * (q3 - q1) / median


def _path(env) -> str:
    return ("fused kernel" if auto_fused(env.fused_rollout)
            else "plain engine")


def _make_mppi(env, horizon, n):
    return solvers.MPPI(d_action=env.d_action, horizon=horizon,
                        num_particles=n, lam=0.01, init_cov=3.0,
                        step_size=0.55, gamma=1.0,
                        filter_coeffs=(0.25, 0.8, 0.0),
                        base_action="repeat")


def _chain_runner(env, solver):
    """k chained solves, timed through a READ of the final action."""
    solve = jax.jit(solvers.make_solve_fn(solver, env))
    state_box = [solver.init_state(jax.random.PRNGKey(0))]
    env_state = env.init(env.params, jax.random.PRNGKey(1))

    def run_chain(k):
        s = state_box[0]
        start = time.perf_counter()
        for _ in range(k):
            action, _, s = solve(env.params, env_state, s)
        value = float(action[0])
        elapsed = time.perf_counter() - start
        if value != value:
            raise RuntimeError(f"{env.name}: solve chain produced NaN")
        state_box[0] = s
        return k / elapsed

    return run_chain


def main():
    runtime.enable_compile_cache()
    env = envs.make(ENV_NAME)
    run_chain = _chain_runner(env, _make_mppi(env, HORIZON, NUM_PARTICLES))
    run_chain(3)                                   # compile + warm up
    solves_per_window = max(20, int(TARGET_WINDOW_S * run_chain(20)))
    q1, median, q3, spread = _quartiles(
        [run_chain(solves_per_window) for _ in range(WINDOWS)])
    print(json.dumps({
        "metric": f"mppi_solves_per_s[{ENV_NAME},H={HORIZON},"
                  f"N={NUM_PARTICLES}]",
        "value": median,
        "unit": "solves/s",
        "windows_p25": q1,
        "windows_p50": median,
        "windows_p75": q3,
        "spread_pct": spread,
        "solves_per_window": solves_per_window,
        "path": _path(env),
        "read_verified": True,
        "particle_substeps_per_s":
            NUM_PARTICLES * HORIZON * ENGINE_SUBSTEPS * median,
        **runtime.device_info(),
    }))


# --- perf-regression gate -------------------------------------------------
# `bench.py --smoke` runs the chain and forest kernel paths at small N
# and FAILS (exit 1) if solves/s drops >30% below the floor recorded in
# bench_floors.json on the same kind of card; refresh the floors with
# `bench.py --record-floors` after a deliberate perf change.
_FLOORS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "bench_floors.json")
_SMOKE_DROP_PCT = 30.0
_SMOKE_CASES = [
    # (key, env, horizon, num_particles) — chain + forest kernel families
    ("chain_smoke", "reacher_7dof-v0", 32, 1024),
    ("forest_smoke", "pen-v0", 32, 1024),
]


def _smoke_rate(env_name: str, horizon: int, n: int) -> float:
    """Read-verified solves/s over a short solve chain."""
    env = envs.make(env_name)
    run_chain = _chain_runner(env, _make_mppi(env, horizon, n))
    run_chain(3)   # compile + warm
    return run_chain(40)


def smoke(record: bool = False) -> int:
    runtime.enable_compile_cache()
    device = runtime.device_info()
    floors = {}
    if os.path.exists(_FLOORS_PATH):
        with open(_FLOORS_PATH) as f:
            floors = json.load(f)
    measured, failed = {"device": device}, []
    for key, env_name, horizon, n in _SMOKE_CASES:
        rate = _smoke_rate(env_name, horizon, n)
        floor = None
        if floors.get("device", {}).get("device_kind") == \
                device["device_kind"]:
            floor = floors.get(key, {}).get("floor_solves_per_s")
        ok = floor is None or rate >= floor * (1.0 - _SMOKE_DROP_PCT / 100)
        measured[key] = dict(env=env_name, horizon=horizon, n=n,
                             path=_path(envs.make(env_name)),
                             floor_solves_per_s=rate)
        print(json.dumps({
            "metric": f"smoke[{key},{env_name},H={horizon},N={n}]",
            "value": rate, "unit": "solves/s", "floor": floor,
            "ok": bool(ok), "read_verified": True, **device,
        }), flush=True)
        if not ok:
            failed.append(key)
    if record:
        with open(_FLOORS_PATH, "w") as f:
            json.dump(measured, f, indent=2)
        print(json.dumps({"metric": "smoke_floors_recorded",
                          "value": _FLOORS_PATH, "unit": "path"}))
        return 0
    if failed:
        print(json.dumps({
            "metric": "smoke_gate", "value": 0, "unit": "FAIL",
            "failed": failed,
            "hint": "kernel path regressed >30% below bench_floors.json",
        }), flush=True)
        return 1
    return 0


if __name__ == "__main__":
    if "--smoke" in sys.argv or "--record-floors" in sys.argv:
        sys.exit(smoke(record="--record-floors" in sys.argv))
    main()
