"""mjmpc_tpu — a sampling-based MPC framework on accelerators.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
mohakbhardwaj/mjmpc (sampling-based model-predictive control for robotics):

- ``ops``:       math kernels (discounted cost-to-go, AR-filtered noise,
                 Gaussian utilities) and the fused Pallas rollout kernels.
- ``envs``:      batched, differentiable dynamics written as pure JAX
                 functions (analytic classic-control models plus a
                 Featherstone articulated-body engine for MuJoCo-style
                 arms). Replaces the reference's mujoco_py process pool.
- ``rollout``:   vmapped lax.scan rollout engine (the reference's
                 GymEnvWrapper.rollout hot loop, fully on device).
- ``solvers``:   the controller zoo (MPPI, CEM, DMD-MPC, random shooting,
                 particle-filter MPC, MPPI-Q) as pure functions over an
                 explicit solver-state pytree.
- ``parallel``:  device-mesh sharding of the particle axis (the reference's
                 SubprocVecEnv scatter/gather, re-done as SPMD collectives).
- ``policies``/``value_functions``: closed-loop MPC + value-function
                 blending stack (ICLR'21 capability).
- ``harness``:   YAML config system compatible with the reference's
                 examples/configs schema, episode runners, tune/sweep jobs.
- ``oracle``:    NumPy re-implementation of the reference update equations
                 for bit-level parity testing (reference noise procedure
                 included), plus a C++ CPU rollout oracle.
"""

__version__ = "0.1.0"
