"""Test configuration: run the suite on an 8-device virtual CPU mesh.

Multi-device sharding paths are exercised without accelerators by forcing
the host platform and splitting it into 8 XLA devices (SURVEY.md §4
testing strategy). jax may already be imported by the time pytest
starts, so the platform is set through jax.config, which takes effect
until the first backend use, rather than env vars alone.

MJMPC_TESTS_ON_GPU=1 leaves JAX on its default platform instead: on a
machine with a GPU that runs the `gpu`-marked tests there
(`MJMPC_TESTS_ON_GPU=1 python -m pytest tests/ -m gpu`); they skip,
inside a fixture, everywhere else.
"""
import os
import resource

# XLA-CPU's LLVM backend recurses deeply when emitting the biggest fused
# programs in this suite (hand-env rollouts, the mppiq-with-Q closed-loop
# kernel in interpreter mode); on the default 8 MB main-thread stack that
# segfaults the whole pytest process partway through a single-process
# full-suite run (observed 3x in r5, always inside backend_compile).
# Raising the soft limit to the hard limit lets the main stack grow past
# it — the compile then completes (slowly) instead of crashing.
_soft, _hard = resource.getrlimit(resource.RLIMIT_STACK)
if _soft != resource.RLIM_INFINITY and (_hard == resource.RLIM_INFINITY or _soft < _hard):
    resource.setrlimit(resource.RLIMIT_STACK, (_hard, _hard))

_ON_GPU = bool(os.environ.get("MJMPC_TESTS_ON_GPU"))
if not _ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"  # for any subprocesses we spawn
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.RandomState(42)
