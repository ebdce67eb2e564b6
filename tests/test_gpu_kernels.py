"""Compiled (Pallas Triton) fused rollout kernels vs the plain engine, on
a GPU, at the benchmark widths (harness/kernel_check.KERNEL_CASES, the
cases `chip_smoke.py` checks). Marked `gpu`: they skip on the CPU, where
the same kernels run in the interpreter (test_pallas_*.py). Run them on
the card with

    MJMPC_TESTS_ON_GPU=1 python -m pytest tests/ -m gpu
"""
import jax
import pytest

from mjmpc_tpu import envs
from mjmpc_tpu.harness import kernel_check
from mjmpc_tpu.ops import kernel_path

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with MJMPC_TESTS_ON_GPU=1 on the "
                    "card)")
    assert kernel_path.kernel_mode() == "triton"


@pytest.mark.parametrize("case", kernel_check.KERNEL_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}-H{c[3]}-N{c[4]}")
def test_compiled_kernel_matches_engine(gpu, case):
    family, env_name, attr, horizon, n = case
    env = envs.make(env_name)
    args = kernel_check.kernel_inputs(env, attr, horizon, n)
    got = jax.jit(getattr(env, attr))(*args)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(kernel_check.reference_rollout(env, attr))(*args)
    worst, excess = kernel_check.compare(got, want, family)
    assert excess <= 0.0, (family, env_name, worst,
                           kernel_check.BOUNDS[family])
