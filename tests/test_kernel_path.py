"""The one path choice for the Pallas rollout kernels (ops/kernel_path.py),
the particle-block layout, the compile-cache helper, and the chip smoke
script's refusal to run without a GPU."""
import io
import os
import subprocess
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mjmpc_tpu import envs
from mjmpc_tpu.envs.reacher_7dof import ReacherState
from mjmpc_tpu.ops import kernel_path
from mjmpc_tpu.ops.pallas_chain import build_chain_rollout
from mjmpc_tpu.rollout.engine import rollout_open_loop
from mjmpc_tpu.utils import runtime


@pytest.mark.parametrize("platform,mode", [("gpu", "triton"),
                                           ("cpu", "interpret")])
def test_kernel_mode_per_platform(platform, mode):
    assert kernel_path.kernel_mode(platform) == mode


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_kernel_mode_refuses_other_platforms(platform):
    with pytest.raises(RuntimeError, match="gpu"):
        kernel_path.kernel_mode(platform)


def test_kernel_mode_here_is_interpret():
    assert jax.default_backend() == "cpu"
    assert kernel_path.kernel_mode() == "interpret"


def test_auto_fused_engages_only_compiled_kernels(monkeypatch):
    kernel = object()
    # the CPU interprets kernels: "auto" keeps the general engine path
    assert not kernel_path.auto_fused(kernel)
    monkeypatch.setattr(kernel_path, "kernel_mode", lambda: "triton")
    assert kernel_path.auto_fused(kernel)
    assert not kernel_path.auto_fused(kernel, sharded=True)
    assert not kernel_path.auto_fused(None)


@pytest.mark.parametrize("num_p,block_n,mode,want", [
    (37, None, "interpret", 64),      # CPU: one block covers all N
    (4096, None, "interpret", 4096),
    (1, None, "interpret", 1),
    (4096, None, "triton", kernel_path.GPU_BLOCK_N),
    (37, 32, "interpret", 32),        # explicit block wins everywhere
    (100, 128, "triton", 128),
])
def test_block_size(num_p, block_n, mode, want):
    assert kernel_path.block_size(num_p, block_n, mode) == want


@pytest.mark.parametrize("block_n", [0, 3, 48, 100])
def test_block_size_must_be_power_of_two(block_n):
    with pytest.raises(ValueError, match="power of two"):
        kernel_path.block_size(64, block_n, "triton")


def test_particle_minor_layout_roundtrip():
    x = jnp.arange(5 * 3 * 2, dtype=jnp.float32).reshape(5, 3, 2)
    y = kernel_path.to_particle_minor(x, 8)
    assert y.shape == (3, 2, 8)
    np.testing.assert_array_equal(np.asarray(y[:, :, 5:]), 0.0)
    np.testing.assert_array_equal(np.asarray(y[1, 0, :5]),
                                  np.asarray(x[:, 1, 0]))
    np.testing.assert_array_equal(
        np.asarray(kernel_path.from_particle_minor(y, 5)), np.asarray(x))
    costs = kernel_path.from_particle_minor(y[:, :1, :], 5)
    assert costs.shape == (5, 3)


def test_ragged_particles_over_several_blocks():
    """N=37 over 32-particle blocks: two programs, the second padded with
    27 zero-noise particles that must not leak into the result."""
    env = envs.make("reacher_7dof-v0")
    rng = np.random.default_rng(5)
    h, n = 3, 37
    mean = jnp.asarray(rng.normal(size=(h, 7)) * 0.3, jnp.float32)
    noise = jnp.asarray(rng.normal(size=(n, h, 7)) * 0.5, jnp.float32)
    q0 = jnp.asarray(rng.normal(size=7) * 0.1, jnp.float32)
    qd0 = jnp.zeros(7, jnp.float32)
    target = jnp.array([0.2, -0.1, 0.15], jnp.float32)
    blocked = build_chain_rollout(env.params.model, n_substeps=2,
                                  block_n=32)
    costs = np.asarray(jax.jit(blocked)(q0, qd0, target, mean, noise))
    assert costs.shape == (n, h)
    whole = build_chain_rollout(env.params.model, n_substeps=2)
    np.testing.assert_array_equal(
        costs, np.asarray(jax.jit(whole)(q0, qd0, target, mean, noise)))
    state = ReacherState(qpos=q0, qvel=qd0, target=target,
                         timestep=jnp.array(0, jnp.int32),
                         key=jax.random.PRNGKey(0))
    ref = rollout_open_loop(env, env.params, state, mean, noise).costs
    np.testing.assert_allclose(costs, np.asarray(ref), rtol=0, atol=5e-5)


def test_compile_cache_honours_env_var(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert runtime.enable_compile_cache() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = runtime.enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_card_line_without_nvidia_smi(monkeypatch):
    def missing(*a, **k):
        raise FileNotFoundError("nvidia-smi")
    monkeypatch.setattr(subprocess, "run", missing)
    assert runtime.card_line() == ""
    info = runtime.device_info()
    assert info["platform"] == "cpu" and info["card"] == ""


def test_card_line_parses_first_card(monkeypatch):
    out = "NVIDIA H100 80GB HBM3, 700.00 W\nNVIDIA H100 80GB HBM3, 700.00 W\n"
    monkeypatch.setattr(subprocess, "run", lambda *a, **k:
                        subprocess.CompletedProcess(a, 0, stdout=out))
    assert runtime.card_line() == "NVIDIA H100 80GB HBM3, 700.00 W"
    info = runtime.device_info()
    assert info["card"] == "NVIDIA H100 80GB HBM3"
    assert info["power_limit"] == "700.00 W"


def test_chip_smoke_refuses_cpu():
    import importlib.util
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    buf = io.StringIO()
    with redirect_stdout(buf), pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in buf.getvalue()
