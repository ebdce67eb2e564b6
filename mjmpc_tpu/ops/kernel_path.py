"""Where the fused rollout kernels run, and how they are launched.

One function, `kernel_mode`, chooses the path for every Pallas kernel
of the package: on a GPU the kernels are compiled through Pallas's
Triton route; on the CPU they run in the Pallas interpreter (the test
suite's path); any other platform is an error. No kernel runs
interpreted on a GPU.

`fused="auto"` in the solvers engages a kernel only where it is
compiled (`auto_fused`): on the CPU the solvers take the general
`rollout/engine.py` path unless a caller asks for the kernel with
`fused=True`.

Layout: a kernel program owns a 1-D block of `block_n` particles (a
power of two, one particle per GPU thread); the grid is
ceil(N / block_n). Per-particle inputs and outputs are laid out
`[H, d, N_pad]`, particle-minor, so every load and store of a block is
one coalesced row. Small shared inputs (initial state, mean, policy
weights) are whole blocks that every program reads.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

# Particles per Triton program on the GPU; one warp. N=4096 then fills
# 128 of the H100's 132 SMs with one warp each (PERF.md: block sweep).
GPU_BLOCK_N = 32
_WARP = 32


def kernel_mode(platform: Optional[str] = None) -> str:
    """'triton' on a GPU (compiled kernel), 'interpret' on the CPU
    (Pallas interpreter, for the tests). Raises on any other platform."""
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return "triton"
    if platform == "cpu":
        return "interpret"
    raise RuntimeError(
        f"fused rollout kernels run on 'gpu' (Triton) or 'cpu' "
        f"(interpreter), not on {platform!r}")


def auto_fused(kernel, sharded: bool = False) -> bool:
    """The `fused="auto"` rule of every solver: use the env's kernel when
    it exists, the solve is unsharded, and the kernel is compiled here."""
    return (kernel is not None and not sharded
            and kernel_mode() == "triton")


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def block_size(num_p: int, block_n: Optional[int] = None,
               mode: Optional[str] = None) -> int:
    """Particles per kernel program. Default: GPU_BLOCK_N on the GPU; on
    the CPU one block covers all N (the interpreter runs the grid as a
    loop, so fewer programs trace and compile faster)."""
    mode = mode or kernel_mode()
    if block_n is None:
        block_n = GPU_BLOCK_N if mode == "triton" else _next_pow2(num_p)
    if block_n < 1 or block_n & (block_n - 1):
        raise ValueError(f"block_n must be a power of two, got {block_n}")
    return block_n


def to_particle_minor(x, n_pad: int):
    """[N, H, d] particle-major -> [H, d, n_pad] f32, zero-padded."""
    num_p = x.shape[0]
    out = jnp.transpose(jnp.asarray(x, jnp.float32), (1, 2, 0))
    return jnp.pad(out, ((0, 0), (0, 0), (0, n_pad - num_p)))


def from_particle_minor(y, num_p: int):
    """[H, d, n_pad] kernel output -> [N, H, d] ([N, H] when d == 1)."""
    y = y[:, :, :num_p]
    if y.shape[1] == 1:
        return jnp.transpose(y[:, 0, :], (1, 0))
    return jnp.transpose(y, (2, 0, 1))


def rollout_call(kernel, shared: Sequence[jax.Array], noise,
                 out_widths: Sequence[int], *, name: str,
                 block_n: Optional[int] = None):
    """Launch a fused rollout kernel over particle blocks.

    kernel(*shared_refs, noise_ref, *out_refs): the per-block body.
    shared: small f32 arrays every program reads whole.
    noise: [N, H, d] per-particle input, particle-major.
    out_widths: per output, its per-step row width d; each output comes
        back particle-major, [N, H, d] (or [N, H] for d == 1).
    """
    mode = kernel_mode()
    num_p, horizon = noise.shape[0], noise.shape[1]
    block = block_size(num_p, block_n, mode)
    n_pad = -(-num_p // block) * block
    shared = [jnp.asarray(x, jnp.float32) for x in shared]

    def whole(shape):
        return pl.BlockSpec(shape, lambda i: (0,) * len(shape))

    def per_particle(d):
        return pl.BlockSpec((horizon, d, block), lambda i: (0, 0, i))

    outs = pl.pallas_call(
        kernel,
        grid=(n_pad // block,),
        in_specs=[whole(x.shape) for x in shared]
        + [per_particle(noise.shape[2])],
        out_specs=[per_particle(d) for d in out_widths],
        out_shape=[jax.ShapeDtypeStruct((horizon, d, n_pad), jnp.float32)
                   for d in out_widths],
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=max(1, block // _WARP), num_stages=1),
        interpret=mode == "interpret",
        name=name,
    )(*shared, to_particle_minor(noise, n_pad))
    return [from_particle_minor(y, num_p) for y in outs]
