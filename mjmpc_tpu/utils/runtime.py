"""Process set-up shared by the entry points: the persistent compile
cache and the device description every benchmark row carries."""
from __future__ import annotations

import os
import subprocess

import jax

# <checkout>/.jax_cache: a fixed path, so a later run finds what an
# earlier one compiled (the path is part of the cache key).
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(_REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its path.

    If JAX_COMPILATION_CACHE_DIR is set, JAX has read it already and that
    setting stands: nothing is changed here. Otherwise the cache goes to
    DEFAULT_CACHE_DIR (git-ignored)."""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def card_line() -> str:
    """`name, power.limit` of the first card as nvidia-smi reports them
    ("" where there is no nvidia-smi)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return ""
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else ""


def device_info() -> dict:
    """The fields every benchmark row names: JAX's platform, device kind
    and count, plus the card's name and power limit."""
    devices = jax.devices()
    name, _, limit = card_line().partition(",")
    return dict(platform=devices[0].platform,
                device_kind=devices[0].device_kind,
                device_count=len(devices),
                card=name.strip(), power_limit=limit.strip())
