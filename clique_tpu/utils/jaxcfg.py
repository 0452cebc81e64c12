"""JAX runtime configuration helpers."""

from __future__ import annotations

import os
import subprocess

# fixed fallback location of the persistent compilation cache: a path that
# never moves, so later runs from this checkout find what earlier ones built
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_persistent_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and this
    sets no other directory; otherwise the cache lives in the checkout's
    own `.jax_cache`."""
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = REPO_CACHE_DIR
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi`'s name and power limit of each card, one per line."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip()


def device_report() -> dict:
    """The devices JAX runs on: platform, kind and count as JAX reports
    them, the JAX version, and on a GPU the card's name and power limit."""
    import jax

    devices = jax.devices()
    report = {"platform": devices[0].platform,
              "kind": devices[0].device_kind,
              "count": len(devices),
              "jax": jax.__version__,
              "gpu": None}
    if report["platform"] == "gpu":
        report["gpu"] = gpu_name_and_power_limit()
    return report
