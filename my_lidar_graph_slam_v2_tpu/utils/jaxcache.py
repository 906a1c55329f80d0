"""Persistent XLA compilation cache setup.

The reference loads its FPGA bitstream once before the run
(``slam_launcher.cpp:83-107``); our analog of that one-time cost is XLA
compilation of the jitted cores.  Enabling JAX's persistent compilation
cache lets a later run load every executable it compiled before from
disk instead of compiling it again.

Where the cache lives: the directory named by ``JAX_COMPILATION_CACHE_DIR``
when that variable is set (no other directory is used then), and
otherwise one fixed directory inside the checkout, ``<repo>/.jax_cache``
(listed in ``.gitignore``).  The path is part of
the cache key, so it must not move between runs.

Call :func:`enable` before the first jit dispatch (the launcher, bench
harness, and e2e scripts all do).  Safe to call repeatedly.
"""
from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = str(Path(__file__).resolve().parents[2] / ".jax_cache")


def enable() -> str:
    """Enable the persistent compilation cache (idempotent); returns the
    directory in use."""
    import jax

    path = os.environ.get(ENV_VAR) or DEFAULT_DIR
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    # Cache everything: the pipeline's cores are many medium-sized
    # programs, and even a 0.5 s compile is worth skipping mid-run.
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
