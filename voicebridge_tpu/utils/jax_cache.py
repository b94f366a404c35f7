"""Persistent XLA compilation cache, shared by every entry-point script.

Each decode graph compiles its own scan programs (its reduction spec is
baked in), so a warm on-disk cache saves most of a run's set-up time.

Rule: when ``JAX_COMPILATION_CACHE_DIR`` is set, that directory is used and
no other is set.  Otherwise the cache lives at a fixed path inside the
checkout, ``<repo>/.jax_cache`` (listed in ``.gitignore``): the path is part
of what makes a cache hit, so it is never built from a temporary directory,
a process id or the time.

Call it before the first compile:

    from voicebridge_tpu.utils.jax_cache import setdefault_compilation_cache
    setdefault_compilation_cache()
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def setdefault_compilation_cache() -> str:
    """Point JAX's persistent compilation cache at ``$JAX_COMPILATION_CACHE_DIR``
    if set, else at ``<repo>/.jax_cache``; return that directory."""
    import jax

    path = os.environ.get(ENV_VAR) or str(DEFAULT_DIR)
    os.environ[ENV_VAR] = path
    jax.config.update("jax_compilation_cache_dir", path)
    # the decode path is built from many medium window programs; cache all
    # that take more than half a second to compile
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
