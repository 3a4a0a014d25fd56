"""Persistent XLA compile cache shared by every entry point.

``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself and nothing else is
changed. Unset: the cache lives at one fixed directory of the checkout,
``<repo>/.jax_cache`` (git-ignored) — a fixed path, because the path is
part of what a later process must find again.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

#: The checkout's own cache directory (used when ENV_VAR is unset).
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; return it."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
