"""Persistent XLA compilation cache location, shared by every entry point.

A flagship fit's cold start is dominated by compilation, so the CLIs,
``bench.py``, ``chip_smoke.py`` and the tests keep compiled programs on
disk.  The cache key includes the directory, so the path is fixed:

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself and nothing here
  sets another directory;
* otherwise ``<checkout>/<subdir>`` (default ``.jax_cache``) — never a
  path under the home directory, a temporary name, a pid or the time.
"""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable(subdir: str = ".jax_cache") -> str:
    """Point JAX's persistent compilation cache at the fixed directory.

    Returns the directory in use.  With ``JAX_COMPILATION_CACHE_DIR`` set
    this only reports it: JAX has already read the variable.
    """
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    import jax

    path = os.path.join(CHECKOUT, subdir)
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
