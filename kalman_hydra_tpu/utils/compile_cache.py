"""Persistent XLA compilation cache location for the entry points.

Only the programs a user starts (`chip_smoke.py`, `bench.py`,
`kalman_hydra_tpu.cli.main`) call `enable_compile_cache`; library modules
never set a cache. The rule is:

* `$JAX_COMPILATION_CACHE_DIR`, when set, is the cache (JAX reads it
  itself; it is passed through unchanged);
* otherwise `<checkout>/.jax_cache`, where `<checkout>` is the source
  checkout the entry point lives in (the directory holding
  `pyproject.toml`). The path is fixed per checkout because it is part of
  the cache key: a directory that moves between runs never hits.

An installed package (no checkout around it) gets no default cache.
"""

from __future__ import annotations

import os
from typing import Optional

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir(checkout: Optional[str] = None) -> Optional[str]:
    """The cache directory the rule above picks, or None for an installed
    package outside any checkout."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    root = os.path.abspath(checkout or _CHECKOUT)
    if not os.path.exists(os.path.join(root, "pyproject.toml")):
        return None
    return os.path.join(root, ".jax_cache")


def enable_compile_cache(checkout: Optional[str] = None) -> Optional[str]:
    """Point JAX's persistent compilation cache at `compile_cache_dir`
    and return the directory (None: left unset)."""
    path = compile_cache_dir(checkout)
    if path is not None:
        import jax
        jax.config.update("jax_compilation_cache_dir", path)
    return path
