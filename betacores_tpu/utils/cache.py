"""Persistent XLA compilation cache.

The reference has no compilation step; in this framework every distinct
build program is XLA-compiled, which costs tens of seconds per program
*per process* at the headline shapes. JAX's persistent compilation cache
amortizes that across processes: compiled executables are serialized to
disk keyed by (HLO, compile options, backend) and reloaded on the next run.

Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when it is set (and no
other directory), else the fixed path ``<checkout>/.cache/jax_compile``
(gitignored). The path is part of what makes a hit, so it never moves.
Enabled on import of ``betacores_tpu``; opt out with
``BETACORES_NO_COMPILATION_CACHE=1``.
"""

from __future__ import annotations

import os

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(_CHECKOUT, ".cache", "jax_compile")

_enabled_dir: str | None = None


def _cpu_only() -> bool:
    """CPU-only processes (the test suite) skip the cache unless
    ``JAX_COMPILATION_CACHE_DIR`` asks for it: compiles
    are cheap there, and XLA:CPU AOT reload emits noisy machine-feature
    warnings. Checking the config does not initialize the backend."""
    try:
        import jax

        platforms = jax.config.jax_platforms or os.environ.get("JAX_PLATFORMS", "")
        return bool(platforms) and set(platforms.split(",")) <= {"cpu"}
    except Exception:
        return True


def enable_persistent_cache(cache_dir: str | None = None,
                            min_compile_time_secs: float = 1.0) -> str | None:
    """Enable JAX's on-disk compilation cache (idempotent).

    ``JAX_COMPILATION_CACHE_DIR`` wins over ``cache_dir``, which wins over
    ``DEFAULT_DIR``. Safe to call before or after backend initialization —
    the cache config is consulted at compile time, not at backend init.
    Returns the cache directory in use, or None if disabled/unsupported.
    """
    global _enabled_dir
    if os.environ.get("BETACORES_NO_COMPILATION_CACHE"):
        return None
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        cache_dir = env_dir
    elif _cpu_only():
        return None
    cache_dir = cache_dir or DEFAULT_DIR
    if _enabled_dir == cache_dir:
        return _enabled_dir
    try:
        import jax

        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          min_compile_time_secs)
    except Exception:  # unsupported jax version / read-only fs: run without
        return None
    try:
        max_gb = float(os.environ.get("BETACORES_COMPILATION_CACHE_MAX_GB", "10"))
    except ValueError:
        max_gb = 10.0  # malformed env must not abort package import
    _prune(cache_dir, max_bytes=max_gb * 1e9)
    _enabled_dir = cache_dir
    return cache_dir


def _prune(cache_dir: str, max_bytes: float) -> None:
    """Evict oldest-WRITTEN entries past the size cap (JAX has no built-in
    eviction). Note this is FIFO by write time, not true LRU: JAX cache
    hits do not touch mtime, so a hot old entry can be evicted — acceptable
    because entries are MB-scale and recompiles take seconds."""
    try:
        entries = []
        with os.scandir(cache_dir) as it:
            for e in it:
                if e.is_file():
                    st = e.stat()
                    entries.append((st.st_mtime, st.st_size, e.path))
        total = sum(sz for _, sz, _ in entries)
        for _, sz, path in sorted(entries):
            if total <= max_bytes:
                break
            os.remove(path)
            total -= sz
    except OSError:
        pass
