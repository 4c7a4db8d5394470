"""Where JAX's persistent compilation cache lives.

``JAX_COMPILATION_CACHE_DIR``, when set, wins and JAX reads it itself.
Otherwise the cache goes to a fixed ``.jax_cache/`` at the checkout root
(listed in ``.gitignore``): the directory is part of the cache key, so it
never comes from a temporary name, a process id or the time.
"""

import os

__all__ = ["compile_cache_dir", "enable_compile_cache"]

CHECKOUT_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def compile_cache_dir():
    """The cache directory this process uses (env var, else the fixed path)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        CHECKOUT_ROOT, ".jax_cache"
    )


def enable_compile_cache():
    """Point JAX's persistent cache at :func:`compile_cache_dir`; returns it.

    With ``JAX_COMPILATION_CACHE_DIR`` set this changes no setting.
    """
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax

        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    return path
