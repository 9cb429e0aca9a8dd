"""Where JAX keeps its persistent compile cache.

`JAX_COMPILATION_CACHE_DIR`, when set, is used as is (JAX reads it
itself); otherwise the cache goes to <repo>/.jax_cache, a fixed path so
that later runs find what earlier ones compiled.
"""
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_DIR = os.path.join(REPO, ".jax_cache")


def enable_compile_cache():
    """Point JAX's persistent compile cache at JAX_COMPILATION_CACHE_DIR
    when that variable is set, else at <repo>/.jax_cache. Call before the
    first compile. Returns the directory in use."""
    import jax
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR
    if jax.config.jax_compilation_cache_dir != path:
        jax.config.update("jax_compilation_cache_dir", path)
    return path
