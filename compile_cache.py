"""Where this repository's scripts keep JAX's persistent compilation cache.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself, so when it is set the
scripts set nothing. Otherwise they use ``.jax_cache`` at the root of the
checkout: one fixed path, so a later run in the same checkout finds what
an earlier one compiled. The library itself sets no cache.
"""

import os

DEFAULT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".jax_cache")


def compile_cache_dir(environ=None) -> str:
    """The cache directory a script run with ``environ`` uses."""
    environ = os.environ if environ is None else environ
    return environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def use_compile_cache() -> str:
    """Point JAX at :data:`DEFAULT_DIR` unless ``JAX_COMPILATION_CACHE_DIR``
    is set; return the directory in use."""
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path
