"""Backend policy, kept in one place.

- ``PRECISION``: the precision of every float32 contraction over the
  particle axis (posterior moments, the Liu–West smear, Bayes risk and
  information gain, the tomography Born rule). On an NVIDIA GPU a
  float32 dot at default precision may run in TF32, which keeps about
  three significant digits; these contractions sum up to millions of
  weighted terms, so they ask for full float32.
- ``enable_compile_cache()``: JAX's persistent compilation cache. Scripts
  and entry points call it; importing the package does not.
"""

from __future__ import annotations

import os

import jax

__all__ = ["PRECISION", "enable_compile_cache", "default_cache_dir"]

PRECISION = jax.lax.Precision.HIGHEST

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def default_cache_dir():
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``.

    The path is fixed: a cache whose directory moves between runs never
    hits."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_CHECKOUT, ".jax_cache"))


def enable_compile_cache():
    """Point JAX's persistent compilation cache at ``default_cache_dir()``
    and return that path."""
    path = default_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
