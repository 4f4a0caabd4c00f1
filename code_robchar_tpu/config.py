"""Global numeric configuration.

The reference computes everything in numpy complex128 (qnewton.py:141,
noise_model.py:79).  The matrices are tiny (N<=10), so the framework
supports two regimes:

- *parity* regime: x64 enabled, complex128 kernels; used by the test-suite
  (CPU backend) to hit the 1e-10 fidelity-parity bar against the reference.
- *throughput* regime: float32 kernels on the GPU; used by the Monte-Carlo
  and training paths, where statistical (not bitwise) accuracy is required.

Kernels take their dtype from their inputs, so callers pick the regime by
constructing inputs with `real_dtype()` / `complex_dtype()`.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import jax
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# Persistent XLA compilation cache.  Collection/figure pipelines are compile-
# dominated between processes; the on-disk cache turns every repeat compile
# across processes into a deserialize.  Within a process, programs are
# additionally shared across optimizer instances by
# models/base._PROGRAM_CACHE.
#
# Where JAX_COMPILATION_CACHE_DIR is set, JAX keeps the cache there and this
# package sets no other directory; a host application that configured
# jax_compilation_cache_dir itself keeps its setting too.  Otherwise the
# cache lives at a fixed path in the checkout, CACHE_DIR.  Opt out with
# ROBCHAR_NO_COMPILATION_CACHE=1 (the tests do).
# ---------------------------------------------------------------------------
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def compile_cache_dir(environ: Mapping[str, str] = os.environ
                      ) -> Optional[str]:
    """The cache directory this package sets, or None where it sets
    none (caching off, or JAX_COMPILATION_CACHE_DIR in charge)."""
    if environ.get("ROBCHAR_NO_COMPILATION_CACHE") or \
            environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return CACHE_DIR


if not os.environ.get("ROBCHAR_NO_COMPILATION_CACHE"):
    _cache_dir = compile_cache_dir()
    if _cache_dir and not jax.config.jax_compilation_cache_dir:
        jax.config.update("jax_compilation_cache_dir", _cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def enable_x64() -> None:
    """Switch JAX to 64-bit mode (parity regime)."""
    jax.config.update("jax_enable_x64", True)


def x64_enabled() -> bool:
    return bool(jax.config.read("jax_enable_x64"))


def real_dtype():
    return jnp.float64 if x64_enabled() else jnp.float32


def complex_dtype():
    return jnp.complex128 if x64_enabled() else jnp.complex64
