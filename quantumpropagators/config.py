"""Global configuration: dtype policy, CPU test setup, compile cache.

The reference implementation (QuantumPropagators.jl) is complex128
end-to-end and verifies kernels against dense ``expm`` at 1e-10
(``test/test_cheby.jl:8``).  This framework follows it:

- With ``jax_enable_x64`` on, states and operators default to
  complex128/float64.  NVIDIA GPUs and the CPU compute in float64
  natively, so this is the main path on both: plain XLA, no emulation.
- With x64 off, the defaults fall back to complex64/float32, and the
  Krylov methods under ``precision="auto"`` switch to the compensated
  double-float tier (:mod:`.ops.dd_linalg`) to keep the 1e-10 contract.

Nothing in this module forces a platform; call :func:`use_cpu_x64`
early (before any device computation) in test harnesses.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax
import jax.numpy as jnp

__all__ = [
    "use_cpu_x64",
    "use_compile_cache",
    "default_real_dtype",
    "default_complex_dtype",
    "x64_enabled",
]

# fixed, inside the checkout (listed in .gitignore): a temporary or
# per-process directory would never be found again by a later run
_DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def use_cpu_x64(n_virtual_devices: int | None = None) -> None:
    """Force the CPU backend with float64/complex128 enabled.

    Must be called before JAX initializes its backends (i.e. before the
    first ``jax.devices()`` / any computation).  Optionally sets up
    ``n_virtual_devices`` host CPU devices for testing multi-device
    sharding without hardware.
    """
    if n_virtual_devices is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        flag = f"--xla_force_host_platform_device_count={n_virtual_devices}"
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (flags + " " + flag).strip()
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


def use_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its
    directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing else is set here.  Otherwise the cache goes to one fixed
    directory inside the checkout (``.jax_cache``).  Call before the
    first compilation."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(_DEFAULT_CACHE_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def x64_enabled() -> bool:
    return bool(jax.config.jax_enable_x64)


def default_real_dtype() -> jnp.dtype:
    return jnp.dtype(jnp.float64) if x64_enabled() else jnp.dtype(jnp.float32)


def default_complex_dtype() -> jnp.dtype:
    return jnp.dtype(jnp.complex128) if x64_enabled() else jnp.dtype(jnp.complex64)
