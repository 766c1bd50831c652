"""Test configuration: the CPU backend with float64/complex128.

The reference's numerical tolerances (1e-10 vs dense expm,
test_cheby.jl:8) need complex128.  The tests run on the CPU with 8
virtual devices, so that multi-device sharding is exercised without a
GPU (SURVEY §4, "multi-chip bit-equality vs single-chip").  Tests
marked ``gpu`` need a GPU and skip here; they run on the card with
``python -m pytest tests/ -m gpu`` (see the README).
"""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import os

os.environ.setdefault("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"
