"""Precision and device policy: ``resolve_dd_precision`` decides from
``jax_enable_x64`` alone, and the compile-cache helper places JAX's
persistent cache."""

from pathlib import Path

import jax
import pytest

from quantumpropagators.config import use_compile_cache
from quantumpropagators.propagators._dd_support import resolve_dd_precision

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def x64(request):
    """Run the test with ``jax_enable_x64`` set to ``request.param``."""
    before = bool(jax.config.jax_enable_x64)
    jax.config.update("jax_enable_x64", request.param)
    try:
        yield request.param
    finally:
        jax.config.update("jax_enable_x64", before)


@pytest.mark.parametrize(
    "x64, precision, expected",
    [
        (True, "auto", "native"),
        (False, "auto", "dd"),
        (True, "dd", "dd"),
        (False, "native", "native"),
    ],
    indirect=["x64"],
)
def test_resolve_dd_precision(x64, precision, expected):
    assert resolve_dd_precision(precision) == expected


def test_resolve_dd_precision_ignores_platform(monkeypatch):
    """The device's platform plays no part: only x64 decides."""

    class Device:
        platform = "some_accelerator"

    monkeypatch.setattr(jax, "devices", lambda *a, **k: [Device()])
    assert resolve_dd_precision("auto") == "native"


def test_resolve_dd_precision_rejects_unknown():
    with pytest.raises(ValueError, match="precision"):
        resolve_dd_precision("quad")


@pytest.fixture
def cache_config():
    """Restore ``jax_compilation_cache_dir`` after the test."""
    before = jax.config.jax_compilation_cache_dir
    try:
        yield
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_follows_environment(monkeypatch, cache_config,
                                           tmp_path):
    """With ``JAX_COMPILATION_CACHE_DIR`` set, the helper leaves the
    directory to JAX and sets none of its own."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert use_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_fixed_path_in_checkout(monkeypatch, cache_config):
    """Unset, the cache goes to one fixed path inside the checkout,
    which ``.gitignore`` lists."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = use_compile_cache()
    assert path == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert use_compile_cache() == path  # same directory every call
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored
