"""Compile-cache placement and the device report (utils/jaxcfg.py)."""

import os

import jax
import pytest

from clique_tpu.utils import jaxcfg


@pytest.fixture
def restore_cache_config():
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


def test_cache_honors_jax_compilation_cache_dir(monkeypatch, tmp_path,
                                                restore_cache_config):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and the
    helper sets no other directory."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert jaxcfg.enable_persistent_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_defaults_to_the_checkout(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(root, ".jax_cache")
    assert jaxcfg.REPO_CACHE_DIR == want
    assert jaxcfg.enable_persistent_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert os.path.isdir(want)


def test_device_report_on_cpu():
    rep = jaxcfg.device_report()
    assert rep["platform"] == "cpu" and rep["count"] == 8
    assert rep["gpu"] is None and rep["jax"] == jax.__version__
