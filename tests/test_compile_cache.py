"""The persistent compilation cache lands where JAX_COMPILATION_CACHE_DIR
says, or at <checkout>/.cache/jax when it is unset."""

import os

import jax
import pytest

from stereo_dso_g2o_tpu.runtime import compile_cache

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_set", [True, False])
def test_cache_location(monkeypatch, tmp_path, env_set):
    updates = {}
    # record the settings instead of applying them: the CPU test process
    # must keep the cache off
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: updates.__setitem__(name, value))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        # JAX reads the variable itself: nothing is set in code
        assert compile_cache.enable("gpu") == str(tmp_path)
        assert updates == {}
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        default = os.path.join(CHECKOUT, ".cache", "jax")
        assert compile_cache.enable("gpu") == default
        assert updates["jax_compilation_cache_dir"] == default
        updates.clear()
        assert compile_cache.enable("cpu") is None  # off on the CPU
        assert updates == {}


def test_no_writes_restores_threshold():
    key = "jax_persistent_cache_min_compile_time_secs"
    before = getattr(jax.config, key)
    with compile_cache.no_writes():
        assert getattr(jax.config, key) == float("inf")
        # a program compiled here still runs
        assert int(jax.jit(lambda x: x + 1)(1)) == 2
    assert getattr(jax.config, key) == before
