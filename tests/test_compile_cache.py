"""utils/compile_cache: one place decides where compiled programs persist."""

import os

import jax
import pytest

from colmap_pcd_tpu.utils import compile_cache, prewarm


@pytest.mark.parametrize("env_dir", [None, "/somewhere/else/jax_cache"])
def test_cache_dir_honours_env_and_defaults_in_checkout(env_dir, monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.__setitem__(k, v))
    if env_dir is None:
        monkeypatch.delenv(compile_cache.ENV, raising=False)
    else:
        monkeypatch.setenv(compile_cache.ENV, env_dir)
    d = compile_cache.enable()
    if env_dir is None:
        # fixed directory inside the checkout, set explicitly
        assert d == os.path.join(compile_cache.REPO_ROOT, ".jax_cache")
        assert calls["jax_compilation_cache_dir"] == d
    else:
        # JAX reads the variable itself; the helper must not set another dir
        assert d == env_dir
        assert "jax_compilation_cache_dir" not in calls
    assert calls["jax_persistent_cache_min_compile_time_secs"] == 0.0
    # the prewarm journal lives beside the compiled programs
    monkeypatch.delenv("COLMAP_PCD_SHAPE_JOURNAL", raising=False)
    assert prewarm._default_path() == os.path.join(d, "shape_journal.json")


def test_default_cache_dir_is_gitignored():
    with open(os.path.join(compile_cache.REPO_ROOT, ".gitignore")) as f:
        ignored = {line.strip().rstrip("/") for line in f}
    assert os.path.basename(compile_cache.DEFAULT_DIR) in ignored
