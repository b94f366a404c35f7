"""Compile-cache directory rule (utils/jax_cache.py): the environment
variable wins; unset, the cache is a fixed directory inside the checkout."""

from pathlib import Path

import jax

from voicebridge_tpu.utils import jax_cache

REPO = Path(__file__).resolve().parent.parent


def _record_updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    return calls


def test_env_var_is_used_and_kept(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _record_updates(monkeypatch)
    assert jax_cache.setdefault_compilation_cache() == str(tmp_path)
    assert calls["jax_compilation_cache_dir"] == str(tmp_path)
    import os
    assert os.environ["JAX_COMPILATION_CACHE_DIR"] == str(tmp_path)


def test_unset_default_is_repo_dot_jax_cache(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_updates(monkeypatch)
    first = jax_cache.setdefault_compilation_cache()
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    second = jax_cache.setdefault_compilation_cache()
    assert first == second == str(REPO / ".jax_cache")
    assert calls["jax_compilation_cache_dir"] == first


def test_default_dir_is_gitignored():
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored
