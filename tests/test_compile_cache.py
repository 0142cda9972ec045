"""Placement of the persistent XLA compilation cache."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir_seen(env_value):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, salt_tpu.pipeline.engine; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=REPO, env={**env, "JAX_PLATFORMS": "cpu"},
        capture_output=True, text=True, timeout=120, check=True)
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("env_value", [None, "set"], ids=["unset", "set"])
def test_cache_dir(env_value, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set the program keeps JAX's choice;
    without it the cache sits at one fixed, git-ignored path in the
    checkout."""
    if env_value is None:
        assert _cache_dir_seen(None) == os.path.join(REPO, ".jax_cache")
        ignored = subprocess.run(
            ["git", "check-ignore", "-q", ".jax_cache/x"], cwd=REPO)
        assert ignored.returncode in (0, 128)  # 128: not a git checkout
    else:
        d = str(tmp_path / "cache")
        assert _cache_dir_seen(d) == d
