import os
import subprocess
import sys

# Tests run on the CPU backend with 8 virtual devices so sharding tests
# exercise a real multi-device mesh without accelerator hardware.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# jax may already be imported (a site hook, a plugin), in which case the
# env vars above are too late for its config snapshot: set it directly.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import pytest  # noqa: E402

ORACLE_DIR = "/tmp/oracle"
REF_BIN = "/tmp/refbuild/Bin"


def have_oracle():
    return os.path.isdir(ORACLE_DIR) and os.path.exists(os.path.join(ORACLE_DIR, "idx.ref"))


requires_oracle = pytest.mark.skipif(
    not have_oracle(), reason="reference oracle data not present in /tmp/oracle"
)


# ---- quick subset --------------------------------------------------
# `pytest -m quick` finishes in a few minutes (per-commit gate); the
# full suite runs the compile-heavy end-to-end/sharded tests too.
# Slow tests are tagged by nodeid substring so the tag stays next to
# the measured duration data rather than scattered across files.
_SLOW_SUBSTRINGS = (
    "test_sharded_engine.py",            # 2 tests, ~5 min of CPU compiles
    "test_roundtrip_accuracy",           # ~100s wgsim round trip
    "test_sw_extend.py",                 # -X 1 device/host compile variants
    "test_sharded.py",                   # 8-shard mesh compiles
    "test_sampled_sa.py",                # full-vs-sampled dual engine compiles
)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: compile-heavy test (excluded "
                                       "from -m quick)")
    config.addinivalue_line("markers", "quick: fast per-commit subset")


def pytest_collection_modifyitems(config, items):
    for item in items:
        if any(s in item.nodeid for s in _SLOW_SUBSTRINGS):
            item.add_marker(pytest.mark.slow)
        else:
            item.add_marker(pytest.mark.quick)
