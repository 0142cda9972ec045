"""The accelerator a measurement runs on, and a refusal to run on
anything else."""

from __future__ import annotations

import subprocess


def card_lines():
    """`nvidia-smi` name and power limit of each card, read in a child
    process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def require_gpu(n: int = 1):
    """(jax devices, `name, power limit` of each card); exits non-zero
    when JAX finds fewer than `n` GPUs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"needs a gpu device; JAX found "
                         f"{devs[0].platform} ({devs[0].device_kind})")
    if len(devs) < n:
        raise SystemExit(f"needs {n} devices, found {len(devs)}")
    return devs, card_lines()
