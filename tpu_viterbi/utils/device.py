"""The accelerator a measurement ran on, as bench.py and chip_smoke.py
report it beside every number."""

from __future__ import annotations

import subprocess

import jax


def require_gpu() -> dict:
    """{'platform', 'kind', 'count'} of jax.devices(); raises unless JAX
    runs on a GPU, so no measurement silently falls back to the CPU."""
    devs = jax.devices()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    if info["platform"] != "gpu":
        raise RuntimeError(f"no GPU: JAX runs on {info['platform']!r}")
    return info


def card_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card, e.g.
    'NVIDIA H200, 700.00 W' (a card set below its maximum limit runs
    slower under load, so this goes beside every number)."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]
