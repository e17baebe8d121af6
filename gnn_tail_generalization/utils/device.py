"""What a run ran on: JAX's device and, on NVIDIA cards, nvidia-smi's view.

Every number a benchmark or smoke run prints carries these fields, so a
time is never read without its device (and, on a GPU, the power limit the
card was held to)."""
from __future__ import annotations

import subprocess

import jax


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card, or a
    note that nvidia-smi did not answer."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def device_fields() -> dict:
    """platform, device_kind and device count as JAX reports them, plus the
    card's name and power limit."""
    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "count": len(devs),
        "gpu": gpu_name_and_power_limit(),
    }
