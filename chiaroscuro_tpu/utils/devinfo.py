"""What ran a measurement: the JAX device and the card's power limit.

A card may be set below its maximum power limit and then runs slower under
load, so every number this repository reports names the card and its
limit beside it.
"""

from __future__ import annotations

import subprocess


def card_line() -> str:
    """``name, power.limit`` of each visible NVIDIA card, as ``nvidia-smi``
    reports them (one line per card, joined by "; ")."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    lines = [l.strip() for l in r.stdout.splitlines() if l.strip()]
    return "; ".join(lines) if lines else f"nvidia-smi rc={r.returncode}"


def jax_device() -> dict:
    """Platform, kind and count of the devices JAX uses."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
