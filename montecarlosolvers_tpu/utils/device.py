"""What a measurement ran on: the JAX devices and the cards under them.

Every number the benchmark and the smoke test print carries both, since a
time means nothing without the device, and a card set below its power
limit runs slower under load."""

from __future__ import annotations

import subprocess


class NoGPUError(RuntimeError):
    """JAX found no GPU; measurements never fall back to another platform."""


def describe():
    """{"platform", "kind", "count"} of JAX's default devices."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu():
    """`describe()`, or NoGPUError naming the platform JAX found."""
    info = describe()
    if info["platform"] != "gpu":
        raise NoGPUError(
            f"no GPU: JAX found platform {info['platform']!r} "
            f"({info['kind']}, {info['count']} device(s))"
        )
    return info


def card():
    """Name and power limit of each card, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them (cards joined by "; "). nvidia-smi runs in a child process that
    does not touch JAX. Returns "unavailable (...)" without nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({type(e).__name__})"
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())
