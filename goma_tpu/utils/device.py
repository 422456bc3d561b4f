"""Which card a measurement ran on: ``nvidia-smi``'s name and power limit.

A card may be set below its maximum power and then runs slower under load,
so every number the benchmark and the smoke test print carries this line.
"""

from __future__ import annotations

import subprocess


def card_line() -> str:
    """``name, power.limit`` of the first card as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    reports it, or why it could not be read."""
    try:
        cp = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    lines = cp.stdout.strip().splitlines()
    if cp.returncode != 0 or not lines:
        return f"nvidia-smi rc={cp.returncode}"
    return lines[0].strip()
