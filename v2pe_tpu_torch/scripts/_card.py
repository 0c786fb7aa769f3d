"""The card a measurement ran on, as ``nvidia-smi --query-gpu=name,
power.limit --format=csv,noheader`` gives it: every number the scripts
print carries it."""

from __future__ import annotations

import subprocess


def card(device) -> str:
    """``"<name>, <power limit>"`` of the first card, or ``"cpu"`` for a
    run on the CPU."""
    if str(device).startswith("cpu"):
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]
