"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, no sparsity).

They assume the card's full 700 W; ``card()`` reads the name and power
limit of the card a run is on, which the readings record beside their numbers.
"""

from __future__ import annotations

import subprocess

FLOPS = {  # operations per second
    "bfloat16": 989e12,
    "float16": 989e12,
    "int8": 1979e12,
    "float32": 67e12,
}
HBM_BYTES_PER_S = 3.35e12


def least_seconds(ops: float, nbytes: float, dtype: str) -> float:
    """The roofline: the larger of the compute and the memory bound."""
    return max(ops / FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def card() -> str:
    """'<name>, <power limit>' of card 0 from nvidia-smi, or 'unknown'."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
