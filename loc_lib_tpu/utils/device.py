"""The accelerator a benchmark or smoke run reports against.

`require_gpu()` stops a run that would otherwise fall back to the CPU, and
`card_line()` names the card and its power limit, which every recorded
time or rate carries beside it (a card set below its maximum power runs
slower under load).
"""

from __future__ import annotations

import shutil
import subprocess
import sys


def require_gpu():
    """The first device JAX sees, which must be a GPU; exits non-zero
    otherwise."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU (JAX's first device is {dev.platform}: "
              f"{dev.device_kind})", file=sys.stderr)
        raise SystemExit(2)
    return dev


def card_line() -> str:
    """`name, power.limit` from nvidia-smi, run as a child process that does
    not import JAX; one `; `-separated entry per card."""
    if shutil.which("nvidia-smi") is None:
        return "nvidia-smi: not available"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return "; ".join(out.stdout.split("\n")).strip("; ")
