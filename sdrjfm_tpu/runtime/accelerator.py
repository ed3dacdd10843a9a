"""What the measurement entry points know about the accelerator.

`bench.py` and `chip_smoke.py` measure the card and nothing else: they call
`require_gpu()` before any work, so a run without a GPU fails instead of
timing the CPU, and print `nvidia_smi_line()` beside every number because a
card set below its power limit runs slower under load.
"""

from __future__ import annotations

import subprocess
import sys


def require_gpu():
    """Return `jax.devices()` if they are CUDA GPUs; exit 1 otherwise."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX found {devs[0].platform} devices "
              f"({devs[0].device_kind}); this measures the card only",
              file=sys.stderr)
        raise SystemExit(1)
    return devs


def device_record(devs) -> dict:
    """The device as JAX reports it."""
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def nvidia_smi_line() -> str:
    """`name, power.limit` of each card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return "; ".join(line.strip() for line in out.splitlines()
                     if line.strip())
