"""What a measurement ran on.

Every line a benchmark prints names its device: JAX's platform, device kind
and device count, plus the card's name and power limit as ``nvidia-smi``
reports them (a card set below its maximum power runs slower under load,
so a number without its limit cannot be compared).  Measurement paths call
:func:`require_gpu` first: a run that finds no GPU fails instead of timing
the CPU.
"""
from __future__ import annotations

import shutil
import subprocess
from typing import Any, Dict, Optional


def card() -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    (one line per card), or None where there is no ``nvidia-smi``."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run(
            [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def record() -> Dict[str, Any]:
    """{"platform", "device_kind", "device_count", "card"} of this process's
    JAX devices; initializes the backend."""
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "device_kind": d[0].device_kind,
            "device_count": len(d), "card": card()}


def require_gpu() -> Dict[str, Any]:
    """The device record, or SystemExit when JAX found no GPU."""
    rec = record()
    if rec["platform"] != "gpu":
        raise SystemExit(f"no GPU: JAX's default devices are "
                         f"{rec['platform']} ({rec['device_kind']}); this "
                         f"measurement runs on the GPU only")
    return rec
