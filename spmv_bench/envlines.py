"""The lines that say what a run ran on: the host's CPU, the torch build,
the card, and its clocks, power draw and power limit (nvidia-smi)."""
from __future__ import annotations

import os
import platform
import subprocess
from typing import List

import torch

SMI_QUERY = "name,clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu"


def host_cpu() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or "unknown"


def smi_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={SMI_QUERY}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        text = out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        text = f"unavailable ({e})"
    return f"env nvidia-smi ({SMI_QUERY}): {text}"


def lines() -> List[str]:
    """The lines printed before set-up (nvidia-smi's is printed after the
    window, beside which it samples the card)."""
    return [
        f"env host_cpu: {host_cpu()} ({os.cpu_count()} logical CPUs)",
        f"env torch: {torch.__version__}, CUDA {torch.version.cuda}",
        f"env device: {torch.cuda.get_device_name(0)}",
    ]
