"""What the benchmark entry points share: the device a run takes and the
card it ran on."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

from .. import config as _config

DEVICES = ("cuda", "cpu")


def take_device(name: str, who: str) -> torch.device:
    """The device of a run, made the port's default: the card unless `name`
    is "cpu". Without a card a run on it exits at once with an error: it
    never carries on on the CPU. On the card the kernels are built first,
    one nvcc per source, all started together."""
    if name not in DEVICES:
        raise ValueError(f"device {name!r}: one of {DEVICES}")
    if name == "cuda" and not torch.cuda.is_available():
        print(f"{who}: no CUDA device (--device cpu runs on the host)", file=sys.stderr)
        sys.exit(2)
    _config.set_config(device=name)
    if name == "cuda":
        from ..ops import build

        build.build()
    return torch.device(name)


def card() -> dict:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` gives them (`line`), or nulls on a machine
    without it."""
    try:
        line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return {"line": None, "name": None, "power_limit": None}
    name, _, limit = line.rpartition(",")
    return {"line": line, "name": name.strip(), "power_limit": limit.strip()}


def commit() -> str | None:
    """The checkout's commit, or None where it is not a git work tree."""
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"], capture_output=True,
                             text=True, timeout=60, cwd=Path(__file__).resolve().parents[2])
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None
