"""Device selection and card identity.

`resolve_device` turns the `device` argument of the public entry points
into a torch.device. Asking for CUDA on a machine without it raises:
the port never moves to the CPU on its own. The CPU is used only when
a caller names it.
"""

from __future__ import annotations

import subprocess

import torch

from ..errors import DeviceUnavailable


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device` ("cuda", "cuda:1", "cpu" or a
    torch.device). Raises DeviceUnavailable when CUDA is asked for and
    absent, and ValueError for any other device type."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailable(
                f"device {device!r} requested but CUDA is not available; "
                f"pass device='cpu' explicitly to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")


def card_identity() -> str:
    """The card's name and power limit as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    prints them (one line per card). Raises when nvidia-smi fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
