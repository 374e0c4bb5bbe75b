"""Device resolution and numerics settings for the port.

Every entry point takes an explicit `device`. Asking for CUDA where there is
none raises: nothing on the serving path falls back to the CPU.
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device) -> torch.device:
    """-> torch.device for `device` ("cpu", "cuda", "cuda:0", a device).
    Raises when CUDA is asked for and absent.

    For CUDA it turns TF32 off for matmuls and convolutions: the feature
    matmuls and the hub one-hot product sit under a log or feed exact
    comparisons, and TF32 keeps about three decimal digits."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               f"available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def card_info() -> str:
    """Name and power limit of the card(s), as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    prints them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip()
