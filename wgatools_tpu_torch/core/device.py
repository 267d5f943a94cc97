"""Which torch device the port runs on, and when the device path pays off.

WGA_TORCH_DEVICE names the device: "cuda" (the default) or "cpu".  The
CPU runs the plain PyTorch versions of the kernels; it is chosen
explicitly, never as a fallback: asking for CUDA where
torch.cuda.is_available() is False raises.

DEVICE_MIN_COLUMNS / DEVICE_MIN_OPS are the TPU package's own thresholds
below which a tool answers with the host engine (device dispatch does not
pay off on small inputs); the port keeps those semantics.
"""

import os

import torch

from wgatools_tpu.core.device import DEVICE_MIN_COLUMNS, DEVICE_MIN_OPS  # noqa: F401

DEVICE_ENV = "WGA_TORCH_DEVICE"


def torch_device() -> torch.device:
    name = os.environ.get(DEVICE_ENV, "cuda")
    if name not in ("cuda", "cpu"):
        raise ValueError(f"{DEVICE_ENV}={name!r}: expected 'cuda' or 'cpu'")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{DEVICE_ENV}=cuda (the default) but torch.cuda.is_available() "
            f"is False; set {DEVICE_ENV}=cpu to run the plain PyTorch "
            "versions on the CPU"
        )
    return torch.device(name)
