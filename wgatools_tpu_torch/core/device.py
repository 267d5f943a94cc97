"""Which torch device the port runs on, and when the device path pays off.

WGA_TORCH_DEVICE names the device: "cuda" (the default) or "cpu".  The
CPU runs the plain PyTorch versions of the kernels and is meant for tests;
it is chosen explicitly, never as a fallback: asking for CUDA where
torch.cuda.is_available() is False raises.

Below DEVICE_MIN_COLUMNS aligned columns (MAF tools) or DEVICE_MIN_OPS op
slots (chain/PAF batches) a tool answers with the host engine: device
dispatch does not pay off on small inputs.  The values are the TPU
package's (wgatools_tpu/core/device.py), so both packages route alike.
"""

import os

import torch

# the device path pays off past this many alignment columns
DEVICE_MIN_COLUMNS = 1 << 22

# the same rule for op-table batches (chain_scan / segment-sum pipelines):
# ops are ~32 columns each, so this matches DEVICE_MIN_COLUMNS volume
DEVICE_MIN_OPS = 1 << 16

DEVICE_ENV = "WGA_TORCH_DEVICE"

# the card's peaks behind every bound the port states (NVIDIA's data sheet,
# H100 SXM at 700 W): HBM bytes/s, and operations/s outside the tensor
# cores (the float32 rate; the kernels' integer work has no faster unit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


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
